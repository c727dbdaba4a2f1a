"""The port's timing scripts (``rgbmanip_tpu_torch/bench.py`` and
``rgbmanip_tpu_torch/scripts/bench_*.py``) against the JAX package's, on the
CPU, where what they time runs through the plain PyTorch path (the scripts
themselves refuse to time without a card, but for the host-only
``bench_sim_scaling`` and ``bench_ppo_iter`` with ``device=cpu``):

- ``append_picture`` on the three estimators: the base and gt ones raise
  ``NotImplementedError``, AdaPose returns ``None``, as the JAX classes do;
- the bench's estimate (its knobs, ``estimator_fast_cabinet_r2.ckpt``, f32)
  on ``bench_inputs(2, ...)``, and ``bench_estimate``'s ``FAST``
  configuration at B=2 on its own inputs, on weights made from a seed with
  numpy in the JAX estimator and carried across by the converter: both packages' estimates on the
  same views and point draws, the JAX crop through its Pallas kernel in
  interpret mode. Two-view estimates: bbox within 1e-3 m, valid flags equal
  (``tests/test_torch_estimator.py``'s rule);
- one ``bench_ppo_update`` batch (its shape and configuration, drawn from
  numpy with a seed) through the JAX ``_update`` (jitted) and the port's,
  from the same fresh weights: parameters, Adam's moments, the learning
  rates and the metrics within ``tests/test_torch_ppo_train.py``'s
  tolerances;
- ``bench_sim_scaling``'s measure loop at 2 envs, one cycle, in both
  packages: the last ``get_image()`` equal bit for bit;
- ``bench_ppo_iter`` at 2 envs for one iteration on the CPU: one history
  entry, and the printed env-steps/s is T * N / (collect + learn).
"""

import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch import bench
from rgbmanip_tpu_torch.algo import ppo as P
from rgbmanip_tpu_torch.models.pose_estimator import adapose as port_adapose
from rgbmanip_tpu_torch.models.pose_estimator.base_estimator import BasePoseEstimator
from rgbmanip_tpu_torch.models.pose_estimator.converter import load_jax_params
from rgbmanip_tpu_torch.models.pose_estimator.groundtruth_estimator import (
    GroundTruthPoseEstimator)
from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
from rgbmanip_tpu_torch.scripts import (bench_estimate, bench_ppo_iter, bench_ppo_update,
                                        bench_sim_scaling, bf16_step_spread)

from test_torch_paper_estimator import init_shapes_only, seeded_tree
from test_torch_ppo_train import actor_of, as_state, critic_of, max_diff
from test_torch_rl_loop import jax_pallas_crop, uniforms_of
from torch_card_cpu import TIE_PX, Disagreement, estimate_projections, view2_raised

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2


def jax_estimator(cfg):
    """The JAX estimator of ``cfg`` with its checkpoint, or else with weights
    made from a seed with numpy (``seeded_tree``); flax's eager init, whose
    values either replaces, takes half a minute on a CPU."""
    from rgbmanip_tpu.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth
    from rgbmanip_tpu.utils.logger import get_logger

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StereoPoseNetWithDepth, "init", init_shapes_only)
        jest = AdaPoseEstimator(cfg, get_logger())
    if not cfg["load"]:
        rng = np.random.default_rng(0)
        jest.params = seeded_tree(jest.params, rng)
        jest.batch_stats = seeded_tree(jest.batch_stats, rng)
    return jest


@pytest.fixture(scope="module")
def estimates():
    """{case: (jax (bbox, valid), port (bbox, valid))} for the bench's
    estimate and the ``FAST`` configuration, with the JAX estimators."""
    jb = jax_estimator(dict(bench.CFG, checkpoint_path=os.path.join(REPO, bench.CKPT)))
    pb = bench.estimator(bench.CKPT, torch.float32, "cpu")
    jf = jax_estimator(bench_estimate.FAST)
    pf = port_adapose.AdaPoseEstimator(bench_estimate.FAST, device="cpu")
    load_jax_params(pf.model, jf.params, jf.batch_stats)

    cases = {"bench": (jb, pb, [t.numpy() for t in bench.bench_inputs(B, bench.SEED, "cpu")]),
             "fast": (jf, pf, [t.numpy() for t in bench_estimate.estimate_inputs(
                 np.random.default_rng(0), B, "cpu")])}
    key = jax.random.PRNGKey(0)
    out = {}
    with jax_pallas_crop():
        for name, (jest, pest, (K, rgb1, mask, ext1, rgb2, ext2)) in cases.items():
            bbox, valid, _ = jest._estimate_fn(jest.params, jest.batch_stats, K, rgb1, mask,
                                               ext1, rgb2, mask, ext2, key)
            u1, u2 = uniforms_of(key, B, pest.img_size)
            t = torch.from_numpy
            pbbox, pvalid, _ = pest._estimate(t(K), t(rgb1), t(mask), t(ext1), t(rgb2),
                                              t(mask), t(ext2), t(u1), t(u2))
            out[name] = ((np.asarray(bbox), np.asarray(valid)),
                         (pbbox.numpy(), pvalid.numpy()))
    return {"estimators": (jb, pb), "cases": out}


def test_append_picture_behaves_as_in_the_jax_package(estimates):
    from rgbmanip_tpu.models.pose_estimator.base_estimator import (
        BasePoseEstimator as JaxBase)
    from rgbmanip_tpu.models.pose_estimator.groundtruth_estimator import (
        GroundTruthPoseEstimator as JaxGt)

    jest, pest = estimates["estimators"]
    assert jest.append_picture("rgb", k=1) is None
    assert pest.append_picture("rgb", k=1) is None
    for est in (JaxBase({}, None), JaxGt(None, {}, None),
                BasePoseEstimator({}, None), GroundTruthPoseEstimator(None, {}, None)):
        with pytest.raises(NotImplementedError):
            est.append_picture("rgb", k=1)


@pytest.mark.parametrize("case", ["bench", "fast"])
def test_estimate_equals_the_jax_package(estimates, case):
    (jbbox, jvalid), (pbbox, pvalid) = estimates["cases"][case]
    assert pbbox.shape == jbbox.shape == (B, 8, 3)
    np.testing.assert_array_equal(pvalid, jvalid)
    print(case, "valid", pvalid, "max |bbox diff| (m):", np.abs(pbbox - jbbox).max())
    np.testing.assert_allclose(pbbox, jbbox, rtol=0, atol=1e-3)


def test_the_bench_views_put_the_volume_border_rows_on_a_tie(estimates):
    """The bench's two views share their orientation and crop rows, so the
    cost volume's first and last rows project onto the source's top and
    bottom border exactly: in f64 within 1e-6 px (the warp's 1e-9 in the
    depth divisor), so f32 rounding alone decides whether those rays fall
    inside (the card and the CPU part by 1.4 cm there).
    ``torch_card_cpu.view2_raised`` moves them 0.04-0.9 px off the border at
    every depth hypothesis."""
    pest = estimates["estimators"][1]
    m = pest.model
    Sv = pest.img_size // m.volume_scale
    scale = torch.tensor([1.0 / m.volume_scale] * 2 + [1.0, 1.0], dtype=torch.float64)[:, None]
    K, rgb1, mask, ext1, rgb2, ext2 = bench.bench_inputs(1, bench.SEED, "cpu")
    u = torch.rand(1, pest.img_size ** 2, generator=torch.Generator().manual_seed(0))
    dist = {}
    for name, e2 in (("own", ext2), ("raised", view2_raised(ext2))):
        seen = []
        hook = m.register_forward_pre_hook(lambda mod, args: seen.append(args))
        try:
            pest._estimate(K, rgb1, mask, ext1, rgb2, mask, e2, u, u)
        finally:
            hook.remove()
        _, _, _, _, P1, P2, depth = seen[0]
        rot, trans = stereo._relative_projection(scale * P2.double(), scale * P1.double())
        xyz = torch.tensor([[0.0, 0.0, 1.0], [0.0, Sv - 1.0, 1.0]], dtype=torch.float64).T[None]
        _, py, _ = stereo._project(rot, trans, xyz, depth.double(), Sv, Sv)
        dist[name] = torch.stack([py[0, :, 0].abs(), (py[0, :, 1] - (Sv - 1)).abs()])
    assert float(dist["own"].max()) < 1e-6
    assert float(dist["raised"].min()) > 0.03


def test_the_tie_replay_takes_only_border_decisions(estimates):
    """``torch_card_cpu.estimate_projections``, with which the card tests
    hold the card's bench estimate to the CPU's on the bench's own
    views: replaying a run's own projections changes nothing; a flipped
    decision of a ray on the border is taken; a flipped decision off the
    border, or coordinates 0.01 px apart, fail the check."""
    pest = estimates["estimators"][1]
    K, rgb1, mask, ext1, rgb2, ext2 = bench.bench_inputs(1, bench.SEED, "cpu")
    u = torch.rand(1, pest.img_size ** 2, generator=torch.Generator().manual_seed(0))
    inputs = (K, rgb1, mask, ext1, rgb2, mask, ext2, u, u)
    (bbox, valid), calls, taken = estimate_projections(pest, inputs)
    assert calls and taken == 0
    (rbox, rvalid), _, taken = estimate_projections(pest, inputs, calls)
    assert taken == 0 and np.array_equal(rbox, bbox) and np.array_equal(rvalid, valid)

    px, py, inside = calls[0]
    H = W = pest.img_size // pest.model.volume_scale
    on_border = (py.abs() < TIE_PX) | ((py - (H - 1)).abs() < TIE_PX)
    off_border = ((px - (W - 1) / 2).abs() < 2) & ((py - (H - 1) / 2).abs() < 2) & inside

    def flipped(where):
        i = int(where.flatten().nonzero()[0])
        flip = inside.clone()
        flip.view(-1)[i] = ~flip.view(-1)[i]
        return [(px, py, flip)] + calls[1:]

    _, _, taken = estimate_projections(pest, inputs, flipped(on_border))
    assert taken == 1
    with pytest.raises(Disagreement, match="off the border"):
        estimate_projections(pest, inputs, flipped(off_border))
    with pytest.raises(Disagreement, match="projections part"):
        estimate_projections(pest, inputs, [(px + 0.01, py, inside)] + calls[1:])


def jax_script_value(path, name, **names):
    """The value assigned to ``name`` inside a JAX script, evaluated with
    ``names`` as its only variables; of a dict, the entries whose values
    need other names are left out."""
    import ast

    def value(node):
        return eval(compile(ast.Expression(node), path, "eval"), {"__builtins__": {}}, names)

    for node in ast.walk(ast.parse(open(os.path.join(REPO, path)).read())):
        if isinstance(node, ast.Assign) and ast.unparse(node.targets[0]).strip("()") == name:
            if not isinstance(node.value, ast.Dict):
                return value(node.value)
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                try:
                    out[value(k)] = value(v)
                except NameError:
                    pass
            return out
    raise KeyError(name)


def test_the_configurations_are_the_jax_scripts(monkeypatch):
    """The knobs, configurations and shapes the port's scripts time are the
    JAX scripts' own."""
    jcfg = jax_script_value("bench.py", "cfg")
    assert {k: v for k, v in bench.CFG.items() if k not in ("load", "checkpoint_path")} == jcfg
    assert bench.CKPT == "checkpoints/estimator_fast_cabinet_r2.ckpt"
    assert jax_script_value("bench.py", "H, W") == (bench.H, bench.W)
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))   # its `from perfutil import`
    spec = importlib.util.spec_from_file_location(
        "jax_bench_estimate", os.path.join(REPO, "scripts", "bench_estimate.py"))
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    assert (bench_estimate.PARITY, bench_estimate.FAST) == (jscript.PARITY, jscript.FAST)
    shape = jax_script_value("scripts/bench_ppo_update.py", "T, N, OBS, ACT")
    assert shape == (bench_ppo_update.T, bench_ppo_update.N, bench_ppo_update.OBS,
                     bench_ppo_update.ACT)
    jppo = jax_script_value("scripts/bench_ppo_update.py", "cfg", T=shape[0])
    jppo["learn"].pop("save_dir")
    ours = {**bench_ppo_update.CFG, "learn": dict(bench_ppo_update.CFG["learn"])}
    ours["learn"].pop("save_dir")
    assert ours == jppo


def test_bench_refuses_a_missing_checkpoint():
    with pytest.raises(FileNotFoundError):
        bench.estimator("checkpoints/no_such_estimator.ckpt", torch.float32, "cpu")


@pytest.mark.parametrize("main", [bench.main, bench_estimate.main, bench_ppo_update.main,
                                  bf16_step_spread.main],
                         ids=["bench", "bench_estimate", "bench_ppo_update", "bf16_step_spread"])
def test_the_timing_scripts_refuse_the_cpu(main):
    with pytest.raises(RuntimeError, match="card"):
        main([])


@pytest.fixture(scope="module")
def ppo_updates():
    """One update of a ``bench_ppo_update`` batch in both packages from the
    JAX trainer's fresh weights."""
    from rgbmanip_tpu.algo import ppo as J

    jp = J.PPO(bench_ppo_update.FakeEnv(), bench_ppo_update.CFG, seed=0)
    pp = P.PPO(bench_ppo_update.FakeEnv(), bench_ppo_update.CFG, seed=0, device="cpu")
    P.load_flax_actor_critic(pp.model, jp.params["params"])
    rng = np.random.default_rng(3)
    batch = {k: rng.normal(size=s).astype(np.float32)
             for k, s in bench_ppo_update.SHAPES.items()}
    batch["sigma"] = np.ones_like(batch["mu"])
    jparams, jopt, jlr, jm = jax.jit(jp._update)(
        jp.params, jp.opt_state, jnp.asarray(jp.lr, jnp.float32),
        {k: jnp.asarray(v) for k, v in batch.items()})
    pm = pp._update({k: torch.from_numpy(v) for k, v in batch.items()})
    return jparams, jopt, float(jlr), np.asarray(jm), pp, pm.numpy()


def test_ppo_update_batch_equals_the_jax_package(ppo_updates):
    jparams, jopt, jlr, jm, pp, pm = ppo_updates
    assert len(pp.update_lrs) == 32
    assert pp.lr == jlr
    params = {n: p.detach() for n, p in pp.model.named_parameters()}
    ref = as_state(pp, jparams["params"])
    assert max_diff(actor_of(params), ref) <= 2e-6
    assert max_diff(critic_of(params), ref) <= 2e-5
    adam = jopt[1].inner_state[0]
    count, mu, nu = pp._moments()
    assert count == int(adam.count) == 32
    mu_j, nu_j = as_state(pp, adam.mu["params"]), as_state(pp, adam.nu["params"])
    mu_scale = max(float(v.abs().max()) for v in mu_j.values())
    assert max_diff(actor_of(mu), mu_j) <= 2e-5 * mu_scale
    assert max_diff(critic_of(mu), mu_j) <= 2e-5 * mu_scale + 1e-4
    assert max_diff(nu, nu_j) <= 2e-4 * max(float(v.abs().max()) for v in nu_j.values())
    np.testing.assert_allclose(pm, jm, rtol=1e-5, atol=5e-6)
    assert np.isfinite(pm).all()


def last_images(monkeypatch, module):
    """Wrap ``module.prepare_env`` so that each env it builds keeps its last
    ``get_image()``; returns the list of images the envs return, in order."""
    images = []
    orig = module.prepare_env

    def prepare_env(*a, **kw):
        env = orig(*a, **kw)
        get_image = env.get_image

        def kept(*ga, **gkw):
            images.append(get_image(*ga, **gkw))
            return images[-1]
        env.get_image = kept
        return env

    monkeypatch.setattr(module, "prepare_env", prepare_env)
    return images


def test_sim_scaling_loop_renders_as_the_jax_package(monkeypatch):
    import rgbmanip_tpu.train as jax_train
    import rgbmanip_tpu_torch.train as port_train

    monkeypatch.setenv("RGBMANIP_SIM_THREADS", "0")   # the JAX script sets it and leaves it
    spec = importlib.util.spec_from_file_location(
        "jax_bench_sim_scaling", os.path.join(REPO, "scripts", "bench_sim_scaling.py"))
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    jimages, pimages = last_images(monkeypatch, jax_train), last_images(monkeypatch, port_train)
    jrow = jscript.measure(2, 1, n_cycles=1)
    prow = bench_sim_scaling.measure(2, 1, n_cycles=1)
    assert os.environ["RGBMANIP_SIM_THREADS"] == "1"   # the JAX script's; the port restores
    assert len(jimages) == len(pimages) == 2          # the warm-up cycle and one timed
    jcam, pcam = jimages[-1]["camera0"], pimages[-1]["camera0"]
    assert sorted(jcam) == sorted(pcam)
    for k in jcam:
        assert pcam[k].dtype == jcam[k].dtype and np.array_equal(pcam[k], jcam[k]), k
    for row in (jrow, prow):
        assert row["n_envs"] == 2 and row["n_threads"] == 1 and row["env_steps_per_s"] > 0


def test_sim_scaling_restores_the_thread_variable(monkeypatch):
    monkeypatch.setenv("RGBMANIP_SIM_THREADS", "3")
    rows = bench_sim_scaling.main(["--envs", "1", "--threads", "--cycles", "1"])
    assert [(r["n_envs"], r["n_threads"]) for r in rows] == [(1, 1)]
    assert os.environ["RGBMANIP_SIM_THREADS"] == "3"


def test_ppo_iteration_reads_the_trainers_own_record(capsys):
    out = bench_ppo_iter.main(["2", "1", "device=cpu"])
    assert len(out["history"]) == 1
    h = out["history"][0]
    assert out["T"] == 16 and out["N"] == 2
    fps = 16 * 2 / (h["collect_s"] + h["learn_s"])
    lines = capsys.readouterr().out.strip().splitlines()
    m = re.search(r"= ([\d.]+) env-steps/s", lines[-2])
    assert m and float(m.group(1)) == round(fps, 1), lines[-2]
    printed = json.loads(lines[-1])
    assert printed["env_steps_per_s"] == out["env_steps_per_s"] == fps
    assert (printed["collect_s"], printed["learn_s"]) == (h["collect_s"], h["learn_s"])
