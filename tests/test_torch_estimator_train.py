"""Estimator training in the port (``rgbmanip_tpu_torch/models/pose_estimator/
{training,data,train_estimator}.py``, the converter's inverse and
``AdaPoseEstimator.save``) against the JAX package's, both on the CPU, at
64 px, 128 points and 2 envs, with the production knobs otherwise
(resnet18, backbone stride 32, volume scale 8, 16 depth bins of 0.15 m,
nearest warp).

- ``SimViewSampler``: the same seed renders the same views in both packages
  (the camera poses, the replay buffer's choices and the view augmentation
  come from one numpy generator, called in the same order); the port is fed
  the JAX sampler's point-sampling draws. The JAX sampler runs as it is: it
  prepares its batches on the CPU backend, where the crop clamps at the
  frame border, and the port's sampler crops with K1's clamping mode, so
  the crops agree on a window in a frame corner too (K1's renormalising
  mode parts from them there by more than 1: tests/test_torch_preprocess.py).
- One ``EstimatorTrainer`` step from shared weights on the same batch: the
  loss parts, the gradients, the BatchNorm running statistics (flax's
  biased variance, updated twice per forward) and the parameters. This is
  Adam's first step, where ``m / sqrt(v)`` is +-1 per element: an element
  whose gradient is near 0 may take either sign with rounding, so the
  parameters are held per element to two learning rates while the
  gradients are held tightly.
- ``train`` through ``main`` for 2 steps with ``device=cpu`` and ``bf16=0``
  (f32; ``main`` trains in bf16 by default: tests/test_torch_precision.py):
  the saved head
  is read by the JAX package's ``AdaPoseEstimator.load`` and gives the
  port's estimate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu.config import load_config as jax_load_config
from rgbmanip_tpu.models.pose_estimator import data as jdata
from rgbmanip_tpu.models.pose_estimator import training as jtraining
from rgbmanip_tpu.models.pose_estimator.adapose import AdaPoseEstimator as JaxEstimator
from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth as JaxNet
from rgbmanip_tpu.train import prepare_env as jax_prepare_env
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch import repo_path
from rgbmanip_tpu_torch.config.loader import load_config
from rgbmanip_tpu_torch.models.pose_estimator import data as pdata
from rgbmanip_tpu_torch.models.pose_estimator import train_estimator as ptrain
from rgbmanip_tpu_torch.models.pose_estimator import training as ptraining
from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
from rgbmanip_tpu_torch.models.pose_estimator.converter import load_jax_params, to_jax_params
from rgbmanip_tpu_torch.train import prepare_env
from rgbmanip_tpu_torch.utils.checkpoint import flatten, load_checkpoint
from rgbmanip_tpu_torch.utils.logger import get_logger
from test_torch_rl_loop import jax_pallas_crop

torch.set_num_threads(2)

S, N_PTS, N_ENVS, SEED, LR = 64, 128, 2, 7, 1e-4
TASK = ["dataset=cabinet_train", "task=open_cabinet", f"task.num_envs={N_ENVS}",
        f"seed={SEED}"]
KNOBS = {"backend": "resnet18", "backbone_stride": 32, "volume_scale": 8, "n_depth": 16,
         "d_interval": 0.15, "warp_mode": "nearest"}
EST_CFG = dict({"name": "adapose_v5", "task_name": "open_cabinet", "load": False,
                "checkpoint_path": "", "img_size": S, "use_depth": True, "n_pts": N_PTS,
                "direct_regression": True, "real_world": False}, **KNOBS)
SAMPLER = dict(img_size=S, n_pts=N_PTS, seed=SEED, reuse=2, buffer_size=2, d_min=0.1,
               d_interval=0.15, n_depth=16)
CALLS = 4   # fresh, replay, fresh (the buffer overflows and drops one), replay
AUGS = ("box", "wide")


@pytest.fixture(scope="module")
def jax_estimator():
    """One JAX estimator at the test's knobs for the module, its flax init
    traced once under ``jax.jit`` (the same weights as the JAX package's
    eager init, in half its time)."""
    orig = JaxNet.init

    def jitted(self, rngs, *args, **kw):
        return jax.jit(lambda r, *a: orig(self, r, *a, **kw))(rngs, *args)
    JaxNet.init = jitted
    try:
        return JaxEstimator(EST_CFG, jax_get_logger())
    finally:
        JaxNet.init = orig


def jax_draws(seed):
    """The port sampler's ``_draws`` fed from the JAX sampler's key chain:
    per prepared batch ``key, k1, k2 = split(key, 3)`` and the (B, S*S)
    uniforms of k1 and k2."""
    state = {"key": np.asarray(jax.random.PRNGKey(seed))}

    def draws(B):
        keys = jax.random.split(jnp.asarray(state["key"]), 3)
        state["key"] = np.asarray(keys[0])
        return tuple(torch.from_numpy(np.array(jax.random.uniform(k, (B, S * S))))
                     for k in keys[1:])
    return draws


@pytest.fixture(scope="module")
def sampled_all():
    """``CALLS`` batches of each package's sampler over the same scenes, for
    each view augmentation."""
    jcfg, pcfg = jax_load_config(TASK), load_config(TASK)
    jenv = jax_prepare_env(jcfg["task"], jcfg["dataset"], log=jax_get_logger(), seed=SEED)
    penv = prepare_env(pcfg["task"], pcfg["dataset"], log=get_logger(), seed=SEED)
    out = {}
    try:
        for aug in AUGS:
            js = jdata.SimViewSampler(jenv, view_aug=aug, **SAMPLER)
            ps = pdata.SimViewSampler(penv, view_aug=aug, device="cpu", **SAMPLER)
            ps._draws = jax_draws(SEED)
            jb, pb = [], []
            for _ in range(CALLS):
                jb.append(js.sample_batch())
                pb.append(ps.sample_batch())
            out[aug] = (js, ps, jb, pb)
    finally:
        jenv.close()
        penv.close()
    return out


@pytest.fixture(params=AUGS)
def sampled(request, sampled_all):
    return sampled_all[request.param]


def test_sampler_renders_the_same_views(sampled):
    js, ps, jb, pb = sampled
    assert ps.rng.bit_generator.state == js.rng.bit_generator.state
    assert len(ps._buffer) == len(js._buffer) == 2
    for je, pe in zip(js._buffer, ps._buffer):
        for jv, pv in zip(je[:2], pe[:2]):
            assert np.array_equal(pv["Color"].numpy(), jv["Color"])
            assert pv["Color"].dtype == torch.float16
            assert np.array_equal(pv["Mask"].numpy(), jv["Mask"])
            for k in ("Depth", "Position", "Intrinsic", "Extrinsic"):
                assert np.array_equal(pv[k], jv[k]), k
        for (jp, jc, jx, jd), (pp, pc, px, pd) in zip(je[2], pe[2]):
            assert np.array_equal(pp.p, jp.p) and np.array_equal(pp.q, jp.q)
            assert np.array_equal(pc, jc) and np.array_equal(px, jx) and pd == jd
    assert any(b is not None and b["valid"].any() for b in jb)


def test_sampler_batches_match_jax(sampled):
    """Crops within 1e-5 (K1's clamping mode, plain, against the JAX
    sampler's own crop), the chosen points equal, the labels equal or within
    f32 rounding, the projections within 1e-6 relative."""
    _, _, jb, pb = sampled
    for i, (j, p) in enumerate(zip(jb, pb)):
        assert (j is None) == (p is None), i
        if j is None:
            continue
        for k in ("img1", "img2"):
            np.testing.assert_allclose(p[k].numpy(), j[k], rtol=0, atol=1e-5, err_msg=k)
        for k in ("choose1", "choose2", "valid"):
            np.testing.assert_array_equal(p[k].numpy(), j[k], err_msg=k)
        for k in ("nocs1", "nocs2", "depth1", "depth2", "r1", "r2", "t1", "t2",
                  "s1", "s2", "depth_values"):
            np.testing.assert_allclose(p[k].numpy(), j[k], rtol=1e-6, atol=1e-6, err_msg=k)
        for k in ("P1", "P2"):
            np.testing.assert_allclose(p[k].numpy(), j[k], rtol=1e-6, atol=1e-4, err_msg=k)


def test_sampler_crops_a_corner_window_as_the_jax_sampler(sampled_all):
    """A replayed entry whose masks sit in the frame's top-left (view 1) and
    bottom-right (view 2) corners, in copies of both samplers: the port's
    batch equals the JAX sampler's own within 1e-5, where the renormalising
    rule parts from it by more than ten times that (on these smooth renders;
    by 3.3 on noise: tests/test_torch_preprocess.py)."""
    import copy

    from rgbmanip_tpu_torch.ops.preprocess import prepare_model_input
    from rgbmanip_tpu_torch.utils.logger import PhaseTimer

    js, ps, _, _ = sampled_all["box"]
    (jv1, jv2, frames), (pv1, pv2, _) = js._buffer[-1], ps._buffer[-1]
    corners = []
    for sl in ((slice(0, 30), slice(0, 30)), (slice(450, 480), slice(610, 640))):
        m = np.zeros_like(jv1["Mask"])
        m[:, sl[0], sl[1]] = True
        corners.append(m)
    jcopy, pcopy = copy.copy(js), copy.copy(ps)
    jcopy._buffer = [(dict(jv1, Mask=corners[0]), dict(jv2, Mask=corners[1]), frames)]
    pcopy._buffer = [(dict(pv1, Mask=torch.from_numpy(corners[0])),
                      dict(pv2, Mask=torch.from_numpy(corners[1])), frames)]
    jcopy.rng, pcopy.rng = copy.deepcopy(js.rng), copy.deepcopy(js.rng)
    jcopy.key = np.asarray(jax.random.PRNGKey(11))
    pcopy._draws = jax_draws(11)
    pcopy.timer = PhaseTimer()
    jcopy._calls = pcopy._calls = 1            # the next call replays
    j, p = jcopy.sample_batch(), pcopy.sample_batch()
    assert j is not None and p is not None and j["valid"].all()
    for k in ("img1", "img2"):
        np.testing.assert_allclose(p[k].numpy(), j[k], rtol=0, atol=1e-5, err_msg=k)
    for k in ("choose1", "choose2"):
        np.testing.assert_array_equal(p[k].numpy(), j[k], err_msg=k)
    K = torch.from_numpy(np.asarray(jv1["Intrinsic"], np.float32))
    renorm = prepare_model_input(pv1["Color"].float(), torch.from_numpy(corners[0]), K,
                                 torch.Generator().manual_seed(0), S, N_PTS)[0]
    assert float(np.abs(renorm.numpy() - j["img1"]).max()) > 1e-4


def test_the_replay_buffer_keeps_views_on_the_device_and_copies_only_labels(sampled):
    _, ps, _, _ = sampled
    views = 2 * N_ENVS * 480 * 640
    per_fresh = views * (3 * 2 + 1)              # f16 colour and a bool mask per view
    assert ps.timer.counts["render"] == 2 and ps.timer.counts["prepare"] == CALLS
    labels = N_ENVS * (N_PTS * 8 + 2 * 16 + 6 + 9 + 2 * 16) * 4 + N_ENVS * 9 * 4
    assert ps.h2d_bytes <= 2 * per_fresh + CALLS * 2 * labels


def test_estimator_loss_with_one_invalid_env_matches_jax():
    rng = np.random.default_rng(0)
    B = 2
    shapes = {"nocs": (B, N_PTS, 3), "depth": (B, N_PTS), "r": (B, 3, 3), "t": (B, 3),
              "s": (B, 3)}
    pred, labels = {}, {}
    for k, shape in shapes.items():
        for v in (1, 2):
            pred[f"view{v}_{k}"] = rng.normal(size=shape).astype(np.float32) * 0.3
            labels[f"{k}{v}"] = rng.normal(size=shape).astype(np.float32) * 0.3
    labels["valid"] = np.array([True, False])
    jt, jp = jtraining.estimator_loss({k: jnp.asarray(v) for k, v in pred.items()},
                                      {k: jnp.asarray(v) for k, v in labels.items()})
    pt, pp = ptraining.estimator_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                                      {k: torch.from_numpy(v) for k, v in labels.items()})
    assert sorted(pp) == sorted(jp) == ["depth", "nocs", "rot", "size", "trans"]
    for k in jp:
        np.testing.assert_allclose(float(pp[k]), float(jp[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-6)
    # the invalid env counts for nothing
    flip = {k: (v.copy() if k == "valid" else v) for k, v in labels.items()}
    flip["nocs1"] = labels["nocs1"].copy()
    flip["nocs1"][1] += 5.0
    pt2, _ = ptraining.estimator_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                                      {k: torch.from_numpy(v) for k, v in flip.items()})
    assert float(pt2) == float(pt)


class AdamRecorder:
    """Keeps the raw gradients the JAX trainer's optax step receives."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, opt_state, params):
        jax.debug.callback(lambda g: self.grads.append(jax.tree.map(np.asarray, g)), grads,
                           ordered=True)
        return self.tx.update(grads, opt_state, params)


@pytest.fixture(scope="module")
def stepped(sampled_all, jax_estimator):
    """One training step of each package from the JAX estimator's seeded
    weights on the JAX box sampler's first valid batch."""
    jb = sampled_all["box"][2]
    batch = next(b for b in jb if b is not None)
    jest = jax_estimator
    params0, stats0 = jest.params, jest.batch_stats
    jtr = jtraining.EstimatorTrainer(jest.model, params0, stats0, lr=LR)
    rec = AdamRecorder(jtr.tx)
    jtr.tx = rec
    jtr._step = jax.jit(jtr.train_step)
    jtotal, jparts = jtr.step({k: jnp.asarray(v) for k, v in batch.items()})
    jax.effects_barrier()

    pest = AdaPoseEstimator(EST_CFG, get_logger(), device="cpu")
    load_jax_params(pest.model, params0, stats0)
    ptr = ptraining.EstimatorTrainer(pest.model, lr=LR)
    grads = {}
    step = ptr.optimizer.step

    def keep_grads(*a, **k):
        grads.update({n: p.grad.clone() for n, p in pest.model.named_parameters()})
        return step(*a, **k)
    ptr.optimizer.step = keep_grads
    ptotal, pparts = ptr.step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return dict(jax=(jtotal, jparts, jtr.params, jtr.batch_stats, rec.grads[0], params0),
                port=(ptotal, pparts, pest, grads))


def test_training_step_loss_parts_match_jax(stepped):
    jtotal, jparts = stepped["jax"][:2]
    ptotal, pparts = stepped["port"][:2]
    assert sorted(pparts) == sorted(jparts)
    for k in jparts:
        np.testing.assert_allclose(pparts[k], jparts[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(ptotal, jtotal, rtol=1e-5)


def test_training_step_gradients_match_jax(stepped):
    """Every gradient within 1e-3 of its tensor's largest (f32 through a
    resnet18, a 3-D U-Net and both their backward passes; 3e-5 seen), but
    the PReLU slopes' within 1e-2: each is one scalar summed over every
    element of its feature map, terms of both signs that cancel to a small
    value (1.9e-3 seen)."""
    pest, grads = stepped["port"][2], stepped["port"][3]
    jgrads = stepped["jax"][4]
    pg, _ = to_jax_params_like(pest.model, grads)
    fj, fp = flatten(jgrads), flatten(pg)
    assert sorted(fj) == sorted(fp)
    rel = {k: float(np.abs(fp[k] - fj[k]).max() / (np.abs(fj[k]).max() + 1e-12)) for k in fj}
    prelu = [k for k in fj if k[-1] == "prelu"]
    assert prelu
    worst = max(v for k, v in rel.items() if k not in prelu)
    print("largest gradient difference relative to its tensor's largest:", worst,
          "PReLU slopes:", max(rel[k] for k in prelu))
    assert worst <= 1e-3
    assert max(rel[k] for k in prelu) <= 1e-2


def to_jax_params_like(model, tensors):
    """The flax trees of ``tensors`` named as ``model``'s parameters."""
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(tensors[n])
        out = to_jax_params(model)
        for n, p in model.named_parameters():
            p.copy_(saved[n])
    return out


def test_training_step_batch_stats_match_jax(stepped):
    """flax's BatchNorm updates its running variance with the biased batch
    variance, twice per forward (view 1, then view 2)."""
    pest = stepped["port"][2]
    jstats = flatten(stepped["jax"][3])
    _, pstats = to_jax_params(pest.model)
    pstats = flatten(pstats)
    assert sorted(pstats) == sorted(jstats)
    for k in jstats:
        np.testing.assert_allclose(pstats[k], jstats[k], rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(k))
    # the statistics moved from their initial (0, 1)
    assert any(np.abs(v).max() > 1e-3 for k, v in jstats.items() if k[-1] == "mean")


def test_training_step_parameters_match_jax(stepped):
    """Adam's first step moves each parameter by +-lr up to rounding; an
    element whose gradient is near 0 may go either way. Held per element to
    two learning rates and rounding (2.1 lr), and all but a few elements to
    1e-3 of one."""
    pest = stepped["port"][2]
    jparams, params0 = flatten(stepped["jax"][2]), flatten(stepped["jax"][5])
    pparams, _ = to_jax_params(pest.model)
    pparams = flatten(pparams)
    n_total = n_loose = 0
    for k in jparams:
        d = np.abs(pparams[k] - jparams[k])
        assert d.max() <= 2.1 * LR, "/".join(k)
        n_total += d.size
        n_loose += int((d > 1e-3 * LR).sum())
        moved = np.abs(jparams[k] - np.asarray(params0[k]))
        assert moved.max() <= LR * 1.001, "/".join(k)
    print(f"{n_loose} of {n_total} parameters differ by more than 1e-3 lr")
    assert n_loose <= 1e-3 * n_total


def test_the_converter_round_trips_flax_to_the_port_and_back_bit_for_bit(jax_estimator):
    jest = jax_estimator
    pest = AdaPoseEstimator(EST_CFG, get_logger(), device="cpu")
    tree, _ = load_checkpoint(repo_path("checkpoints/estimator_fast_cabinet_aug_r5.ckpt"))
    for params, stats in ((jest.params, jest.batch_stats),
                          (tree["params"], tree["batch_stats"])):
        load_jax_params(pest.model, params, stats)
        p2, s2 = to_jax_params(pest.model)
        for a, b in ((p2, params), (s2, stats)):
            fa, fb = flatten(a), flatten(b)
            assert sorted(fa) == sorted(fb)
            for k in fb:
                ref = np.asarray(fb[k])
                assert fa[k].dtype == ref.dtype and np.array_equal(fa[k], ref), k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("est")
    argv = TASK + [f"{k}={v}" for k, v in KNOBS.items()] + [
        f"img_size={S}", f"n_pts={N_PTS}", "steps=2", "reuse=2", "log_every=1",
        f"save={tmp / 'head.ckpt'}", f"log_dir={tmp / 'logs'}", "device=cpu", "bf16=0"]
    return ptrain.main(argv), tmp / "head.ckpt"


def test_train_runs_through_main_and_saves_a_head_jax_reads(trained, jax_estimator):
    est, path = trained
    assert est.train_stats["steps"] == 2 and est.train_stats["phases"]["train_step"] > 0
    assert not est.model.training
    jest = jax_estimator
    jest.load(str(path))
    pp, ps = to_jax_params(est.model)
    for a, b in ((pp, jest.params), (ps, jest.batch_stats)):
        fa, fb = flatten(a), flatten(b)
        assert sorted(fa) == sorted(fb)
        assert all(np.array_equal(fa[k], np.asarray(fb[k])) for k in fb)
    # the same estimate from the same views and draws, within 1e-5 m
    jcfg = jax_load_config(TASK)
    env = jax_prepare_env(jcfg["task"], jcfg["dataset"], log=jax_get_logger(), seed=SEED)
    try:
        v1, v2, _ = jdata.SimViewSampler(env, **SAMPLER)._render_entry()
    finally:
        env.close()
    args = [v1["Intrinsic"], v1["Color"], v1["Mask"], v1["Extrinsic"], v2["Color"],
            v2["Mask"], v2["Extrinsic"]]
    args = [np.asarray(a, np.float32) if a.dtype != bool else a for a in args]
    k = jax.random.PRNGKey(3)
    k1, k2, _ = jax.random.split(k, 3)
    with jax_pallas_crop():
        jb, jv, _ = jest._estimate_fn(jest.params, jest.batch_stats, *args, k)
    u1, u2 = (torch.from_numpy(np.array(jax.random.uniform(x, (N_ENVS, S * S))))
              for x in (k1, k2))
    pb, pv, _ = est._estimate(*(torch.from_numpy(a) for a in args), u1, u2)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)


def test_the_port_resumes_from_a_head_of_either_package(trained, jax_estimator, tmp_path):
    est, path = trained
    cfg = dict(EST_CFG, load=True, checkpoint_path=str(path))
    again = AdaPoseEstimator(cfg, get_logger(), device="cpu")
    a, b = again.model.state_dict(), est.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in b if not k.endswith("num_batches_tracked"))
    jest = jax_estimator
    jest.load(str(path))
    jest.save(str(tmp_path / "jax.ckpt"))
    mine, theirs = load_checkpoint(str(path)), load_checkpoint(str(tmp_path / "jax.ckpt"))
    assert mine[1] == theirs[1]                          # the architecture metadata
    fa, fb = flatten(mine[0]), flatten(theirs[0])
    assert sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fb)
    from_jax = AdaPoseEstimator(dict(cfg, checkpoint_path=str(tmp_path / "jax.ckpt")),
                                get_logger(), device="cpu").model.state_dict()
    assert all(torch.equal(from_jax[k], b[k]) for k in b
               if not k.endswith("num_batches_tracked"))


def test_policy_view_sampler_matches_jax(tmp_path):
    """``PolicyViewSampler`` (the DAgger view source) at 2 envs with every
    fresh pair from a policy episode (``mix=0``): the same frames, labels and
    crops as the JAX package's. Each port action is checked within 1e-5 of
    the JAX policy's on the same observation, and the port then takes the
    JAX action (a camera target moved by f32 rounding changes edge pixels:
    tests/test_torch_rl_loop.py)."""
    over = TASK + ["controller=rl", f"controller.learn.save_dir={tmp_path}"]
    kw = dict(SAMPLER, mix=0.0, noise=0.15, pair_mode="last", reuse=1)
    policy = "checkpoints/ppo_rl_coadapt_model_165.ckpt"
    jcfg, pcfg = jax_load_config(over), load_config(over)
    jenv = jax_prepare_env(jcfg["task"], jcfg["dataset"], log=jax_get_logger(), seed=SEED)
    penv = prepare_env(pcfg["task"], pcfg["dataset"], log=get_logger(), seed=SEED)
    try:
        js = jdata.PolicyViewSampler(jenv, jcfg, policy, **kw)
        ps = pdata.PolicyViewSampler(penv, pcfg, policy, device="cpu", **kw)
        ps._draws = jax_draws(SEED)
        actions, own = [], []
        jact, pact = js._ppo.act_inference, ps._ppo.act_inference

        def jax_act(obs):
            actions.append(np.asarray(jact(obs)))
            return actions[-1]

        def port_act(obs):
            own.append(pact(obs))
            return actions[len(own) - 1]
        js._ppo.act_inference, ps._ppo.act_inference = jax_act, port_act
        jb, pb = [], []
        for _ in range(2):
            jb.append(js.sample_batch())
            pb.append(ps.sample_batch())
    finally:
        jenv.close()
        penv.close()
    assert len(own) == len(actions) >= 2
    assert max(float(np.abs(a - b).max()) for a, b in zip(own, actions)) <= 1e-5
    assert ps.rng.bit_generator.state == js.rng.bit_generator.state
    for je, pe in zip(js._buffer, ps._buffer):
        for jv, pv in zip(je[:2], pe[:2]):
            assert np.array_equal(pv["Color"].numpy(), jv["Color"])
            assert np.array_equal(pv["Mask"].numpy(), jv["Mask"])
    for j, p in zip(jb, pb):
        assert (j is None) == (p is None)
        if j is not None:
            np.testing.assert_array_equal(p["choose1"].numpy(), j["choose1"])
            np.testing.assert_allclose(p["img2"].numpy(), j["img2"], rtol=0, atol=1e-5)
            np.testing.assert_allclose(p["nocs2"].numpy(), j["nocs2"], rtol=1e-6, atol=1e-6)
    assert any(b is not None for b in pb)


def test_synthetic_batch_has_the_jax_batch_layout_and_trains():
    jb = jtraining.synthetic_batch(jax.random.PRNGKey(0), 2, S, N_PTS, n_depth=16)
    pb = ptraining.synthetic_batch(torch.Generator().manual_seed(0), 2, S, N_PTS, n_depth=16)
    assert sorted(pb) == sorted(jb)
    for k in jb:
        assert tuple(pb[k].shape) == tuple(jb[k].shape), k
        assert pb[k].dtype.is_floating_point == jnp.issubdtype(jb[k].dtype, jnp.floating), k
    np.testing.assert_array_equal(pb["depth_values"].numpy(), np.asarray(jb["depth_values"]))
    est = AdaPoseEstimator(EST_CFG, get_logger(), device="cpu")
    total, parts = ptraining.EstimatorTrainer(est.model).step(pb)
    assert np.isfinite(total) and sorted(parts) == ["depth", "nocs", "rot", "size", "trans"]
