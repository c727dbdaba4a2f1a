"""The JAX package's compute dtype in the port: bf16, the default of its
estimator trainer (``train_estimator.main``) and of ``evaluate``, against
the JAX package's own bf16 on the CPU.

Sizes: 64 px, 128 points, B=2, the production knobs (resnet18 at backbone
stride 32, volume scale 8, 16 bins of 0.15 m, nearest warp), seeded weights
(``seeded_tree``), the JAX crop through its Pallas kernel in interpret mode.

How the bounds are set. Both packages round to bf16 at the same points (a
convolution or dense layer's output, its bias add, each add of a pooled
window, each of the point sampler's two contractions, BatchNorm's f32
result), so on the same input one layer agrees bit for bit but where the two
f32 accumulations round a sum to the two sides of a bf16 midpoint: 1 to 2
values in 10,000 per convolution (XLA's and oneDNN's orders of summation
differ). Each such flip changes the input of every later layer it reaches,
so through a resnet18 the two bf16 networks part in the last bits of most
values: the JAX package's own bf16 on a TPU would part from its bf16 on a
CPU the same way. So:

- each layer and stage alone, on the same bf16 input: the mean |port - JAX
  bf16| is at most a tenth of the mean |JAX bf16 - JAX f32| on that input
  (measured 0 to 1e-3 of it). A port that ran f32 would sit at the whole
  gap and fail;
- the whole network and the estimate: the port's bf16 within twice the
  JAX package's own bf16-to-f32 gap of the JAX package's bf16, and at least
  half that gap away from the port's f32 (a port that ran f32 would be 0
  away and fail);
- one bf16 training step: the loss parts within 1e-2 relative, the
  gradients f32 and pointing as the JAX package's bf16 ones (cosine), the
  BatchNorm statistics within 1e-2 of their largest, the parameters within
  two learning rates;
- the defaults: both packages' ``train_estimator.main`` train in bf16
  without ``bf16``, in f32 with ``bf16=0``; ``evaluate`` defaults to bf16.
"""

import inspect
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from rgbmanip_tpu_torch.models.pose_estimator import adapose as port_adapose
from rgbmanip_tpu_torch.models.pose_estimator import evaluate as port_evaluate
from rgbmanip_tpu_torch.models.pose_estimator import train_estimator as port_train
from rgbmanip_tpu_torch.models.pose_estimator import training as ptraining
from rgbmanip_tpu_torch.models.pose_estimator.converter import (FLAX_TO_TORCH,
                                                                load_jax_params,
                                                                to_jax_params,
                                                                torch_key_map)
from rgbmanip_tpu_torch.models.pose_estimator.nets import pspnet as PP
from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo as PS
from rgbmanip_tpu_torch.models.pose_estimator.nets.layers import Conv2d, Linear
from rgbmanip_tpu_torch.ops.gather import point_sample
from rgbmanip_tpu_torch.utils.checkpoint import flatten

from test_torch_estimator import scene
from test_torch_paper_estimator import init_shapes_only, seeded_tree
from test_torch_rl_loop import jax_pallas_crop
from test_torch_stereo import projections

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, NPTS, B, D = 64, 128, 2, 16
KNOBS = dict(backend="resnet18", backbone_stride=32, volume_scale=8, warp_mode="nearest")
BF = jnp.bfloat16


def bf16_values(rng, shape, scale=1.0):
    """Normal values that bf16 holds exactly, as f32."""
    x = (scale * rng.normal(size=shape)).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def f32(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(a).astype(np.float32)


def state_from(kmap, trees, prefix=""):
    """A state dict for the torch keys of ``kmap`` under ``prefix`` (the
    prefix stripped) from flax trees {"params": ..., "batch_stats": ...}."""
    flat = {c: flatten(t) for c, t in trees.items()}
    return {k[len(prefix):]: torch.from_numpy(np.ascontiguousarray(
                FLAX_TO_TORCH[kind](np.asarray(flat[c][fp], np.float32))))
            for k, (c, fp, kind) in kmap.items() if k.startswith(prefix)}


def strip(kmap, n):
    """``kmap`` with the first ``n`` entries of every flax path dropped."""
    return {k: (c, fp[n:], kind) for k, (c, fp, kind) in kmap.items()}


# ------------------------------------------------------- layer by layer ----
def layer_cases():
    """name -> build(rng) giving (jax_fn(dtype), port_fn(dtype), inputs)."""
    from flax import linen as nn

    from rgbmanip_tpu.models.pose_estimator.nets import pspnet as JPsp
    from rgbmanip_tpu.models.pose_estimator.nets import stereo as JSt
    from rgbmanip_tpu.ops.gather import point_sample_matmul

    def flax_case(make_jax, make_port, inputs, pre="", n=0, kmap=None):
        def build(rng):
            xs = inputs(rng)
            shapes = init_shapes_only(make_jax(jnp.float32), jax.random.PRNGKey(0),
                                      *(jnp.asarray(x) for x in xs))
            trees = {c: seeded_tree(shapes[c], rng) for c in shapes}

            def jax_fn(dt):
                m = make_jax(dt)
                return lambda *a: m.apply(trees, *(jnp.asarray(x).astype(dt) for x in a))

            def port_fn(dt):
                m = make_port(dt).eval()
                _, unexpected = m.load_state_dict(state_from(strip(kmap, n), trees, pre),
                                                  strict=False)
                assert not unexpected
                return lambda *a: m(*(torch.from_numpy(x).to(dt) for x in a))
            return jax_fn, port_fn, xs
        return build

    full = torch_key_map("resnet18")
    psp = {k: v for k, v in full.items() if k.startswith("img_extractor.")}

    def conv3d_map():
        return {k: v for k, v in full.items() if k.startswith("cost_regularization.conv0.")}

    def heads_map():
        return {k: v for k, v in full.items()
                if k.split(".")[0] in ("pose_mlp1", "pose_mlp2", "rotation_estimator",
                                       "translation_estimator", "size_estimator")}

    class Heads(PS._PoseNet):
        def __init__(self, dt):
            super().__init__()
            self._build_heads(96, dt)

        def forward(self, x):
            return self.heads(x)

    cases = {
        "conv2d+bias": flax_case(
            lambda dt: nn.Conv(32, (3, 3), padding=1, dtype=dt),
            lambda dt: ChannelsLast(Conv2d(64, 32, 3, padding=1, dtype=dt)),
            lambda r: [bf16_values(r, (B, 16, 16, 64))],
            kmap={"weight": ("params", ("kernel",), "conv2d"),
                  "bias": ("params", ("bias",), "copy")}),
        "dense+bias": flax_case(
            lambda dt: nn.Dense(64, dtype=dt), lambda dt: Linear(96, 64, dtype=dt),
            lambda r: [bf16_values(r, (B, NPTS, 96))],
            kmap={"weight": ("params", ("kernel",), "dense"),
                  "bias": ("params", ("bias",), "copy")}),
        "psp module": flax_case(
            lambda dt: JPsp.PSPModule(dtype=dt), lambda dt: ChannelsLast(PP.PSPModule(512, dt)),
            lambda r: [np.maximum(bf16_values(r, (B, 6, 6, 512)), 0)],
            pre="img_extractor.psp.", n=2,
            kmap={k: v for k, v in psp.items() if ".psp." in k}),
        "psp upsample": flax_case(
            lambda dt: JPsp.PSPUpsample(64, dtype=dt), lambda dt: ChannelsLast(PP.PSPUpsample(256, 64, 3, dt)),
            lambda r: [bf16_values(r, (B, 6, 6, 256))],
            pre="img_extractor.up_2.", n=2,
            kmap={k: v for k, v in psp.items() if ".up_2." in k}),
        "conv3d+batchnorm": flax_case(
            lambda dt: JSt.ConvBnRelu3d(8, dtype=dt),
            lambda dt: ChannelsLast(PS.ConvBnRelu3d(32, 8, dtype=dt)), lambda r: [bf16_values(r, (B, 8, 8, 8, 32))],
            pre="cost_regularization.conv0.", n=2, kmap=conv3d_map()),
        "pose heads": flax_case(
            lambda dt: JSt.PoseHeads(dtype=dt), Heads,
            lambda r: [np.maximum(bf16_values(r, (B, NPTS, 96)), 0)], n=1, kmap=heads_map()),
    }

    def fn_case(jax_f, port_f, inputs):
        def build(rng):
            xs = inputs(rng)

            def jax_fn(dt):
                return lambda *a: jax_f(dt, *a)

            def port_fn(dt):
                return lambda *a: port_f(dt, *a)
            return jax_fn, port_fn, xs
        return build

    def coords(r):
        return [bf16_values(r, (B, 8, 8, 32)), r.uniform(-1.0, 8.0, (B, NPTS)).astype(np.float32),
                r.uniform(-1.0, 8.0, (B, NPTS)).astype(np.float32)]

    cases["point sample"] = fn_case(
        lambda dt, f, y, x: point_sample_matmul(jnp.asarray(f).astype(dt), y, x),
        lambda dt, f, y, x: point_sample(torch.from_numpy(f).to(dt), torch.from_numpy(y),
                                         torch.from_numpy(x)), coords)
    cases["avg pool"] = fn_case(
        lambda dt, f: nn.avg_pool(jnp.asarray(f).astype(dt), (2, 2), strides=(2, 2)),
        lambda dt, f: PS.avg_pool(torch.from_numpy(f).to(dt), 2),
        lambda r: [bf16_values(r, (B, 16, 16, 32))])

    def warp_inputs(r):
        P1, P2 = projections(8, 3)
        dv = np.broadcast_to(0.1 + 0.15 * np.arange(D, dtype=np.float32), (B, D)).copy()
        return [bf16_values(r, (B, 8, 8, 32)), P2, P1, dv]
    cases["bilinear warp"] = fn_case(
        lambda dt, f, p2, p1, dv: JSt.homo_warp_batched(jnp.asarray(f).astype(dt), p2, p1, dv,
                                                        "bilinear"),
        lambda dt, f, p2, p1, dv: PS.homo_warp_batched(torch.from_numpy(f).to(dt),
                                                       torch.from_numpy(p2),
                                                       torch.from_numpy(p1),
                                                       torch.from_numpy(dv), "bilinear"),
        warp_inputs)
    return cases


class ChannelsLast(torch.nn.Module):
    """A channels-first module taking and giving channels last, as the JAX
    modules lay out images (B, H, W, C) and volumes (B, D, H, W, C)."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        n = x.dim()
        y = self.inner(x.permute(0, n - 1, *range(1, n - 1)))
        return y.permute(0, *range(2, n), 1)

    def load_state_dict(self, state, strict=True):
        return self.inner.load_state_dict(state, strict=strict)


LAYERS = layer_cases()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_bf16_layer_matches_jax_bf16_well_inside_its_gap(name):
    """The mean |port bf16 - JAX bf16| at most a tenth of the mean |JAX
    bf16 - JAX f32|, with equal output dtypes, on the same input."""
    jax_fn, port_fn, xs = LAYERS[name](np.random.default_rng(sorted(LAYERS).index(name)))
    jb, jf = jax_fn(BF)(*xs), jax_fn(jnp.float32)(*xs)
    with torch.no_grad():
        pb = port_fn(torch.bfloat16)(*xs)
    jb, jf, pb = (x if isinstance(x, tuple) else (x,) for x in (jb, jf, pb))
    for j, f, p in zip(jb, jf, pb):
        assert str(p.dtype).split(".")[-1] == str(j.dtype), (p.dtype, j.dtype)
        assert tuple(p.shape) == tuple(j.shape)
        d, gap = np.abs(f32(p) - f32(j)), np.abs(f32(j) - f32(f))
        print(f"{name}: mean |port - JAX| {d.mean():.3g}, {(d > 0).mean():.2e} of the values "
              f"differ; the JAX bf16-f32 gap {gap.mean():.3g}")
        assert gap.mean() > 0
        assert d.mean() <= 0.1 * gap.mean()


# --------------------------------------------------------- the network -----
@pytest.fixture(scope="module")
def network():
    """The production network's outputs at bf16 and f32 in both packages on
    the same seeded weights and inputs."""
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth as JNet
    from test_torch_stereo import inputs

    x = inputs()
    shapes = init_shapes_only(JNet(**KNOBS), jax.random.PRNGKey(0),
                              *(jnp.asarray(a) for a in x), train=False)
    rng = np.random.default_rng(0)
    trees = {c: seeded_tree(shapes[c], rng) for c in shapes}
    out = {}
    for name, jdt, pdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", BF, torch.bfloat16)):
        m = JNet(dtype=jdt, **KNOBS)
        out["jax", name] = jax.jit(lambda t, *a: m.apply(t, *a, train=False))(
            trees, *(jnp.asarray(a) for a in x))
        net = PS.StereoPoseNetWithDepth(dtype=pdt, **KNOBS).eval()
        load_jax_params(net, trees["params"], trees["batch_stats"])
        with torch.no_grad():
            out["port", name] = net(*(torch.from_numpy(a) for a in x))
    return out


OUTPUTS = [f"view{v}_{k}" for v in (1, 2) for k in ("nocs", "depth", "r", "t", "s")]


@pytest.mark.parametrize("key", OUTPUTS)
def test_bf16_network_output_matches_jax_bf16(network, key):
    """Each output: the JAX package's dtype; within twice the JAX package's
    bf16-to-f32 gap of its bf16 output (max over elements); and carrying
    bf16's rounding: at least half that gap (mean) from the port's f32."""
    jb, jf = network["jax", "bf16"][key], network["jax", "f32"][key]
    pb, pf = network["port", "bf16"][key], network["port", "f32"][key]
    assert str(pb.dtype).split(".")[-1] == str(jb.dtype)
    gap = np.abs(f32(jb) - f32(jf))
    d = np.abs(f32(pb) - f32(jb))
    own = np.abs(f32(pb) - f32(pf))
    print(f"{key}: max |port - JAX| {d.max():.3g} (bound {2 * gap.max():.3g}), mean "
          f"{d.mean():.3g}; JAX gap mean {gap.mean():.3g}, port bf16-f32 mean {own.mean():.3g}")
    assert d.max() <= 2 * gap.max()
    assert own.mean() >= 0.5 * gap.mean()
    np.testing.assert_allclose(f32(pf), f32(jf), rtol=0, atol=1e-4)


def test_bf16_tail_matches_jax_bit_for_bit_on_the_same_features(network):
    """Fed the JAX package's bf16 PSPNet features, the port's NOCS head
    gives the JAX package's bf16 NOCS bit for bit: no chaos past the
    backbone without a convolution stack."""
    from rgbmanip_tpu.models.pose_estimator.nets.pspnet import PSPNet as JP
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth as JNet
    from test_torch_stereo import inputs

    x = inputs()
    shapes = init_shapes_only(JNet(**KNOBS), jax.random.PRNGKey(0),
                              *(jnp.asarray(a) for a in x), train=False)
    rng = np.random.default_rng(0)
    trees = {c: seeded_tree(shapes[c], rng) for c in shapes}
    jp = JP(backend="resnet18", backbone_stride=32, dtype=BF)
    feats = [torch.from_numpy(f32(jax.jit(jp.apply)({"params": trees["params"]["img_extractor"]},
                                                    jnp.asarray(x[i])))).bfloat16()
             for i in (0, 2)]
    net = PS.StereoPoseNetWithDepth(dtype=torch.bfloat16, **KNOBS).eval()
    load_jax_params(net, trees["params"], trees["batch_stats"])
    it = iter(feats)
    net.img_extractor.forward = lambda a: next(it)
    with torch.no_grad():
        out = net(*(torch.from_numpy(a) for a in x))
    for k in ("view1_nocs", "view2_nocs"):
        assert out[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(out[k]), f32(network["jax", "bf16"][k]))


# -------------------------------------------------------- the estimate -----
def est_cfg():
    with open(os.path.join(REPO, "rgbmanip_tpu", "config", "cfg", "pose_estimator",
                           "adapose_cabinet_fast.yaml")) as f:
        cfg = yaml.safe_load(f)
    return {**cfg, "load": False, "checkpoint_path": "", "img_size": S, "n_pts": NPTS}


@pytest.fixture(scope="module")
def estimates():
    """The bf16 estimate of both packages (and the port's f32) on the same
    views, draws and seeded weights."""
    from rgbmanip_tpu.models.pose_estimator.adapose import AdaPoseEstimator as JEst
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth as JNet
    from rgbmanip_tpu.utils.logger import get_logger

    K, rgb, mask, ext = scene()
    n = K.shape[0]
    out = {}
    key = jax.random.PRNGKey(7)
    for name, dt in (("jax f32", jnp.float32), ("jax", BF)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JNet, "init", init_shapes_only)
            jest = JEst(est_cfg(), get_logger(), dtype=dt)
        rng = np.random.default_rng(0)
        jest.params = seeded_tree(jest.params, rng)
        jest.batch_stats = seeded_tree(jest.batch_stats, rng)
        with jax_pallas_crop():
            bbox, valid, _ = jest._estimate_fn(jest.params, jest.batch_stats, K, rgb[0],
                                               mask[0], ext[0], rgb[1], mask[1], ext[1], key)
        out[name] = (np.asarray(bbox), np.asarray(valid))
    k1, k2, _ = jax.random.split(key, 3)
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (n, S * S)))) for k in (k1, k2)]
    t = torch.from_numpy
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        pest = port_adapose.AdaPoseEstimator(est_cfg(), device="cpu", dtype=dt)
        load_jax_params(pest.model, jest.params, jest.batch_stats)
        b, v, _ = pest._estimate(t(K), t(rgb[0]), t(mask[0]), t(ext[0]), t(rgb[1]), t(mask[1]),
                                 t(ext[1]), *u)
        out[name] = (b.numpy(), v.numpy())
    return out


def test_bf16_estimate_matches_jax_bf16(estimates):
    """Equal valid flags; the world bbox within twice the JAX package's own
    bf16-to-f32 gap of its bf16 estimate, and at least half that gap from
    the port's f32 estimate; the port's f32 within 1e-4 m of the JAX
    package's f32."""
    jb, jv = estimates["jax"]
    jf, _ = estimates["jax f32"]
    pb, pv = estimates["bf16"]
    fb, _ = estimates["f32"]
    ok = jv
    gap = np.abs(jb - jf)[ok].max()
    d, own = np.abs(pb - jb)[ok].max(), np.abs(pb - fb)[ok].max()
    print(f"bf16 estimate: max |port - JAX| {d:.3g} m (bound {2 * gap:.3g}); the JAX "
          f"bf16-f32 gap {gap:.3g} m; port bf16 - port f32 {own:.3g} m")
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(jv, [True, True, False])
    assert d <= 2 * gap and own >= 0.5 * gap
    np.testing.assert_allclose(fb, jf, rtol=0, atol=1e-4)


def test_the_bf16_estimate_takes_k1s_bf16_crop(monkeypatch):
    """In bf16 the crop leaves K1 in bf16 (on the card its bf16 entry point)
    and equals the f32 crop cast once, the JAX package's
    ``crop.astype(bf16)``."""
    from rgbmanip_tpu_torch.ops import preprocess
    seen = []
    orig = preprocess.crop_resize_normalize

    def kept(*a, **k):
        seen.append((orig(*a, **k), orig(*a, **{**k, "out_dtype": torch.float32})))
        return seen[-1][0]
    monkeypatch.setattr(preprocess, "crop_resize_normalize", kept)
    K, rgb, mask, ext = scene()
    est = port_adapose.AdaPoseEstimator(est_cfg(), device="cpu", dtype=torch.bfloat16)
    est.estimate(K, rgb[0], mask[0], ext[0], rgb[1], mask[1], ext[1])
    assert len(seen) == 2
    for crop, crop32 in seen:
        assert crop.dtype == torch.bfloat16
        assert torch.equal(crop, crop32.to(torch.bfloat16))


# -------------------------------------------------------- the defaults -----
def test_evaluate_defaults_to_bf16_as_jax_does():
    from rgbmanip_tpu.models.pose_estimator import evaluate as jax_evaluate
    mine = inspect.signature(port_evaluate.evaluate).parameters["dtype"].default
    theirs = inspect.signature(jax_evaluate.evaluate).parameters["dtype"].default
    assert mine is torch.bfloat16 and theirs is jnp.bfloat16


def test_evaluate_runs_its_estimator_in_bf16_by_default(monkeypatch):
    built = []
    orig = port_adapose.AdaPoseEstimator.__init__

    def keep(self, *a, **k):
        orig(self, *a, **k)
        built.append(self)
    monkeypatch.setattr(port_adapose.AdaPoseEstimator, "__init__", keep)
    stats = port_evaluate.evaluate(["dataset=cabinet_test", "task=open_cabinet",
                                    "task.num_envs=2"], checkpoint="", rounds=1,
                                   img_size=S, n_pts=NPTS, device="cpu",
                                   est_overrides={k: v for k, v in est_cfg().items()
                                                  if k in ("backend", "backbone_stride",
                                                           "volume_scale", "n_depth",
                                                           "d_interval")})
    assert built[0].dtype == torch.bfloat16
    assert built[0].model.img_extractor.final.compute_dtype == torch.bfloat16
    assert 0.0 <= stats["valid_frac"] <= 1.0


def jax_main_dtype(monkeypatch, argv):
    """The dtype the JAX package's ``train_estimator.main`` hands ``train``."""
    from rgbmanip_tpu.models.pose_estimator import train_estimator as jte
    seen = {}
    monkeypatch.setattr(jte, "train", lambda **kw: seen.update(kw))
    monkeypatch.setattr(sys, "argv", ["train_estimator"] + argv)
    jte.main()
    return seen["dtype"]


TRAIN_ARGS = ["dataset=cabinet_train", "task=open_cabinet", "task.num_envs=2", "seed=7",
              f"img_size={S}", f"n_pts={NPTS}", "backend=resnet18", "backbone_stride=32",
              "volume_scale=8", "n_depth=16", "d_interval=0.15", "warp_mode=nearest",
              "steps=1", "reuse=1", "device=cpu"]


@pytest.mark.parametrize("flag,dtype", [(None, torch.bfloat16), ("bf16=1", torch.bfloat16),
                                        ("bf16=0", torch.float32)])
def test_train_estimator_main_trains_in_the_jax_default_dtype(flag, dtype, monkeypatch, tmp_path):
    """Without ``bf16`` both packages' ``main`` train in bf16; ``bf16=0`` in
    f32. The port's parameters, gradients and Adam state stay f32."""
    extra = [] if flag is None else [flag]
    jdt = jax_main_dtype(monkeypatch, TRAIN_ARGS + extra)
    assert jdt == (jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    grads = []
    step = torch.optim.Adam.step

    def keep(self, *a, **k):
        grads.extend(p.grad for g in self.param_groups for p in g["params"] if p.grad is not None)
        return step(self, *a, **k)
    monkeypatch.setattr(torch.optim.Adam, "step", keep)
    est = port_train.main(TRAIN_ARGS + extra + [f"save={tmp_path / 'h.ckpt'}",
                                                f"log_dir={tmp_path / 'logs'}"])
    assert est.dtype == dtype
    assert est.model.cost_regularization.conv0.conv.compute_dtype == dtype
    assert {p.dtype for p in est.model.parameters()} == {torch.float32}
    assert grads and {g.dtype for g in grads} == {torch.float32}
    assert est.train_stats["steps"] == 1


# ------------------------------------------------------ the training step ---
@pytest.fixture(scope="module")
def stepped():
    """One bf16 training step of each package from the same seeded weights
    on one synthetic batch."""
    from rgbmanip_tpu.models.pose_estimator import training as jtraining
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth as JNet

    batch = {k: np.asarray(v) for k, v in
             jtraining.synthetic_batch(jax.random.PRNGKey(1), B, S, NPTS, n_depth=D).items()}
    model = JNet(dtype=BF, **KNOBS)
    shapes = init_shapes_only(model, jax.random.PRNGKey(0),
                              *(jnp.asarray(batch[k]) for k in ("img1", "choose1", "img2",
                                                                "choose2", "P1", "P2",
                                                                "depth_values")),
                              train=False)
    rng = np.random.default_rng(0)
    params, stats = seeded_tree(shapes["params"], rng), seeded_tree(shapes["batch_stats"], rng)
    jtr = jtraining.EstimatorTrainer(model, params, stats, lr=1e-4)
    grads = []
    update = jtr.tx.update

    class Rec:
        init = jtr.tx.init

        @staticmethod
        def update(g, s, p):
            jax.debug.callback(lambda x: grads.append(jax.tree.map(np.asarray, x)), g,
                               ordered=True)
            return update(g, s, p)
    jtr.tx = Rec
    jtr._step = jax.jit(jtr.train_step)
    jtotal, jparts = jtr.step({k: jnp.asarray(v) for k, v in batch.items()})
    jax.effects_barrier()
    f32_model = JNet(**KNOBS)

    def loss_f32(p):
        out, _ = f32_model.apply({"params": p, "batch_stats": stats},
                                 *(jnp.asarray(batch[k]) for k in ("img1", "choose1", "img2",
                                                                   "choose2", "P1", "P2",
                                                                   "depth_values")),
                                 train=True, mutable=["batch_stats"])
        return jtraining.estimator_loss(out, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    grads_f32 = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_f32))(params))

    net = PS.StereoPoseNetWithDepth(dtype=torch.bfloat16, **KNOBS).eval()
    load_jax_params(net, params, stats)
    ptr = ptraining.EstimatorTrainer(net, lr=1e-4)
    pgrads = {}
    pstep = ptr.optimizer.step

    def keep(*a, **k):
        pgrads.update({n: p.grad.clone() for n, p in net.named_parameters()})
        return pstep(*a, **k)
    ptr.optimizer.step = keep
    ptotal, pparts = ptr.step({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return dict(jax=(jtotal, jparts, jtr.params, jtr.batch_stats, grads[0], params,
                     grads_f32),
                port=(ptotal, pparts, net, pgrads))


def test_bf16_training_step_loss_parts_match_jax(stepped):
    """Each loss part within 1e-2 relative of the JAX package's bf16 step
    (the predictions differ in their last bf16 bits)."""
    jtotal, jparts = stepped["jax"][:2]
    ptotal, pparts = stepped["port"][:2]
    assert sorted(pparts) == sorted(jparts)
    for k in jparts:
        print(k, pparts[k], jparts[k])
        np.testing.assert_allclose(pparts[k], jparts[k], rtol=1e-2, err_msg=k)
    np.testing.assert_allclose(ptotal, jtotal, rtol=1e-2)


def test_bf16_training_step_gradients_are_f32_and_match_jax(stepped):
    """f32 gradients of f32 parameters, pointing as the JAX package's bf16
    ones do. A bf16 backward at this size is noise: through the U-Net's
    BatchNorms over a few cells each (conv5's: 4 per channel) the JAX
    package's own bf16 gradients part from its f32 ones by up to 1.3 of a
    tensor's largest, so tensors are not held one by one; the whole
    gradient is, by its cosine with the JAX bf16 gradient: 0.9 or more
    (measured 0.966; the JAX package's bf16 against its f32: 0.984)."""
    net, pgrads = stepped["port"][2], stepped["port"][3]
    assert {g.dtype for g in pgrads.values()} == {torch.float32}
    saved = {n: p.detach().clone() for n, p in net.named_parameters()}
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(pgrads[n])
        pg, _ = to_jax_params(net)
        for n, p in net.named_parameters():
            p.copy_(saved[n])
    fj, fp, ff = flatten(stepped["jax"][4]), flatten(pg), flatten(stepped["jax"][6])
    assert sorted(fj) == sorted(fp) == sorted(ff)
    vec = {n: np.concatenate([np.asarray(t[k], np.float32).ravel() for k in sorted(fj)])
           for n, t in (("port", fp), ("jax", fj), ("f32", ff))}

    def cos(a, b):
        return float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
    print(f"gradient cosine port-JAX bf16 {cos(vec['port'], vec['jax']):.5f}, JAX bf16-f32 "
          f"{cos(vec['jax'], vec['f32']):.5f}")
    assert cos(vec["port"], vec["jax"]) >= 0.9


def test_bf16_training_step_batch_stats_and_parameters_match_jax(stepped):
    """BatchNorm's running statistics (f32, from bf16 activations) within
    1e-2 of their largest; every parameter within two learning rates and
    rounding (Adam's first step moves each by +-lr)."""
    net = stepped["port"][2]
    jparams, jstats = flatten(stepped["jax"][2]), flatten(stepped["jax"][3])
    pparams, pstats = (flatten(t) for t in to_jax_params(net))
    for k in jstats:
        j = np.asarray(jstats[k])
        assert np.abs(pstats[k] - j).max() <= 1e-2 * (np.abs(j).max() + 1e-6), k
    for k in jparams:
        assert np.abs(pparams[k] - np.asarray(jparams[k])).max() <= 2.1e-4, k


def test_flagship_rows_script_builds_the_estimator_in_the_asked_dtype(monkeypatch):
    """``scripts/flagship_rows.py`` runs each row with the estimator in the
    dtype it is given (``train``'s configs name none): one round of 8 per
    row on the CPU."""
    from rgbmanip_tpu_torch.scripts import flagship_rows as FR

    built = []

    def build(*a, **k):
        built.append(port_adapose.AdaPoseEstimator(*a, **k))
        return built[-1]
    monkeypatch.setattr(FR, "AdaPoseEstimator", build)
    out = FR.main(["--dtype", "bf16", "--rounds", "8", "--device", "cpu"])
    assert [e.dtype for e in built] == [torch.bfloat16] * len(FR.ROWS)
    assert {e.model.img_extractor.final.compute_dtype for e in built} == {torch.bfloat16}
    assert sorted(out["bf16"]) == sorted(FR.ROWS)
    assert all(0.0 <= v <= 100.0 for v in out["bf16"].values())


def test_train_step_profile_counts_each_dtypes_ops_on_the_cpu():
    """``scripts/train_step_profile.py`` off the card: one step of each
    dtype at B=1, its aten ops counted and its host's top ops listed; no
    device time is claimed."""
    from rgbmanip_tpu_torch.scripts import train_step_profile as TSP

    out = TSP.run(device="cpu", batch=1)
    assert sorted(out) == sorted(TSP.DTYPES)
    for row in out.values():
        assert row["aten_ops"] > 0 and row["top_host_ops"]
        assert "wall_ms" not in row and "busy_ms" not in row
    # bf16 dispatches flax's casts on top of f32's ops
    assert out["bf16"]["aten_ops"] > out["f32"]["aten_ops"]


def test_bf16_step_spread_readings_with_the_cpu_in_the_cards_place():
    """``scripts/bf16_step_spread.py``'s readings of one 2-env slice with
    the CPU in the card's place (64 px, seeded weights, a synthetic batch):
    the card-vs-CPU difference of every loss part is 0, so the least
    multiplier that passes it is 0; the f32 control sits at the CPU's own
    bf16-to-f32 difference, within f32 rounding of the loss; crops moved
    one and four pixels move the loss."""
    from rgbmanip_tpu_torch.config.loader import load_group
    from rgbmanip_tpu_torch.scripts import bf16_step_spread as SP

    cfg = load_group("pose_estimator", "adapose_cabinet_fast",
                     {"load": False, "checkpoint_path": "", "img_size": S, "n_pts": NPTS})
    batch = ptraining.synthetic_batch(torch.Generator().manual_seed(3), B, S, NPTS,
                                      n_depth=int(cfg["n_depth"]))
    x = SP.slice_readings(cfg, torch.device("cpu"), batch)
    assert set(x) == {"r", "c", "c_card"} | set(SP.CONTROLS)
    assert all(v == 0.0 for v in x["r"].values()) and SP.k_needed([x]) == 0.0
    assert x["c"] == x["c_card"] and all(v > 0 for v in x["c"].values())
    for part, c in x["c"].items():
        assert abs(x["f32"][part] - c) <= 1e-5 * (1 + c), part
    for control in ("shift1", "shift4"):
        assert max(x[control].values()) > 0, control
