"""K7, the 3-D U-Net's one-output-channel ``prob`` convolution
(``ops/prob_conv.py``), on the CPU: the wrapper refuses the CPU and what the
kernel does not take; the rule that routes ``CostRegNet.prob`` through K7
(``nets/stereo.py::ProbConv3d.k7_applies``) over a stand-in for a tensor on
the card, as ``test_torch_plane_sweep.py`` does for ``k2_applies``; the
forward taking K7's route only where it applies; the U-Net's CPU outputs bit
for bit those of the plain ``Conv3d`` it had; and the reference check K7 is
held to. The kernel itself runs on the card
(``tests/test_torch_cuda.py -k k7``). The file imports neither JAX nor the JAX
package."""

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo
from rgbmanip_tpu_torch.models.pose_estimator.nets.layers import Conv3d
from rgbmanip_tpu_torch.models.pose_estimator.nets.stereo import CostRegNet, ProbConv3d
from rgbmanip_tpu_torch.ops import prob_conv
from rgbmanip_tpu_torch.utils import logger as L

torch.set_num_threads(2)

BF16 = torch.bfloat16
INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


class OnCard:
    """What ``k7_applies`` reads of a tensor, as if it lay on the card."""

    is_cuda = True

    def __init__(self, t):
        self.dtype = t.dtype
        self._t = t

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self._t.is_contiguous(memory_format=memory_format)


def volume(B=2, C=8, D=5, H=6, W=7, dtype=BF16, seed=0):
    """A (B, C, D, H, W) volume in the channels-last-3d layout."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, D, H, W, C, generator=g).to(dtype).permute(0, 4, 1, 2, 3)


def prob_layer(in_ch=8, dtype=BF16, **kw):
    torch.manual_seed(0)
    args = dict(padding=1, bias=False)
    args.update(kw)
    return ProbConv3d(in_ch, 1, args.pop("kernel_size", 3), dtype=dtype, **args)


def bits(t):
    return t.contiguous().view(INT[t.dtype])


# ------------------------------------------------------------- the wrapper --
WEIGHT = torch.randn(1, 8, 3, 3, 3)


@pytest.mark.parametrize("x,weight,match", [
    (volume(), WEIGHT, "card"),
    (volume(dtype=torch.float32), WEIGHT, "bfloat16"),
    (volume().contiguous(), WEIGHT, "channels-last"),
    (volume(C=16), WEIGHT, r"\(B, 8, D, H, W\)"),
    (volume()[:, :, 0], WEIGHT, r"\(B, 8, D, H, W\)"),
    (volume(), torch.randn(1, 8, 1, 1, 1), r"\(1, 8, 3, 3, 3\)"),
    (volume(), torch.randn(2, 8, 3, 3, 3), r"\(1, 8, 3, 3, 3\)"),
    (volume(), WEIGHT.double(), "float32 or bfloat16"),
], ids=["cpu", "f32", "ncdhw", "16-channels", "4-d", "k1-filter", "2-outputs", "f64-weight"])
def test_prob_conv3d_refuses_the_cpu_and_what_it_does_not_take(x, weight, match):
    """The wrapper raises before it launches: inside a traced span it counts
    no ``k7_launches``."""
    L.SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]), L.span("k7"):
            with pytest.raises(ValueError, match=match):
                prob_conv.prob_conv3d(x, weight)
        s = L.SPANS.summary()
    finally:
        L.SPANS.reset()
    assert s["k7"]["calls"] == 1 and s["k7"].get("k7_launches", 0) == 0


# ------------------------------------------------------------ the rule ------
@pytest.mark.parametrize("case,applies", [
    ("on-card", True),
    ("cpu", False),
    ("f32-input", False),
    ("f32-layer", False),
    ("ncdhw", False),
    ("grad", False),
    ("16-in", False),
    ("bias", False),
    ("stride-2", False),
    ("padding-0", False),
    ("dilation-2", False),
    ("k1", False),
    ("reflect", False),
])
def test_k7_applies_truth_table(case, applies):
    """K7 runs ``prob`` only on the card, for a bf16 channels-last input to a
    bf16 layer, with no gradient recorded, and only for its 8 -> 1, k3, s1,
    p1 convolution without bias; every other case keeps ``Conv3d``."""
    x = volume(C=16 if case == "16-in" else 8,
               dtype=torch.float32 if case == "f32-input" else BF16)
    if case == "ncdhw":
        x = x.contiguous()
    layer = {"f32-layer": lambda: prob_layer(dtype=torch.float32),
             "16-in": lambda: prob_layer(16),
             "bias": lambda: prob_layer(bias=True),
             "stride-2": lambda: prob_layer(stride=2),
             "padding-0": lambda: prob_layer(padding=0),
             "dilation-2": lambda: prob_layer(dilation=2, padding=2),
             "k1": lambda: prob_layer(kernel_size=1, padding=0),
             "reflect": lambda: prob_layer(padding_mode="reflect")}.get(case, prob_layer)()
    seen = x if case == "cpu" else OnCard(x)
    with torch.set_grad_enabled(case == "grad"):
        assert layer.k7_applies(seen) is applies
    with torch.inference_mode():   # the estimator's own mode records none either
        assert layer.k7_applies(seen) is (applies or case == "grad")


def test_the_unets_prob_is_k7s_convolution():
    """``CostRegNet.prob`` at the base every configuration builds (8) is the
    convolution K7 takes; a U-Net of another base keeps ``Conv3d``."""
    assert prob_conv.takes(CostRegNet(32, base=8, dtype=BF16).prob)
    assert not prob_conv.takes(CostRegNet(32, base=4, dtype=BF16).prob)


@pytest.fixture
def routed(monkeypatch):
    """K7's route as if on the card: ``k7_applies`` asked of the input as
    seen on the card (its other rules unchanged), and the call to K7 (off the
    card its plain version) recorded."""
    calls = []
    applies = ProbConv3d.k7_applies
    monkeypatch.setattr(ProbConv3d, "k7_applies", lambda self, x: applies(self, OnCard(x)))
    monkeypatch.setattr(prob_conv, "prob_conv3d",
                        lambda x, w: calls.append(x.shape) or prob_conv.prob_conv3d_plain(x, w))
    return calls


def unet(dtype, seed=0):
    net = CostRegNet(32, base=8, dtype=dtype)
    return stereo.flax_init_(net, torch.Generator().manual_seed(seed)).eval()


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_a_bf16_unet_forward_takes_k7_once(routed, mode):
    """One bf16 U-Net forward on a channels-last volume without a gradient
    calls K7 once, on the 8-channel channels-last activation, and returns
    what the ``Conv3d`` forward returns."""
    net = unet(BF16)
    vol = volume(C=32, D=8, H=8, W=8)
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx:
        got = net(vol)
        assert routed == [(2, 8, 8, 8, 8)]
        want = Conv3d.forward(net.prob, _before_prob(net, vol))
    assert torch.equal(bits(got), bits(want))


def _before_prob(net, x):
    """The U-Net's activation that ``prob`` takes."""
    c0 = net.conv0(x)
    c2 = net.conv2(net.conv1(c0))
    c4 = net.conv4(net.conv3(c2))
    y = net.conv6(net.conv5(c4))
    y = c4 + net.conv7(y)
    y = c2 + net.conv9(y)
    return c0 + net.conv11(y)


@pytest.mark.parametrize("case", ["grad", "f32", "ncdhw"])
def test_training_f32_and_ncdhw_keep_conv3d(routed, case):
    """With a gradient recorded (the trainer's bf16 step), in f32, and on an
    NCDHW volume the U-Net keeps ``Conv3d`` for ``prob``."""
    net = unet(torch.float32 if case == "f32" else BF16).train(case == "grad")
    vol = volume(C=32, D=8, H=8, W=8, dtype=torch.float32 if case == "f32" else BF16)
    if case == "ncdhw":
        vol = vol.contiguous()
    if case == "grad":
        net(vol).float().sum().backward()
        assert net.prob.weight.grad is not None
    else:
        with torch.no_grad():
            net(vol)
    assert routed == []


# ----------------------------------------------------- the CPU, unchanged --
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("layout", ["ncdhw", "channels-last"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_unet_on_the_cpu_keeps_its_outputs_bit_for_bit(dtype, layout, mode):
    """On the CPU ``CostRegNet`` returns bit for bit what it returned with
    ``prob`` a plain ``Conv3d``: its outputs, and in train mode its
    gradients."""
    net = unet(dtype).train(mode == "train")
    old = unet(dtype).train(mode == "train")
    old.prob = Conv3d(8, 1, 3, padding=1, bias=False, dtype=dtype)
    old.load_state_dict(net.state_dict())
    vol = volume(C=32, D=8, H=8, W=8, dtype=dtype, seed=3)
    if layout == "ncdhw":
        vol = vol.contiguous()
    if mode == "eval":
        with torch.no_grad():
            got, want = net(vol), old(vol)
        assert torch.equal(bits(got), bits(want))
        return
    got, want = net(vol), old(vol)
    assert torch.equal(bits(got), bits(want))
    got.float().square().sum().backward()
    want.float().square().sum().backward()
    assert torch.equal(bits(net.prob.weight.grad), bits(old.prob.weight.grad))


def test_no_k7_launch_is_counted_on_the_cpu():
    """Under a profiler a bf16 U-Net forward on the CPU, inside a span,
    counts no ``k7_launches`` (on the card 1 a forward, ``test_torch_cuda.py``)."""
    net = unet(BF16)
    L.SPANS.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
            with L.span("unet"):
                net(volume(C=32, D=8, H=8, W=8))
        s = L.SPANS.summary()
    finally:
        L.SPANS.reset()
    assert s["unet"]["calls"] == 1 and s["unet"].get("k7_launches", 0) == 0


# ------------------------------------------------------- the reference --
def _gaps_input():
    x = volume(B=2, D=4, H=6, W=6, seed=5)
    w = torch.randn(1, 8, 3, 3, 3, generator=torch.Generator().manual_seed(6)) / 216 ** 0.5
    ref = F.conv3d(x.double(), w.to(BF16).double(), None, 1, 1).to(BF16)
    return x, w, ref


def _off_by(ref, ulps, every):
    """``ref`` moved by ``ulps`` bf16 ulps at every ``every``-th output, or
    (``every`` 0) at its largest output alone."""
    out = ref.clone().flatten()
    idx = (out.float().abs().argmax().view(1) if every == 0
           else torch.arange(0, out.numel(), every))
    moved = out[idx].double()
    out[idx] = (moved + ulps * prob_conv._ulp(moved)).to(BF16)   # exact in bf16
    return out.view_as(ref)


@pytest.mark.parametrize("ulps,every,held", [
    (2, 0, False), (1, 50, False), (1, 0, True), (1, 200, True), (3, 200, False)],
    ids=["2-ulps-once", "1-ulp-at-2pct", "1-ulp-once", "1-ulp-at-half-pct", "3-ulps-at-half-pct"])
def test_reference_gaps_holds_its_tolerance(ulps, every, held):
    """The reference check on the CPU, at the edges of its tolerance: an
    output off by 1 ulp (beyond the plain version's own largest error) is
    held where fewer than 1% of outputs differ; 2 ulps anywhere, or 1 ulp at
    2% of outputs, is not."""
    x, w, ref = _gaps_input()
    gaps = prob_conv.reference_gaps(_off_by(ref, ulps, every), x, w)
    assert gaps["held"] is held, gaps


def test_reference_gaps_holds_the_plain_version():
    """The plain version (the library call itself) is held, with its own
    largest error as K7's."""
    x, w, _ = _gaps_input()
    gaps = prob_conv.reference_gaps(prob_conv.prob_conv3d_plain(x, w), x, w)
    assert gaps["held"] and gaps["max_err"] == gaps["library_max_err"]
