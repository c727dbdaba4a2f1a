"""Kernel K1 (fused crop-resize-normalise) and the estimator preprocessing of
the PyTorch port, held against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode: that is the crop the
main path ran on its chip. The JAX package's CPU fallback clamps taps at the
frame border where the Pallas kernel renormalises the hat rows, so the two
JAX paths disagree near the border; the port follows the Pallas kernel.
``jax.clear_caches()`` around the patch keeps a jitted trace of the other
path from being reused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.ops import crop_resize as port_k1
from rgbmanip_tpu_torch.ops import preprocess as port_pre

torch.set_num_threads(2)

H, W, S = 480, 640, 192
# windows (rmin, cmin, side): a centred 120 px window, a 40 px window in the
# top-left corner (upsampled), a 440 px window (downsampled) and a 40 px
# window in the bottom-right corner
WINDOWS = [(180, 260, 120), (0, 0, 40), (20, 100, 440), (440, 600, 40)]


def frames(B, seed=0):
    return np.random.default_rng(seed).uniform(size=(B, H, W, 3)).astype(np.float32)


def window_arrays(windows):
    """(rmin, cmin, ratio) as the JAX wrapper takes them."""
    w = np.asarray(windows, np.float32)
    return w[:, 0], w[:, 1], (np.float32(S) / w[:, 2]).astype(np.float32)


def port_window(windows, device="cpu"):
    """(rmin, cmin, inv_ratio) tensors: 1 / ratio in f32, as the JAX wrapper
    computes it when it is called on its own."""
    rmin, cmin, ratio = window_arrays(windows)
    inv = (np.float32(1) / ratio).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (rmin, cmin, inv))


@pytest.fixture
def jax_pallas_crop(monkeypatch):
    """Route the JAX preprocessing through the Pallas kernel (interpret)."""
    import rgbmanip_tpu.ops.pallas_preprocess as jpal
    import rgbmanip_tpu.ops.preprocess as jpre

    jax.clear_caches()
    monkeypatch.setattr(jpre, "_use_pallas", lambda: True)
    monkeypatch.setattr(jpal, "crop_resize_normalize",
                        functools.partial(jpal.crop_resize_normalize, interpret=True))
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_k1_plain_matches_pallas_kernel_whole_output():
    from rgbmanip_tpu.ops.pallas_preprocess import crop_resize_normalize

    rgb = frames(len(WINDOWS))
    rmin, cmin, ratio = window_arrays(WINDOWS)
    ref = np.asarray(crop_resize_normalize(
        jnp.asarray(rgb), jnp.asarray(rmin), jnp.asarray(cmin), jnp.asarray(ratio),
        out_size=S, out_dtype=jnp.float32, interpret=True))
    out = port_k1.crop_resize_normalize(torch.from_numpy(rgb), *port_window(WINDOWS),
                                        out_size=S).numpy()
    assert out.shape == ref.shape == (len(WINDOWS), S, S, 3)
    # same taps and weights, f32; only the order of the TPU kernel's dense
    # sums (exact zeros included) differs: 1e-5 in normalised units
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# reversed windows (rmin, cmin, side < 0): the one an empty mask gives, and
# one that runs past the top-left corner, beside a forward window
REVERSED = {"empty-mask": [(460, 540, -440)],
            "past-the-corner": [(30, 20, -120), (180, 260, 120)]}


def test_empty_mask_gives_a_reversed_window():
    """Both packages turn an empty mask into rmin 460, rmax 20 (side -440),
    cmin 540, cmax 100; the estimate still runs K1 on such a view."""
    from rgbmanip_tpu.ops.preprocess import mask_bbox_batched, square_window_batched

    mask = np.zeros((1, H, W), bool)
    ref = square_window_batched(*mask_bbox_batched(jnp.asarray(mask))[:4], H, W)
    out = port_pre.square_window_batched(*port_pre.mask_bbox_batched(
        torch.from_numpy(mask).float())[:4], H, W)
    assert [int(np.asarray(r)[0]) for r in ref] == [int(o[0]) for o in out] == [460, 20, 540, 100]


@pytest.mark.parametrize("case", sorted(REVERSED))
def test_k1_plain_matches_pallas_kernel_on_reversed_windows(case):
    """inv_ratio < 0: the source coordinate runs backwards through the
    window; the hat rows and their renormalisation at the border are those of
    the Pallas kernel (interpret mode), to the same 1e-5 as the forward
    windows."""
    from rgbmanip_tpu.ops.pallas_preprocess import crop_resize_normalize

    windows = REVERSED[case]
    rgb = frames(len(windows), seed=5)
    rmin, cmin, ratio = window_arrays(windows)
    ref = np.asarray(crop_resize_normalize(
        jnp.asarray(rgb), jnp.asarray(rmin), jnp.asarray(cmin), jnp.asarray(ratio),
        out_size=S, out_dtype=jnp.float32, interpret=True))
    win = port_window(windows)
    assert (win[2][0] < 0).item()
    out = port_k1.crop_resize_normalize(torch.from_numpy(rgb), *win, out_size=S).numpy()
    assert out.shape == ref.shape == (len(windows), S, S, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("std", port_k1.IMAGENET_STD)
def test_k1_kernel_division_by_std_is_correctly_rounded(std):
    """The CUDA kernel divides by std as q = RN(x * y), y = RN(1 / std), and
    one FMA step, q + (x - q * std) * y. For each of the three divisors that
    equals the IEEE quotient (the plain version's division) for every f32 x
    in [1, 2), and so, scaled by powers of two and by sign, for every normal
    x. Emulated here exactly: the products of two f32 are exact in f64, and
    the f64 sum of the last step is rounded twice only where it lands on an
    f32 midpoint, which the test counts."""
    d = np.float32(std)
    y = np.float32(1) / d
    midpoints = 0
    for start in range(0, 2 ** 23, 2 ** 21):
        m = np.arange(start, start + 2 ** 21, dtype=np.uint32) | np.uint32(0x3F800000)
        x = m.view(np.float32)
        q = (x.astype(np.float64) * float(y)).astype(np.float32)
        r = (x.astype(np.float64) - q.astype(np.float64) * float(d)).astype(np.float32)
        s = q.astype(np.float64) + r.astype(np.float64) * float(y)
        q2 = s.astype(np.float32)
        up = np.nextafter(q2, np.float32(np.inf)).astype(np.float64)
        down = np.nextafter(q2, np.float32(-np.inf)).astype(np.float64)
        q64 = q2.astype(np.float64)
        midpoints += int(((s == (q64 + up) / 2) | (s == (q64 + down) / 2)).sum())
        np.testing.assert_array_equal(q2, x / d)
    assert midpoints == 0


def test_k1_border_rows_are_renormalised_not_clamped():
    """At the corner window the first output row reads src row -0.40: the
    hat row keeps only row 0 and renormalises it to weight 1."""
    rgb = frames(1, seed=3)
    out = port_k1.crop_resize_normalize_plain(
        torch.from_numpy(rgb), *port_window([(0, 0, 40)]), out_size=S).numpy()
    mean = np.asarray(port_k1.IMAGENET_MEAN, np.float32)
    std = np.asarray(port_k1.IMAGENET_STD, np.float32)
    np.testing.assert_allclose(out[0, 0, 0], (rgb[0, 0, 0] - mean) / std,
                               rtol=0, atol=1e-6)


def test_k1_plain_bf16_is_rounded_f32():
    rgb = torch.from_numpy(frames(2, seed=1))
    win = port_window(WINDOWS[:2])
    f32 = port_k1.crop_resize_normalize(rgb, *win, S)
    bf16 = port_k1.crop_resize_normalize(rgb, *win, S, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "window",
                                 "out_dtype"])
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rgb = torch.zeros(2, 48, 64, 3)
    rmin = cmin = torch.zeros(2)
    inv_ratio = torch.ones(2)
    kw = {}
    if bad == "dtype":
        rgb = rgb.double()
    elif bad == "shape":
        rgb = rgb[..., :2]
    elif bad == "contiguous":
        rgb = rgb.transpose(1, 2)
    elif bad == "window":
        inv_ratio = torch.ones(3)
    else:
        kw["out_dtype"] = torch.float16
    with pytest.raises(ValueError):
        port_k1.crop_resize_normalize(rgb, rmin, cmin, inv_ratio, 16, **kw)


def test_k1_cpu_tensor_takes_plain_version_without_counting():
    before = port_k1.crop_resize_normalize.launches
    port_k1.crop_resize_normalize(torch.zeros(1, 48, 64, 3), torch.zeros(1),
                                  torch.zeros(1), torch.ones(1), 16)
    assert port_k1.crop_resize_normalize.launches == before


def masks(B):
    m = np.zeros((B, H, W), bool)
    m[0, 180:300, 260:380] = True           # centred 120 px object
    m[1, 0:30, 0:28] = True                 # small object in the corner
    if B > 2:
        m[2, 30:450, 110:520] = True        # large object: 440 px window
    if B > 3:
        m[3, 455:480, 610:640] = True       # bottom-right corner
    return m


def test_prepare_model_input_matches_jax(jax_pallas_crop):
    from rgbmanip_tpu.ops.preprocess import prepare_model_input as jax_prepare

    B, n_pts = 4, 1024
    rgb = frames(B, seed=2)
    mask = masks(B)
    K = np.tile(np.array([[439.3, 0, 320], [0, 439.3, 240], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    key = jax.random.PRNGKey(5)
    ref = jax_prepare(jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(K), key,
                      out_size=S, n_pts=n_pts)
    ref = [np.asarray(r) for r in ref]
    draws = np.asarray(jax.random.uniform(key, (B, S * S)))
    out = port_pre.prepare_model_input(torch.from_numpy(rgb), torch.from_numpy(mask),
                                       torch.from_numpy(K), torch.from_numpy(draws.copy()),
                                       out_size=S, n_pts=n_pts)
    crop, choose, pts2d, newK, valid = (o.numpy() for o in out)
    # integer and window arithmetic is the same f32 op by op: exact
    np.testing.assert_array_equal(choose, ref[1])
    np.testing.assert_array_equal(pts2d, ref[2])
    np.testing.assert_array_equal(newK, ref[3])
    np.testing.assert_array_equal(valid, ref[4])
    # the crop differs only by the order of the TPU kernel's dense sums
    np.testing.assert_allclose(crop, ref[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [64, S, 224])
def test_k1_clamp_mode_equals_the_jax_cpu_fallback(size):
    """K1's clamping mode (plain) against the JAX package's own
    ``prepare_model_input`` on its CPU backend, unpatched: the crop its
    estimator trainer's sampler makes. Centred, large, corner and
    bottom-right windows and an empty mask (a reversed window), f16-valued
    frames as the sampler's buffer holds them: bit for bit (the plain
    version rounds each step as XLA's compiled fallback does; the bound the
    trainer's parity needs is 1e-5)."""
    from rgbmanip_tpu.ops.preprocess import prepare_model_input as jax_prepare

    B = 5
    rgb = frames(B, seed=6).astype(np.float16).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    mask[:4] = masks(4)
    K = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax_prepare(jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(K),
                                     jax.random.PRNGKey(0), out_size=size, n_pts=128)[0])
    out = port_pre.prepare_model_input(torch.from_numpy(rgb), torch.from_numpy(mask),
                                       torch.from_numpy(K), torch.Generator().manual_seed(0),
                                       out_size=size, n_pts=128, border="clamp")[0]
    np.testing.assert_array_equal(out.numpy(), ref)
    bf16 = port_k1.crop_resize_normalize_clamp_plain(
        torch.from_numpy(rgb), *port_window([(180, 260, 120)] * B)[:2],
        torch.full((B,), size / 120.0), size, out_dtype=torch.bfloat16)
    f32 = port_k1.crop_resize_normalize_clamp_plain(
        torch.from_numpy(rgb), *port_window([(180, 260, 120)] * B)[:2],
        torch.full((B,), size / 120.0), size)
    assert torch.equal(bf16, f32.to(torch.bfloat16))


def test_k1_clamp_mode_mixes_rows_0_and_1_above_the_frame():
    """At the corner window the first output row reads src row -0.396
    (floor -1): the clamping rule takes rows 0 and 1 with weights 0.396 and
    0.604 (from the unclamped floor), not row 0 alone."""
    rgb = frames(1, seed=3)
    ratio = torch.tensor([S / 40.0])
    out = port_k1.crop_resize_normalize_clamp_plain(
        torch.from_numpy(rgb), torch.zeros(1), torch.tensor([100.0]), ratio, S).numpy()
    src = (0 + 0.5 / np.float32(S / 40.0)) - 0.5
    wy = np.float32(src - np.floor(src))
    mean = np.asarray(port_k1.IMAGENET_MEAN, np.float32)
    std = np.asarray(port_k1.IMAGENET_STD, np.float32)
    xsrc = (100 + 0.5 / np.float32(S / 40.0)) - 0.5
    x0, wx = int(np.floor(xsrc)), np.float32(xsrc - np.floor(xsrc))
    col = lambda x: (1 - wy) * rgb[0, 0, x] + wy * rgb[0, 1, x]
    want = ((1 - wx) * col(x0) + wx * col(x0 + 1) - mean) / std
    np.testing.assert_allclose(out[0, 0, 0], want, rtol=0, atol=1e-5)
    assert abs(wy - 0.604) < 1e-3


def test_k1_clamp_fma_is_rounded_once():
    """The plain clamping mode's fused multiply-add (round to odd in f64)
    against exact rational arithmetic on values whose f64 sum would round
    twice."""
    from fractions import Fraction

    from rgbmanip_tpu_torch.ops.crop_resize import _fma

    rng = np.random.default_rng(0)
    a = rng.uniform(-2, 2, 2000).astype(np.float32)
    b = rng.uniform(-2, 2, 2000).astype(np.float32)
    c = rng.uniform(-2, 2, 2000).astype(np.float32) * np.float32(2.0 ** -30)
    got = _fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32)) & 1))
        assert got[i] == best, i


def test_prepare_model_input_rejects_an_unknown_border():
    with pytest.raises(ValueError, match="border"):
        port_pre.prepare_model_input(torch.zeros(1, H, W, 3), torch.zeros(1, H, W, dtype=torch.bool),
                                     torch.eye(3)[None], torch.Generator(), 64, 128,
                                     border="wrap")


def test_prepare_model_input_sampling_invariants():
    """With a generator: every chosen pixel lies in the mask, and a mask with
    fewer resized pixels than n_pts is wrap-padded."""
    B, n_pts = 2, 1024
    mask = masks(B)
    mask[1] = False
    mask[1, 100:104, 200:204] = True        # 4x4 px -> ~19x19 of the crop
    K = torch.eye(3).repeat(B, 1, 1)
    g = torch.Generator().manual_seed(0)
    crop, choose, pts2d, newK, valid = port_pre.prepare_model_input(
        torch.from_numpy(frames(B)), torch.from_numpy(mask), K, g, S, n_pts)
    assert valid.all()
    px, py = pts2d[..., 0].numpy(), pts2d[..., 1].numpy()
    for b in range(B):
        ys, xs = np.nonzero(mask[b])
        # a chosen crop pixel maps back to its cell's corner: within 1 px
        assert (py[b] >= ys.min() - 1).all() and (py[b] <= ys.max() + 1).all()
        assert (px[b] >= xs.min() - 1).all() and (px[b] <= xs.max() + 1).all()
    count = len(np.unique(choose[1].numpy()))
    assert count < n_pts
    np.testing.assert_array_equal(choose[1, count:].numpy(),
                                  choose[1, :n_pts - count].numpy())


def test_empty_mask_is_invalid():
    B = 1
    out = port_pre.prepare_model_input(
        torch.zeros(B, H, W, 3), torch.zeros(B, H, W, dtype=torch.bool),
        torch.eye(3)[None], torch.Generator().manual_seed(0), 64, 128)
    assert not out[4].any()


def test_depth_hypotheses_match_jax():
    from rgbmanip_tpu.ops.preprocess import depth_hypotheses

    ref = np.asarray(depth_hypotheses(3, 0.1, 0.15, 16))
    np.testing.assert_array_equal(port_pre.depth_hypotheses(3, 0.1, 0.15, 16).numpy(), ref)


def test_jax_crop_paths_disagree_at_the_border():
    """A property of the reference, not of the port: the JAX package's CPU
    fallback clamps taps at the frame border, its Pallas kernel renormalises
    the hat rows. Centred windows agree; a corner window does not. The port
    follows the Pallas kernel."""
    from rgbmanip_tpu.ops.pallas_preprocess import crop_resize_normalize
    from rgbmanip_tpu.ops.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                             bilinear_sample_batched)

    rgb = jnp.asarray(frames(2, seed=4))
    rmin, cmin, ratio = (jnp.asarray(a) for a in window_arrays([(180, 260, 120),
                                                                 (0, 0, 40)]))
    ii = jnp.arange(S, dtype=jnp.float32)[None]
    src_y = rmin[:, None] + (ii + 0.5) / ratio[:, None] - 0.5
    src_x = cmin[:, None] + (ii + 0.5) / ratio[:, None] - 0.5
    gy = jnp.broadcast_to(src_y[:, :, None], (2, S, S))
    gx = jnp.broadcast_to(src_x[:, None, :], (2, S, S))
    fallback = (bilinear_sample_batched(rgb, gy, gx) - IMAGENET_MEAN) / IMAGENET_STD
    pallas = crop_resize_normalize(rgb, rmin, cmin, ratio, out_size=S,
                                   out_dtype=jnp.float32, interpret=True)
    diff = np.abs(np.asarray(fallback) - np.asarray(pallas)).max(axis=(1, 2, 3))
    print(f"JAX fallback vs Pallas crop, max |diff|: centred {diff[0]:.3g}, "
          f"corner {diff[1]:.3g}")
    assert diff[0] < 1e-5
    assert diff[1] > 1.0
