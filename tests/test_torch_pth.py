"""Reference ``.pth`` state dicts and a missing checkpoint in the port's
``AdaPoseEstimator.load``, held against the JAX package's.

The released ``.pth`` weights are not in the repo, so the test writes one:
seeded numpy values for every key of the JAX package's reference key map
(``converter.torch_key_map``, resnet34), in the torch layouts (the MLPs as
Conv1d weights (O, I, 1)), with the ``module.`` prefix that
``nn.DataParallel`` gives, one ``num_batches_tracked`` and one key that no
network has. Both estimators load it with ``load: true``: the JAX one
through ``convert_torch_checkpoint``, the port through
``load_torch_state_dict``. The paper configuration runs at 64 px, as in
``test_torch_paper_estimator.py``, whose tolerance holds here too: the world
bbox within 1e-3 m (expected ~1e-6 m; both sides compute in f32, and the
convolutions sum in another order), equal valid flags.

The JAX estimator's flax init is replaced by seeded numpy values of the
init's shapes (the init itself costs half a minute at resnet34, stride 8);
its ``load`` runs as it is.
"""

import functools
import logging

import jax
import numpy as np
import pytest
import torch

from rgbmanip_tpu_torch.config.loader import load_group
from rgbmanip_tpu_torch.models.pose_estimator import adapose as port_adapose

from test_torch_estimator import scene
from test_torch_paper_estimator import S, init_shapes_only, jax_cfg, seeded_tree

torch.set_num_threads(2)

UNKNOWN = "some.unknown.weight"
# flax leaf -> torch layout, the inverse of the reference converter's _TRANSFORMS
TO_TORCH = {"conv2d": lambda a: np.transpose(a, (3, 2, 0, 1)),
            "conv3d": lambda a: np.transpose(a, (4, 3, 0, 1, 2)),
            "deconv3d": lambda a: np.transpose(a, (3, 4, 0, 1, 2)),
            "dense": lambda a: np.transpose(a)[..., None],       # Conv1d (O, I, 1)
            "copy": np.asarray, "stats": np.asarray}


def recording_logger(name):
    """A logger that keeps its messages, by level."""
    log = logging.getLogger(f"test_torch_pth.{name}")
    log.propagate = False
    log.setLevel(logging.INFO)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.levelname, record.getMessage()))

    log.handlers = [Keep()]
    return log, records


def leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def torch_state(params, batch_stats):
    """The reference state dict of a flax tree, every leaf used once."""
    from rgbmanip_tpu.models.pose_estimator.converter import torch_key_map

    kmap = torch_key_map()
    used = {(kind == "stats", path) for path, kind in kmap.values()}
    every = {(False, p) for p in flat_paths(params)} | {(True, p) for p in flat_paths(batch_stats)}
    assert used == every, "the reference key map does not cover the paper network"
    return {tk: torch.from_numpy(np.ascontiguousarray(
        TO_TORCH[kind](leaf(batch_stats if kind == "stats" else params, path))))
        for tk, (path, kind) in kmap.items()}


def flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def save_pth(path, state, prefix="module."):
    full = {prefix + k: v for k, v in state.items()}
    full[prefix + "cost_regularization.conv0.bn.num_batches_tracked"] = torch.tensor(7)
    full[prefix + UNKNOWN] = torch.zeros(3)
    torch.save(full, path)
    return str(path)


def port_cfg(**over):
    return load_group("pose_estimator", "adapose_cabinet", {"img_size": S, **over})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages: an estimator whose checkpoint is missing (load: true),
    its estimate on its initial weights, then the ``.pth`` loaded and the
    estimate on it; the JAX crop through its Pallas kernel in interpret
    mode, the crop its main path ran on the chip."""
    import rgbmanip_tpu.ops.pallas_preprocess as jpal
    import rgbmanip_tpu.ops.preprocess as jpre
    from rgbmanip_tpu.models.pose_estimator.adapose import AdaPoseEstimator
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import StereoPoseNetWithDepth

    tmp = tmp_path_factory.mktemp("pth")
    absent = str(tmp / "absent.pth")
    # the file's weights: the seeded tree of test_torch_paper_estimator.py
    shapes = None

    def init_seeded(module, key, *args, **kwargs):
        nonlocal shapes
        shapes = init_shapes_only(module, key, *args, **kwargs)
        rng = np.random.default_rng(1)
        return {"params": seeded_tree(shapes["params"], rng),
                "batch_stats": seeded_tree(shapes["batch_stats"], rng)}

    jlog, jrec = recording_logger("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StereoPoseNetWithDepth, "init", init_seeded)
        jest = AdaPoseEstimator(jax_cfg(img_size=S, load=True, checkpoint_path=absent), jlog)
    rng = np.random.default_rng(0)
    file_params = seeded_tree(shapes["params"], rng)
    file_stats = seeded_tree(shapes["batch_stats"], rng)
    state = torch_state(file_params, file_stats)
    pth = save_pth(tmp / "weights.pth", state)

    K, rgb, mask, ext = scene()
    n = K.shape[0]
    key = jax.random.PRNGKey(7)
    k1, k2, _ = jax.random.split(key, 3)
    u1 = np.array(jax.random.uniform(k1, (n, S * S)))
    u2 = np.array(jax.random.uniform(k2, (n, S * S)))
    views = (K, rgb[0], mask[0], ext[0], rgb[1], mask[1], ext[1])

    def jax_estimate():
        bbox, valid, _ = jest._estimate_fn(jest.params, jest.batch_stats, *views, key)
        return np.asarray(bbox), np.asarray(valid)

    orig_use, orig_crop = jpre._use_pallas, jpal.crop_resize_normalize
    jax.clear_caches()
    jpre._use_pallas = lambda: True
    jpal.crop_resize_normalize = functools.partial(orig_crop, interpret=True)
    try:
        jax_init = jax_estimate()
        with pytest.warns(UserWarning, match="unmapped torch keys") as jwarn:
            jest.load(pth)
        jax_pth = jax_estimate()
    finally:
        jpre._use_pallas, jpal.crop_resize_normalize = orig_use, orig_crop
        jax.clear_caches()

    t = torch.from_numpy
    tviews = [t(a) for a in views]

    def port_estimate(est):
        bbox, valid, _ = est._estimate(*tviews, t(u1), t(u2))
        return bbox.numpy(), valid.numpy()

    plog, prec = recording_logger("port")
    pest_absent = port_adapose.AdaPoseEstimator(
        port_cfg(load=True, checkpoint_path=absent), plog, device="cpu")
    absent_rec = list(prec)
    port_init = port_estimate(pest_absent)
    prec.clear()
    pest = port_adapose.AdaPoseEstimator(port_cfg(load=True, checkpoint_path=pth), plog,
                                         device="cpu")
    return dict(absent=absent, pth=pth, state=state, jrec=jrec, jwarn=[str(w.message) for w in jwarn],
                jax_init=jax_init, jax_pth=jax_pth, jest=jest, file_params=file_params,
                file_stats=file_stats, port_absent_rec=absent_rec, port_init=port_init,
                port_pth_rec=list(prec), pest=pest, port_pth=port_estimate(pest))


def test_pth_estimate_valid_flags_equal_jax(runs):
    ref, out = runs["jax_pth"], runs["port_pth"]
    np.testing.assert_array_equal(out[1], ref[1])
    assert ref[1].any(), "no valid estimate: the comparison would be of sentinel boxes"


def test_pth_estimate_world_bbox_within_a_millimetre_of_jax(runs):
    ref, out = runs["jax_pth"], runs["port_pth"]
    print("max |bbox diff| (m):", np.abs(out[0] - ref[0]).max())
    assert np.isfinite(out[0]).all()
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-3)


def test_pth_loads_every_key_into_both_packages(runs):
    """Each tensor of the file lands in the port unchanged (up to the Conv1d
    squeeze), and the JAX package converts it back to the seeded tree."""
    sd = runs["pest"].model.state_dict()
    for k, w in runs["state"].items():
        np.testing.assert_array_equal(sd[k].numpy(), w.numpy().reshape(sd[k].shape), err_msg=k)
    for path in flat_paths(runs["file_params"]):
        np.testing.assert_array_equal(np.asarray(leaf(runs["jest"].params, path)),
                                      leaf(runs["file_params"], path))
    assert not any("holds no value" in m for _, m in runs["port_pth_rec"])


def test_pth_unknown_key_and_missing_metadata_are_logged(runs):
    warnings_ = [m for lvl, m in runs["port_pth_rec"] if lvl == "WARNING"]
    assert any("unmapped torch keys" in m and UNKNOWN in m for m in warnings_)
    assert any("restoring unvalidated" in m for m in warnings_)
    assert any(UNKNOWN in m for m in runs["jwarn"])


def test_missing_checkpoint_warns_and_still_estimates_in_both_packages(runs):
    """The reference logs that the checkpoint was not found and runs on its
    initial weights; the port does the same on its seeded weights."""
    want = f"checkpoint {runs['absent']} not found; using random init"
    assert ("WARNING", want) in runs["jrec"]
    assert ("WARNING", want) in runs["port_absent_rec"]
    for bbox, valid in (runs["jax_init"], runs["port_init"]):
        assert bbox.shape == (3, 8, 3) and valid.shape == (3,)
        assert np.isfinite(bbox).all()


def test_pth_tensor_of_the_wrong_shape_raises(runs, tmp_path):
    state = dict(runs["state"])
    state["nocs_head.0.weight"] = torch.zeros(5, 7, 1)
    path = save_pth(tmp_path / "bad.pth", state)
    with pytest.raises(ValueError, match="shape"):
        port_adapose.AdaPoseEstimator(port_cfg(load=True, checkpoint_path=path), device="cpu")


def test_pth_without_a_parameter_keeps_its_initial_value(runs, tmp_path):
    """The file's keys without the prefix, the MLPs in Linear layout (O, I),
    one parameter left out: it keeps the seeded value, and a warning names
    it."""
    dropped = "size_estimator.4.bias"
    state = {k: (w[..., 0] if k.endswith(".weight") and w.dim() == 3 else w)
             for k, w in runs["state"].items() if k != dropped}
    path = save_pth(tmp_path / "partial.pth", state, prefix="")
    log, rec = recording_logger("partial")
    est = port_adapose.AdaPoseEstimator(port_cfg(load=True, checkpoint_path=path), log,
                                        device="cpu")
    init = port_adapose.AdaPoseEstimator(port_cfg(), device="cpu")
    sd, sd0 = est.model.state_dict(), init.model.state_dict()
    assert torch.equal(sd[dropped], sd0[dropped])
    assert torch.equal(sd["size_estimator.4.weight"], runs["pest"].model.state_dict()[
        "size_estimator.4.weight"])
    assert any("holds no value" in m and dropped in m for _, m in rec)
