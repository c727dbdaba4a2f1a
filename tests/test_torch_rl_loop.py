"""The flagship evaluation loop (``controller=rl``,
``pose_estimator=adapose_cabinet_fast``, consensus fusion, k=4; the protocol
of ``scripts/r5_cabinet_evals.sh``) through the port's ``train`` functions
against the JAX package's, both on the CPU: one round at ``num_envs=2``,
seed 11, ``cabinet_test``, with the committed estimator and policy
checkpoints.

The camera's path does not depend on the estimates (the policy sees the pose
and mask-bbox queues, both from the simulator), so the actions must agree to
f32 rounding and the frames and masks bit for bit at every step. The
estimates enter through ``pred_bbox``, the rewards, the fusion and the
skill. Four things are made equal on purpose:
- the camera moves: the two actors' f32 actions differ in the last bits
  (4e-7 seen: XLA's and PyTorch's CPU matmuls sum in other orders), and a
  camera target that moves by that much changes pixels at the edges of the
  rendered parts, after which the two loops see other views. Each port step
  therefore records its own policy's action, checked within 1e-5 of the JAX
  action on the same observation, and moves the camera by the JAX action;
- the skill's input: the closed-loop skill turns a 1.3e-6 m difference in
  the fused bbox into centimetres of arm motion (contacts, 1 cm proceed
  tests), so the port's fused bbox is checked within 1e-3 m of the JAX one
  and the port's skill then acts on the JAX one;
- the point-sampling draws: the port is fed, on each estimate, the uniforms
  the JAX estimator drew from its key on that call (a test-side wrapper; the
  port's main path draws from its own ``torch.Generator``);
- the JAX crop runs through its Pallas kernel in interpret mode, the crop
  the main path runs on its chip (the CPU fallback clamps at the frame
  border where the kernel renormalises, tests/test_torch_preprocess.py).

One case is not held to 1e-3 m: an estimate made while an env has only one
valid view, which ``get_estimation`` duplicates into both stereo slots (the
reference's quasi-monocular step; ``stereo_ok`` keeps it out of the fusion).
With two identical cameras the plane-sweep warp's ``src_proj @
inv(ref_proj)`` is the identity up to rounding, which the two frameworks
round differently, so the warp's in-frame test flips at the cost volume's
border pixels and the two estimates part by centimetres. The tests below
hold every other estimate to 1e-3 m, show that the duplicated pairs' warps
differ only on that border, and hold every reward term that does not read
the estimate to 1e-4.

Run as a module, the file compares the two loops episode by episode over
several rounds, with the port's skill acting on the port's own fused bbox
(a few minutes; 13 rounds are the protocol's 104 episodes):

    JAX_PLATFORMS=cpu python -m tests.test_torch_rl_loop [ROUNDS] [SPLIT] [K]
"""

import contextlib
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from rgbmanip_tpu import train as jax_train
from rgbmanip_tpu.config import load_config as jax_load_config
from rgbmanip_tpu.utils.logger import get_logger as jax_get_logger
from rgbmanip_tpu_torch import train as port_train
from rgbmanip_tpu_torch.config.loader import load_config
from rgbmanip_tpu_torch.models.pose_estimator.nets import stereo as port_stereo
from rgbmanip_tpu_torch.utils.logger import get_logger

torch.set_num_threads(2)

N_ENVS = 2


def flagship(rounds=1, n_envs=N_ENVS, split="test", k=4):
    return [f"dataset=cabinet_{split}", "task=open_cabinet", "manipulation=open_cabinet",
            "controller=rl", "controller.load=checkpoints/ppo_rl_coadapt_model_165.ckpt",
            "pose_estimator=adapose_cabinet_fast",
            "pose_estimator.checkpoint_path=checkpoints/estimator_fast_cabinet_aug_r5.ckpt",
            "controller.estimate_fusion=consensus", f"controller.early_stop={k}",
            "train=test", f"train.total_round={rounds * n_envs}", f"task.num_envs={n_envs}",
            "seed=11"]


@contextlib.contextmanager
def jax_pallas_crop():
    """Route the JAX estimator's crop through its Pallas kernel in
    interpret mode."""
    import rgbmanip_tpu.ops.pallas_preprocess as jpal
    import rgbmanip_tpu.ops.preprocess as jpre

    orig_use, orig_crop = jpre._use_pallas, jpal.crop_resize_normalize
    jax.clear_caches()
    jpre._use_pallas = lambda: True
    jpal.crop_resize_normalize = functools.partial(orig_crop, interpret=True)
    try:
        yield
    finally:
        jpre._use_pallas, jpal.crop_resize_normalize = orig_use, orig_crop
        jax.clear_caches()


def uniforms_of(key, B, S):
    """The draws the JAX estimator makes from one call's key
    (``adapose.py::_estimate``: k1, k2 for the two views' point sampling)."""
    k1, k2, _ = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k1, (B, S * S))),
            np.array(jax.random.uniform(k2, (B, S * S))))


def keep_keys(est, keys):
    """Record the JAX estimator's key before each of its calls."""
    call = est._call_estimate

    def keyed(*args):
        keys.append(est.key)
        return call(*args)
    est._call_estimate = keyed


def replay_draws(est, keys):
    """Feed the port's estimator, call by call, the draws the JAX estimator
    made from ``keys`` (its key before each call)."""
    calls = []

    def replayed(K, rgb1, mask1, ext1, rgb2, mask2, ext2):
        _, k = jax.random.split(keys[len(calls)])
        calls.append(k)
        u1, u2 = uniforms_of(k, rgb1.shape[0], est.img_size)
        t = functools.partial(torch.as_tensor, dtype=torch.float32)
        return est._estimate(t(K), t(rgb1), torch.as_tensor(mask1), t(ext1),
                             t(rgb2), torch.as_tensor(mask2), t(ext2),
                             torch.from_numpy(u1), torch.from_numpy(u2))
    est._call_estimate = replayed


def run(pkg, cfg, log, drive=None, own_fused=False, **kw):
    """One evaluation (``train.test``) recorded step by step and round by
    round. With ``drive`` (the JAX run's record) the port moves the camera
    by the JAX actions, takes the JAX draws and, unless ``own_fused``, acts
    on the JAX fused bbox of each round; the record keeps the port's own
    actions and fused bboxes."""
    rec = {"actions": [], "rewards": [], "terms": [], "frames": [], "masks": [],
           "pred_bbox": [], "fused": [], "stereo_ok": [], "views_so_far": [],
           "success": [], "move": [], "keys": []}
    env = pkg.prepare_env(cfg["task"], cfg["dataset"], log=log, seed=cfg["seed"])
    try:
        manip = pkg.prepare_manipulation(env, cfg["manipulation"], log)
        est = pkg.prepare_pose_estimator(env, cfg["pose_estimator"], log, **kw)
        ctrl = pkg.prepare_controller(env, est, manip, cfg["controller"], cfg, log, **kw)
        rec["estimator"], rec["privileged_ok"] = est, manip.privileged_ok
        if drive is None:
            keep_keys(est, rec["keys"])
        else:
            replay_draws(est, drive["keys"])
        iface = ctrl.control_interface
        step, act, run_round = iface.step, iface.call_manipulation, ctrl.run

        def rec_step(action, eval=False):
            rec["actions"].append(np.array(action, np.float64))
            if drive is not None:
                action = drive["actions"][len(rec["actions"]) - 1]
            out = step(action, eval=eval)
            t = (iface.accumulate_steps - 1) % iface.max_steps
            rec["rewards"].append(np.array(out[1]))
            rec["terms"].append({k: np.array(v) for k, v in out[3].items()})
            rec["frames"].append(iface.image_queue[t].copy())
            rec["masks"].append(iface.mask_queue[t].copy())
            rec["pred_bbox"].append(iface.pred_bbox[t].copy())
            return out

        def rec_act(estimation, eval=False):
            rec["fused"].append(np.array(estimation))
            rec["stereo_ok"].append(iface.stereo_ok().copy())
            rec["views_so_far"].append(np.cumsum(iface.available, axis=0))
            rec["first_view"] = (iface.image_queue[0].copy(), iface.mask_queue[0].copy())
            rec["cams"] = (iface.intrinsic_queue.copy(), iface.extrinsic_queue.copy())
            if drive is not None and not own_fused:
                estimation = drive["fused"][len(rec["fused"]) - 1]
            return act(estimation, eval)

        def rec_round(eval=False):
            run_round(eval=eval)
            obs = env.get_observation()
            rec["success"].append(np.array(obs["success"]))
            rec["move"].append(np.array(obs["total_move_distance"]))

        iface.step, iface.call_manipulation, ctrl.run = rec_step, rec_act, rec_round
        rec["result"] = pkg.test(env, ctrl, cfg, log)
    finally:
        env.close()
    return rec


def run_jax(over, save_dir):
    with jax_pallas_crop():
        return run(jax_train, jax_load_config(over + [f"controller.learn.save_dir={save_dir}"]),
                   jax_get_logger())


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    ref = run_jax(flagship(), tmp_path_factory.mktemp("ppo"))
    warps = []
    orig_warp = port_stereo.homo_warp_batched

    def warp(src_feat, src_proj, ref_proj, depth_values, mode="bilinear"):
        warps.append((tuple(src_feat.shape), src_proj.clone(), ref_proj.clone(),
                      depth_values.clone(), mode))
        return orig_warp(src_feat, src_proj, ref_proj, depth_values, mode)

    port_stereo.homo_warp_batched = warp
    try:
        out = run(port_train, load_config(flagship() + ["device=cpu"]), get_logger(),
                  drive=ref, device="cpu")
    finally:
        port_stereo.homo_warp_batched = orig_warp
    out["warps"] = warps
    assert len(ref["keys"]) == len(ref["actions"]) == 4
    return ref, out


def test_the_loop_runs_four_steps_on_the_port_classes(loops):
    ref, out = loops
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import AdaPoseEstimator
    assert type(out["estimator"]) is AdaPoseEstimator
    assert out["privileged_ok"] is False and ref["privileged_ok"] is False
    assert len(out["actions"]) == len(ref["actions"]) == 4
    assert out["result"]["rounds"] == N_ENVS


def test_frames_and_masks_equal_bit_for_bit_at_every_step(loops):
    ref, out = loops
    for i in range(2):
        assert np.array_equal(out["first_view"][i], ref["first_view"][i])
    for t, (fp, fj, mp, mj) in enumerate(zip(out["frames"], ref["frames"],
                                             out["masks"], ref["masks"])):
        assert np.array_equal(fp, fj), f"step {t + 1}: frames differ"
        assert np.array_equal(mp, mj), f"step {t + 1}: masks differ"
    assert any(m.any() for m in out["masks"]), "no step saw the handle"


def test_actions_within_1e5(loops):
    ref, out = loops
    diff = max(np.abs(a - b).max() for a, b in zip(out["actions"], ref["actions"]))
    print("max |action diff|:", diff)
    assert diff <= 1e-5


def duplicated(rec, r=0):
    """(steps, N) bool: round ``r``'s per-step estimates made from one valid
    view duplicated into both stereo slots."""
    steps = len(rec["pred_bbox"]) // len(rec["fused"])
    return rec["views_so_far"][r][1:steps + 1] == 1


def test_per_step_bboxes_from_two_views_and_the_fused_bbox_within_a_millimetre(loops):
    ref, out = loops
    dup = duplicated(ref)
    np.testing.assert_array_equal(duplicated(out), dup)
    diff = np.stack([np.abs(a - b).reshape(a.shape[0], -1).max(-1)
                     for a, b in zip(out["pred_bbox"], ref["pred_bbox"])])   # (steps, N)
    fused = np.abs(out["fused"][0] - ref["fused"][0]).max()
    print("max |pred_bbox diff| (m), two views:", diff[~dup].max(initial=0.0),
          " one view duplicated:", diff[dup].max(initial=0.0), f"({int(dup.sum())} estimates)",
          " fused:", fused)
    assert (~dup).sum() >= 4, "too few two-view estimates to compare"
    assert diff[~dup].max() <= 1e-3
    assert fused <= 1e-3
    assert np.isfinite(out["fused"][0]).all() and (np.abs(out["fused"][0]) < 5).any()


def test_duplicated_pairs_differ_only_through_the_warps_border_test(loops):
    """On a pair of identical cameras the two packages' warps of the same
    features agree everywhere but on the volume's outer ring of pixels."""
    import jax.numpy as jnp
    from rgbmanip_tpu.models.pose_estimator.nets.stereo import homo_warp_batched

    _, out = loops
    n_same = n_flips = 0
    for (B, H, W, _), sp, rp, dv, mode in out["warps"]:
        same = [b for b in range(B) if torch.equal(sp[b], rp[b])]
        if not same:
            continue
        ones = torch.ones(len(same), H, W, 1)
        port = port_stereo.homo_warp_batched(ones, sp[same], rp[same], dv[same], mode).numpy()
        ref = np.asarray(homo_warp_batched(jnp.asarray(ones.numpy()), jnp.asarray(sp[same].numpy()),
                                           jnp.asarray(rp[same].numpy()),
                                           jnp.asarray(dv[same].numpy()), mode=mode))
        ring = np.ones((H, W), bool)
        ring[1:-1, 1:-1] = False
        flips = port != ref
        assert not flips[:, :, ~ring].any()
        n_same += len(same)
        n_flips += int(flips.sum())
    print(f"{n_same} warps of identical cameras, {n_flips} in-frame flags flipped "
          f"on the border ring")
    assert n_same >= 1


def test_rewards_within_1e4(loops):
    """The total where every env's estimate came from two views; each term
    that does not read the estimate at every step."""
    ref, out = loops
    dup = duplicated(ref)
    for t, (tp, tj) in enumerate(zip(out["terms"], ref["terms"])):
        for k in tj:
            if k.startswith("REW:") and k not in ("REW:center_rew", "REW:open_rew"):
                assert np.abs(tp[k] - tj[k]).max() <= 1e-4, (t + 1, k)
        ok = ~dup[t]
        assert np.abs(out["rewards"][t][ok] - ref["rewards"][t][ok]).max(initial=0.0) <= 1e-4
    diff = max(np.abs(a - b)[~d].max(initial=0.0)
               for a, b, d in zip(out["rewards"], ref["rewards"], dup))
    print("max |reward diff| on two-view estimates:", diff)


def test_an_env_without_a_valid_view_gets_the_sentinel_as_in_jax(loops):
    """``get_estimation`` leaves an env with no valid view yet at zero
    views, zero masks and zero extrinsics: its projections are singular.
    The JAX package's inverses give NaN there and the env gets the sentinel
    bbox; the port must do the same, and not raise for the whole batch, while
    the other env's estimate stays within 1e-3 m of the JAX one."""
    from rgbmanip_tpu_torch.models.pose_estimator.adapose import DEFAULT_BBOX

    ref, out = loops
    K, E = out["cams"]
    assert np.array_equal(E, ref["cams"][1])
    views = [np.array(out["frames"][2]), np.array(out["masks"][2]), E[3].copy(),
             np.array(out["frames"][3]), np.array(out["masks"][3]), E[4].copy()]
    for v in views:
        v[1] = 0                                   # env 1: no valid view yet
    assert views[1][0].any() and views[4][0].any()
    _, k = jax.random.split(jax.random.PRNGKey(5))
    u1, u2 = uniforms_of(k, N_ENVS, out["estimator"].img_size)

    jest = ref["estimator"]
    with jax_pallas_crop():
        jb, jv, _ = jest._estimate_fn(jest.params, jest.batch_stats, K[3], *views, k)
        jb, jv = np.asarray(jb), np.asarray(jv)
    t = torch.from_numpy
    pb, pv, _ = out["estimator"]._estimate(t(K[3]), *map(t, views), t(u1), t(u2))
    pb, pv = pb.numpy(), pv.numpy()
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pv, [True, False])
    np.testing.assert_array_equal(pb[1], DEFAULT_BBOX)
    np.testing.assert_array_equal(jb[1], DEFAULT_BBOX)
    np.testing.assert_allclose(pb[0], jb[0], rtol=0, atol=1e-3)


def test_stereo_gate_success_and_move_distance_equal(loops):
    ref, out = loops
    np.testing.assert_array_equal(out["stereo_ok"][0], ref["stereo_ok"][0])
    np.testing.assert_array_equal(out["success"][0], ref["success"][0])
    np.testing.assert_array_equal(out["move"][0], ref["move"][0])
    assert out["result"] == ref["result"]


def main(argv):
    """Compare the loops episode by episode: ``ROUNDS`` rounds of 8 envs
    (default 13) of ``cabinet_<SPLIT>`` (default train) at k=``K`` (default
    4), the port's skill on its own fused bbox. Prints, per round, each
    episode's |fused bbox difference|, its number of stereo votes, the
    largest difference among its stereo estimates and the two successes."""
    rounds = int(argv[0]) if argv else 13
    split = argv[1] if len(argv) > 1 else "train"
    k = int(argv[2]) if len(argv) > 2 else 4
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    over = flagship(rounds, 8, split, k)
    ref = run_jax(over, "saves/ppo_parity")
    out = run(port_train, load_config(over + ["device=cpu"]), get_logger(), drive=ref,
              own_fused=True, device="cpu")
    adiff = max(float(np.abs(a - b).max()) for a, b in zip(out["actions"], ref["actions"]))
    print(f"max |action diff| {adiff:.3g} over {len(ref['actions'])} steps")
    steps = len(ref["pred_bbox"]) // rounds
    flipped = 0
    for r in range(rounds):
        fused = np.abs(out["fused"][r] - ref["fused"][r]).reshape(8, -1).max(1)
        ok = ref["stereo_ok"][r]
        stereo = np.zeros(8)
        for s in range(steps):
            d = np.abs(out["pred_bbox"][r * steps + s] - ref["pred_bbox"][r * steps + s])
            stereo = np.maximum(stereo, np.where(ok[s + 1], d.reshape(8, -1).max(1), 0))
        sj, sp = ref["success"][r].astype(int), out["success"][r].astype(int)
        flipped += int((sj != sp).sum())
        print(f"round {r + 1}: |fused diff| (m) {np.array2string(fused, precision=6)}; "
              f"stereo votes {ok.sum(0)}; max |stereo estimate diff| (m) "
              f"{np.array2string(stereo, precision=6)}; success jax {sj} port {sp}")
    print(f"success: jax {ref['result']['success_rate']:.2f}%, port "
          f"{out['result']['success_rate']:.2f}% over {ref['result']['rounds']} episodes; "
          f"{flipped} episodes differ")


if __name__ == "__main__":
    main(sys.argv[1:])
