"""The flagship evaluation: a closed loop of whole rounds (the scenes of a
round loaded into the env, ``controller.run(eval=True)``, the success read,
as the program's ``train.test`` runs a round) of the camera-scheduling
policy, the estimator and the scripted skill, until the window's deadline.

The stack is built with the program's ``train.prepare_*`` from its config
groups, the configuration file's estimator knobs and the traffic file's
overrides (dataset, task, envs, policy checkpoint, early stop, fusion). The
scenes (object instance, placement, robot pose of each env) are a cycle of
``scene_rounds`` rounds that the env's own generator draws at the traffic's
``scene_seed``. The point-sampling draws of each estimate come from a
generator the benchmark seeds before the call, from the traffic's
``scene_seed``, the round's place in the cycle, how often that place has
come round before, and the step. So the n-th visit of a place is the same
round, with the same inputs and draws, whatever the run; ``--seed`` only
picks where a run enters the cycle, and every seed runs the same rounds in
another order. The warm-up rounds are set-up.

Correctness: in ``check_rounds`` rounds drawn from the seed among the
window's first ``check_within``, the benchmark
keeps what the program was handed and what it answered: the view pairs and
the estimate of each step, the observations and the actions of each policy
call, and the fused bbox the skill was given (with the per-step
stereo flags, the controller's own state). Once the window has closed and
the program is freed, the reference recomputes each estimate from the
views, each action from the observation, and the fusion from its own
estimates; ``compare`` holds the program to them.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import harness as H
from portbench.counts import flops
from portbench.drivers import estimate as E
from portbench.reference import policy as RP
from portbench.reference import weights as RW


def overrides(cfg, wl, scene_seed):
    ov = [f"pose_estimator.{k}={cfg[k]}" for k in E.KNOBS if k != "name"]
    ov += [f"pose_estimator.checkpoint_path={cfg['weights']['checkpoint']}",
           "pose_estimator.load=true", f"controller.load={wl['policy']}",
           f"seed={scene_seed}"]
    return ["pose_estimator=" + wl["pose_estimator_group"]] + wl["overrides"] + ov


class Recorder:
    """Wraps the program's estimator, policy and skill entry on their
    instances: seeds each estimate's draws, and keeps what a recorded round
    handed them and got back."""

    def __init__(self, est, ppo, iface, draw_base):
        self.calls = 0
        self.recording = False
        self.rounds = []
        self.key, self.step = (0, 0), 0
        est_fn, act_fn, manip_fn = est.estimate, ppo.act_inference, iface.call_manipulation

        def estimate(*args):
            draw = H.derive(draw_base, *self.key, self.step)
            self.calls += 1
            self.step += 1
            est.generator.manual_seed(draw)
            out = est_fn(*args)
            if self.recording:
                self.rounds[-1]["estimates"].append((draw, args, np.array(out)))
            return out

        def act_inference(obs):
            out = act_fn(obs)
            if self.recording:
                self.rounds[-1]["actions"].append((np.array(obs), np.array(out)))
            return out

        def call_manipulation(estimation, eval=False):
            if self.recording:
                self.rounds[-1]["fused"] = np.array(estimation)
                self.rounds[-1]["stereo_ok"] = iface.stereo_ok().copy()
                self.rounds[-1]["cur_step"] = iface.accumulate_steps - 1
            return manip_fn(estimation, eval)

        est.estimate, ppo.act_inference = estimate, act_inference
        iface.call_manipulation = call_manipulation

    def start_round(self, record: bool, key):
        """Round ``key`` (place in the cycle, visit) starts; ``record`` keeps
        what it hands the program and gets back."""
        self.recording = record
        self.key, self.step = key, 0
        if record:
            self.rounds.append({"estimates": [], "actions": []})


def scenes(env, rounds):
    """``rounds`` rounds of per-env scene configurations (object and robot),
    drawn by the program's own env generator, whose seed the traffic file
    fixes."""
    out = []
    for _ in range(rounds):
        env.reset()
        out.append([{"obj_config": env.current_obj_config[e],
                     "robot_config": env.current_robot_config[e]}
                    for e in range(env.num_envs)])
    return out


def schedule(cycle, seed):
    """Round i of a run of ``seed``: its key (place in the cycle, visits of
    that place before) and its configurations, the cycle entered at an
    offset drawn from the seed."""
    place = int(np.random.default_rng(H.derive(seed, 11)).integers(len(cycle)))
    visits = [0] * len(cycle)
    while True:
        yield (place, visits[place]), cycle[place]
        visits[place] += 1
        place = (place + 1) % len(cycle)


def build(cfg, wl, seed, device):
    from rgbmanip_tpu_torch.config.loader import load_config
    from rgbmanip_tpu_torch.train import (prepare_controller, prepare_env,
                                          prepare_manipulation, prepare_pose_estimator)
    from rgbmanip_tpu_torch.utils.logger import get_logger
    c = load_config(overrides(cfg, wl, int(wl["scene_seed"])))
    log = get_logger()
    env = prepare_env(c["task"], c["dataset"], True, False, log, seed=int(wl["scene_seed"]))
    manip = prepare_manipulation(env, c["manipulation"], log, c["train"], device)
    est = prepare_pose_estimator(env, c["pose_estimator"], log, device)
    ctrl = prepare_controller(env, est, manip, c["controller"], c, log, device=device)
    est.generator = torch.Generator(device=device)
    rec = Recorder(est, ctrl.controller, ctrl.control_interface,
                   H.derive(int(wl["scene_seed"]), 4))
    rounds = schedule(scenes(env, int(wl["scene_rounds"])), seed)
    return env, est, ctrl, rec, rounds


def one_round(env, ctrl, rec, item, record=False):
    """Round ``item`` (key, configurations) of the schedule; its success."""
    key, cfgs = item
    rec.start_round(record, key)
    env.load(cfgs)
    ctrl.run(eval=True)
    return float(np.asarray(env.get_observation()["success"]).sum())


def reference_round(net, cfg, layers, r, device, quant=None):
    """The reference's answers for one recorded round: per-step estimates,
    actions and the fusion of its own estimates."""
    est = []
    for draw, args, _ in r["estimates"]:
        K, rgb1, m1, e1, rgb2, m2, e2 = (torch.as_tensor(np.asarray(a), device=device)
                                         for a in args)
        B = rgb1.shape[0]
        u1, u2 = E.draws(cfg, B, draw, device)
        x = {"K": K.float(), "rgb1": rgb1.float(), "mask1": m1.bool(), "ext1": e1.float(),
             "rgb2": rgb2.float(), "mask2": m2.bool(), "ext2": e2.float()}
        est.append(E.reference_outputs(net, cfg, x, u1, u2, quant)["bbox"])
    q = quant or (lambda t: t)
    with torch.no_grad():
        acts = [RP.act([(q(w), b) for w, b in layers],
                       q(torch.as_tensor(obs, dtype=torch.float32, device=device)))
                .cpu().numpy() for obs, _ in r["actions"]]
    queue = np.zeros((r["stereo_ok"].shape[0],) + est[0].shape, np.float32)
    for t, bbox in enumerate(est, start=1):
        queue[t] = bbox
    fused = RP.consensus_fuse(queue, r["cur_step"], r["stereo_ok"])
    return est, acts, fused


def compare(rounds, answers):
    """The numbers that decide ``correct``: the median and the widest
    relative gap of the per-step estimates, the widest relative gap of the
    fused bbox the skill acted on, and the widest gap of an action over the
    largest action of its call."""
    est_gaps, fused_gaps, act_gaps = [], [], []
    for r, (est, acts, fused) in zip(rounds, answers):
        for (_, _, prog), ref in zip(r["estimates"], est):
            est_gaps.append(E.gaps({"bbox": prog}, {"bbox": ref}))
        fused_gaps.append(E.gaps({"bbox": r["fused"]}, {"bbox": fused}))
        for (_, prog), ref in zip(r["actions"], acts):
            act_gaps.append(np.abs(prog - ref).max() / max(np.abs(ref).max(), 1e-12))
    est_gaps = np.concatenate(est_gaps)
    return {"bbox_gap_p50": float(np.median(est_gaps)), "bbox_gap_max": float(est_gaps.max()),
            "fused_gap_max": float(np.concatenate(fused_gaps).max()),
            "action_gap_max": float(max(act_gaps))}


def reference_answers(cfg, wl, rec, device, quant=None):
    """The reference's answers for every round ``rec`` recorded."""
    net = E.reference_net(cfg, None, device)
    layers = RP.actor_layers(RW.read_checkpoint(f"{H.ROOT}/{wl['policy']}"), device)
    return [reference_round(net, cfg, layers, r, device, quant) for r in rec.rounds]


def run(run, t0):
    cfg, wl, dev = run.cfg, run.wl, run.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env, est, ctrl, rec, sched = build(cfg, wl, run.seed, dev)
    for _ in range(int(wl["warmup_rounds"])):
        one_round(env, ctrl, rec, next(sched))
    run.tracer.prime(lambda: one_round(env, ctrl, rec, next(sched)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_before = dict(env.timer.totals)
    n_before = dict(env.timer.counts)
    calls_before = rec.calls
    picked = set(np.random.default_rng(H.derive(run.seed, 5)).choice(
        int(wl["check_within"]), size=int(wl["check_rounds"]), replace=False).tolist())
    n_env = env.num_envs
    rounds = success = 0
    took = []
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    deadline = start + run.seconds
    while time.perf_counter() < deadline:
        run.tracer.tick()
        t = time.perf_counter()
        with H.span("round"):
            success += one_round(env, ctrl, rec, next(sched), rounds in picked)
        took.append(time.perf_counter() - t)
        rounds += 1
    end = time.perf_counter()
    print(f"portbench: window {H.spread_line(took)}", file=sys.stderr)
    run.tracer.tick(last=True)
    rec.recording = False
    run.window_s = end - start - run.tracer.paused
    run.phases = {"totals": {k: v - t_before.get(k, 0.0) for k, v in env.timer.totals.items()},
                  "counts": {k: v - n_before.get(k, 0) for k, v in env.timer.counts.items()}}
    print("portbench: window phases s " + " ".join(
        f"{k} {v:.2f}" for k, v in sorted(run.phases["totals"].items())), file=sys.stderr)
    acts = run.phases["counts"].get("policy", 0)
    calls = rec.calls - calls_before
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    layers = RP.actor_layers(RW.read_checkpoint(f"{H.ROOT}/{wl['policy']}"), "cpu")
    widths = [layers[0][0].shape[1]] + [w.shape[0] for w, _ in layers]
    run.counts.update(rounds=rounds, episodes=rounds * n_env, success=success,
                      estimates=calls * n_env, dtype="float32",
                      flops=calls * flops.estimate_flops(cfg, n_env)
                      + acts * flops.mlp_flops(widths, n_env))
    env.close()
    del env, est, ctrl
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not rec.rounds:
        raise RuntimeError("no round was recorded for the check: the window is too short")
    numbers = compare(rec.rounds, reference_answers(cfg, wl, rec, dev))
    return {"e2e": {"episodes_per_s": rounds * n_env / run.window_s, "setup_s": setup_s},
            "attempted": rounds * n_env, "failed": 0, "peak": peak,
            "checks": E.checks(numbers, wl["limits"])}


def readings(cfg, wl, seed, device, calls=None):
    """For one seed: the numbers compared for the program over
    ``check_rounds`` rounds after one warm-up round, and for the control
    (the reference with TF32 operands, one precision step below the cell's
    f32, in the program's place), each against the f32 reference."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env, est, ctrl, rec, sched = build(cfg, wl, seed, device)
    one_round(env, ctrl, rec, next(sched))
    for _ in range(int(calls or wl["check_rounds"])):
        one_round(env, ctrl, rec, next(sched), True)
    rec.recording = False
    env.close()
    del env, est, ctrl
    gc.collect()
    ref = reference_answers(cfg, wl, rec, device)
    control = reference_answers(cfg, wl, rec, device, E.tf32)
    as_program = []
    for r, (est_c, acts_c, fused_c) in zip(rec.rounds, control):
        c = dict(r)
        c["estimates"] = [(k, a, b) for (k, a, _), b in zip(r["estimates"], est_c)]
        c["actions"] = [(o, a) for (o, _), a in zip(r["actions"], acts_c)]
        c["fused"] = fused_c
        as_program.append(c)
    return {"program": compare(rec.rounds, ref), "control": compare(as_program, ref)}
