#!/bin/bash
# The port's results table: every row of the JAX package's evaluation
# protocols through rgbmanip_tpu_torch, at 104 episodes, 8 envs, seed 11.
#   1. the gt sweep of every task x split (scripts/eval_sweep.py 104)
#   2. the flagship rows and the ViewNum curve (scripts/flagship_sweep.sh),
#      with each cabinet estimator: aug_r5 (the port's flagship checkpoint)
#      and dagger_r3 (the estimator of docs/RESULTS.md's featured rows)
#   3. the drawer flagship: zero-shot (the cabinet policy) on test, and the
#      fine-tuned policy on both splits (scripts/r5_stageE.sh:13-19, 33-39)
#   4. the variants open_cabinet_45 (each cabinet estimator) and
#      open_drawer_30 on both splits (scripts/r5_stageF.sh:13-35)
#   5. the per-step diagnostic, 6 rounds of 8, with each cabinet estimator
#      (scripts/r5_stageD.sh:18)
#
# Usage: bash rgbmanip_tpu_torch/scripts/results_rows.sh OUT_DIR [rounds] [key=value ...]
# Writes OUT_DIR/rows.txt (one FINAL line per row), the sweep's JSON under
# OUT_DIR/docs/, the flagship sweeps' files and the diagnostics' output.
# The estimator and the policy run on the card; pass device=cpu (and a small
# rounds) to run them on the CPU.
set -u
cd "$(dirname "$0")/../.."
REPO=$PWD
OUT=$(mkdir -p "$1" && cd "$1" && pwd)
ROUNDS=${2:-104}
shift $(( $# > 1 ? 2 : 1 ))
CAB165=checkpoints/ppo_rl_coadapt_model_165.ckpt
DRAWER195=checkpoints/ppo_rl_drawer_rl_model_195.ckpt
DRAWER_EST=checkpoints/estimator_fast_drawer_r3.ckpt

row() {  # row NAME override...
  local name=$1
  shift
  python -m rgbmanip_tpu_torch.train "$@" train=test train.total_round=$ROUNDS \
    task.num_envs=8 seed=11 "train.save_dir=$OUT/saves" "train.log_dir=$OUT/logs" \
    "exp_name=$name" > "$OUT/$name.log" 2>&1
  echo "$name rc=$? $(grep -o 'FINAL success rate.*' "$OUT/$name.log" | tail -1)" >> "$OUT/rows.txt"
}

(cd "$OUT" && PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
  python -m rgbmanip_tpu_torch.scripts.eval_sweep "$ROUNDS" "$@" \
  > "$OUT/gt_sweep.log" 2>&1; echo "gt_sweep rc=$?" >> "$OUT/rows.txt")

for est in aug_r5 dagger_r3; do
  POLICY=$CAB165 EST=checkpoints/estimator_fast_cabinet_$est.ckpt \
    OUT=$OUT/flagship_$est.txt bash rgbmanip_tpu_torch/scripts/flagship_sweep.sh "$ROUNDS" "$@"
done

DRAWER=(task=open_drawer manipulation=open_drawer controller=rl
        pose_estimator=adapose_drawer_fast "pose_estimator.checkpoint_path=$DRAWER_EST")
row drawer_zeroshot_test dataset=drawer_test "${DRAWER[@]}" "controller.load=$CAB165" "$@"
for split in test train; do
  row drawer_ft_$split dataset=drawer_$split "${DRAWER[@]}" "controller.load=$DRAWER195" "$@"
done

for split in test train; do
  for est in aug_r5 dagger_r3; do
    row cab45_${est}_$split dataset=cabinet_$split task=open_cabinet_45 \
      manipulation=open_cabinet controller=rl "controller.load=$CAB165" \
      pose_estimator=adapose_cabinet_fast \
      "pose_estimator.checkpoint_path=checkpoints/estimator_fast_cabinet_$est.ckpt" "$@"
  done
  row drawer30_$split dataset=drawer_$split task=open_drawer_30 manipulation=open_drawer \
    controller=rl "controller.load=$DRAWER195" pose_estimator=adapose_drawer_fast \
    "pose_estimator.checkpoint_path=$DRAWER_EST" "$@"
done

for est in aug_r5 dagger_r3; do
  EST_CKPT=checkpoints/estimator_fast_cabinet_$est.ckpt \
    python -m rgbmanip_tpu_torch.scripts.diag_flagship "$CAB165" 6 8 "$@" \
    > "$OUT/diag_$est.log" 2>&1
  echo "diag_$est rc=$?" >> "$OUT/rows.txt"
done
