#!/bin/bash
# Flagship (RL + AdaPose) evaluation sweep through the port, the rows of
# scripts/flagship_sweep.sh: k=4 views (the default) on both splits, then
# the ViewNum curve k=3,2,1 on the test split (reference ablation:
# miscs/experimental_results/ablation_results.yaml:51-64; reference flagship
# main row: main_results.yaml:17-19 = 89.25 train / 88.875 test).
#
# Usage: POLICY=checkpoints/ppo_rl_coadapt_model_165.ckpt \
#        EST=checkpoints/estimator_fast_cabinet_aug_r5.ckpt \
#        bash rgbmanip_tpu_torch/scripts/flagship_sweep.sh [rounds] [key=value ...]
# The estimator and the policy run on the card; pass device=cpu (and, for a
# short run, a small rounds) to run them on the CPU. Every further key=value
# is a config override of each row.
set -u
cd "$(dirname "$0")/../.."
ROUNDS=${1:-104}
shift $(( $# > 0 ? 1 : 0 ))
POLICY=${POLICY:?policy ckpt}
EST=${EST:?estimator ckpt}
OUT=${OUT:-/tmp/flagship_sweep_torch.txt}

run() {  # run SPLIT K
  local split=$1 k=$2
  shift 2
  echo "=== split=$split k=$k policy=$POLICY est=$EST ===" >> "$OUT"
  timeout 2700 python -m rgbmanip_tpu_torch.train dataset=cabinet_$split \
    task=open_cabinet manipulation=open_cabinet controller=rl \
    "controller.load=$POLICY" controller.early_stop=$k \
    pose_estimator=adapose_cabinet_fast "pose_estimator.checkpoint_path=$EST" \
    train=test train.total_round=$ROUNDS task.num_envs=8 seed=11 "$@" 2>&1 |
    grep -E "FINAL|error|Error" | tail -4 >> "$OUT"
}

run test 4 "$@"
run train 4 "$@"
run test 3 "$@"
run test 2 "$@"
run test 1 "$@"
echo "=== sweep done $(date -u) ===" >> "$OUT"
