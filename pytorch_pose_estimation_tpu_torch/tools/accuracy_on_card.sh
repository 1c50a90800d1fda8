#!/usr/bin/env bash
# The port's accuracy path on one GPU, from the repo root:
#
#   bash pytorch_pose_estimation_tpu_torch/tools/accuracy_on_card.sh \
#       [OUT_DIR=saved/accuracy] [PIS_SEEDS="0"]
#
# a. the ref-scale synthetic corpus (tests/synth_fixture.py, by its path:
#    `-m tests.synth_fixture` can find another package named `tests`);
# b. the angle-group arm G=16, 60 epochs (tools.ab_angle_groups), its validation
#    trajectory (tools.tb_trajectory, or the printed epoch lines where
#    tensorboardX is missing);
# c. test_sbp of the arm's `best` checkpoint;
# d. the PIS chain: the behaviour corpus, saving_weights of (c)'s `best`,
#    then for each seed of PIS_SEEDS train_sbp_pis on a copy of
#    configs/sbp_pis_synth.yaml (under $TMPDIR) with 140 epochs and that
#    `seed`, its trajectory, and both behaviour harnesses on its
#    `best`.
# Every command's output goes to OUT_DIR/<step>.log; OUT_DIR/summary.txt
# collects the numbers.  Corpus, memo and checkpoints stay under ./data,
# ./saved and ./saved_ab.
set -uo pipefail
OUT=${1:-saved/accuracy}
PIS_SEEDS=${2:-0}
PIS_EPOCHS=140  # the JAX run stopped at about epoch 135
PY=${PYTHON:-python3}
M=pytorch_pose_estimation_tpu_torch
mkdir -p "$OUT"
SUM="$OUT/summary.txt"
: > "$SUM"
say() { echo "$*" | tee -a "$SUM"; }
step() {  # step NAME CMD...: run, keep its output, stop the script on failure
    local name=$1; shift
    local t0; t0=$(date +%s%N)
    "$@" > "$OUT/$name.log" 2>&1
    local rc=$?
    say "$name: rc $rc in $(( ($(date +%s%N) - t0) / 1000000 )) ms: $*"
    if [ $rc -ne 0 ]; then tail -n 40 "$OUT/$name.log"; exit $rc; fi
}

say "card: $(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)"
say "$($PY -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)')"
$PY -c 'import tensorboardX' 2>/dev/null && TB=1 || TB=0
say "tensorboardX importable: $TB"

# a. the corpus
step corpus $PY tests/synth_fixture.py ./data/ref_scale 5000 250 --hard

# b. the SBP arm
step sbp_g16 $PY -u -m $M.tools.ab_angle_groups 16 60
grep -E "device cache|steps/epoch" "$OUT/sbp_g16.log" | tee -a "$SUM"
RESULT=$(grep -E '^\{"G"' "$OUT/sbp_g16.log" | tail -n 1)
say "sbp result: $RESULT"
VDIR=$(echo "$RESULT" | $PY -c 'import json, sys; print(json.load(sys.stdin)["version_dir"])')
SPE=$(grep -oE "[0-9]+ steps/epoch" "$OUT/sbp_g16.log" | head -n 1 | cut -d' ' -f1)
grep -E "^epoch [0-9]+: train_loss" "$OUT/sbp_g16.log" >> "$SUM"
trajectory() {  # trajectory LOGDIR LOG STEPS_PER_EPOCH
    if [ "$TB" = 1 ]; then
        $PY -m $M.tools.tb_trajectory "$1" --steps-per-epoch "$3"
    else
        $PY -m $M.tools.tb_trajectory --log "$2" --steps-per-epoch "$3"
    fi
}
say "sbp trajectory (steps per epoch $SPE):"
trajectory "$VDIR" "$OUT/sbp_g16.log" "$SPE" | tee -a "$SUM"
BEST="$VDIR/checkpoints/best"
say "best: $(cat "$BEST.meta.json")"

# c. the checkpoint's numbers again, through the eval CLI
step test_sbp $PY -u -m $M.test_sbp --cfg configs/sbp_synth_ref.yaml --ckpt "$BEST"
grep -E "AP @|AR @|val_loss=" "$OUT/test_sbp.log" | tee -a "$SUM"

# d. the PIS chain
step pis_corpus $PY -c "import importlib.util as u
s = u.spec_from_file_location('synth_fixture', 'tests/synth_fixture.py')
m = u.module_from_spec(s); s.loader.exec_module(m)
print(m.make_pis_behavior_dataset('./data/pis_behavior'))"
step surgery $PY -u -m $M.saving_weights --ckpt "$BEST" \
    --out ./saved/simple-baselines-pose_synth-ref-scale/pretrained_weights
A=./data/pis_behavior/annotations
for SEED in $PIS_SEEDS; do
    PIS_CFG=$(mktemp -d)/sbp_pis_synth.yaml
    sed -E "s/^epochs: [0-9]+/epochs: $PIS_EPOCHS/" configs/sbp_pis_synth.yaml > "$PIS_CFG"
    echo "seed: $SEED" >> "$PIS_CFG"
    say "pis config: $(grep -E '^(epochs|seed):' "$PIS_CFG" | tr '\n' ' ')"
    step pis_train_s$SEED $PY -u -m $M.train_sbp_pis --cfg "$PIS_CFG"
    grep -E "warm-started|device cache" "$OUT/pis_train_s$SEED.log" | tee -a "$SUM"
    grep -E "^epoch [0-9]+: train_loss" "$OUT/pis_train_s$SEED.log" | tail -n 3 >> "$SUM"
    PDIR=$(ls -d ./saved/simple-baselines-pose_pis-synth/version_* | sort -V | tail -n 1)
    PSPE=$(grep -oE "[0-9]+ steps/epoch" "$OUT/pis_train_s$SEED.log" | head -n 1 | cut -d' ' -f1)
    say "pis trajectory, seed $SEED ($PDIR, steps per epoch $PSPE):"
    trajectory "$PDIR" "$OUT/pis_train_s$SEED.log" "$PSPE" | tee -a "$SUM"
    PBEST="$PDIR/checkpoints/best"
    say "pis best: $(cat "$PBEST.meta.json")"
    step handle_s$SEED $PY -u -m $M.pis_handle_test_code --cfg "$PIS_CFG" --ckpt "$PBEST" \
        --label-depth -2 --val-path "$A/pis_behavior_handle_val.json"
    step fall_s$SEED $PY -u -m $M.pis_falling_down_test_code --cfg "$PIS_CFG" --ckpt "$PBEST" \
        --label-depth -2 --val-path "$A/pis_behavior_fall_val.json"
    say "handle harness, seed $SEED:"; tail -n 2 "$OUT/handle_s$SEED.log" | tee -a "$SUM"
    say "fall harness, seed $SEED:"; tail -n 3 "$OUT/fall_s$SEED.log" | tee -a "$SUM"
done
say "done"
