#!/usr/bin/env bash
# The port's accuracy path on one GPU, from the repo root:
#
#   [ARMS="sbp spm"] [SPM_EPOCHS=90] [SPM_SEEDS="0"] [HARD_EPOCHS=250] \
#   [HARD_RECIPES="hard"] bash pytorch_pose_estimation_tpu_torch/tools/accuracy_on_card.sh \
#       [OUT_DIR=saved/accuracy] [PIS_SEEDS="0"]
#
# ARMS selects the arms: "sbp" runs steps a-d, "spm" step e, "spm_hard"
# step f; "sbp spm" by default.
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
#    `best`;
# e. SPM at reference scale: configs/spm_synth_ref.yaml's corpus
#    (tools.spm_ref corpus: 5,000 train images with 27,656 instances, 500
#    val with 2,774, or it fails), then for each seed of SPM_SEEDS a copy
#    of the YAML under $TMPDIR with `epochs: $SPM_EPOCHS`, that `seed`
#    (the init, the augmentation stream and the shuffle) and its own
#    `save_dir: ./saved/spm_s<seed>` (so that --resume auto finds only
#    that seed's checkpoints), nothing else changed; train_spm --resume
#    auto on it (about an hour of card time for 90 epochs at about 255 ms
#    a step; a later run of the script resumes from the seed's newest
#    checkpoint, its log in spm_s<seed>_train_<N>.log), the trajectory at
#    156 steps an epoch over every attempt's log, test_spm and
#    inference_spm --limit 8 of the newest run's `best`;
# f. spm_synth_hard, for each corpus of HARD_RECIPES: "hard" is
#    configs/spm_synth_hard.yaml's (tools.spm_ref corpus --recipe hard:
#    256 train and 48 val images of 5-8 persons), "hard3" the 1-3-person
#    one (--recipe hard3: make_dataset's defaults, the same counts and
#    seeds, under ./data/spm_hard3, its copies saving under
#    ./saved/spm_hard3); a copy of the YAML with `epochs: $HARD_EPOCHS`
#    and nothing else changed (8 steps an epoch: 250 epochs are yolo_lr's
#    2,000 steps) but `save_last_every_n_epochs: 25` appended (a card host
#    counts every byte written: `last` every epoch would be 73 GB),
#    train_spm --resume auto, the trajectory, test_spm of `best`.  Where
#    SPM_SEEDS is given, once per seed as in (e): `seed: N` appended and
#    `save_dir: ./saved/spm_<recipe>_s<N>`, logs spm_<recipe>_s<N>_*.
# Every command's output goes to OUT_DIR/<step>.log; OUT_DIR/summary.txt
# collects the numbers.  Corpus, memo and checkpoints stay under ./data,
# ./saved and ./saved_ab.
set -uo pipefail
OUT=${1:-saved/accuracy}
PIS_SEEDS=${2:-0}
PIS_EPOCHS=140  # the JAX run stopped at about epoch 135
ARMS=${ARMS:-sbp spm}
SPM_EPOCHS=${SPM_EPOCHS:-90}  # JAX's last validation was at epoch 89
HARD_SEEDS=${SPM_SEEDS:-}  # the hard arm runs the YAML's own seed unless given
SPM_SEEDS=${SPM_SEEDS:-0}
HARD_EPOCHS=${HARD_EPOCHS:-250}
HARD_RECIPES=${HARD_RECIPES:-hard}
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
say "arms: $ARMS"
arm() { [[ " $ARMS " == *" $1 "* ]]; }
trajectory() {  # trajectory LOGDIR LOG STEPS_PER_EPOCH
    if [ "$TB" = 1 ]; then
        $PY -m $M.tools.tb_trajectory "$1" --steps-per-epoch "$3"
    else
        $PY -m $M.tools.tb_trajectory --log "$2" --steps-per-epoch "$3"
    fi
}
spm_run() {  # spm_run TAG RECIPE EPOCHS [SEED]: config copy, train, trajectory, best
    local tag=$1 recipe=$2 epochs=$3 seed=${4:-}
    local cfg; cfg=$(mktemp -d)/spm_$recipe.yaml
    step ${tag}_config $PY -m $M.tools.spm_ref config "$cfg" --recipe "$recipe" --epochs "$epochs"
    if [ -n "$seed" ]; then
        echo "seed: $seed" >> "$cfg"
        sed -i -E "s|^save_dir *:.*|save_dir : './saved/$tag'|" "$cfg"
    fi
    # `last` of 293 MB every epoch would write 73 GB in 250 epochs
    [[ "$recipe" == hard* ]] && echo "save_last_every_n_epochs: 25" >> "$cfg"
    local yaml; yaml=$($PY -c "from $M.tools.spm_ref import RECIPES; print(RECIPES['$recipe'][2])")
    say "$tag config: $cfg, $(diff "$yaml" "$cfg" | grep -E '^[<>]' | tr '\n' ' ')"
    local n=1; while [ -e "$OUT/${tag}_train_$n.log" ]; do n=$((n + 1)); done
    step ${tag}_train_$n $PY -u -m $M.train_spm --cfg "$cfg" --resume auto
    grep -E "auto-resume|resuming|device cache" "$OUT/${tag}_train_$n.log" | tee -a "$SUM"
    local all="$OUT/${tag}_train_all.log"
    for F in $(ls "$OUT/${tag}"_train_[0-9]*.log | sort -V); do cat "$F"; done > "$all"
    grep -E "^epoch [0-9]+: train_loss" "$all" >> "$SUM"
    local save; save=$(sed -nE "s/^save_dir *: *'?([^' ]*)'?.*/\1/p" "$cfg")
    local ds; ds=$(sed -nE "s/^dataset_name *: *'?([^' ]*)'?.*/\1/p" "$cfg")
    local sdir; sdir=$(ls -d "$save"/single-stage-pose-machines_"$ds"/version_* | sort -V | tail -n 1)
    local spe; spe=$(grep -oE "[0-9]+ steps/epoch" "$all" | head -n 1 | cut -d' ' -f1)
    # no device cache, no such line: train images // batch
    [ -n "$spe" ] || spe=$($PY -c "import json; from $M.config import get_configs
c = get_configs('$cfg')
print(len(json.load(open(c['train_path']))['images']) // c['batch_size'])")
    say "$tag trajectory ($sdir, steps per epoch $spe):"
    trajectory "$sdir" "$all" "$spe" | tee -a "$SUM"
    SCFG=$cfg
    SBEST="$sdir/checkpoints/best"
    say "$tag best: $(cat "$SBEST.meta.json")"
    step ${tag}_test $PY -u -m $M.test_spm --cfg "$cfg" --ckpt "$SBEST"
    grep -E "AP @|AR @|val_loss=" "$OUT/${tag}_test.log" | tee -a "$SUM"
}

if arm sbp; then
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
fi

if arm spm; then
# e. SPM at reference scale, per seed
step spm_corpus $PY -m $M.tools.spm_ref corpus ./data/spm_ref
tee -a "$SUM" < "$OUT/spm_corpus.log"
for SEED in $SPM_SEEDS; do
    spm_run spm_s$SEED ref "$SPM_EPOCHS" "$SEED"
    step inference_spm_s$SEED $PY -u -m $M.inference_spm --cfg "$SCFG" --ckpt "$SBEST" \
        --save-dir "$OUT/spm_vis_s$SEED" --limit 8
    say "inference_spm, seed $SEED: $(grep -c '^Inference:' "$OUT/inference_spm_s$SEED.log") images, $(grep '^Inference:' "$OUT/inference_spm_s$SEED.log" | tr '\n' ' ')"
done
fi

if arm spm_hard; then
# f. spm_synth_hard, per corpus and seed
for RECIPE in $HARD_RECIPES; do
    step ${RECIPE}_corpus $PY -m $M.tools.spm_ref corpus --recipe "$RECIPE"
    tee -a "$SUM" < "$OUT/${RECIPE}_corpus.log"
    if [ -z "$HARD_SEEDS" ]; then
        spm_run spm_$RECIPE "$RECIPE" "$HARD_EPOCHS"
    fi
    for SEED in $HARD_SEEDS; do
        spm_run spm_${RECIPE}_s$SEED "$RECIPE" "$HARD_EPOCHS" "$SEED"
    done
done
fi
say "done"
