#!/bin/sh
# The CI-size 5x5 learning proof of scripts/prove_learning_torch.py over a
# small matrix of device, compute dtype and seed, all runs side by side on
# one GPU (one process each, one host thread each).  It separates what the
# proof's outcome depends on: the card against the CPU, bf16 against fp32
# convolutions (TF32 off), and the seed that picks the random initial net.
#
#   sh scripts/prove5_matrix_torch.sh OUTDIR [MAX_SECONDS] [EVAL_ROLLOUTS]
#
# EVAL_ROLLOUTS 0 (default) is the policy-only evaluation of the CI test;
# above 0 both sides search with that many rollouts in the eval games.
#
# Writes OUTDIR/<run>.log and OUTDIR/<run>_curve.jsonl per run and prints
# one line per run: name, return code (0 = trained net beat its frozen
# init at 0.6 or better in the confirmation match), the win rates of the
# periodic evals, and the run's torch build and fingerprint of its init.
out=${1:?usage: prove5_matrix_torch.sh OUTDIR [MAX_SECONDS] [EVAL_ROLLOUTS]}
secs=${2:-420}
evalr=${3:-0}
cd "$(dirname "$0")/.." || exit 2
mkdir -p "$out"
export OMP_NUM_THREADS=1 MKL_NUM_THREADS=1 NVIDIA_TF32_OVERRIDE=0

run() {  # name device use_bf16 seed
    python scripts/prove_learning_torch.py --device "$2" --use_bf16 "$3" \
        --seed "$4" --out "$out/$1" --board_size 5 --blocks 1 --dim 16 \
        --batch_boards 32 --rollouts 16 --rollouts_per_batch 8 \
        --train_bs 64 --komi 2.5 --sample_ratio 2.0 --eval_every_games 120 \
        --eval_games 24 --eval_rollouts "$evalr" --final_games 48 \
        --target_winrate 0.6 --min_replay_games 32 --max_seconds "$secs" \
        --policy_distri_cutoff 4 --ply_pass_enabled 8 \
        > "$out/$1.log" 2>&1
    echo $? > "$out/$1.rc"
}

runs="cuda_bf16_s11 cuda_fp32_s11 cpu_bf16_s11 cuda_bf16_s7 cuda_fp32_s7 cuda_fp32_s3"
run cuda_bf16_s11 cuda 1 11 &
run cuda_fp32_s11 cuda 0 11 &
run cpu_bf16_s11 cpu 1 11 &
run cuda_bf16_s7 cuda 1 7 &
run cuda_fp32_s7 cuda 0 7 &
run cuda_fp32_s3 cuda 0 3 &
wait

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for r in $runs; do
    cp "$out/$r/learning_curve.jsonl" "$out/${r}_curve.jsonl" 2>/dev/null
    rates=$(sed -n 's/.*"winrate": \([0-9.]*\).*/\1/p' \
        "$out/${r}_curve.jsonl" 2>/dev/null | tr '\n' ' ')
    echo "$r rc=$(cat "$out/$r.rc") winrates: $rates"
    grep -m 1 init_crc32 "$out/$r.log"
    rm -rf "$out/$r"
done
