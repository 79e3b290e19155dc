#!/bin/sh
# The 9x9 production protocol of scripts/prove_production_torch.py (its
# defaults, which are the JAX command's, with one promotion and 64 eval
# boards) on one GPU, from the JAX run's own init, runs/prod9/init.bin.
#
#   sh scripts/prod9_card_torch.sh OUT SECONDS [AB_SECONDS]
#
# OUT is the run directory.  When it holds no checkpoint it is seeded
# from the init (ckpt/save-0.bin, ckpt/latest and init.bin); otherwise
# the run resumes, and SECONDS is its CUMULATIVE --max_seconds.  With
# AB_SECONDS > 0, a fresh run at torch's default host thread count goes
# first, for AB_SECONDS, in OUT.threads_default: its status curve against
# the run's own (OMP_NUM_THREADS = nproc / 3, at least 1, unless the
# caller set it) compares the children's thread counts.  Both runs' small
# files and gzipped logs are copied to chiprun_out/prod9_torch/.
out=${1:?usage: prod9_card_torch.sh OUT SECONDS [AB_SECONDS]}
secs=${2:?usage: prod9_card_torch.sh OUT SECONDS [AB_SECONDS]}
ab=${3:-0}
cd "$(dirname "$0")/.." || exit 2
keep=chiprun_out/prod9_torch
mkdir -p "$keep"
nproc
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
# build the kernels once, outside both runs' clocks
python -c 'from elf_tpu_torch import _build; [_build.build(n) for n in ("go_libs", "replayer")]'

seed() {  # dir: an --out holding only the JAX init
    mkdir -p "$1/ckpt"
    cp runs/prod9/init.bin "$1/ckpt/save-0.bin"
    ln -sf save-0.bin "$1/ckpt/latest"
    cp runs/prod9/init.bin "$1/init.bin"
}

prove() {  # dir seconds [options]: the protocol at its defaults, one
            # promotion
    d=$1 s=$2
    shift 2
    python scripts/prove_production_torch.py --out "$d" \
        --target_promotions 1 --eval_num_threads 64 --max_seconds "$s" "$@"
}

keep_small() {  # dir name
    mkdir -p "$keep/$2"
    for f in status_curve.jsonl eval_ladder.txt final.json progress.json \
             ckpt/promotions.jsonl prove.log; do
        [ -f "$1/$f" ] && cp "$1/$f" "$keep/$2/"
    done
    for f in "$1"/*.log; do
        [ -f "$f" ] && gzip -c "$f" > "$keep/$2/$(basename "$f").gz"
    done
}

if [ "$ab" -gt 0 ]; then
    rm -rf "$out.threads_default"
    seed "$out.threads_default"
    (unset OMP_NUM_THREADS; prove "$out.threads_default" "$ab" \
        --final_games 0) \
        > "$out.threads_default/prove.log" 2>&1
    echo "threads_default rc=$?"
    keep_small "$out.threads_default" threads_default
fi

[ -e "$out/ckpt/latest" ] || seed "$out"
: "${OMP_NUM_THREADS:=$(( $(nproc) / 3 > 1 ? $(nproc) / 3 : 1 ))}"
export OMP_NUM_THREADS
echo "OMP_NUM_THREADS=$OMP_NUM_THREADS"
prove "$out" "$secs" >> "$out/prove.log" 2>&1
rc=$?
echo "prod9 rc=$rc"
tail -n 30 "$out/prove.log"
keep_small "$out" prod9
exit $rc
