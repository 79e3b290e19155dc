#!/bin/sh
# The README's 13x13 production protocol (10 blocks x 128 channels,
# 400-game evals, three promotions as its target) through
# scripts/prove_production_torch.py on one GPU, from the JAX run's own
# init, runs/prod13/init.bin.
#
#   sh scripts/prod13_card_torch.sh OUT SECONDS [verdict]
#
# OUT is the run directory.  When it holds no checkpoint it is restored
# from OUT.carry.tar (tools/run_carry.py) if there is one, else seeded
# from the init (ckpt/save-0.bin, ckpt/latest and init.bin).  The fleet
# then runs to the CUMULATIVE --max_seconds SECONDS (progress.json), so a
# run cut by a call's time limit goes on in the next call.  With
# `verdict`, the proof runs once more on OUT with --target_promotions 1
# --final_games 100 and no budget left: it skips the fleet and plays the
# anchor of the last promotion alone, as the JAX run's final.json (n =
# 100, one promotion) implies its verdict was played.  The fleet's
# processes run OMP_NUM_THREADS = nproc / 3 (at least 1) unless the caller
# set it.  Small files, gzipped logs and the run's record (status curve,
# eval ladder, promotions, each process's exit summary, the server's
# events, final.json) are copied to chiprun_out/prod13_torch/, the record
# also to runs/prod13/, and the resume set to
# chiprun_out/prod13_torch/carry.tar (at most 52 MiB; move it to
# OUT.carry.tar for the next call).
out=${1:?usage: prod13_card_torch.sh OUT SECONDS [verdict]}
secs=${2:?usage: prod13_card_torch.sh OUT SECONDS [verdict]}
mode=${3:-}
cd "$(dirname "$0")/.." || exit 2
keep=chiprun_out/prod13_torch
mkdir -p "$keep"
nproc
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
# build the kernels once, outside the run's clock
python -c 'from elf_tpu_torch import _build; [_build.build(n) for n in ("go_libs", "replayer")]'

# the README's command (README.md, "13x13, half-depth production net")
README13="--board_size 13 --num_block 10 --dim 128 --num_games 192
    --client1_num_games 96 --eval_num_games 400 --value_weight 0.25
    --train_bs 256 --num_minibatch 40 --selfplay_init_num 150
    --selfplay_update_num 75"

if [ ! -e "$out/ckpt/latest" ]; then
    if [ -f "$out.carry.tar" ]; then
        python tools/run_carry.py unpack "$out.carry.tar" "$out" || exit 2
    else
        mkdir -p "$out/ckpt"
        cp runs/prod13/init.bin "$out/ckpt/save-0.bin"
        ln -sf save-0.bin "$out/ckpt/latest"
    fi
fi
[ -f "$out/init.bin" ] || cp runs/prod13/init.bin "$out/init.bin"
: "${OMP_NUM_THREADS:=$(( $(nproc) / 3 > 1 ? $(nproc) / 3 : 1 ))}"
export OMP_NUM_THREADS
echo "OMP_NUM_THREADS=$OMP_NUM_THREADS"

# shellcheck disable=SC2086
python scripts/prove_production_torch.py --out "$out" $README13 \
    --max_seconds "$secs" >> "$out/prove.log" 2>&1
rc=$?
echo "prod13 fleet rc=$rc"
tail -n 30 "$out/prove.log"
if [ "$mode" = verdict ]; then
    # shellcheck disable=SC2086
    python scripts/prove_production_torch.py --out "$out" $README13 \
        --max_seconds 0 --target_promotions 1 --final_games 100 \
        >> "$out/prove.log" 2>&1
    rc=$?
    echo "prod13 verdict rc=$rc"
    tail -n 20 "$out/prove.log"
fi

# the run's record, named as runs/prod9's: into chiprun_out, and into
# runs/prod13/ where the checkout is kept
for f in status_curve.jsonl eval_ladder.txt final.json progress.json \
         ckpt/promotions.jsonl prove.log; do
    [ -f "$out/$f" ] && cp "$out/$f" "$keep/"
done
: > "$keep/summaries.jsonl"
for f in "$out"/*.log; do
    [ -f "$f" ] || continue
    name=$(basename "$f" .log)
    gzip -c "$f" > "$keep/$name.log.gz"
    grep -o 'summary {.*' "$f" |
        sed "s/^summary {/{\"process\": \"$name\", /" >> "$keep/summaries.jsonl"
done
[ -f "$out/server.log" ] && grep -E 'resumed from|resumed [0-9]+ records|server up on|new client|training on mesh|queued candidate|PROMOTE eval|rejected eval|promoted to selfplay|promotions reached' \
    "$out/server.log" > "$keep/server_events.txt"
for f in status_curve.jsonl eval_ladder.txt final.json promotions.jsonl \
         summaries.jsonl server_events.txt; do
    [ -f "$keep/$f" ] && cp "$keep/$f" runs/prod13/
done
[ "$mode" = verdict ] || python tools/run_carry.py pack "$out" "$keep/carry.tar"
exit $rc
