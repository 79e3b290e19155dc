#!/bin/bash
# Production training server of the PyTorch/CUDA port: start_server.sh's
# flags (reference scripts/elfgames/go/start_server.sh:10-33) against
# train_server_torch.py: batchsize 2048, 20b256c, SGD 0.01 momentum 0.9,
# weight decay 2e-4, bn_momentum 0 + 50 cooldown passes, replay q_min 200 /
# q_max 4000, 400-game evals promoting at 55%, 496-client fleet, selfplay
# async.
#
# --use_mesh 1 (the default) spans all local cards, one rank each (tp = 2
# when their number is even); across hosts, run one process per card with
# --dist_coordinator HOST:PORT --dist_num_processes N --dist_process_id I.
# The batch of 2048 needs the activation memory of several cards (one
# H100 holds batch 256 at 13.2 GiB without block remat).
set -euo pipefail
CKPT=${CKPT:-./ckpts}
PORT=${PORT:-5556}

exec python "$(dirname "$0")/../train_server_torch.py" \
    --ckpt_dir "$CKPT" --port "$PORT" \
    --batchsize 2048 --num_minibatch 1000 \
    --num_block 20 --dim 256 \
    --lr 0.01 --momentum 0.9 --weight_decay 0.0002 \
    --bn_momentum 0 --num_cooldown 50 \
    --q_min_size 200 --q_max_size 4000 \
    --eval_num_games 400 --eval_winrate_thres 0.55 \
    --expected_num_clients 496 \
    --selfplay_init_num 5000 --selfplay_update_num 1000 \
    --selfplay_async 1 --keep_prev_selfplay 1 \
    --num_rollouts 1600 --rollouts_per_batch 8 \
    --c_puct 0.85 --virtual_loss 5 \
    --root_epsilon 0.25 --root_alpha 0.03 \
    --resign_thres 0.01 \
    "$@"
