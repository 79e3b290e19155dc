#!/bin/bash
# Production self-play client of the PyTorch/CUDA port: start_client.sh's
# flags (reference scripts/elfgames/go/start_client.sh:11-29) against
# selfplay_client_torch.py: 1600 lockstep rollouts/move in batches of 8,
# puct 0.85, virtual loss 5, 0.25/0.03 root noise, pass enabled from ply
# 160, diverse sampling below ply 30.  One client plays a [B]-board
# lockstep shard on one card (default B = 1024); run one client per card.
set -euo pipefail
CKPT=${CKPT:-./ckpts}
SERVER=${SERVER:-127.0.0.1}
PORT=${PORT:-5556}
GAMES=${GAMES:-1024}

exec python "$(dirname "$0")/../selfplay_client_torch.py" \
    --ckpt_dir "$CKPT" --server_addr "$SERVER" --port "$PORT" \
    --num_games "$GAMES" \
    --num_block 20 --dim 256 --bf16 1 \
    --num_rollouts 1600 --rollouts_per_batch 8 \
    --c_puct 0.85 --virtual_loss 5 \
    --root_epsilon 0.25 --root_alpha 0.03 \
    --ply_pass_enabled 160 --policy_distri_cutoff 30 \
    "$@"
