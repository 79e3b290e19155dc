#!/bin/bash
# Play-strength GTP engine of the PyTorch/CUDA port: gtp.sh's flags
# (reference README.rst:147) against gtp_console_torch.py: 20b256c, puct
# 1.5, 16384 rollouts/move, resign 0.05, persistent trees.
set -euo pipefail
MODEL=${MODEL:?set MODEL=/path/to/save-N.bin}

exec python "$(dirname "$0")/../gtp_console_torch.py" \
    --load "$MODEL" \
    --num_block 20 --dim 256 \
    --num_rollouts 16384 --rollouts_per_batch 16 \
    --c_puct 1.5 --resign_thres 0.05 --persistent_tree 1 \
    "$@"
