"""Option groups of the learner: the port's copy of the parts of
`elf_tpu/config.py` it uses (`opt`, `TrainOptions`, `ReplayOptions`, same
fields and defaults).  The other option groups and the `OptionSpec`
argparse registry come with the control plane.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence


def opt(default: Any, help: str = "", aliases: Sequence[str] = ()) -> Any:
    """Declare a documented option field in an options dataclass."""
    if isinstance(default, (list, dict)):
        return dataclasses.field(
            default_factory=lambda: json.loads(json.dumps(default)),
            metadata={"help": help, "aliases": tuple(aliases)},
        )
    return dataclasses.field(
        default=default, metadata={"help": help, "aliases": tuple(aliases)}
    )


@dataclasses.dataclass
class TrainOptions:
    """Learner options (rlpytorch model_interface / start_server.sh)."""

    batchsize: int = opt(2048, "train batch size")
    lr: float = opt(0.01, "SGD learning rate")
    momentum: float = opt(0.9, "SGD momentum")
    weight_decay: float = opt(2e-4, "L2 weight decay")
    opt_method: str = opt("sgd", "sgd | adam")
    adam_eps: float = opt(1e-3, "adam epsilon")
    bn_momentum: float = opt(0.0, "batch-norm running-stat momentum")
    num_block: int = opt(20, "ResNet blocks")
    dim: int = opt(256, "ResNet channels")
    num_cooldown: int = opt(50, "BN re-estimation passes before checkpointing")
    value_loss_weight: float = opt(1.0, "scale on the value MSE term "
                                        "(1.0 = reference parity)")
    use_data_parallel: bool = opt(True, "shard batch over the device mesh")
    grad_clip_norm: float = opt(0.0, "0 = no clipping")
    bf16: bool = opt(True, "bfloat16 compute policy")


@dataclasses.dataclass
class ReplayOptions:
    """Replay buffer (shared_reader.h `RQCtrl`, go_game_specific.h:81)."""

    num_reader: int = opt(50, "number of replay shards (parity-balanced)")
    q_min_size: int = opt(10, "min records per shard before sampling")
    q_max_size: int = opt(1000, "max records per shard (FIFO eviction)")
