"""Typed option system: the port's copy of `elf_tpu/config.py` (same
option groups, fields, types, defaults and help text; reference
`OptionSpec.h:222`, `OptionMap.h:48`, `py_option_spec.py`).

Options are plain dataclasses.  `OptionSpec.from_dataclasses` merges
several components' option groups (name collisions must agree on type and
default, as in OptionSpec::merge) and renders one argparse parser; `parse`
returns an `OptionMap` that instantiates any registered dataclass, with a
prefix/suffix for multi-model indexing (`--load0/--load1`,
model_loader.py:72).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Type, get_type_hints


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


class OptionSpec:
    """Merged registry of option dataclasses -> one argparse parser."""

    def __init__(self) -> None:
        self._classes: List[Type] = []
        self._fields: Dict[str, dataclasses.Field] = {}
        self._types: Dict[str, Any] = {}

    @classmethod
    def from_dataclasses(cls, classes: Sequence[Type]) -> "OptionSpec":
        spec = cls()
        for c in classes:
            spec.merge(c)
        return spec

    def merge(self, c: Type) -> None:
        """Add a component's options; collisions must agree (OptionSpec::merge)."""
        hints = get_type_hints(c)
        for f in dataclasses.fields(c):
            t = hints[f.name]
            if f.name in self._fields:
                prev = self._fields[f.name]
                prev_default = _field_default(prev)
                if self._types[f.name] != t or prev_default != _field_default(f):
                    raise ValueError(
                        f"option collision on '{f.name}': "
                        f"{self._types[f.name]}/{prev_default} vs {t}/{_field_default(f)}"
                    )
                continue
            self._fields[f.name] = f
            self._types[f.name] = t
        self._classes.append(c)

    def to_argparse(self, parser: Optional[argparse.ArgumentParser] = None):
        parser = parser or argparse.ArgumentParser()
        for name, f in self._fields.items():
            t = self._types[name]
            default = _field_default(f)
            help_ = f.metadata.get("help", "") if f.metadata else ""
            flag = "--" + name
            if t is bool:
                parser.add_argument(
                    flag,
                    type=_str2bool,
                    nargs="?",
                    const=True,
                    default=default,
                    help=help_,
                )
            elif t in (list, List[int], List[str], List[float]) or str(t).startswith(
                "typing.List"
            ):
                parser.add_argument(
                    flag, type=str, default=",".join(map(str, default or [])), help=help_
                )
            else:
                parser.add_argument(flag, type=t, default=default, help=help_)
        return parser

    def parse(self, argv: Optional[Sequence[str]] = None) -> "OptionMap":
        args = self.to_argparse().parse_args(argv)
        return OptionMap(self, vars(args))


def _field_default(f: dataclasses.Field) -> Any:
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    return None


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "t", "yes", "y", "on")


class OptionMap:
    """Parsed values; instantiates any registered dataclass (OptionMap::get<T>)."""

    def __init__(self, spec: OptionSpec, values: Dict[str, Any]) -> None:
        self.spec = spec
        self.values = dict(values)

    def get(self, c: Type, prefix: str = "", suffix: str = ""):
        """Build a dataclass instance; `prefix`/`suffix` let several model
        slots share a spec (`--load0`, `--load1`, model_loader.py:72)."""
        hints = get_type_hints(c)
        kwargs = {}
        for f in dataclasses.fields(c):
            key = prefix + f.name + suffix
            if key not in self.values and f.name in self.values:
                key = f.name
            v = self.values.get(key, _field_default(f))
            t = hints[f.name]
            if str(t).startswith("typing.List") and isinstance(v, str):
                inner = t.__args__[0] if getattr(t, "__args__", None) else str
                v = [inner(x) for x in v.split(",") if x != ""]
            kwargs[f.name] = v
        return c(**kwargs)

    def to_json(self) -> str:
        return json.dumps(self.values, sort_keys=True)

    @classmethod
    def from_json(cls, spec: OptionSpec, s: str) -> "OptionMap":
        return cls(spec, json.loads(s))


# ---------------------------------------------------------------------------
# Framework option groups (counterparts of the reference option structs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GameOptions:
    """Go game options (go_game_specific.h `GameOptions`)."""

    board_size: int = opt(19, "board size (9 or 19)")
    komi: float = opt(7.5, "komi (go_game_specific.h:85)")
    model: str = opt(
        "df_kl", "model family (models/registry.py: df_kl AlphaZero / "
        "df_pred supervised — the reference's Models map, df_model3.py:310)"
    )
    num_games: int = opt(1024, "number of lockstep boards per actor shard")
    seed: int = opt(0, "base RNG seed (0 = derive from time at launch site)")
    use_df_feature: bool = opt(False, "25-plane df features instead of AGZ 18")
    handicap_level: int = opt(0, "handicap stones")
    ply_pass_enabled: int = opt(0, "allow pass only after this ply in selfplay")
    policy_distri_cutoff: int = opt(30, "sample (not argmax) policy below this ply")
    policy_distri_training_for_all: bool = opt(False, "train on sampled policy at every ply")
    num_future_actions: int = opt(1, "future actions stored for offline training")
    cheat_eval_new_model_wins_half: bool = opt(
        False, "integration-test mode: decide eval games by version-hash coin flip"
    )
    cheat_selfplay_random_result: bool = opt(
        False, "integration-test mode: random selfplay outcomes"
    )
    dump_record_prefix: str = opt("", "SGF dump prefix")
    num_games_per_thread: int = opt(
        -1, "finish after this many games per board slot (-1 = endless)"
    )
    move_cutoff: int = opt(-1, "end games at this ply with a TT count (-1 = off)")
    preload_sgf: str = opt("", "start games from this SGF prefix")
    preload_sgf_move_to: int = opt(-1, "replay the preload to this move")
    data_aug: int = opt(-1, "fixed D4 aug code for training (-1 = random)")
    following_pass: bool = opt(
        False, "answer an opponent pass with a pass when clearly winning"
    )
    white_puct: float = opt(
        -1.0, "white player's c_puct for its whole search (-1 = same as "
        "black; go_game_specific.h:89)"
    )
    white_num_rollouts: int = opt(
        0, "white player's total rollouts per move (reference: "
        "white_mcts_rollout_per_thread x num_threads; 0 = same as black)"
    )
    use_mcts: bool = opt(True, "search-driven play (false = policy only)")


@dataclasses.dataclass
class MCTSOptions:
    """Tree-search options (tree_search_options.h:77 `TSOptions`)."""

    num_rollouts: int = opt(1600, "rollouts per move (threads x rollouts_per_thread)")
    rollouts_per_batch: int = opt(8, "leaves selected per NN evaluation (virtual-loss batch)")
    max_nodes: int = opt(0, "tree capacity; 0 = num_rollouts + 2")
    c_puct: float = opt(1.5, "PUCT exploration constant (README 1.5 play / 0.85 train)")
    virtual_loss: int = opt(1, "virtual loss added along selected paths")
    root_epsilon: float = opt(0.0, "Dirichlet root-noise weight (0.25 selfplay)")
    root_alpha: float = opt(0.03, "Dirichlet concentration")
    pick_method: str = opt("most_visited", "most_visited | prior | uniform_random")
    use_prior: bool = opt(True, "PUCT prior term enabled")
    unexplored_q_zero: bool = opt(False, "unexplored edges default to Q=0 instead of the parent-mean FPU")
    root_unexplored_q_zero: bool = opt(False, "Q=0 default at the root only")
    persistent_tree: bool = opt(False, "reuse subtree across moves (treeAdvance)")


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


@dataclasses.dataclass
class ControlOptions:
    """Distributed control plane (shared_rw_buffer2.h Options + client_manager)."""

    server_addr: str = opt("127.0.0.1", "control server address")
    port: int = opt(5556, "control server port")
    expected_num_clients: int = opt(1, "fleet size the server waits for")
    client_max_delay_sec: int = opt(1200, "client declared dead after this silence")
    selfplay_init_num: int = opt(200, "games required before first training")
    selfplay_update_num: int = opt(1000, "games per model version")
    selfplay_async: bool = opt(
        False, "async self-play: games continue across model versions"
    )
    eval_num_games: int = opt(400, "games per candidate evaluation")
    eval_num_threads: int = opt(
        -1, "boards an eval client may use (shipped as ClientCtrl."
        "num_game_thread_used, ctrl_eval.h:140; -1 = all)"
    )
    eval_num_rollouts: int = opt(
        -1, "rollout budget for eval games (shipped in the eval job's "
        "mcts_opt; -1 = same as selfplay, 0 = policy-only)"
    )
    eval_winrate_thres: float = opt(0.55, "promotion threshold")
    eval_old_model: int = opt(-1, "baseline version override")
    keep_prev_selfplay: bool = opt(True, "keep replay buffer across promotions")
    resign_thres: float = opt(0.05, "resign when value below this")
    never_resign_prob: float = opt(0.1, "fraction of games that never resign")
    resign_thres_lower_bound: float = opt(1e-9, "dynamic threshold floor")
    resign_thres_upper_bound: float = opt(0.50, "dynamic threshold cap")
    resign_target_fp_rate: float = opt(0.05, "false-positive quantile target")
    resign_target_hist_size: int = opt(2500, "winner-min-value history size")


ALL_OPTION_CLASSES = (
    GameOptions,
    MCTSOptions,
    TrainOptions,
    ReplayOptions,
    ControlOptions,
)
