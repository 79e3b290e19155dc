"""Game-record wire types: counterpart of `elf_tpu/selfplay/records.py`, with
the same JSON (reference `record.h`): a Record from either package loads
in the other.

  MsgRequest  { vers: {black_ver, white_ver[, mcts_opt]}, client_ctrl }
  MsgResult   { reward, content (moves as compact SGF string), policies,
                values, using_models, num_move, ... }
  Record      { request, result, timestamp, thread_id, seq, pri, offline }
  Records     { identity, states: {thread_id: ThreadState}, records: [...] }

`ModelPair.mcts_opt` is a `TSOptions` (tree_search_options.h:77), through
which the server drives each job's search; `MsgRequestSeq` sequences the
server's replies.  MCTS policies are quantized to 8 bits per coordinate
like the reference (`go_state_ext.h:172` CoordRecord: prob / max * 255).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from elf_tpu_torch.native.sgf_codec import moves_to_sgf_string


@dataclasses.dataclass
class TSOptions:
    """MCTS options on the wire (tree_search_options.h:77 TSOptions).

    Reference JSON field names, including the num_threads x
    rollouts_per_thread split (our array MCTS runs their product as one
    lockstep budget) and the nested alg_opt {c_puct}.  Shipping these
    inside ModelPair lets the SERVER drive rollout counts / noise / puct
    per job — eval games are noise-free because the server says so
    (ctrl_eval.h:233), not by client-side hardcoding."""

    num_threads: int = 16
    num_rollouts_per_thread: int = 100
    num_rollouts_per_batch: int = 8
    persistent_tree: bool = False
    root_epsilon: float = 0.0
    root_alpha: float = 0.03
    virtual_loss: int = 0
    pick_method: str = "most_visited"
    c_puct: float = 1.5           # alg_opt.c_puct (tree_search_options.h:23)
    use_prior: bool = True        # alg_opt.use_prior (:24)
    unexplored_q_zero: bool = False        # alg_opt (:26) FPU-off switches
    root_unexplored_q_zero: bool = False   # alg_opt (:27)

    @property
    def total_rollouts(self) -> int:
        return self.num_threads * self.num_rollouts_per_thread

    @classmethod
    def from_search_options(cls, mo) -> "TSOptions":
        """Build the wire TSOptions from a config `MCTSOptions` dataclass —
        how the production server turns its --num_rollouts/--c_puct/...
        flags into the per-request options it drives the fleet with
        (model_pair.h:10; the reference builds TSOptions from the same
        flag set in context_utils.py:89)."""
        return cls(
            num_threads=1,
            num_rollouts_per_thread=int(mo.num_rollouts),
            num_rollouts_per_batch=int(mo.rollouts_per_batch),
            persistent_tree=bool(mo.persistent_tree),
            root_epsilon=float(mo.root_epsilon),
            root_alpha=float(mo.root_alpha),
            virtual_loss=int(mo.virtual_loss),
            pick_method=str(mo.pick_method),
            c_puct=float(mo.c_puct),
            use_prior=bool(mo.use_prior),
            unexplored_q_zero=bool(mo.unexplored_q_zero),
            root_unexplored_q_zero=bool(mo.root_unexplored_q_zero),
        )

    def noise_free(self) -> "TSOptions":
        """The eval variant (ctrl_eval.h:234-236)."""
        return dataclasses.replace(self, root_epsilon=0.0, root_alpha=0.0)

    def as_mcts_kwargs(self) -> Dict[str, Any]:
        """kwargs for dataclasses.replace on a search MCTSConfig."""
        return dict(
            num_rollouts=self.total_rollouts,
            rollouts_per_batch=self.num_rollouts_per_batch,
            c_puct=self.c_puct,
            virtual_loss=self.virtual_loss,
            root_epsilon=self.root_epsilon,
            root_alpha=self.root_alpha,
            pick_method=self.pick_method,
            use_prior=self.use_prior,
            unexplored_q_zero=self.unexplored_q_zero,
            root_unexplored_q_zero=self.root_unexplored_q_zero,
        )

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        del d["c_puct"]
        del d["use_prior"]
        del d["unexplored_q_zero"]
        del d["root_unexplored_q_zero"]
        d["alg_opt"] = {
            "c_puct": self.c_puct,
            "use_prior": self.use_prior,
            "unexplored_q_zero": self.unexplored_q_zero,
            "root_unexplored_q_zero": self.root_unexplored_q_zero,
        }
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TSOptions":
        base = cls()
        alg = d.get("alg_opt", {})
        return cls(
            int(d.get("num_threads", base.num_threads)),
            int(d.get("num_rollouts_per_thread",
                      base.num_rollouts_per_thread)),
            int(d.get("num_rollouts_per_batch", base.num_rollouts_per_batch)),
            bool(d.get("persistent_tree", base.persistent_tree)),
            float(d.get("root_epsilon", base.root_epsilon)),
            float(d.get("root_alpha", base.root_alpha)),
            int(d.get("virtual_loss", base.virtual_loss)),
            str(d.get("pick_method", base.pick_method)),
            float(alg.get("c_puct", base.c_puct)),
            bool(alg.get("use_prior", base.use_prior)),
            bool(alg.get("unexplored_q_zero", base.unexplored_q_zero)),
            bool(alg.get("root_unexplored_q_zero",
                         base.root_unexplored_q_zero)),
        )


@dataclasses.dataclass
class ModelPair:
    """(black_ver, white_ver, mcts_opt); -1 white = selfplay
    (model_pair.h:7-10)."""

    black_ver: int = -1
    white_ver: int = -1
    mcts_opt: Optional[TSOptions] = None

    def wait(self) -> bool:
        return self.black_ver < 0

    def is_selfplay(self) -> bool:
        return self.black_ver >= 0 and self.white_ver == -1

    def to_json(self) -> Dict[str, Any]:
        d = {"black_ver": self.black_ver, "white_ver": self.white_ver}
        if self.mcts_opt is not None:
            d["mcts_opt"] = self.mcts_opt.to_json()
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ModelPair":
        mo = d.get("mcts_opt")
        return cls(
            int(d.get("black_ver", -1)),
            int(d.get("white_ver", -1)),
            TSOptions.from_json(mo) if mo is not None else None,
        )


@dataclasses.dataclass
class ClientCtrl:
    """record.h:31."""

    resign_thres: float = 0.05
    never_resign_prob: float = 0.1
    player_swap: bool = False
    async_mode: bool = False
    num_game_thread_used: int = -1

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ClientCtrl":
        return cls(
            float(d.get("resign_thres", 0.05)),
            float(d.get("never_resign_prob", 0.1)),
            bool(d.get("player_swap", False)),
            bool(d.get("async_mode", False)),
            int(d.get("num_game_thread_used", -1)),
        )


@dataclasses.dataclass
class MsgRequest:
    """record.h:115."""

    vers: ModelPair = dataclasses.field(default_factory=ModelPair)
    client_ctrl: ClientCtrl = dataclasses.field(default_factory=ClientCtrl)

    def to_json(self) -> Dict[str, Any]:
        return {"vers": self.vers.to_json(),
                "client_ctrl": self.client_ctrl.to_json()}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "MsgRequest":
        return cls(ModelPair.from_json(d.get("vers", {})),
                   ClientCtrl.from_json(d.get("client_ctrl", {})))


@dataclasses.dataclass
class MsgRequestSeq:
    """record.h:152: a sequenced request so clients detect stale/changed
    replies (the server increments per-client seq on every reply)."""

    seq: int = -1
    request: MsgRequest = dataclasses.field(default_factory=MsgRequest)

    def to_json(self) -> Dict[str, Any]:
        return {"seq": self.seq, "request": self.request.to_json()}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "MsgRequestSeq":
        return cls(
            int(d.get("seq", -1)),
            MsgRequest.from_json(d.get("request", {})),
        )


def quantize_policy(pi: Optional[np.ndarray]) -> Dict[str, List[int]]:
    """8-bit policy quantization (go_state_ext.h:172-194): prob/max*255,
    stored sparsely as {idx, q}.  None (a ply whose distribution was not
    recorded) becomes the empty CoordRecord."""
    if pi is None:
        return {"idx": [], "q": []}
    mx = float(pi.max()) if pi.size else 0.0
    if mx <= 0:
        return {"idx": [], "q": []}
    q = np.round(pi / mx * 255.0).astype(np.int32)
    nz = np.nonzero(q)[0]
    return {"idx": nz.tolist(), "q": q[nz].tolist()}


def dequantize_policy(d: Dict[str, List[int]], num_actions: int) -> np.ndarray:
    pi = np.zeros((num_actions,), np.float32)
    idx = np.asarray(d.get("idx", []), np.int64)
    qv = np.asarray(d.get("q", []), np.float32)
    if idx.size:
        pi[idx] = qv
        s = pi.sum()
        if s > 0:
            pi /= s
    return pi


@dataclasses.dataclass
class MsgResult:
    """record.h:184, plus the start-position fields of the JAX package
    (first_player, setup_black, setup_white) for handicap games."""

    reward: float = 0.0
    content: str = ""
    policies: List[Dict[str, List[int]]] = dataclasses.field(default_factory=list)
    values: List[float] = dataclasses.field(default_factory=list)
    using_models: List[int] = dataclasses.field(default_factory=list)
    num_move: int = 0
    black_never_resign: bool = False
    white_never_resign: bool = False
    first_player: int = 1
    setup_black: List[int] = dataclasses.field(default_factory=list)
    setup_white: List[int] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "MsgResult":
        return cls(
            float(d.get("reward", 0.0)),
            d.get("content", ""),
            list(d.get("policies", [])),
            [float(v) for v in d.get("values", [])],
            [int(v) for v in d.get("using_models", [])],
            int(d.get("num_move", 0)),
            bool(d.get("black_never_resign", False)),
            bool(d.get("white_never_resign", False)),
            int(d.get("first_player", 1)),
            [int(v) for v in d.get("setup_black", [])],
            [int(v) for v in d.get("setup_white", [])],
        )


@dataclasses.dataclass
class Record:
    """record.h:252."""

    request: MsgRequest = dataclasses.field(default_factory=MsgRequest)
    result: MsgResult = dataclasses.field(default_factory=MsgResult)
    timestamp: float = 0.0
    thread_id: int = 0
    seq: int = 0
    pri: float = 0.0
    offline: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "request": self.request.to_json(),
            "result": self.result.to_json(),
            "timestamp": self.timestamp,
            "thread_id": self.thread_id,
            "seq": self.seq,
            "pri": self.pri,
            "offline": self.offline,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Record":
        return cls(
            MsgRequest.from_json(d.get("request", {})),
            MsgResult.from_json(d.get("result", {})),
            float(d.get("timestamp", 0.0)),
            int(d.get("thread_id", 0)),
            int(d.get("seq", 0)),
            float(d.get("pri", 0.0)),
            bool(d.get("offline", False)),
        )

    @property
    def black_win(self) -> bool:
        return self.result.reward > 0


@dataclasses.dataclass
class ThreadState:
    """record.h:354."""

    thread_id: int = -1
    seq: int = 0
    move_idx: int = 0
    black: int = -1
    white: int = -1

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ThreadState":
        return cls(
            int(d.get("thread_id", -1)),
            int(d.get("seq", 0)),
            int(d.get("move_idx", 0)),
            int(d.get("black", -1)),
            int(d.get("white", -1)),
        )


@dataclasses.dataclass
class Records:
    """Batch of records from one client (record.h:401)."""

    identity: str = ""
    states: Dict[int, ThreadState] = dataclasses.field(default_factory=dict)
    records: List[Record] = dataclasses.field(default_factory=list)

    def to_json_string(self) -> str:
        return json.dumps(
            {
                "identity": self.identity,
                "states": {str(k): v.to_json() for k, v in self.states.items()},
                "records": [r.to_json() for r in self.records],
            }
        )

    @classmethod
    def from_json_string(cls, s: str) -> "Records":
        d = json.loads(s)
        return cls(
            d.get("identity", ""),
            {
                int(k): ThreadState.from_json(v)
                for k, v in d.get("states", {}).items()
            },
            [Record.from_json(r) for r in d.get("records", [])],
        )


def make_record(
    moves: List[int],
    reward: float,
    policies: List[Optional[np.ndarray]],
    values: List[float],
    size: int,
    request: Optional[MsgRequest] = None,
    thread_id: int = 0,
    seq: int = 0,
    never_resign: bool = False,
    using_models=None,
    first_player: int = 1,
    setup_black=None,
    setup_white=None,
) -> Record:
    return Record(
        request=request or MsgRequest(),
        result=MsgResult(
            reward=reward,
            content=moves_to_sgf_string(moves, size),
            policies=[quantize_policy(p) for p in policies],
            values=list(values),
            num_move=len(moves),
            black_never_resign=never_resign,
            white_never_resign=never_resign,
            using_models=list(using_models or []),
            first_player=int(first_player),
            setup_black=list(setup_black or []),
            setup_white=list(setup_white or []),
        ),
        timestamp=time.time(),
        thread_id=thread_id,
        seq=seq,
    )
