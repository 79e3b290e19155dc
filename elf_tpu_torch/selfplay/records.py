"""Game-record wire types: counterpart of `elf_tpu/selfplay/records.py`, with
the same JSON (reference `record.h`): a Record from either package loads
in the other.

  MsgRequest  { vers: {black_ver, white_ver[, mcts_opt]}, client_ctrl }
  MsgResult   { reward, content (moves as compact SGF string), policies,
                values, using_models, num_move, ... }
  Record      { request, result, timestamp, thread_id, seq, pri, offline }

MCTS policies are quantized to 8 bits per coordinate like the reference
(`go_state_ext.h:172` CoordRecord: prob / max * 255).  The control-plane
side of ModelPair / ClientCtrl (TSOptions and its conversions) is not
ported yet: `mcts_opt` travels as its raw JSON dict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from elf_tpu_torch.env.go.coords import moves_to_sgf_string


@dataclasses.dataclass
class ModelPair:
    """(black_ver, white_ver, mcts_opt); -1 white = selfplay
    (model_pair.h:7-10)."""

    black_ver: int = -1
    white_ver: int = -1
    mcts_opt: Optional[Dict[str, Any]] = None

    def is_selfplay(self) -> bool:
        return self.black_ver >= 0 and self.white_ver == -1

    def to_json(self) -> Dict[str, Any]:
        d = {"black_ver": self.black_ver, "white_ver": self.white_ver}
        if self.mcts_opt is not None:
            d["mcts_opt"] = self.mcts_opt
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ModelPair":
        return cls(int(d.get("black_ver", -1)), int(d.get("white_ver", -1)),
                   d.get("mcts_opt"))


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
