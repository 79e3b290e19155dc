"""Client fleet bookkeeping: identities, liveness, role allocation.

The port's copy of `elf_tpu/control/client_manager.py`, same behaviour.

Counterpart of the reference's `src_cpp/elfgames/go/train/client_manager.{h,cc}`:
 - per-client `ThreadState` tracking and last-seen timestamps;
 - IsStuck / dead-after-`max_delay_sec` (client_manager.h:69, default 1200 s)
   with ALIVE2DEAD / DEAD2ALIVE transitions re-allocating the role;
 - role allocation: the first `expected * (1 - selfplay_only_ratio)` clients
   are EVAL_THEN_SELFPLAY, the rest SELFPLAY_ONLY (client_manager.h:215).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Dict, List, Optional

from elf_tpu_torch.logging_utils import get_indexed_logger
from elf_tpu_torch.selfplay.records import ThreadState


class ClientType(enum.Enum):
    SELFPLAY_ONLY = "selfplay_only"
    EVAL_THEN_SELFPLAY = "eval_then_selfplay"


class ClientChange(enum.Enum):
    ALIVE2DEAD = "alive2dead"
    DEAD2ALIVE = "dead2alive"
    ALIVE = "alive"
    DEAD = "dead"


class ClientInfo:
    def __init__(self, identity: str, ctype: ClientType, max_delay_sec: float):
        self.identity = identity
        self.type = ctype
        self.max_delay_sec = max_delay_sec
        self.last_update = time.time()
        self.active = True
        self.seq = 0
        self.threads: Dict[int, ThreadState] = {}

    def touch(self) -> ClientChange:
        was_active = self.active
        self.last_update = time.time()
        self.active = True
        return ClientChange.DEAD2ALIVE if not was_active else ClientChange.ALIVE

    def is_stuck(self, now: Optional[float] = None) -> bool:
        now = now if now is not None else time.time()
        return now - self.last_update > self.max_delay_sec

    def update_states(self, states: Dict[int, ThreadState]) -> None:
        self.threads.update(states)


class ClientManager:
    def __init__(
        self,
        expected_num_clients: int,
        max_delay_sec: float = 1200.0,
        selfplay_only_ratio: float = 0.5,
    ):
        self.expected = expected_num_clients
        self.max_delay_sec = max_delay_sec
        self.selfplay_only_ratio = selfplay_only_ratio
        self.clients: Dict[str, ClientInfo] = {}
        self.lock = threading.Lock()
        self.logger = get_indexed_logger("control.ClientManager-")

    def _alloc_type(self) -> ClientType:
        """First (1 - ratio) * expected clients do eval duty
        (client_manager.h:215 alloc_type)."""
        n_eval = int(self.expected * (1.0 - self.selfplay_only_ratio))
        n_current_eval = sum(
            1 for c in self.clients.values()
            if c.type == ClientType.EVAL_THEN_SELFPLAY
        )
        return (
            ClientType.EVAL_THEN_SELFPLAY
            if n_current_eval < n_eval
            else ClientType.SELFPLAY_ONLY
        )

    def on_message(
        self, identity: str, states: Optional[Dict[int, ThreadState]] = None
    ) -> ClientInfo:
        with self.lock:
            c = self.clients.get(identity)
            if c is None:
                c = ClientInfo(identity, self._alloc_type(), self.max_delay_sec)
                self.clients[identity] = c
                self.logger.info(
                    "new client %s as %s (%d/%d)",
                    identity, c.type.value, len(self.clients), self.expected,
                )
            change = c.touch()
            if change == ClientChange.DEAD2ALIVE:
                self.logger.info("client %s back alive", identity)
            if states:
                c.update_states(states)
            return c

    def get(self, identity: str) -> Optional[ClientInfo]:
        with self.lock:
            return self.clients.get(identity)

    def sweep_dead(self) -> List[str]:
        """Mark stuck clients dead; returns newly-dead identities."""
        now = time.time()
        newly_dead = []
        with self.lock:
            for c in self.clients.values():
                if c.active and c.is_stuck(now):
                    c.active = False
                    newly_dead.append(c.identity)
        for ident in newly_dead:
            self.logger.warning("client %s declared dead", ident)
        return newly_dead

    def num_alive(self) -> int:
        with self.lock:
            return sum(1 for c in self.clients.values() if c.active)

    def info(self) -> str:
        with self.lock:
            n = len(self.clients)
            alive = sum(1 for c in self.clients.values() if c.active)
            n_eval = sum(
                1 for c in self.clients.values()
                if c.type == ClientType.EVAL_THEN_SELFPLAY
            )
        return (
            f"ClientManager: {alive}/{n} alive (expected {self.expected}), "
            f"{n_eval} eval-capable"
        )
