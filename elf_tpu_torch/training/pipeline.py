"""Training-batch assembly: records -> feature batches on the device.
Counterpart of `elf_tpu/training/pipeline.py` (reference
`game_train.cc:23` GoGameTrain::act + GoStateExtOffline): sample records
with outcome parity, replay each to a uniformly random ply, apply a random
D4 augmentation, and emit the `train` batch (s, mcts_scores, winner).

A game is replayed once, when its record is inserted, by the C replayer
into per-ply board snapshots, so per-step batch assembly is gathering on
the host (numpy) plus one feature extraction on the device
(`extract_agz_from_snapshots`).  The policy target is re-indexed under the
same D4 code on the device (`features.transform_policy` == extractMCTSPi,
game_feature.h:107).  The host draws (records, codes, one ply per item)
come in the JAX package's order, so equal seeds give equal batches.

With `feature_set="df"` a batch also carries each position's board, ko
point, ply and placement plies, from which the device builds the 25 df
planes (`extract_df_parts`).

While tracing is on (`profiling`), sampling records the span
`elf.pipeline.sample` and the feature extraction `elf.pipeline.features`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from elf_tpu_torch.device import DeviceLike, resolve_device
from elf_tpu_torch.env.go.features import (
    extract_agz_from_snapshots,
    extract_df_parts,
    transform_action,
    transform_policy,
)
from elf_tpu_torch.env.go.state import MAX_AGZ_HISTORY
from elf_tpu_torch.native.replayer import replay_to_snapshots
from elf_tpu_torch.native.sgf_codec import sgf_string_to_moves
from elf_tpu_torch.profiling import span
from elf_tpu_torch.selfplay.records import Record, dequantize_policy
from elf_tpu_torch.training.replay import ReplayBuffer


class ReplayItem:
    """A record + its precomputed per-ply board snapshots."""

    __slots__ = ("record", "snapshots", "moves", "first_player",
                 "setup_board")

    def __init__(self, record: Record, size: int):
        self.record = record
        self.moves = sgf_string_to_moves(record.result.content, size)
        # the real mover colors come from the record (handicap games start
        # with white; go_state_ext.h:259 fromRecord replays a full GoState)
        self.first_player = int(record.result.first_player) or 1
        self.snapshots = replay_to_snapshots(
            self.moves, size, self.first_player,
            record.result.setup_black, record.result.setup_white,
        )  # [L, n2] i8
        self.setup_board = np.zeros((size * size,), np.int8)
        self.setup_board[record.result.setup_black] = 1
        self.setup_board[record.result.setup_white] = 2

    def board_at(self, ply: int) -> np.ndarray:
        """Board AFTER `ply` moves (the setup board at ply 0)."""
        return self.snapshots[ply - 1] if ply > 0 else self.setup_board

    def last_placed_at(self, ply: int, n2: int) -> np.ndarray:
        """Per-point 1-based placement ply at position `ply`
        (board.cc _infos[].last_placed; handicap stones stamp 1,
        board.cc:1379).  Later placements overwrite earlier ones; points
        later emptied by capture are masked by the board itself."""
        lp = np.zeros((n2,), np.int32)
        lp[self.setup_board != 0] = 1
        for k in range(min(ply, len(self.moves))):
            m = self.moves[k]
            if m < n2:
                lp[m] = k + 1
        return lp

    def ko_at(self, ply: int, size: int) -> int:
        """Simple-ko point active at position `ply`, or -1 (board.cc:1384
        semantics: the previous move captured exactly one stone with a
        lone stone that has exactly one liberty)."""
        if ply < 1:
            return -1
        n2 = size * size
        m = self.moves[ply - 1]
        if m >= n2:
            return -1
        prev = self.board_at(ply - 1)
        cur = self.board_at(ply)
        color = cur[m]
        if color == 0:
            return -1
        captured = np.nonzero((prev == 3 - color) & (cur == 0))[0]
        if captured.size != 1:
            return -1
        r, c = m // size, m % size
        nbrs = []
        if r > 0:
            nbrs.append(m - size)
        if r < size - 1:
            nbrs.append(m + size)
        if c > 0:
            nbrs.append(m - 1)
        if c < size - 1:
            nbrs.append(m + 1)
        if any(cur[q] == color for q in nbrs):
            return -1  # not a lone stone
        if sum(1 for q in nbrs if cur[q] == 0) != 1:
            return -1  # not exactly one liberty
        return int(captured[0])

    def to_play_at(self, ply: int) -> int:
        """Mover color at `ply` (colors strictly alternate from
        first_player; a pass is a move)."""
        return self.first_player if ply % 2 == 0 else 3 - self.first_player

    @property
    def black_win(self) -> bool:
        return self.record.result.reward > 0


class HostBatch(NamedTuple):
    snaps: np.ndarray     # i8 [B, 8, n2]
    valid: np.ndarray     # bool [B, 8]
    to_play: np.ndarray   # i8 [B]
    codes: np.ndarray     # i32 [B]
    pi_target: np.ndarray # f32 [B, A]
    winner: np.ndarray    # f32 [B]
    selfplay_ver: np.ndarray  # i64 [B] per-sample record version
    #                           (game_feature.h training field selfplay_ver)
    offline_a: np.ndarray  # i32 [B, T] future actions at ply..ply+T-1
    #                        (game_feature.h `offline_a`, T =
    #                        num_future_actions; pass-padded past game end)
    # df-25 inputs (only when feature_set == "df"):
    stones: Optional[np.ndarray] = None       # i8 [B, n2] current board
    ko_point: Optional[np.ndarray] = None     # i32 [B] (-1 = none)
    ply: Optional[np.ndarray] = None          # i32 [B]
    last_placed: Optional[np.ndarray] = None  # i32 [B, n2]


class TrainingPipeline:
    def __init__(self, replay: ReplayBuffer, size: int, seed: int = 0,
                 data_aug: int = -1, num_future_actions: int = 1,
                 feature_set: str = "agz"):
        """data_aug: fixed D4 code for training augmentation, or -1 for a
        random code per sample (go_game_specific.h:46).
        num_future_actions: horizons in the `offline_a` target
        (go_game_specific.h num_future_actions; the multi-horizon
        supervised target of MultiplePrediction, multiple_prediction.py:30).
        feature_set: "agz" (18-plane snapshots) or "df" (25 planes of
        liberties, ko and placement history, board_feature.h:18-37: the
        --use_df_feature path)."""
        if feature_set not in ("agz", "df"):
            raise ValueError(f"feature_set={feature_set!r}")
        self.replay = replay
        self.size = size
        self.n2 = size * size
        self.A = self.n2 + 1
        self.data_aug = data_aug
        self.num_future_actions = max(1, num_future_actions)
        self.feature_set = feature_set
        self.rng = np.random.RandomState(seed)

    def insert_record(self, record: Record) -> None:
        self.replay.insert(ReplayItem(record, self.size))

    def sample_host_batch(self, batch_size: int) -> Optional[HostBatch]:
        with span("elf.pipeline.sample"):
            items = self.replay.sample_many(batch_size)
            if len(items) < batch_size:
                return None
            n2, A, H = self.n2, self.A, MAX_AGZ_HISTORY
            snaps = np.zeros((batch_size, H, n2), np.int8)
            valid = np.zeros((batch_size, H), bool)
            to_play = np.zeros((batch_size,), np.int8)
            if self.data_aug >= 0:
                codes = np.full(batch_size, self.data_aug % 8, np.int32)
            else:
                codes = self.rng.randint(0, 8, size=batch_size).astype(
                    np.int32)
            pi = np.zeros((batch_size, A), np.float32)
            winner = np.zeros((batch_size,), np.float32)
            selfplay_ver = np.zeros((batch_size,), np.int64)
            T = self.num_future_actions
            offline_a = np.full((batch_size, T), n2, np.int32)  # pass-padded
            df = self._df_fields(batch_size)
            for i, item in enumerate(items):
                selfplay_ver[i] = item.record.request.vers.black_ver
                L = len(item.moves)
                if L == 0:
                    valid[i] = False
                    to_play[i] = item.first_player
                    pi[i, n2] = 1.0
                    winner[i] = 1.0 if item.black_win else -1.0
                    if df:
                        df["stones"][i] = item.setup_board
                        df["last_placed"][i] = item.last_placed_at(0, n2)
                    continue
                # position after `ply` moves; predict the move made at `ply`
                # (game_train.cc switchRandomMove)
                ply = int(self.rng.randint(L))
                # snapshots ending at the position (oldest first)
                n_avail = min(ply, H)
                for j in range(n_avail):
                    snaps[i, H - 1 - j] = item.snapshots[ply - 1 - j]
                    valid[i, H - 1 - j] = True
                to_play[i] = item.to_play_at(ply)
                if df:
                    df["stones"][i] = item.board_at(ply)
                    df["ko_point"][i] = item.ko_at(ply, self.size)
                    df["ply"][i] = ply
                    df["last_placed"][i] = item.last_placed_at(ply, n2)
                pols = item.record.result.policies
                if ply < len(pols) and (pols[ply].get("idx") or []):
                    pi[i] = dequantize_policy(pols[ply], A)
                else:
                    pi[i, item.moves[ply]] = 1.0
                winner[i] = 1.0 if item.black_win else -1.0
                for k in range(min(T, L - ply)):
                    offline_a[i, k] = item.moves[ply + k]
            return HostBatch(snaps, valid, to_play, codes, pi, winner,
                             selfplay_ver, offline_a, **df)

    def _df_fields(self, batch_size: int) -> dict:
        """The df inputs of a batch, empty; {} for the AGZ planes."""
        if self.feature_set != "df":
            return {}
        n2 = self.n2
        return dict(stones=np.zeros((batch_size, n2), np.int8),
                    ko_point=np.full((batch_size,), -1, np.int32),
                    ply=np.zeros((batch_size,), np.int32),
                    last_placed=np.zeros((batch_size, n2), np.int32))

    def zero_host_batch(self, batch_size: int) -> HostBatch:
        """Shape/dtype template of sample_host_batch's output (what the
        non-source processes of a multi-process learner receive into)."""
        n2, A, H = self.n2, self.A, MAX_AGZ_HISTORY
        T = self.num_future_actions
        return HostBatch(
            np.zeros((batch_size, H, n2), np.int8),
            np.zeros((batch_size, H), bool),
            np.zeros((batch_size,), np.int8),
            np.zeros((batch_size,), np.int32),
            np.zeros((batch_size, A), np.float32),
            np.zeros((batch_size,), np.float32),
            np.zeros((batch_size,), np.int64),
            np.full((batch_size, T), n2, np.int32),
            **self._df_fields(batch_size),
        )

    def _features(self, hb: HostBatch, dev: torch.device):
        """(AGZ or df planes, D4 codes) of a host batch, on `dev`."""
        with span("elf.pipeline.features"):
            to = lambda a: torch.from_numpy(a).to(dev)
            codes = to(hb.codes)
            if self.feature_set == "df":
                ko_point = to(hb.ko_point)
                feats = extract_df_parts(
                    to(hb.stones), to(hb.to_play), ko_point, ko_point >= 0,
                    to(hb.ply), to(hb.last_placed), codes, self.size)
            else:
                feats = extract_agz_from_snapshots(
                    to(hb.snaps), to(hb.valid), to(hb.to_play), codes,
                    self.size)
            return feats, codes

    def device_batch(self, hb: HostBatch, device: DeviceLike = "cuda"):
        """(features [B, N, N, 18 | 25], pi_target [B, A] under the batch's
        D4 codes, winner [B]) on `device`."""
        dev = resolve_device(device)
        with torch.no_grad():
            feats, codes = self._features(hb, dev)
            pi_t = transform_policy(torch.from_numpy(hb.pi_target).to(dev),
                                    codes, self.size)
        return feats, pi_t, torch.from_numpy(hb.winner).to(dev)

    def device_batch_offline(self, hb: HostBatch,
                             device: DeviceLike = "cuda"):
        """Supervised multi-horizon variant: (features, offline_a [B, T]
        under the D4 codes, winner), the MultiplePrediction target set."""
        dev = resolve_device(device)
        with torch.no_grad():
            feats, codes = self._features(hb, dev)
            B, T = hb.offline_a.shape
            offline_a = transform_action(
                torch.from_numpy(hb.offline_a).to(dev).reshape(-1),
                codes.repeat_interleave(T), self.size).reshape(B, T)
        return feats, offline_a, torch.from_numpy(hb.winner).to(dev)
