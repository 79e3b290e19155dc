"""Host-side rendering of a search tree for analysis dumps: the port's copy
of `elf_tpu/search/tree_dump.py`.

Counterpart of the reference's per-move tree files: `MCTSAI_T::getCurrentTree`
(`src_cpp/elf/ai/tree_search/mcts.h:100`) renders `SearchTreeT::printTree`
(`tree_search_node.h:484`), an indented listing of every visited edge with
visit count / Q / prior and the child's value, plus root totals and the
prior entropy; `GoStateExt::saveCurrentTree` (`go_state_ext.h:158`) writes
one file per move under `--dump_record_prefix`.

The tree is the port's `[B, N, A]` array-of-trees (`search/mcts.py Tree`):
one batch row is copied to the host once, then walked in numpy.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from elf_tpu_torch.env.go.coords import flat_to_gtp


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class _HostTree:
    """Numpy copy of one tree row."""

    def __init__(self, tree, b: int):
        self.prior = _host(tree.prior[b]).astype(np.float32)
        self.child = _host(tree.child[b]).astype(np.int32)
        self.value = _host(tree.value[b])
        self.terminal = _host(tree.terminal[b])
        self.expanded = _host(tree.expanded[b])
        self.count = int(tree.count[b])
        # edge stats live on the child node (search/mcts.py Tree): the
        # [N, A] per-edge view for rendering
        n_node = _host(tree.n[b])
        w_node = _host(tree.w[b])
        cs = np.clip(self.child, 0, n_node.shape[0] - 1)
        has = self.child >= 0
        self.n_edge = np.where(has, n_node[cs], 0)
        self.w_edge = np.where(has, w_node[cs], 0.0)


def render_tree(
    tree,
    b: int,
    size: int,
    max_depth: Optional[int] = None,
    min_visits: int = 1,
) -> str:
    """Render tree row `b` in the reference tree-file shape: one line per
    visited edge (indent = depth) with `move [n/q/prior], V: child_value`,
    recursing into visited children; unvisited root edges at indent 0; then
    `- Total visit` and `- Prior Entropy` footer (tree_search_node.h:517)."""
    t = _HostTree(tree, b)
    A = t.prior.shape[-1]
    lines: List[str] = []

    def move_str(a: int) -> str:
        return flat_to_gtp(a, size)

    def edge_line(indent: int, node: int, a: int) -> str:
        n = int(t.n_edge[node, a])
        q = float(t.w_edge[node, a]) / max(n, 1)
        p = float(t.prior[node, a])
        s = " " * indent + f"{move_str(a)} [n: {n}, q: {q:.4f}, prior: {p:.4f}]"
        c = int(t.child[node, a])
        if c >= 0:
            s += f", V: {float(t.value[c]):.4f}"
            if t.terminal[c]:
                s += ", terminal"
        return s

    def walk(indent: int, node: int, depth: int) -> None:
        order = np.argsort(-t.n_edge[node])  # most-visited first
        for a in order:
            a = int(a)
            n = int(t.n_edge[node, a])
            if n >= max(min_visits, 1):
                lines.append(edge_line(indent, node, a))
                c = int(t.child[node, a])
                if (
                    c >= 0
                    and t.expanded[c]
                    and (max_depth is None or depth + 1 < max_depth)
                ):
                    walk(indent + 2, c, depth + 1)
            elif indent == 0 and float(t.prior[node, a]) > 0.0:
                # the reference prints unvisited edges only at the root
                lines.append(edge_line(0, node, a))

    walk(0, 0, 0)

    total_n = int(t.n_edge[0].sum())
    prior = t.prior[0]
    pos = prior[prior > 0.0]
    entropy = float(-(pos * np.log(pos + 1e-10)).sum()) if pos.size else 0.0
    lines.append(f"- Total visit: {total_n}")
    lines.append(f"- Prior Entropy: {entropy:.4f}")
    return "\n".join(lines) + "\n"


def top_moves(tree, b: int, size: int, k: int = 5) -> List[dict]:
    """[{move, n, q, prior}] for the k most-visited root actions — the
    per-move suggestion block analysis mode prints (README.rst:166)."""
    t = _HostTree(tree, b)
    order = np.argsort(-t.n_edge[0])[:k]
    out = []
    for a in order:
        a = int(a)
        n = int(t.n_edge[0, a])
        if n <= 0 and float(t.prior[0, a]) <= 0.0:
            continue
        out.append(
            {
                "move": flat_to_gtp(a, size),
                "n": n,
                "q": float(t.w_edge[0, a]) / max(n, 1),
                "prior": float(t.prior[0, a]),
            }
        )
    return out
