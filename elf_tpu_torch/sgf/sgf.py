"""SGF parse/serialize + move iteration: the port's copy of
`elf_tpu/sgf/sgf.py` (reference `src_cpp/elfgames/go/sgf/sgf.{h,cc}`).

Full-file SGF parsing with properties, a linear main-variation move
iterator (the reference ignores side variations for replay), side-variation
replay, serialization, and a game built from a flat move list (the
actor's and the analysis driver's dumps).  Plain Python on the host.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from elf_tpu_torch.env.go.coords import flat_to_sgf, sgf_to_flat


@dataclass
class SgfNode:
    props: Dict[str, List[str]] = field(default_factory=dict)
    children: List["SgfNode"] = field(default_factory=list)


@dataclass
class SgfGame:
    root: SgfNode

    @property
    def board_size(self) -> int:
        sz = self.root.props.get("SZ", ["19"])[0]
        return int(sz.split(":")[0])

    @property
    def komi(self) -> float:
        try:
            return float(self.root.props.get("KM", ["7.5"])[0])
        except ValueError:
            return 7.5

    @property
    def result(self) -> str:
        return self.root.props.get("RE", [""])[0]

    @property
    def handicap(self) -> int:
        try:
            return int(self.root.props.get("HA", ["0"])[0])
        except ValueError:
            return 0

    def setup_stones(self) -> Tuple[List[int], List[int]]:
        """(black, white) flat coords from AB/AW setup properties."""
        size = self.board_size
        ab = [sgf_to_flat(s, size) for s in self.root.props.get("AB", [])]
        aw = [sgf_to_flat(s, size) for s in self.root.props.get("AW", [])]
        return ab, aw

    def main_moves(self) -> Iterator[Tuple[str, int]]:
        """Yield (color 'B'/'W', flat action) along the main variation
        (Sgf::iterator semantics, sgf.h:200)."""
        yield from self.moves_along(())

    def moves_along(self, branch: Tuple[int, ...]) -> Iterator[Tuple[str, int]]:
        """Yield (color, flat action) along a chosen variation path.

        `branch` gives the child index to take at each successive branch
        point (node with >1 child); exhausted entries default to 0 (main
        line).  This is the side-variation replay the reference parses but
        never replays (sgf.cc keeps only child 0)."""
        size = self.board_size
        node: Optional[SgfNode] = self.root
        depth = 0
        while node is not None:
            for color in ("B", "W"):
                if color in node.props:
                    yield color, sgf_to_flat(node.props[color][0], size)
            if not node.children:
                return
            if len(node.children) > 1:
                pick = branch[depth] if depth < len(branch) else 0
                depth += 1
                pick = min(max(pick, 0), len(node.children) - 1)
                node = node.children[pick]
            else:
                node = node.children[0]

    def variations(self) -> List[Tuple[int, ...]]:
        """Enumerate every variation path (see `moves_along`) in the tree,
        depth-first, main line first."""
        out: List[Tuple[int, ...]] = []

        def walk(node: SgfNode, path: Tuple[int, ...]) -> None:
            while True:
                if not node.children:
                    out.append(path)
                    return
                if len(node.children) > 1:
                    for i, child in enumerate(node.children):
                        walk(child, path + (i,))
                    return
                node = node.children[0]

        walk(self.root, ())
        return out


_TOKEN = re.compile(r"\s*(?:(\()|(\))|(;)|([A-Za-z]+)((?:\[(?:[^\]\\]|\\.)*\])+))")
_PROP_VAL = re.compile(r"\[((?:[^\]\\]|\\.)*)\]")


def parse_sgf(text: str) -> SgfGame:
    """Parse one SGF game tree (variations preserved as child branches)."""
    pos = 0
    n = len(text)

    def skip_to_open(p: int) -> int:
        while p < n and text[p] != "(":
            p += 1
        return p

    pos = skip_to_open(pos)
    if pos >= n:
        raise ValueError("no SGF game tree found")

    root: Optional[SgfNode] = None
    node_stack: List[SgfNode] = []
    cur: Optional[SgfNode] = None
    pos += 1  # consume '('

    while pos < n:
        m = _TOKEN.match(text, pos)
        if not m:
            pos += 1
            continue
        pos = m.end()
        open_, close, semi, ident, vals = m.groups()
        if open_:
            node_stack.append(cur)  # branch point
        elif close:
            if not node_stack:
                break
            cur = node_stack.pop()
        elif semi:
            new = SgfNode()
            if cur is None:
                root = new
            else:
                cur.children.append(new)
            cur = new
        elif ident:
            values = [_unescape(v) for v in _PROP_VAL.findall(vals)]
            cur.props.setdefault(ident.upper(), []).extend(values)
    if root is None:
        raise ValueError("empty SGF game tree")
    return SgfGame(root)


def _unescape(s: str) -> str:
    return re.sub(r"\\(.)", r"\1", s)


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace("]", "\\]")


def serialize_sgf(game: SgfGame) -> str:
    out: List[str] = []

    def emit(node: SgfNode) -> None:
        out.append(";")
        for k, vs in node.props.items():
            out.append(k)
            for v in vs:
                out.append(f"[{_escape(v)}]")
        if len(node.children) == 1:
            emit(node.children[0])
        else:
            for c in node.children:
                out.append("(")
                emit(c)
                out.append(")")

    out.append("(")
    emit(game.root)
    out.append(")")
    return "".join(out)


def game_from_moves(
    moves: List[int],
    size: int,
    komi: float = 7.5,
    result: str = "",
    extra_root_props: Optional[Dict[str, List[str]]] = None,
) -> SgfGame:
    """Build an SGF game from a flat move list (for record dumps,
    go_state_ext.h `dumpSgf` equivalent)."""
    root = SgfNode(
        props={
            "GM": ["1"],
            "FF": ["4"],
            "SZ": [str(size)],
            "KM": [str(komi)],
            **({"RE": [result]} if result else {}),
            **(extra_root_props or {}),
        }
    )
    cur = root
    for i, m in enumerate(moves):
        color = "B" if i % 2 == 0 else "W"
        node = SgfNode(props={color: [flat_to_sgf(int(m), size)]})
        cur.children.append(node)
        cur = node
    return SgfGame(root)
