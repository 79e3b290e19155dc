from elf_tpu_torch.sgf.sgf import (  # noqa: F401
    SgfGame,
    SgfNode,
    game_from_moves,
    parse_sgf,
    serialize_sgf,
)
