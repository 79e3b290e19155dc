"""Traffic kind "train_family": the "train" kind (`harness/train.py`, its
parameters, window and check) with the learner's net built from the
configuration's model family (`family`) through the program's registry
(`elf_tpu_torch.models.registry`), where "train" builds the
post-activation ResNet by name.

The family's config class takes the configuration's keys that name its
fields (a list as a tuple), `use_bf16` from `conv_dtype` and `remat` from
the traffic; the program's `Trainer` builds the net that config
configures.  The window's work adds `normact_bytes`, the bytes its norm,
activation, pooling and residual passes must move
(`yardstick_nbt_train.py`).  The check follows the checked steps in
float32 with `reference/kata_nbt_train.py`.  A program whose registry
gives the family no learner fails at once, before any game or weight is
drawn.
"""

from __future__ import annotations

import dataclasses

from harness import core, selfplay, train, yardstick_nbt_train
from reference import kata_nbt_train


def learner_config(cfg: dict, remat: bool):
    """The program's config of the configuration's family."""
    from elf_tpu_torch.models.registry import get_model_family

    cls = get_model_family(cfg["family"]).config_cls
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in names}
    kw.update(use_bf16=cfg["conv_dtype"] == "bfloat16", remat=remat)
    return cls(**kw)


def run(ctx) -> core.Measured:
    from elf_tpu_torch.config import TrainOptions
    from elf_tpu_torch.models.registry import make_trainer

    cfg, tr = ctx.config, ctx.traffic
    # raises for a family without a learner
    make_trainer(cfg["family"], cfg["board_size"],
                 TrainOptions(batchsize=tr["batch"]), device=ctx.device)
    mcfg = learner_config(cfg, tr["remat"])
    # "train" sizes TrainOptions by the ResNet's keys, which this net's
    # config does not read
    ctx = dataclasses.replace(ctx, config=dict(
        cfg, num_block=cfg["num_blocks"], dim=cfg["trunk_channels"]))
    saved, selfplay.model_config = selfplay.model_config, lambda c: mcfg
    try:
        m = train.run(ctx)
    finally:
        selfplay.model_config = saved
    m.work["normact_bytes"] = yardstick_nbt_train.normact_bytes(
        cfg, m.work["positions"], tr["remat"])
    return m


def check(ctx, m: core.Measured) -> dict:
    return train.check(dataclasses.replace(ctx, reference=kata_nbt_train), m)
