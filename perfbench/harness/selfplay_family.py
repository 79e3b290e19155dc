"""Traffic kind "selfplay_family": the "selfplay" kind (`harness/selfplay.py`,
its parameters, window and check unchanged) with the program's net built
from the configuration's model family (`family`) through the program's
registry (`elf_tpu_torch.models.registry`), where "selfplay" builds the
post-activation ResNet by name.

The family's config class takes the configuration's keys that name its
fields (a list as a tuple), and `use_bf16` from `conv_dtype`; the net is
built on the device and receives a copy of the weights through its
state-dict interface (`port_net`, in place of `selfplay.port_net` while
`run` runs).  A program whose registry lacks the family fails at once,
before any weight is drawn.
"""

from __future__ import annotations

import dataclasses

import torch

from harness import core, selfplay


def family(cfg: dict):
    from elf_tpu_torch.models.registry import get_model_family

    return get_model_family(cfg["family"])


def port_net(cfg: dict, W: dict, dev):
    """The program's net of the configuration's family, built on the
    device, holding a copy of W."""
    fam = family(cfg)
    names = {f.name for f in dataclasses.fields(fam.config_cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg.items() if k in names}
    kw["use_bf16"] = cfg["conv_dtype"] == "bfloat16"
    with torch.device(dev):
        net = fam.model_cls(fam.config_cls(**kw))
    net.load_state_dict(W)
    return net.eval()


def run(ctx) -> core.Measured:
    family(ctx.config)
    saved, selfplay.port_net = selfplay.port_net, port_net
    try:
        return selfplay.run(ctx)
    finally:
        selfplay.port_net = saved


check = selfplay.check
