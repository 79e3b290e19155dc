"""Model-family registry: counterpart of `elf_tpu/models/registry.py` (the
reference's `Models = {name: [Model, Method]}` mapping and `load_env`
composition, `df_model3.py:310`, `rlpytorch/model_loader.py:192`).

Each entry pairs a network with its training loss and the reader of its
checkpoints (`load_model(path, cfg, device)`):
  df_kl     PolicyValueNet + mcts_prediction_loss     (AlphaZero training)
  df_pred   PolicyValueNet + multiple_prediction_loss (supervised moves)
  df_policy PolicyNet      + multiple_prediction_loss (policy-only CNN; no
            reader: nothing plays it)
  kata_nbt  NestedBottleneckNet (KataGo's b18c384nbt, `models/nbt.py`) +
            mcts_prediction_loss on its value P(win) - P(loss) (KataGo
            trains the three value logits by cross-entropy instead)
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

from elf_tpu_torch.device import DeviceLike
from elf_tpu_torch.models import nbt, resnet
from elf_tpu_torch.models.nbt import NbtConfig, NestedBottleneckNet
from elf_tpu_torch.models.policy_net import PolicyNet, PolicyNetConfig
from elf_tpu_torch.models.resnet import ModelConfig, PolicyValueNet
from elf_tpu_torch.training.loss import (
    mcts_prediction_loss,
    multiple_prediction_loss,
)


class ModelFamily(NamedTuple):
    model_cls: type
    config_cls: type
    loss_fn: Callable
    feature_set: str  # "agz" (18 planes) or "df" (25 planes)
    load_model: Optional[Callable]  # (path, cfg, device) -> net


MODELS: Dict[str, ModelFamily] = {
    "df_kl": ModelFamily(PolicyValueNet, ModelConfig, mcts_prediction_loss,
                         "agz", resnet.load_model),
    "df_pred": ModelFamily(
        PolicyValueNet, ModelConfig, multiple_prediction_loss, "agz",
        resnet.load_model
    ),
    "df_policy": ModelFamily(
        PolicyNet, PolicyNetConfig, multiple_prediction_loss, "df", None
    ),
    "kata_nbt": ModelFamily(
        NestedBottleneckNet, NbtConfig, mcts_prediction_loss, "agz",
        nbt.load_model
    ),
}


def get_model_family(name: str) -> ModelFamily:
    if name not in MODELS:
        raise KeyError(f"unknown model family '{name}'; have {sorted(MODELS)}")
    return MODELS[name]


def model_class(cfg) -> type:
    """The net a family's config builds (`ModelConfig`: PolicyValueNet)."""
    for fam in MODELS.values():
        if type(cfg) is fam.config_cls:
            return fam.model_cls
    raise TypeError(f"no model family is configured by {type(cfg).__name__}")


def family_feature_set(name: str, use_df_feature: bool = False) -> str:
    """The feature set a family trains/plays on ('agz' or 'df'); the
    --use_df_feature flag upgrades agz families to df-25."""
    fam = get_model_family(name)
    return "df" if (fam.feature_set == "df" or use_df_feature) else "agz"


def make_trainer(name: str, board_size: int, to, use_df_feature: bool = False,
                 device: DeviceLike = "cuda"):
    """Model-family name + parsed TrainOptions -> (trainer, train_mode,
    feature_set), as the JAX `make_trainer` (25 input planes where the
    feature set is df):
      df_kl    -> Trainer + "mcts"    (AlphaZero MCTSPrediction loss)
      df_pred  -> Trainer + "offline" (supervised MultiplePrediction)
      kata_nbt -> Trainer + "mcts", at `NbtConfig`'s widths (b18c384nbt's;
                  `to.num_block` and `to.dim` size the ResNet only)
    df_policy (the value-head-less PolicyNet) has no Trainer path and
    raises ValueError, as in the JAX package: build it with
    `models.policy_net.init_policy_net`."""
    fam = get_model_family(name)
    if fam.model_cls is PolicyNet:
        raise ValueError(
            f"model family '{name}' ({fam.model_cls.__name__}) has no "
            "value head; use elf_tpu_torch.models.policy_net directly"
        )
    feature_set = family_feature_set(name, use_df_feature)
    from elf_tpu_torch.training.trainer import Trainer

    common = dict(board_size=board_size,
                  num_planes=25 if feature_set == "df" else 18,
                  bn_momentum=to.bn_momentum, use_bf16=to.bf16)
    if fam.config_cls is ModelConfig:
        cfg = ModelConfig(num_block=to.num_block, dim=to.dim, **common)
    else:
        cfg = fam.config_cls(**common)
    train_mode = "mcts" if fam.loss_fn is mcts_prediction_loss else "offline"
    return Trainer(cfg, to, device=device), train_mode, feature_set
