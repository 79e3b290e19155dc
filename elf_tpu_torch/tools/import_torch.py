"""Import reference PyTorch checkpoints into the port's PolicyValueNet.
Counterpart of `elf_tpu/tools/import_torch.py`.

Reads `Model_PolicyValue` checkpoints saved by the reference
(`rlpytorch/model_base.py:83`: `torch.save` of {"state_dict", "step",
"options"}), such as the published pretrained-go-19x19-v2.bin, and maps
them onto the flax trees of `PolicyValueNet`, from which
`models.resnet.params_from_jax` builds the port's net:

    params, stats, step = load_torch_checkpoint(path, cfg)
    net = params_from_jax(params, stats, cfg, device)

Module names (reference df_model3.py:183-200):
  init_conv.0/.1                    -> init_conv / init_bn
  resnet.resnet.{i}.conv_lower.0/.1 -> block{i}.conv1 / bn1
  resnet.resnet.{i}.conv_upper.0/.1 -> block{i}.conv2 / bn2
  pi_final_conv.0/.1                -> pi_conv / pi_bn
  value_final_conv.0/.1             -> v_conv / v_bn
  pi_linear                         -> pi_fc (rows permuted from the NCHW
                                       flatten to the NHWC one)
  value_linear1/2                   -> v_fc1 / v_fc2

Layouts: conv [O, I, kh, kw] -> [kh, kw, I, O]; dense [O, I] -> [I, O];
BN weight / bias / running_mean / running_var -> scale / bias / mean /
var.  `module.` prefixes (DataParallel) are stripped, as the reference
loader's replace_prefix does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from elf_tpu_torch.models.resnet import ModelConfig


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _conv(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _bn(sd: Dict, key: str) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}
    stats = {
        "mean": _np(sd[f"{key}.running_mean"]),
        "var": _np(sd[f"{key}.running_var"]),
    }
    return params, stats


def _dense(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": _np(sd[f"{key}.weight"]).T,
        "bias": _np(sd[f"{key}.bias"]),
    }


def _strip_prefixes(sd: Dict) -> Dict:
    out = {}
    for k, v in sd.items():
        k = k.replace(".module.", ".")
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v
    return out


def convert_state_dict(sd: Dict, cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """Reference state_dict -> (params, batch_stats) flax trees of numpy
    arrays for PolicyValueNet."""
    sd = _strip_prefixes(sd)
    n2 = cfg.board_size * cfg.board_size
    params: Dict = {}
    stats: Dict = {}

    params["init_conv"] = _conv(sd, "init_conv.0")
    params["init_bn"], stats["init_bn"] = _bn(sd, "init_conv.1")

    for i in range(cfg.num_block):
        base = f"resnet.resnet.{i}"
        blk_p: Dict = {}
        blk_s: Dict = {}
        blk_p["conv1"] = _conv(sd, f"{base}.conv_lower.0")
        blk_p["bn1"], blk_s["bn1"] = _bn(sd, f"{base}.conv_lower.1")
        blk_p["conv2"] = _conv(sd, f"{base}.conv_upper.0")
        blk_p["bn2"], blk_s["bn2"] = _bn(sd, f"{base}.conv_upper.1")
        params[f"block{i}"] = blk_p
        stats[f"block{i}"] = blk_s

    params["pi_conv"] = _conv(sd, "pi_final_conv.0")
    params["pi_bn"], stats["pi_bn"] = _bn(sd, "pi_final_conv.1")
    params["v_conv"] = _conv(sd, "value_final_conv.0")
    params["v_bn"], stats["v_bn"] = _bn(sd, "value_final_conv.1")

    # pi_linear: the reference's input index is c * n2 + pos (NCHW
    # flatten), the net's pos * 2 + c (NHWC flatten): permute the rows
    pi = _dense(sd, "pi_linear")
    perm = np.empty(2 * n2, np.int64)
    for c in range(2):
        for pos in range(n2):
            perm[pos * 2 + c] = c * n2 + pos
    pi["kernel"] = pi["kernel"][perm]
    params["pi_fc"] = pi

    params["v_fc1"] = _dense(sd, "value_linear1")  # 1 channel: no permute
    params["v_fc2"] = _dense(sd, "value_linear2")
    return params, stats


def load_torch_checkpoint(path: str, cfg: ModelConfig):
    """(params, batch_stats, step) from a reference .bin file: a dict with
    "state_dict" (and "step", "options"), or a bare state dict."""
    # "options" is not a tensor, so the file needs the full unpickler;
    # open only checkpoints you trust
    data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict) and "state_dict" in data:
        sd, step = data["state_dict"], int(data.get("step", 0))
    else:
        sd, step = data, 0
    params, stats = convert_state_dict(dict(sd), cfg)
    return params, stats, step
