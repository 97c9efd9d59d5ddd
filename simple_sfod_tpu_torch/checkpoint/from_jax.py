"""Carry weights from the JAX package's flax tree to the port's state dict.

The port's parameter names are Detectron2's, the names that
`simple_sfod_tpu/checkpoint/torch_export.py:export_torch_checkpoint` writes,
so `FasterRCNN.load_state_dict(..., strict=True)` takes the result. This
module keeps its own copy of the layout conversions:

  conv kernel    flax HWIO [kh, kw, I, O]  ->  torch OIHW [O, I, kh, kw]
  dense kernel   flax [I, O]               ->  torch [O, I]
  box-head fc1   the JAX head flattens pooled NHWC [P, P, C]; the port
                 flattens NCHW [C, P, P], so the input dim is un-permuted
  BatchNorm      scale/bias/mean/var -> weight/bias/running_mean/running_var,
                 num_batches_tracked = 0
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.backbones.vgg import STAGE_PLAN


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv(w) -> np.ndarray:
    return np.transpose(_f32(w), (3, 2, 0, 1))


def _dense(w) -> np.ndarray:
    return np.transpose(_f32(w), (1, 0))


def _fc0(w, pool: int, channels: int) -> np.ndarray:
    w = _dense(w)  # [out, P*P*C] in NHWC flatten order
    out_dim = w.shape[0]
    w = w.reshape(out_dim, pool, pool, channels)
    return np.transpose(w, (0, 3, 1, 2)).reshape(out_dim, channels * pool * pool)


def state_dict_from_jax(variables: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of the JAX FasterRCNN (numpy
    leaves) -> the port's state dict (float32 tensors). `cfg` is the port's
    DetectorConfig; only the single-level VGG16-BN detector is ported."""
    if cfg.backbone != "vgg16" or not cfg.vgg_bn or cfg.fpn:
        raise NotImplementedError("state_dict_from_jax carries the single-level VGG16-BN detector only")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    bp, bs = params["backbone"], stats["backbone"]
    conv_i = 0
    for stage, widths in enumerate(STAGE_PLAN):
        for j in range(len(widths)):
            key = f"backbone.vgg{stage}.{3 * j}"
            sd[f"{key}.weight"] = _conv(bp[f"conv{conv_i}"]["kernel"])
            sd[f"{key}.bias"] = _f32(bp[f"conv{conv_i}"]["bias"])
            bn = f"backbone.vgg{stage}.{3 * j + 1}"
            sd[f"{bn}.weight"] = _f32(bp[f"bn{conv_i}"]["scale"])
            sd[f"{bn}.bias"] = _f32(bp[f"bn{conv_i}"]["bias"])
            sd[f"{bn}.running_mean"] = _f32(bs[f"bn{conv_i}"]["mean"])
            sd[f"{bn}.running_var"] = _f32(bs[f"bn{conv_i}"]["var"])
            sd[f"{bn}.num_batches_tracked"] = np.zeros((), np.int64)
            conv_i += 1

    rpn = params["rpn_head"]
    for ours, theirs in (
        ("conv", "proposal_generator.rpn_head.conv"),
        ("objectness", "proposal_generator.rpn_head.objectness_logits"),
        ("deltas", "proposal_generator.rpn_head.anchor_deltas"),
    ):
        sd[f"{theirs}.weight"] = _conv(rpn[ours]["kernel"])
        sd[f"{theirs}.bias"] = _f32(rpn[ours]["bias"])

    pool = cfg.pooler_resolution
    for i in range(cfg.num_fc):
        fc = params["box_head"][f"fc{i}"]
        key = f"roi_heads.box_head.fc{i + 1}"
        sd[f"{key}.weight"] = _fc0(fc["kernel"], pool, cfg.feature_channels) if i == 0 else _dense(fc["kernel"])
        sd[f"{key}.bias"] = _f32(fc["bias"])
    for name in ("cls_score", "bbox_pred"):
        sd[f"roi_heads.box_predictor.{name}.weight"] = _dense(params["predictor"][name]["kernel"])
        sd[f"roi_heads.box_predictor.{name}.bias"] = _f32(params["predictor"][name]["bias"])

    sd["pixel_mean"] = np.asarray(cfg.pixel_mean, np.float32).reshape(3, 1, 1)
    sd["pixel_std"] = np.asarray(cfg.pixel_std, np.float32).reshape(3, 1, 1)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
