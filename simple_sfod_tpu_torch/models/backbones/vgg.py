"""VGG-16 backbone with BatchNorm (the port of
`simple_sfod_tpu/models/backbones/vgg.py`).

13 3x3 convs in the (2, 2, 3, 3, 3) stage layout, each stage ending in a
2x2/2 max-pool, so "vgg0".."vgg4" have channels (64, 128, 256, 512, 512) and
strides (2, 4, 8, 16, 32). The heads consume "vgg4" (stride 32).

Parameter names follow Detectron2's VGG layout: stage s is
`backbone.vgg{s}` = [conv, bn, relu] * k + [maxpool], so conv j of a stage is
module 3j and its BatchNorm 3j+1.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

STAGE_PLAN: Sequence[Sequence[int]] = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool, floor mode (odd trailing rows/cols dropped), NCHW."""
    return nn.functional.max_pool2d(x, 2, 2)


class _MaxPool2x2(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_2x2(x)


class VGG16Backbone(nn.Module):
    """x [B, 3, H, W] (mean-subtracted) -> {"vgg0": ..., ..., "vgg4": ...} NCHW.

    BatchNorm in eval mode uses the running statistics with eps 1e-5."""

    def __init__(self, bn: bool = True):
        super().__init__()
        if not bn:
            raise NotImplementedError(
                "VGG.BN=False is not ported yet (its Detectron2 layout splits "
                "stages mid-block); the served configurations use BN"
            )
        in_ch = 3
        for s, widths in enumerate(STAGE_PLAN):
            layers = []
            for width in widths:
                layers += [
                    nn.Conv2d(in_ch, width, 3, padding=1),
                    nn.BatchNorm2d(width, eps=1e-5, momentum=0.1),
                    nn.ReLU(inplace=True),
                ]
                in_ch = width
            layers.append(_MaxPool2x2())
            self.add_module(f"vgg{s}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = {}
        for s in range(len(STAGE_PLAN)):
            x = getattr(self, f"vgg{s}")(x)
            feats[f"vgg{s}"] = x
        return feats

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {f"vgg{i}": plan[-1] for i, plan in enumerate(STAGE_PLAN)}

    @staticmethod
    def out_strides() -> Dict[str, int]:
        return {f"vgg{i}": 2 ** (i + 1) for i in range(len(STAGE_PLAN))}
