"""A 2-conv backbone for the multi-process dry run and tests (the port of
`simple_sfod_tpu/models/backbones/tiny.py`, which no reference config
names).

Two stages of 3x3 conv (16 channels, bias) + BatchNorm (flax's
bookkeeping, backbones/vgg.py) + ReLU + 2x2/2 max-pool: "tiny0" at stride
2 and "tiny1" at stride 4. Small enough that the whole adaptation step
(teacher, pseudo-labels, student forward and backward, the collectives)
runs on several CPU processes in seconds, with the structure of VGG16-BN:
named pooled stages and BatchNorm statistics for AdaBN. Names:
`backbone.conv{i}`, `backbone.bn{i}`. Without BN (`bn=False`, the
detector's vgg_bn) the convs feed the ReLU directly.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...parallel import spatial
from .vgg import BatchNorm2d, max_pool_2x2

WIDTH = 16
NUM_STAGES = 2


class TinyBackbone(nn.Module):
    """x [B, 3, H, W] -> {"tiny0": stride 2, "tiny1": stride 4} NCHW."""

    band_stride = 4  # tiny1's: the alignment of height bands (parallel/spatial.py)

    def __init__(self, bn: bool = True):
        super().__init__()
        self.bn = bn
        for i in range(NUM_STAGES):
            self.add_module(f"conv{i}", spatial.Conv2d(3 if i == 0 else WIDTH, WIDTH, 3, padding=1))
            if bn:
                self.add_module(f"bn{i}", BatchNorm2d(WIDTH))

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> Dict[str, torch.Tensor]:
        feats = {}
        for i in range(NUM_STAGES):
            x = getattr(self, f"conv{i}")(x)
            if self.bn:
                x = getattr(self, f"bn{i}")(x, train, update_stats)
            x = max_pool_2x2(torch.relu(x))
            feats[f"tiny{i}"] = x
        return feats

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {f"tiny{i}": WIDTH for i in range(NUM_STAGES)}

    @staticmethod
    def out_strides() -> Dict[str, int]:
        return {f"tiny{i}": 2 ** (i + 1) for i in range(NUM_STAGES)}
