"""VGG-16 backbone with BatchNorm (the port of
`simple_sfod_tpu/models/backbones/vgg.py`).

13 3x3 convs in the (2, 2, 3, 3, 3) stage layout, each stage ending in a
2x2/2 max-pool, so "vgg0".."vgg4" have channels (64, 128, 256, 512, 512) and
strides (2, 4, 8, 16, 32). The heads consume "vgg4" (stride 32).

Parameter names follow Detectron2's VGG layout: stage s is
`backbone.vgg{s}` = [conv, bn, relu] * k + [maxpool], so conv j of a stage is
module 3j and its BatchNorm 3j+1.

BatchNorm keeps the JAX package's (flax's) bookkeeping, not torch's: in
train mode it normalises with the batch statistics and, when asked, moves
the running statistics by momentum 0.9 toward the batch mean and the BIASED
batch variance (`nn.BatchNorm2d` would write the unbiased one).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

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


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with eps 1e-5 and flax's running-statistics update
    (`simple_sfod_tpu/models/backbones/vgg.py`, `nn.BatchNorm(momentum=0.9)`):

        running_mean = 0.9 * running_mean + 0.1 * mean(x)
        running_var  = 0.9 * running_var  + 0.1 * var(x)     (biased)

    The mode is an argument, not `self.training`: `train` selects batch
    statistics, `update_stats` whether the running ones move. The parameter
    and buffer names are nn.BatchNorm2d's; `num_batches_tracked` stays as
    loaded (the JAX package has no such counter).

    The weight and bias may be bfloat16 (the fixed teacher's, under
    `TPU.DTYPE: bfloat16`) while the running statistics stay float32: they
    are normalised in the input's dtype in train mode, in float32 against
    the float32 statistics in eval mode, and the update writes float32."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def _affine(self, dtype: torch.dtype):
        """weight and bias in `dtype` where they are reduced precision and
        `dtype` is not (torch's batch norm takes reduced-precision input with
        float32 parameters, not the other way round)."""
        w, b = self.weight, self.bias
        if w.dtype != dtype and w.dtype != torch.float32:
            w, b = w.to(dtype), b.to(dtype)
        return w, b

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> torch.Tensor:
        if not train:
            w, b = self._affine(self.running_mean.dtype)
            return F.batch_norm(x, self.running_mean, self.running_var, w, b, False, 0.0, self.eps)
        w, b = self._affine(x.dtype)
        y = F.batch_norm(x, None, None, w, b, True, 0.0, self.eps)
        if update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
                keep = 1.0 - self.momentum
                self.running_mean.mul_(keep).add_((1.0 - keep) * mean)
                self.running_var.mul_(keep).add_((1.0 - keep) * var)
        return y


class VGG16Backbone(nn.Module):
    """x [B, 3, H, W] (mean-subtracted) -> {"vgg0": ..., ..., "vgg4": ...} NCHW.

    `train` runs BatchNorm on batch statistics (and `update_stats` moves the
    running ones); otherwise it uses the running statistics."""

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
                    BatchNorm2d(width),
                    nn.ReLU(inplace=True),
                ]
                in_ch = width
            layers.append(_MaxPool2x2())
            self.add_module(f"vgg{s}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> Dict[str, torch.Tensor]:
        feats = {}
        for s in range(len(STAGE_PLAN)):
            for layer in getattr(self, f"vgg{s}"):
                x = layer(x, train, update_stats) if isinstance(layer, BatchNorm2d) else layer(x)
            feats[f"vgg{s}"] = x
        return feats

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {f"vgg{i}": plan[-1] for i, plan in enumerate(STAGE_PLAN)}

    @staticmethod
    def out_strides() -> Dict[str, int]:
        return {f"vgg{i}": 2 ** (i + 1) for i in range(len(STAGE_PLAN))}
