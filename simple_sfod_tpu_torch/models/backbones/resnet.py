"""ResNet-50/101 backbone, C4 layout (the port of
`simple_sfod_tpu/models/backbones/resnet.py`).

stem = 7x7/2 conv (pad 3, no bias) + norm + ReLU + 3x3/2 max-pool (pad 1),
then bottleneck stages res2..res5 with strides (4, 8, 16, 32) and channels
(256, 512, 1024, 2048); the backbone stops after the deepest stage it is
asked for, so the C4 detector ("res4", stride 16, 1024 channels) builds no
res5. The stride sits on each stage's first 1x1 conv (Detectron2's
`stride_in_1x1`), and a block whose channels or stride change has a 1x1
projection shortcut with its own norm.

Parameter names are Detectron2's: `stem.conv1.weight`, `stem.conv1.norm.*`,
`res{s}.{b}.conv{1,2,3}.weight`, `res{s}.{b}.conv{i}.norm.*`,
`res{s}.{b}.shortcut.weight`, `res{s}.{b}.shortcut.norm.*`.

Norms (MODEL.RESNETS.NORM):
  BN        the port's BatchNorm2d with flax's bookkeeping (backbones/vgg.py):
            batch statistics in train mode, running ones otherwise
  FrozenBN  FrozenBatchNorm2d: a fixed affine from loaded statistics; its
            weight, bias and statistics are buffers (as in Detectron2), so
            no optimizer sees them and AdaBN leaves them alone

Dtypes follow the JAX package under bfloat16: a FrozenBN output is float32
(its float32 affine promotes the bfloat16 conv output), a live BN's output
stays in the conv's dtype, and the residual add takes the promoted dtype.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ...parallel import spatial
from .vgg import BatchNorm2d

BLOCK_COUNTS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class FrozenBatchNorm2d(nn.Module):
    """y = x * s + (bias - running_mean * s), s = weight / sqrt(running_var +
    eps), as the JAX package computes it. Every tensor is a buffer; the
    `num_batches_tracked` buffer exists so that the JAX package's exported
    files (which write one for every norm) load strictly, and a Detectron2
    file without it loads too (it stays 0). `train` and `update_stats` are
    taken and ignored: a frozen norm has one mode."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> torch.Tensor:
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.setdefault(prefix + "num_batches_tracked", torch.zeros((), dtype=torch.long))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def make_norm(kind: str, channels: int) -> nn.Module:
    """MODEL.RESNETS.NORM -> the norm module."""
    if kind == "BN":
        return BatchNorm2d(channels)
    if kind == "FrozenBN":
        return FrozenBatchNorm2d(channels)
    raise NotImplementedError(f"MODEL.RESNETS.NORM={kind!r} is not ported (BN and FrozenBN are)")


class Conv2d(spatial.Conv2d):
    """Detectron2's conv wrapper: a bias-free conv followed by its norm,
    held as the submodule `norm` (banded under height bands, as every
    backbone conv)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0, norm: str = "BN"):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.norm = make_norm(norm, out_ch)

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> torch.Tensor:
        return self.norm(super().forward(x), train, update_stats)


class BasicStem(nn.Module):
    def __init__(self, norm: str):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, norm=norm)

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> torch.Tensor:
        x = F.relu(self.conv1(x, train, update_stats))
        return spatial.max_pool2d(x, 3, 2, 1)


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, bottleneck_ch: int, stride: int, norm: str):
        super().__init__()
        if in_ch != out_ch or stride != 1:
            self.shortcut = Conv2d(in_ch, out_ch, 1, stride=stride, norm=norm)
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_ch, bottleneck_ch, 1, stride=stride, norm=norm)
        self.conv2 = Conv2d(bottleneck_ch, bottleneck_ch, 3, padding=1, norm=norm)
        self.conv3 = Conv2d(bottleneck_ch, out_ch, 1, norm=norm)

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x, train, update_stats)
        y = F.relu(self.conv1(x, train, update_stats))
        y = F.relu(self.conv2(y, train, update_stats))
        y = self.conv3(y, train, update_stats)
        return F.relu(y + shortcut)


class ResNetBackbone(nn.Module):
    """x [B, 3, H, W] (mean-subtracted) -> {"res2": ..., up to the deepest
    of `out_features`} NCHW. `train` runs live BatchNorm on batch statistics
    (and `update_stats` moves the running ones); FrozenBN ignores both."""

    def __init__(self, depth: int = 101, norm: str = "BN", out_features: Sequence[str] = ("res4",)):
        super().__init__()
        self.stem = BasicStem(norm)
        deepest = max(int(f[3]) for f in out_features)
        self.stages = []
        in_ch, out_ch, bottleneck_ch = 64, 256, 64
        for stage, n_blocks in enumerate(BLOCK_COUNTS[depth], start=2):
            if stage > deepest:
                break
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 2) else 1
                blocks.append(BottleneckBlock(in_ch, out_ch, bottleneck_ch, stride, norm))
                in_ch = out_ch
            name = f"res{stage}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stages.append(name)
            out_ch *= 2
            bottleneck_ch *= 2

    @property
    def band_stride(self) -> int:
        """The deepest stage's stride: the alignment of height bands
        (parallel/spatial.py)."""
        return self.out_strides()[self.stages[-1]]

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> Dict[str, torch.Tensor]:
        x = self.stem(x, train, update_stats)
        feats = {}
        for name in self.stages:
            for block in getattr(self, name):
                x = block(x, train, update_stats)
            feats[name] = x
        return feats

    @staticmethod
    def out_channels() -> Dict[str, int]:
        return {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}

    @staticmethod
    def out_strides() -> Dict[str, int]:
        return {"res2": 4, "res3": 8, "res4": 16, "res5": 32}
