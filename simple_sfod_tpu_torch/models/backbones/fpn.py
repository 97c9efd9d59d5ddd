"""Feature Pyramid Network over a pooled-stage backbone (the port of
`simple_sfod_tpu/models/backbones/fpn.py`, Detectron2's FPN with a
LastLevelMaxPool top block).

A lateral 1x1 conv projects each input stage to OUT_CHANNELS; the top-down
pathway adds each coarser merged map, upsampled 2x by nearest neighbour and
cropped to the finer map, into the finer lateral (FUSE_TYPE "sum", or "avg":
halved); a 3x3 conv smooths each merged map into `p{level}`, level =
log2(stride); the top block is the strided slice [..., ::2, ::2] of the
coarsest output, `p{top + 1}`. Under NORM "BN" each conv is followed by the
port's BatchNorm2d and has no bias.

Parameter names are Detectron2's: `bottom_up.*` (the backbone's own),
`fpn_lateral{l}.{weight,bias}`, `fpn_output{l}.{weight,bias}`, and under
NORM "BN" `fpn_lateral{l}.norm.*` / `fpn_output{l}.norm.*`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ...parallel import spatial
from .vgg import BatchNorm2d


def upsample2x(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of [B, C, h, w], cropped to `like`'s
    spatial size (the JAX package's repeat-then-crop). Under height bands
    both are this rank's band, which starts on the same row of each map, so
    the crop is the band's."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, : like.shape[2], : like.shape[3]]


class _ConvNorm(spatial.Conv2d):
    """A conv with an optional BatchNorm held as the submodule `norm`
    (Detectron2's Conv2d wrapper); the conv has a bias only without it."""

    def __init__(self, in_ch: int, out_ch: int, k: int, norm: str):
        super().__init__(in_ch, out_ch, k, padding=k // 2, bias=norm == "")
        self.norm = BatchNorm2d(out_ch) if norm == "BN" else None

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> torch.Tensor:
        x = super().forward(x)
        return self.norm(x, train, update_stats) if self.norm is not None else x


class FPN(nn.Module):
    """`bottom_up` exposes pooled-stage features by name and `out_strides()`
    / `out_channels()` (VGG16Backbone does). Returns {"p{l}": [B, C, h, w]}
    for each input level and the top block's level."""

    def __init__(self, bottom_up: nn.Module, in_features: Tuple[str, ...], out_channels: int = 256,
                 norm: str = "", fuse_type: str = "sum"):
        super().__init__()
        if norm not in ("", "BN"):
            raise NotImplementedError(f"MODEL.FPN.NORM={norm!r} is not ported ('' and 'BN' are)")
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"MODEL.FPN.FUSE_TYPE={fuse_type!r} (sum or avg)")
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fuse_type = fuse_type
        strides, chans = bottom_up.out_strides(), bottom_up.out_channels()
        self.levels = [strides[f].bit_length() - 1 for f in self.in_features]
        self.band_stride = 2 ** (self.levels[-1] + 1)  # p{top + 1}'s (parallel/spatial.py)
        for f, lvl in zip(self.in_features, self.levels):
            self.add_module(f"fpn_lateral{lvl}", _ConvNorm(chans[f], out_channels, 1, norm))
            self.add_module(f"fpn_output{lvl}", _ConvNorm(out_channels, out_channels, 3, norm))

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = True) -> Dict[str, torch.Tensor]:
        feats = self.bottom_up(x, train, update_stats)
        laterals = [getattr(self, f"fpn_lateral{lvl}")(feats[f], train, update_stats)
                    for f, lvl in zip(self.in_features, self.levels)]
        fmt = torch.channels_last if x.device.type == "cuda" else torch.contiguous_format
        merged = [None] * len(laterals)
        merged[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            m = laterals[i] + upsample2x(merged[i + 1], laterals[i])
            # one memory format for every map the convs take, in eager code
            # and in an exported program alike (cuDNN picks its kernels by it)
            merged[i] = (m / 2.0 if self.fuse_type == "avg" else m).contiguous(memory_format=fmt)
        out = {f"p{lvl}": getattr(self, f"fpn_output{lvl}")(m, train, update_stats)
               for m, lvl in zip(merged, self.levels)}
        top = self.levels[-1]
        spatial.check_even(out[f"p{top}"])  # the band plan aligns the stride-2 slice
        out[f"p{top + 1}"] = out[f"p{top}"][:, :, ::2, ::2].contiguous(memory_format=fmt)
        return out
