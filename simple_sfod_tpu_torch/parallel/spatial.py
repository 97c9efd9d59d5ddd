"""Spatial sharding: each image in height bands over the model axis (the port
of the JAX package's `shard_batch(spatial=True)`, TPU.SPATIAL_SHARD).

In the JAX package the canvas height is placed on the 'model' mesh axis and
GSPMD inserts the halo exchanges. Here every layer of the backbone does it
explicitly, and each step computes what one process computes on the whole
image.

The band plan. Band boundaries fall on multiples of S, the backbone's
`band_stride`: the largest stride of any map it returns (32 for VGG16, 16
for the C4 ResNet's res4, 64 for an FPN with its p6 top block, 4 for the
tiny backbone). H // S units are dealt to the model ranks in order, the
first ranks taking one more where they do not divide, and the last band
also takes the rows past the last whole unit: at 608 rows, S 32 and model 2
the bands are 320 and 288 rows. Every map of a band then starts on a whole
row of the global map (the band start over the map's stride), so a strided
layer or a pool sees the rows the whole image would. A width that leaves a
band without a whole unit raises.

Layers, while a band is active (`bands(layout)`, or `mesh.data_parallel`
of a layout built with `spatial=True`):
  Conv2d      (`Conv2d`, the backbones' conv class) a k x k / s / p conv
              takes p rows from the band above and max(k - s - p, 0) rows
              from the band below (`halo`) and runs with zero H-padding; the
              image's first band pads p zero rows on top and the last p
              below, as the whole-image conv does; the W-padding stays
  max pools   `max_pool2d` likewise, its image-edge rows -inf; the 2x2/2
              pool needs no halo (every band starts on an even row, which
              `check_even` asserts)
  BatchNorm   train-mode statistics over the data x model group (every
              rank), each rank's moments weighted by its own element count
              on the forward and the backward pass (`sync_batch_norm`); in
              an evaluation, outside `data_parallel`, over the model group
  features    `models/faster_rcnn.py:FasterRCNN.features` normalises the
              whole image, keeps this rank's band (`take_band`), runs the
              backbone and gathers every returned map (`gather`) before the
              heads, which run whole on every model rank
  gradients   the backbone's parameters are tagged `band_sum`: their
              gradients are partial sums over the band and are summed over
              the model group (`mesh.all_reduce_grads`); the heads' are
              replicas and are averaged as before
Outside a band every function here is the identity.

Transport. Every exchange is a `dist.all_reduce` of a zero-filled buffer
(float32, or float64 for float64 maps) over the model group (one slot a
rank, or the full map), which is exact: gloo offers only broadcast and all-reduce on CUDA tensors, and
several ranks on one GPU run gloo.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from . import mesh

REFUSAL = ("TPU.SPATIAL_SHARD=True requires TPU.MESH_MODEL > 1 "
           "(the image height bands live on the 'model' mesh axis)")


def check_config(tpu) -> None:
    """TPU.SPATIAL_SHARD without a model axis raises ValueError (the JAX
    BaseTrainer's words): a set key that would change nothing fails."""
    if tpu.SPATIAL_SHARD and int(tpu.MESH_MODEL) <= 1:
        raise ValueError(REFUSAL)


def band_plan(height: int, stride: int, width: int) -> List[Tuple[int, int]]:
    """The [start, end) rows of each of `width` bands of an image of `height`
    rows, boundaries on multiples of `stride` (module docstring)."""
    units = height // stride
    if units < width:
        raise ValueError(f"{height} rows hold {units} band(s) of {stride} rows: too few for a model width of "
                         f"{width} (every band needs at least {stride} rows)")
    base, extra = divmod(units, width)
    bounds, start = [], 0
    for m in range(width):
        end = start + (base + (m < extra)) * stride
        bounds.append((start, end))
        start = end
    bounds[-1] = (bounds[-1][0], height)
    return bounds


# -- the context ----------------------------------------------------------------

_ACTIVE: Optional[mesh.Layout] = None


@contextlib.contextmanager
def bands(layout: Optional[mesh.Layout]) -> Iterator[None]:
    """Within: the model ranks of `layout` run each image in bands (None, or
    a model width of 1, is no band)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (layout if layout is not None and layout.model > 1 else None)
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[mesh.Layout]:
    """The banded layout in force: `bands`', or a spatial layout's under
    `mesh.data_parallel`; else None."""
    if _ACTIVE is not None:
        return _ACTIVE
    lay = mesh.active()
    return lay if lay is not None and lay.spatial and lay.model > 1 else None


def _fmt(like: torch.Tensor) -> torch.memory_format:
    if like.dim() == 4 and not like.is_contiguous() and like.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


def _wide(x: torch.Tensor) -> torch.dtype:
    """The transport dtype: float32, or x's where it is wider (exact)."""
    return torch.promote_types(x.dtype, torch.float32)


def _all_reduce(buf: torch.Tensor, lay: mesh.Layout) -> torch.Tensor:
    dist.all_reduce(buf, group=lay.model_group)
    return buf


# -- halo exchange ----------------------------------------------------------------

class _Halo(torch.autograd.Function):
    """x [B, C, h, W], this rank's band -> [B, C, top + h + bottom, W]: `top`
    rows above it (the last rows of the band above, or `pad` at the image's
    top edge) and below it `up` rows of the band below (or `top` rows of
    `pad` at the image's bottom edge). The backward is the adjoint: each
    halo row's gradient is added to the row of the rank that owns it, and
    the padding's is dropped."""

    @staticmethod
    def forward(ctx, x, top: int, up: int, pad: float, lay):
        m, last = lay.model_index, lay.model - 1
        b, c, h, w = x.shape
        if h < max(top, up):
            raise ValueError(f"a band of {h} rows cannot give a halo of {max(top, up)} rows")
        buf = x.new_zeros((lay.model, b, c, up + top, w), dtype=_wide(x))
        buf[m, :, :, :up] = x[:, :, :up]  # for the band above
        buf[m, :, :, up:] = x[:, :, h - top:]  # for the band below
        _all_reduce(buf, lay)
        above = buf[m - 1, :, :, up:].to(x.dtype) if m > 0 else x.new_full((b, c, top, w), pad)
        below = buf[m + 1, :, :, :up].to(x.dtype) if m < last else x.new_full((b, c, top, w), pad)
        ctx.top, ctx.up, ctx.lay, ctx.h = top, up, lay, h
        return torch.cat([above, x, below], dim=2).contiguous(memory_format=_fmt(x))

    @staticmethod
    def backward(ctx, g):
        top, up, lay, h = ctx.top, ctx.up, ctx.lay, ctx.h
        m, last = lay.model_index, lay.model - 1
        b, c, _, w = g.shape
        buf = g.new_zeros((lay.model, b, c, top + up, w), dtype=_wide(g))
        if m > 0:
            buf[m, :, :, :top] = g[:, :, :top]  # the band above's last rows
        if m < last:
            buf[m, :, :, top:] = g[:, :, top + h:]  # the band below's first rows
        _all_reduce(buf, lay)
        gx = g[:, :, top:top + h].to(_wide(g), copy=True)
        if m < last:
            gx[:, :, h - top:] += buf[m + 1, :, :, :top]
        if m > 0:
            gx[:, :, :up] += buf[m - 1, :, :, top:]
        return gx.to(g.dtype).contiguous(memory_format=_fmt(g)), None, None, None, None


def halo(x: torch.Tensor, kernel: int, stride: int, padding: int, pad: float = 0.0) -> torch.Tensor:
    """This rank's band of a map extended by the rows a kernel x kernel /
    stride window with `padding` rows of H-padding needs (module
    docstring); the identity outside a band. A strided window needs bands
    whose maps start on a multiple of its stride."""
    lay = active()
    if lay is None:
        return x
    if stride > 1:
        check_even(x, stride)
    top, up = padding, max(kernel - stride - padding, 0)
    if top == 0 and up == 0:
        return x
    return _Halo.apply(x, top, up, pad, lay)


def check_even(x: torch.Tensor, multiple: int = 2) -> None:
    """Under a band: a band other than the last holds a multiple of
    `multiple` rows, so that the next band starts on such a row (a pool's
    or a strided slice's window sees the rows the whole image would)."""
    lay = active()
    if lay is not None and lay.model_index < lay.model - 1 and x.shape[2] % multiple:
        raise ValueError(f"a band of {x.shape[2]} rows is not a multiple of {multiple}: the band plan's stride "
                         "is smaller than the backbone's")


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes this rank's rows of the whole image's output
    under a band (a halo of its own rows from the neighbours, no H-padding);
    nn.Conv2d outside one."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        if active() is None:
            return super()._conv_forward(x, weight, bias)
        (kh, _), (sh, _), (ph, pw) = self.kernel_size, self.stride, self.padding
        if self.padding_mode != "zeros" or self.dilation != (1, 1):
            raise NotImplementedError("a banded conv takes zero padding and no dilation")
        x = halo(x, kh, sh, ph)
        return F.conv2d(x, weight, bias, self.stride, (0, pw), self.dilation, self.groups)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """F.max_pool2d (floor mode) on this rank's rows under a band, the
    image's edges -inf."""
    if active() is None:
        return F.max_pool2d(x, kernel, stride, padding)
    x = halo(x, kernel, stride, padding, pad=float("-inf"))
    return F.max_pool2d(x, kernel, stride, (0, padding))


# -- batch normalisation ------------------------------------------------------------

def sync_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """Train-mode BatchNorm over the ranks that share this rank's batch:
    under a band, every rank within `mesh.data_parallel` (data x model) and
    the model group outside it, count-weighted; else the data group
    (`mesh.sync_batch_norm`). -> (y, mean, var)."""
    lay = active()
    if lay is None:
        return mesh.sync_batch_norm(x, weight, bias, eps)
    group = dist.group.WORLD if mesh.active() is not None else lay.model_group
    return mesh.SyncBatchNorm.apply(x, weight, bias, eps, group, None)


# -- bands of the image and the gathered maps ---------------------------------------

class _TakeBand(torch.autograd.Function):
    """Rows [a, b) of x [B, C, H, W]; the backward puts the gradient back in
    a zero map of H rows summed over the model group (the whole image's
    gradient on every model rank)."""

    @staticmethod
    def forward(ctx, x, a: int, b: int, lay):
        ctx.a, ctx.h, ctx.lay = a, x.shape[2], lay
        return x[:, :, a:b].contiguous(memory_format=_fmt(x))

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros((g.shape[0], g.shape[1], ctx.h, g.shape[3]), dtype=_wide(g))
        full[:, :, ctx.a:ctx.a + g.shape[2]] = g
        return _all_reduce(full, ctx.lay).to(g.dtype), None, None, None


def take_band(x: torch.Tensor, stride: int) -> torch.Tensor:
    """This rank's band of images x [B, C, H, W] by `band_plan(H, stride,
    model)`; the identity outside a band."""
    lay = active()
    if lay is None:
        return x
    a, b = band_plan(x.shape[2], stride, lay.model)[lay.model_index]
    return _TakeBand.apply(x, a, b, lay)


def gather(maps: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every model rank's bands of each map -> the whole maps, the same on
    every model rank; the identity outside a band."""
    lay = active()
    if lay is None:
        return maps
    names = list(maps)
    heights = torch.zeros((lay.model, len(names)), dtype=torch.int64, device=lay.device)
    heights[lay.model_index] = torch.tensor([maps[k].shape[2] for k in names], dtype=torch.int64)
    dist.all_reduce(heights, group=lay.model_group)
    heights = heights.tolist()
    out = {}
    for j, k in enumerate(names):
        col = [row[j] for row in heights]
        out[k] = _GatherRows.apply(maps[k], sum(col[:lay.model_index]), sum(col), lay)
    return out


class _GatherRows(torch.autograd.Function):
    """This rank's rows [start, start + h) of a map of `total` rows -> the
    whole map (each band in a zero map, summed over the model group: exact);
    the backward keeps this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, start: int, total: int, lay):
        ctx.start, ctx.rows = start, x.shape[2]
        full = x.new_zeros((x.shape[0], x.shape[1], total, x.shape[3]), dtype=_wide(x))
        full[:, :, start:start + x.shape[2]] = x
        return _all_reduce(full, lay).to(x.dtype).contiguous(memory_format=_fmt(x))

    @staticmethod
    def backward(ctx, g):
        return g[:, :, ctx.start:ctx.start + ctx.rows].contiguous(memory_format=_fmt(g)), None, None, None


def tag_banded(module: nn.Module) -> None:
    """Mark `module`'s parameters (a backbone's) as band partial sums for
    the gradient all-reduce."""
    for p in module.parameters():
        p.band_sum = True
