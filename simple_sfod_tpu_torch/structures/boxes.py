"""Box operations on XYXY tensors (the port of `simple_sfod_tpu/structures/boxes.py`).

Every function keeps the JAX package's operation order, so that in float32
the two packages round the same: areas as (x2-x1)*(y2-y1), IoU as
inter / (a1 + a2 - inter) guarded by union > 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

# Detectron2's default: log(1000 / 16). Deltas are clamped so decoded boxes
# cannot explode.
DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [...]. Degenerate boxes give area <= 0."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both sides > threshold. [..., 4] -> [...] bool."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def clip_boxes(boxes: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Clip boxes to [0, W] x [0, H]. image_size: (h, w), a [2] tensor or
    [..., 2] broadcastable against the leading dims of `boxes`."""
    image_size = image_size.to(boxes.dtype)
    h = image_size[..., 0:1]
    w = image_size[..., 1:2]
    while h.dim() < boxes.dim():
        h = h.unsqueeze(-2)
        w = w.unsqueeze(-2)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0:1], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1:2], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2:3], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3:4], zero), h)
    return torch.cat([x1, y1, x2, y2], dim=-1)


def _pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection areas. [N, 4] x [M, 4] -> [N, M]."""
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix. [N, 4] x [M, 4] -> [N, M]. 0 where union is 0."""
    inter = _pairwise_intersection(boxes1, boxes2)
    a1 = area(boxes1)[:, None]
    a2 = area(boxes2)[None, :]
    union = a1 + a2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(union))


def pairwise_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of boxes2. [N, 4] x [M, 4] -> [N, M]; 0
    where that area is not positive."""
    inter = _pairwise_intersection(boxes1, boxes2)
    a2 = area(boxes2)[None, :]
    pos = a2 > 0
    return torch.where(pos, inter / torch.where(pos, a2, torch.ones_like(a2)), torch.zeros_like(inter))


class BoxTransform(NamedTuple):
    """Faster R-CNN box deltas with coordinate weights (detectron2's
    Box2BoxTransform): RPN uses (1, 1, 1, 1), the box head (10, 10, 5, 5)."""

    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    scale_clamp: float = DEFAULT_SCALE_CLAMP

    def get_deltas(self, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return encode_deltas(src, target, self.weights)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        return decode_deltas(deltas, boxes, self.weights, self.scale_clamp)


def encode_deltas(
    src: torch.Tensor,
    target: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Target boxes as (dx, dy, dw, dh) deltas relative to src boxes, both
    [..., 4] XYXY. The sides of both are floored at 1e-6 so degenerate boxes
    give finite targets (callers mask them out); the target centre uses the
    unfloored sides, in the JAX package's operation order."""
    src_w = torch.clamp_min(src[..., 2] - src[..., 0], 1e-6)
    src_h = torch.clamp_min(src[..., 3] - src[..., 1], 1e-6)
    src_cx = src[..., 0] + 0.5 * src_w
    src_cy = src[..., 1] + 0.5 * src_h

    tgt_w = torch.clamp_min(target[..., 2] - target[..., 0], 1e-6)
    tgt_h = torch.clamp_min(target[..., 3] - target[..., 1], 1e-6)
    tgt_cx = target[..., 0] + 0.5 * (target[..., 2] - target[..., 0])
    tgt_cy = target[..., 1] + 0.5 * (target[..., 3] - target[..., 1])

    wx, wy, ww, wh = weights
    dx = wx * (tgt_cx - src_cx) / src_w
    dy = wy * (tgt_cy - src_cy) / src_h
    dw = ww * torch.log(tgt_w / src_w)
    dh = wh * torch.log(tgt_h / src_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_deltas(
    deltas: torch.Tensor,
    boxes: torch.Tensor,
    weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
    scale_clamp: float = DEFAULT_SCALE_CLAMP,
) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to boxes. deltas [..., K*4] or [..., 4],
    boxes [..., 4]; returns the shape of `deltas`."""
    boxes = boxes.to(deltas.dtype)
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    wx, wy, ww, wh = weights
    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (-1, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = torch.clamp(d[..., 2] / ww, max=scale_clamp)
    dh = torch.clamp(d[..., 3] / wh, max=scale_clamp)

    pred_cx = dx * w[..., None] + cx[..., None]
    pred_cy = dy * h[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * w[..., None]
    pred_h = torch.exp(dh) * h[..., None]

    out = torch.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w,
            pred_cy + 0.5 * pred_h,
        ],
        dim=-1,
    )
    return out.reshape(shape)
