"""BPC (bounding-box prediction calibration) loss (the port of
`simple_sfod_tpu/losses/bpc.py`).

Raw predictions (no score filter, no NMS) are split per class into true
positives (best legacy IoU, +1 pixel, against a same-class GT above 0.5)
and false positives; their confidences accumulate into

    AC = sum_{TP, s>=.5} s*tanh(s)      AN = sum_{TP, s<.5} s*(1-tanh(s))
    IC = sum_{FP, s>=.5} (1-s)*tanh(s)  IN = sum_{FP, s<.5} (1-s)*(1-tanh(s))

and the loss of an image is log(1 + (AN+IC)/(AC+IN)), averaged over the
images with a positive denominator. The adaptation step logs it and weights
it 0, as the reference does.
"""

from __future__ import annotations

import torch

from ..structures.instances import Instances


def _legacy_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pascal-style IoU with +1 offsets. [N, 4] x [M, 4] -> [N, M]."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp_min(rb - lt + 1.0, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(union))


def bpc_loss(pred: Instances, gt: Instances, iou_thresh: float = 0.5) -> torch.Tensor:
    """pred, gt: batched Instances [B, N] and [B, M] -> scalar."""
    losses, valid = [], []
    for i in range(pred.boxes.shape[0]):
        iou = _legacy_iou(gt.boxes[i], pred.boxes[i])  # [G, P]
        pair_ok = (gt.classes[i][:, None] == pred.classes[i][None, :]) & gt.valid[i][:, None] & pred.valid[i][None, :]
        best = torch.where(pair_ok, iou, torch.zeros_like(iou)).amax(dim=0)  # [P]
        is_tp = pred.valid[i] & (best > iou_thresh)
        is_fp = pred.valid[i] & ~is_tp
        s = pred.scores[i]
        t = torch.tanh(s)
        hi = s >= 0.5
        zero = torch.zeros_like(s)
        ac = torch.sum(torch.where(is_tp & hi, s * t, zero))
        an = torch.sum(torch.where(is_tp & ~hi, s * (1 - t), zero))
        ic = torch.sum(torch.where(is_fp & hi, (1 - s) * t, zero))
        inn = torch.sum(torch.where(is_fp & ~hi, (1 - s) * (1 - t), zero))
        denom = ac + inn
        loss = torch.log1p((an + ic) / torch.clamp_min(denom, 1e-12))
        losses.append(torch.where(denom > 0, loss, torch.zeros_like(loss)))
        valid.append((denom > 0).to(torch.float32))
    return torch.sum(torch.stack(losses)) / torch.clamp_min(torch.sum(torch.stack(valid)), 1.0)
