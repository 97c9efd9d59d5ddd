"""IoU matcher with fixed shapes (the port of `simple_sfod_tpu/ops/matcher.py`,
detectron2's `Matcher`).

RPN anchor labelling uses thresholds (0.3, 0.7) -> labels (0, -1, 1) with
low-quality matches; ROI proposal labelling uses (0.5,) -> (0, 1). Padded
ground-truth rows are masked to IoU -1, so they never match, and with no
valid ground truth every prediction is background.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class MatcherConfig(NamedTuple):
    thresholds: Sequence[float]
    labels: Sequence[int]  # len(thresholds) + 1 entries; -1 = ignore
    allow_low_quality_matches: bool = False


RPN_MATCHER = MatcherConfig((0.3, 0.7), (0, -1, 1), True)
ROI_MATCHER = MatcherConfig((0.5,), (0, 1), False)


def match_boxes(
    iou: torch.Tensor, gt_valid: torch.Tensor, config: MatcherConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """iou [M_gt, N_pred] (padded GT rows included), gt_valid [M_gt] bool ->
    (matched_idx [N] int64, the first GT row of the highest IoU, 0 when
    nothing matches; labels [N] int32 in {-1, 0, 1})."""
    masked = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))
    # torch.max along a dim returns the first maximal index, as jnp.argmax does
    matched_vals, matched_idx = torch.max(masked, dim=0)

    labels = torch.full(matched_vals.shape, config.labels[0], dtype=torch.int32, device=iou.device)
    for thr, lbl in zip(config.thresholds, config.labels[1:]):
        labels = torch.where(matched_vals >= thr, torch.full_like(labels, lbl), labels)

    if config.allow_low_quality_matches:
        # each valid GT forces positive the predictions that tie its best
        # IoU (> 0), even below the high threshold (set_low_quality_matches_)
        per_gt_best = torch.max(masked, dim=1, keepdim=True).values
        is_best = (masked >= per_gt_best) & (per_gt_best > 0) & gt_valid[:, None]
        labels = torch.where(is_best.any(dim=0), torch.ones_like(labels), labels)
    return matched_idx, labels
