"""Monte-Carlo-dropout uncertainty of the box head (the port of
`simple_sfod_tpu/models/uncertainty.py:mc_dropout_box_outputs`).

K stochastic passes of the box head over the RPN's inference proposals: the
JAX package vmaps the head over K dropout keys; here the K passes are
stacked on the row axis and the head runs once (FastRCNNConvFCHead with
keep masks of K * B * R rows), so fc1 runs on the B * R pooled features
once and the K passes share it. The backbone runs with eval-mode
BatchNorm, the NMS inside `propose` is the card's kernel, and the keep
masks are inputs (or drawn from `generator`)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .detector import Detector
from .faster_rcnn import anchors_for, box_dropout_masks, pool_rois, propose


@torch.no_grad()
def mc_dropout_box_outputs(
    detector: Detector,
    images,
    sizes,
    num_samples: int = 10,
    keep: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """images [B, H, W, 3], sizes [B, 2] -> (mean softmax [B, R, C+1], its
    standard deviation over the passes [B, R, C+1] (ddof 0), proposal boxes
    [B, R, 4], valid [B, R]; `valid` tells NMS survivors from the padding,
    whose rows still carry softmax statistics). `keep`: one bool
    [num_samples * B * R, fc_dim] mask a fc layer, pass-major; without it
    the masks are drawn from `generator` on the detector's device. Requires
    box_head_dropout > 0."""
    cfg, model = detector.cfg, detector.model
    if cfg.box_head_dropout <= 0:
        raise ValueError("MC dropout needs box_head_dropout > 0")
    images = detector._tensor(images)
    sizes = detector._tensor(sizes, torch.int32)
    feature = model.features(images, train=False)
    anchors = anchors_for(cfg, tuple(images.shape[1:3]), images.device)
    proposals = propose(cfg, anchors, model.rpn(feature), sizes)
    pooled = pool_rois(cfg, feature, proposals.boxes)
    rows = pooled.shape[0]
    if keep is None:
        keep = box_dropout_masks(cfg, num_samples * rows, generator, images.device)
    if any(k.shape[0] != num_samples * rows for k in keep):
        raise ValueError(f"keep masks of {[k.shape[0] for k in keep]} rows for {num_samples} passes of {rows} ROIs")
    scores, _ = model.box(pooled, keep)
    probs = torch.softmax(scores, dim=-1).view(num_samples, rows, -1)
    b, r = proposals.boxes.shape[:2]
    std, mean = torch.std_mean(probs, dim=0, correction=0)
    return mean.view(b, r, -1), std.view(b, r, -1), proposals.boxes, proposals.valid
