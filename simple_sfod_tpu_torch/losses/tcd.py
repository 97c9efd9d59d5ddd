"""TCD (true-class-distribution) loss (the port of
`simple_sfod_tpu/losses/tcd.py`): the L1 distance between the class
histogram of confident predictions and a target class distribution. The
reference ships it unwired, and so do both packages."""

from __future__ import annotations

import torch

from ..structures.instances import Instances


def tcd_loss(pred: Instances, target_distribution: torch.Tensor, score_thresh: float = 0.5) -> torch.Tensor:
    """pred: batched Instances (valid, scores >= score_thresh count);
    target_distribution [C] summing to 1 -> a float32 scalar. A class
    outside [0, C) counts nowhere (jax.nn.one_hot's zero row)."""
    num_classes = target_distribution.shape[0]
    conf = pred.valid & (pred.scores >= score_thresh)
    cls = torch.arange(num_classes, device=pred.classes.device)
    one_hot = (pred.classes[..., None] == cls).to(torch.float32)
    counts = (one_hot * conf[..., None].to(torch.float32)).reshape(-1, num_classes).sum(dim=0)
    total = torch.clamp_min(counts.sum(), 1.0)
    return torch.sum(torch.abs(counts / total - target_distribution))
