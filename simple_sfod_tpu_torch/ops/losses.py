"""Loss primitives of the RPN and ROI heads (the port of
`simple_sfod_tpu/ops/losses.py`): masked, fixed-shape, float32."""

from __future__ import annotations

import torch

from ..parallel import mesh


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber). beta <= 0 is pure L1, detectron2's
    default for both RPN and box-head regression."""
    diff = pred - target
    if beta <= 0:
        return torch.abs(diff)
    adiff = torch.abs(diff)
    return torch.where(adiff < beta, 0.5 * diff * diff / beta, adiff - 0.5 * beta)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the stable form
    max(x, 0) - x * y + log1p(exp(-|x|))."""
    return torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy. logits [N, C], labels [N] int -> [N]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long())[:, 0]


def masked_mean(values: torch.Tensor, mask: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """Mean over the masked entries; the denominator is floored at `floor`.
    The count is the global batch's within `parallel.mesh.data_parallel`."""
    m = mask.to(values.dtype)
    return torch.sum(values * m) / torch.clamp_min(mesh.global_sum(torch.sum(m)), floor)


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(values * mask.to(values.dtype))
