"""Fixed-capacity instance container (the port of
`simple_sfod_tpu/structures/instances.py`).

Detections and proposals keep the JAX package's layout: N padded slots with
a validity mask, so "filtering" is masking and the shapes never depend on
the data.
"""

from __future__ import annotations

import dataclasses

import torch


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose integer order is the IEEE total order that
    XLA's TopK uses: -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < NaN."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim in `jax.lax.top_k`'s
    order: the total order above, ties broken by the lower index. `torch.topk`
    promises no tie order on CUDA, so this is a stable descending sort of the
    total-order key and a slice."""
    return torch.sort(_total_order_key(key), dim=-1, descending=True, stable=True).indices[..., :k]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [..., N, *rest] gathered at idx [..., K] along the dim of N."""
    d = idx.dim() - 1
    index = idx.reshape(idx.shape + (1,) * (t.dim() - idx.dim())).expand(*idx.shape, *t.shape[idx.dim():])
    return torch.gather(t, d, index)


@dataclasses.dataclass(frozen=True)
class Instances:
    """N padded instances of one image (or [B, N] with a leading batch dim).

    boxes [N, 4] float XYXY, scores [N] float, classes [N] int32, valid [N] bool.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor

    def mask(self, keep: torch.Tensor) -> "Instances":
        """AND the validity mask with `keep` (same shape as valid)."""
        return dataclasses.replace(self, valid=self.valid & keep)

    def take(self, idx: torch.Tensor) -> "Instances":
        """Gather the instances at `idx` along the capacity dim: idx [K] for
        an unbatched set, [B, K] for a batched one."""
        return Instances(
            boxes=_take(self.boxes, idx),
            scores=_take(self.scores, idx),
            classes=_take(self.classes, idx),
            valid=_take(self.valid, idx),
        )

    def top_k(self, k: int) -> "Instances":
        """Keep the k highest-score valid instances (of each image), compacted
        to the front; padding ranks below every valid entry."""
        key = torch.where(self.valid, self.scores, torch.full_like(self.scores, -float("inf")))
        return self.take(topk_indices(key, k))

    @staticmethod
    def concatenate(a: "Instances", b: "Instances") -> "Instances":
        """Concatenate two unbatched sets along the capacity: N_a + N_b."""
        return Instances(
            boxes=torch.cat([a.boxes, b.boxes], dim=0),
            scores=torch.cat([a.scores, b.scores], dim=0),
            classes=torch.cat([a.classes, b.classes], dim=0),
            valid=torch.cat([a.valid, b.valid], dim=0),
        )
