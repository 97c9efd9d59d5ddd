"""RPN head, box head and Fast R-CNN predictor (the port of
`simple_sfod_tpu/models/heads.py`), with Detectron2's parameter names."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class RPNHead(nn.Module):
    """3x3 conv + sibling 1x1 objectness / anchor-delta convs
    (`proposal_generator.rpn_head.{conv,objectness_logits,anchor_deltas}`)."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, C, H, W] -> (objectness [B, H*W*A], deltas [B, H*W*A, 4]) in
        float32, flattened in (y, x, anchor) order like the anchor grid."""
        t = torch.relu(self.conv(x))
        logits = self.objectness_logits(t)
        deltas = self.anchor_deltas(t)
        b = x.shape[0]
        logits = logits.permute(0, 2, 3, 1).reshape(b, -1)
        deltas = deltas.permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits.float(), deltas.float()


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Dropout with a given keep mask, as flax applies it:
    where(keep, x / (1 - rate), 0)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class FastRCNNConvFCHead(nn.Module):
    """FC layers over the pooled ROI feature (`roi_heads.box_head.fc{1..}`).

    The pooled feature is flattened in NCHW order [C, P, P], as in
    Detectron2. The JAX package flattens NHWC [P, P, C]; its fc0 weight is
    permuted once when carried across (checkpoint/from_jax.py).

    With `dropout` > 0 each fc's ReLU is followed by Dropout(dropout) in the
    train mode, as flax applies it (`dropout`). The keep masks are inputs, one bool [rows, fc_dim] a layer; `keep` None is
    the deterministic mode (flax's deterministic=True). Masks of k * N rows
    for N ROIs run k dropout passes at once (MC dropout,
    models/uncertainty.py): the layers before the first dropout run once
    and their output is repeated k times, sample-major.

    Tensor-parallel (parallel/mesh.py:shard_box_head sets `model_group`):
    fc1 holds a slice of its output rows and fc2 the same slice of its
    input columns; fc1's input passes Megatron's f and fc2's partial output
    is summed by g before fc2's bias, and fc1's keep mask is the slice of
    its columns."""

    def __init__(self, in_dim: int, fc_dim: int = 1024, num_fc: int = 2, dropout: float = 0.0):
        super().__init__()
        self.num_fc = num_fc
        self.dropout = dropout
        self.model_group = None  # the model group of a tensor-parallel head
        self.model_width = 1
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """x [N, C, P, P] -> [N, fc_dim] ([k * N, fc_dim] with masks of k * N rows)."""
        if keep is not None and not self.dropout > 0:
            raise ValueError("keep masks given to a box head without dropout")
        x = x.flatten(1)
        if self.model_group is not None:
            from ..parallel.mesh import copy_to_model

            x = copy_to_model(x, self.model_group)
        for i in range(self.num_fc):
            x = torch.relu(self._fc(i, x))
            if keep is not None:
                if x.shape[0] != keep[i].shape[0]:
                    x = x.repeat(keep[i].shape[0] // x.shape[0], 1)
                x = dropout(x, keep[i], self.dropout)
        return x

    def _fc(self, i: int, x: torch.Tensor) -> torch.Tensor:
        fc = getattr(self, f"fc{i + 1}")
        if self.model_group is None or i != 1:
            return fc(x)
        from ..parallel.mesh import reduce_from_model

        y = reduce_from_model(nn.functional.linear(x, fc.weight), self.model_group)
        return (y + fc.bias.float()).to(x.dtype)


class FastRCNNPredictor(nn.Module):
    """Class logits (C+1, background last) and class-specific deltas (4C)
    (`roi_heads.box_predictor.{cls_score,bbox_pred}`), in float32."""

    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(in_dim, num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x).float(), self.bbox_pred(x).float()
