"""RPN head, box head and Fast R-CNN predictor (the port of
`simple_sfod_tpu/models/heads.py`), with Detectron2's parameter names."""

from __future__ import annotations

from typing import Tuple

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


class FastRCNNConvFCHead(nn.Module):
    """FC layers over the pooled ROI feature (`roi_heads.box_head.fc{1..}`).

    The pooled feature is flattened in NCHW order [C, P, P], as in
    Detectron2. The JAX package flattens NHWC [P, P, C]; its fc0 weight is
    permuted once when carried across (checkpoint/from_jax.py)."""

    def __init__(self, in_dim: int, fc_dim: int = 1024, num_fc: int = 2):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(in_dim if i == 0 else fc_dim, fc_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, P, P] -> [N, fc_dim]."""
        x = x.flatten(1)
        for i in range(self.num_fc):
            x = torch.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNPredictor(nn.Module):
    """Class logits (C+1, background last) and class-specific deltas (4C)
    (`roi_heads.box_predictor.{cls_score,bbox_pred}`), in float32."""

    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_dim, num_classes + 1)
        self.bbox_pred = nn.Linear(in_dim, num_classes * 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x).float(), self.bbox_pred(x).float()
