"""Anchor generation (the port of `simple_sfod_tpu/ops/anchors.py`)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def generate_cell_anchors(
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> np.ndarray:
    """Anchors centred at (0, 0) for one feature location, [A, 4] XYXY:
    area = size**2, w = sqrt(area / ratio), h = w * ratio (detectron2)."""
    anchors = []
    for size in sizes:
        anchor_area = float(size) ** 2
        for ratio in aspect_ratios:
            w = float(np.sqrt(anchor_area / ratio))
            h = w * ratio
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def generate_anchors(
    feature_hw: Tuple[int, int],
    stride: int,
    sizes: Sequence[float] = (32, 64, 128, 256, 512),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
    device: torch.device = torch.device("cpu"),
) -> torch.Tensor:
    """Anchor grid for a feature map, [H*W*A, 4] float32, row-major over
    (y, x) with A anchors per location -- the RPN head's flattening order."""
    h, w = feature_hw
    cell = generate_cell_anchors(sizes, aspect_ratios)
    shift_x = np.arange(w, dtype=np.float32) * stride
    shift_y = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    grid = (shifts + cell[None, :, :]).reshape(-1, 4)
    return torch.from_numpy(np.ascontiguousarray(grid)).to(device)
