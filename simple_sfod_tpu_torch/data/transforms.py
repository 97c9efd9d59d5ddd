"""Geometric augmentation (the port of the horizontal flip of
`simple_sfod_tpu/data/transforms.py`). The flip decision is an input, not a
draw, so a caller can hand over the JAX package's draws."""

from __future__ import annotations

from typing import Tuple

import torch


def hflip(image: torch.Tensor, boxes: torch.Tensor, width: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal flip of the valid region of a canvas. image [H, W, C],
    boxes [..., 4] XYXY, width: the valid width (a scalar tensor). The
    valid columns are mirrored in place and the padding stays on the right,
    reversed, exactly as the JAX package's reverse-then-roll leaves it."""
    cols = image.shape[1]
    j = torch.arange(cols, device=image.device)
    w = width.to(j.dtype)
    src = torch.where(j < w, w - 1 - j, cols - 1 + w - j)
    flipped = image.index_select(1, src)
    wf = width.to(boxes.dtype)
    new_boxes = torch.stack(
        [wf - boxes[..., 2], boxes[..., 1], wf - boxes[..., 0], boxes[..., 3]], dim=-1
    )
    return flipped, new_boxes


def random_hflip(
    do: torch.Tensor, image: torch.Tensor, boxes: torch.Tensor, width: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hflip where the bool scalar `do` is set (the JAX package draws it as
    `jax.random.bernoulli(rng, 0.5)`). -> (image, boxes, do)."""
    fi, fb = hflip(image, boxes, width)
    return torch.where(do, fi, image), torch.where(do, fb, boxes), do
