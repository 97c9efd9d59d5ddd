"""A padded image batch (the port of `simple_sfod_tpu/structures/image_list.py`,
the counterpart of detectron2's `ImageList`): images resized (shortest edge
to INPUT.MIN_SIZE) and padded to one fixed canvas, with each image's true
size inside it and the resize factor from its file."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ImageBatch:
    """images: [B, H, W, 3] (uint8 or float, channels last: the loader's layout).
    sizes:  [B, 2] int32, true (h, w) of valid pixels per image.
    scale:  [B] float, resize factor from the original file to this canvas
            (the evaluator maps detections back to file coordinates with it).
    """

    images: torch.Tensor
    sizes: torch.Tensor
    scale: torch.Tensor

    @property
    def batch(self) -> int:
        return self.images.shape[0]

    @property
    def canvas(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

