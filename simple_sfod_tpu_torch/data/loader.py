"""Serving-side image preprocessing (the port of two functions of
`simple_sfod_tpu/data/loader.py`): detectron2's shortest-edge output shape
and the PIL bilinear resize. PIL is imported only when an image actually
needs resizing."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def d2_output_shape(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge.get_output_shape, bit-exact: the shorter
    edge goes to min_size unless the max_size cap applies, and the final dims
    round half up via int(x + 0.5)."""
    size = float(min_size)
    scale = size / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        s = max_size / max(newh, neww)
        newh, neww = newh * s, neww * s
    return int(newh + 0.5), int(neww + 0.5)


def _resize_shortest_edge(img: np.ndarray, min_size: int, max_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL BILINEAR shortest-edge resize, as detectron2's ResizeTransform.
    Returns (image, scale_xy [2] float32). An image already at its output
    size is returned as is, without importing PIL."""
    h, w = img.shape[:2]
    nh, nw = d2_output_shape(h, w, min_size, max_size)
    if (nh, nw) == (h, w):
        return img, np.ones((2,), np.float32)
    from PIL import Image

    pil = Image.fromarray(img.astype(np.uint8))
    out = np.asarray(pil.resize((nw, nh), Image.BILINEAR), dtype=np.float32)
    return out, np.asarray([nw / w, nh / h], np.float32)
