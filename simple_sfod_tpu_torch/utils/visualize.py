"""Detection drawing (the port of `simple_sfod_tpu/utils/visualize.py`):
`draw_detections` renders boxes onto an image, and `VisualizationHook`
writes such images to TensorBoard every VIS_PERIOD steps."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..engine.events import tensorboard_summary_writer

PALETTE = [
    (255, 99, 71),
    (65, 105, 225),
    (60, 179, 113),
    (238, 130, 238),
    (255, 165, 0),
    (64, 224, 208),
    (218, 165, 32),
    (186, 85, 211),
]


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: Optional[np.ndarray] = None,
    scores: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    input_format: str = "BGR",
) -> np.ndarray:
    """Draw boxes onto an image [H, W, 3] (0..255, BGR or RGB) -> RGB uint8."""
    from PIL import Image, ImageDraw

    img = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    if input_format == "BGR":
        img = img[:, :, ::-1]
    pil = Image.fromarray(np.ascontiguousarray(img))
    draw = ImageDraw.Draw(pil)
    boxes = np.asarray(boxes).reshape(-1, 4)
    for i, box in enumerate(boxes):
        cls = int(classes[i]) if classes is not None else 0
        color = PALETTE[cls % len(PALETTE)]
        draw.rectangle([float(box[0]), float(box[1]), float(box[2]), float(box[3])], outline=color, width=2)
        label = ""
        if class_names is not None and classes is not None:
            label = class_names[cls]
        if scores is not None:
            label = f"{label} {float(scores[i]):.2f}".strip()
        if label:
            draw.text((float(box[0]) + 2, float(box[1]) + 2), label, fill=color)
    return np.asarray(pil)


class VisualizationHook:
    """Annotated training images to TensorBoard under `log_dir` every
    `period` steps. The writer is built with the hook, so a machine without
    a TensorBoard backend fails here (ImportError), not at step period - 1."""

    def __init__(self, log_dir: str, period: int, class_names=None, input_format: str = "BGR"):
        self.period = period
        self.class_names = class_names
        self.input_format = input_format
        self._writer = tensorboard_summary_writer()(log_dir)

    def fires(self, step: int) -> bool:
        return self.period > 0 and (step + 1) % self.period == 0

    def after_step(self, step: int, image, boxes, classes=None, scores=None, tag: str = "train/pseudo_labels") -> None:
        if not self.fires(step):
            return
        vis = draw_detections(np.asarray(image), np.asarray(boxes), classes, scores, self.class_names, self.input_format)
        self._writer.add_image(tag, vis.transpose(2, 0, 1), step)

    def close(self) -> None:
        self._writer.close()
