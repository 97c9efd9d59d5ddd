"""Synthetic detection data (the port's numpy copy of
`simple_sfod_tpu/data/synthetic.py:make_synthetic_records` and of the
synthetic branch of the loader's image rendering): rectangles on noise with
exact ground truth, so a trainer runs without a dataset; `register_synthetic`,
which registers such records as a dataset; and the adaptation
benchmark's target batch (`synthetic_bench_batch`, from
`simple_sfod_tpu/utils/bench.py`), images and sizes without ground truth."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def make_synthetic_records(
    num_images: int = 16,
    image_hw: Tuple[int, int] = (128, 256),
    num_classes: int = 8,
    max_boxes: int = 6,
    seed: int = 0,
) -> List[dict]:
    """Records with 1..max_boxes boxes each, drawn from `seed`: the same
    records, in the same order, as the JAX package's function."""
    rs = np.random.RandomState(seed)
    h, w = image_hw
    records = []
    for i in range(num_images):
        n = rs.randint(1, max_boxes + 1)
        boxes, classes = [], []
        for _ in range(n):
            bw = rs.randint(w // 8, w // 3)
            bh = rs.randint(h // 8, h // 3)
            x1 = rs.randint(0, w - bw)
            y1 = rs.randint(0, h - bh)
            boxes.append([float(x1), float(y1), float(x1 + bw), float(y1 + bh)])
            classes.append(int(rs.randint(0, num_classes)))
        records.append(
            {
                "file_name": f"synthetic_{i}.png",
                "height": h,
                "width": w,
                "image_id": i + 1,
                "boxes": boxes,
                "classes": classes,
            }
        )
    return records


def synthetic_image(rec: dict) -> np.ndarray:
    """The loader's synthetic rendering of a record: noise in [0, 80) seeded
    by image_id, each box filled with 120 + 15 * (class + 1). float32 HWC."""
    rs = np.random.RandomState(rec["image_id"] % (2**31))
    img = rs.uniform(0, 80, (rec["height"], rec["width"], 3)).astype(np.float32)
    for box, cls in zip(rec["boxes"], rec["classes"]):
        x1, y1, x2, y2 = [int(v) for v in box]
        img[y1:y2, x1:x2] = 120.0 + 15.0 * (cls + 1)
    return img


def register_synthetic(
    name: str = "synthetic_train",
    num_images: int = 16,
    image_hw: Tuple[int, int] = (128, 256),
    num_classes: int = 8,
    seed: int = 0,
) -> List[dict]:
    """Register `make_synthetic_records(...)` under `name` (classes "c0",
    "c1", ...); a loader renders them with `synthetic=True`."""
    from .datasets import DATASET_REGISTRY, register_dataset

    records = make_synthetic_records(num_images, image_hw, num_classes, seed=seed)
    classes = [f"c{i}" for i in range(num_classes)]
    register_dataset(name, json_file="", image_root="", thing_classes=classes)
    DATASET_REGISTRY[name]["_cache"] = {
        "records": records,
        "thing_classes": classes,
        "id_map": {i: i for i in range(num_classes)},
    }
    return records


def synthetic_batch(records: Sequence[dict], canvas_hw: Tuple[int, int], gt_capacity: int) -> Dict[str, np.ndarray]:
    """A batch in the loader's array layout (images uint8 [B, H, W, 3] on a
    zero canvas, sizes int32 [B, 2], gt_boxes float32 [B, M, 4], gt_classes
    int32 [B, M], gt_valid bool [B, M]) from records that already fit the
    canvas and hold at most gt_capacity boxes (no resize, no crop)."""
    b = len(records)
    ch, cw = canvas_hw
    batch = {
        "images": np.zeros((b, ch, cw, 3), np.uint8),
        "sizes": np.zeros((b, 2), np.int32),
        "gt_boxes": np.zeros((b, gt_capacity, 4), np.float32),
        "gt_classes": np.zeros((b, gt_capacity), np.int32),
        "gt_valid": np.zeros((b, gt_capacity), bool),
    }
    for i, rec in enumerate(records):
        h, w, k = rec["height"], rec["width"], len(rec["boxes"])
        if h > ch or w > cw or k > gt_capacity:
            raise ValueError(f"record {i}: {h}x{w} with {k} boxes does not fit {canvas_hw} / {gt_capacity}")
        batch["images"][i, :h, :w] = np.clip(synthetic_image(rec), 0, 255).astype(np.uint8)
        batch["sizes"][i] = (h, w)
        batch["gt_boxes"][i, :k] = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
        batch["gt_classes"][i, :k] = rec["classes"]
        batch["gt_valid"][i, :k] = True
    return batch


def synthetic_bench_batch(cfg, n: int = None) -> Dict[str, np.ndarray]:
    """The adaptation benchmark's target batch: n (default
    SOLVER.IMS_PER_BATCH_TARGET) uniform-noise uint8 canvases of TPU.CANVAS
    from RandomState(0), each with a 600x1200 content size."""
    n = n or cfg.SOLVER.IMS_PER_BATCH_TARGET
    rs = np.random.RandomState(0)
    return {
        "images": rs.uniform(0, 255, (n, *cfg.TPU.CANVAS, 3)).astype(np.uint8),
        "sizes": np.tile(np.asarray([[600, 1200]], np.int32), (n, 1)),
    }
