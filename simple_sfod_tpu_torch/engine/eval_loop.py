"""Dataset inference and evaluation (the port of
`simple_sfod_tpu/engine/eval_loop.py:inference_on_dataset`).

Detections are mapped back to the records' file coordinates (divided by the
per-axis resize scale, clipped to the file size) in numpy float32 in the JAX
loop's order, so equal device boxes give equal file boxes, and each image is
scored once (the test loader's final-batch repeats are dropped by image id).

Dispatch is pipelined: up to `pipeline_depth` batches are in flight on the
device. On a CUDA detector each batch's canvases and sizes are staged
through a pinned host buffer of their own and copied without blocking (a
copy from pageable memory would synchronise the stream and serialise the
pipeline); a batch's detections are read back, the only host sync, when it
leaves the queue, and only then is its buffer reused.

Several processes (a process group): batch k runs on rank k % world (the JAX
loop's `bi % nproc != pid`); the ranks' records are gathered with their
batch indices and merged in batch order, so every rank ends with the one
process's list and its results. A rank with no batch left joins the gather
all the same; rank 0 alone writes the detections file. Under height bands
(a spatial `layout`, TPU.SPATIAL_SHARD) batch k runs on data index
k % data, banded over that index's model ranks (parallel/spatial.py), and
model rank 0 of each index keeps the records.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..evaluation import COCOEvaluator, F1Evaluator
from ..models.detector import Detector
from ..parallel import mesh, spatial


class Staging:
    """Pinned host buffers for the batches in flight, one per slot."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = depth
        self.slots: List[Optional[tuple]] = [None] * depth

    def stage(self, k: int, batch) -> tuple:
        images = torch.from_numpy(np.ascontiguousarray(batch["images"]))
        sizes = torch.from_numpy(np.ascontiguousarray(batch["sizes"], np.int32))
        if self.device.type != "cuda":
            return images, sizes
        slot = self.slots[k % self.depth]
        if slot is None or slot[0].shape != images.shape:
            slot = (torch.empty(images.shape, dtype=torch.uint8).pin_memory(),
                    torch.empty(sizes.shape, dtype=torch.int32).pin_memory())
            self.slots[k % self.depth] = slot
        slot[0].copy_(images)
        slot[1].copy_(sizes)
        return slot[0].to(self.device, non_blocking=True), slot[1].to(self.device, non_blocking=True)


def _file_records(k: int, batch, dets) -> list:
    """(k, record) of each image of batch k, in file coordinates."""
    boxes = dets.boxes.float().cpu().numpy()
    scores = dets.scores.float().cpu().numpy()
    classes = dets.classes.cpu().numpy()
    valid = dets.valid.cpu().numpy()
    records = []
    for i in range(len(batch["image_ids"])):
        keep = valid[i]
        # per-axis un-scaling (detectron2 ResizeTransform.apply_coords)
        s = np.asarray(batch["scale"][i], np.float32).reshape(-1)
        if s.size == 1:
            s = np.asarray([s[0], s[0]], np.float32)
        inv = 1.0 / np.maximum(np.concatenate([s, s]), 1e-8)
        file_boxes = boxes[i][keep] * inv
        h, w = float(batch["heights"][i]), float(batch["widths"][i])
        file_boxes = np.clip(file_boxes, 0, [w, h, w, h])
        gt_keep = batch["gt_valid"][i]
        records.append((k, {
            "image_id": int(batch["image_ids"][i]),
            "boxes": file_boxes,
            "scores": scores[i][keep],
            "classes": classes[i][keep],
            "gt_boxes": batch["gt_boxes"][i][gt_keep] * inv,
            "gt_classes": np.asarray(batch["gt_classes"][i][gt_keep]),
        }))
    return records


def inference_on_dataset(
    detector: Detector,
    loader,
    thing_classes,
    evaluators: Optional[list] = None,
    train_mode_bn: bool = False,
    dump_json: Optional[str] = None,
    category_ids: Optional[dict] = None,
    pipeline_depth: int = 4,
    layout: Optional[mesh.Layout] = None,
) -> Dict:
    """Run `detector` (on its device) over a test loader and evaluate.

    evaluators: default COCO mAP + F1. train_mode_bn normalises by each
    batch's statistics (the padded repeats of the final batch included, as
    in the JAX loop). dump_json: a COCO detections file
    (`coco_instances_results.json`), with category_ids mapping contiguous
    ids to the dataset's category ids (default id + 1). pipeline_depth:
    TPU.EVAL_PIPELINE_DEPTH, the batches in flight. In a process group
    every rank calls this on the same loader (module docstring); `layout`
    is the trainer's, read only for height bands. Returns the evaluators'
    merged results."""
    if evaluators is None:
        evaluators = [COCOEvaluator(thing_classes), F1Evaluator()]
    depth = max(1, int(pipeline_depth))
    staging = Staging(detector.device, depth)
    records: list = []
    inflight = collections.deque()
    world, me = mesh.world_size(), mesh.rank()
    banded = layout if layout is not None and layout.spatial else None
    if banded is not None:
        world, me = banded.data, banded.data_index
    taken = 0
    with spatial.bands(banded):
        for k, batch in enumerate(loader):
            if k % world != me:
                continue
            images, sizes = staging.stage(taken, batch)
            taken += 1
            inflight.append((k, batch, detector.infer(images, sizes, train_mode_bn=train_mode_bn)))
            if len(inflight) >= depth:
                records.extend(_file_records(*inflight.popleft()))
    while inflight:
        records.extend(_file_records(*inflight.popleft()))
    if banded is not None and banded.model_index:  # model rank 0 of its data index holds the same records
        records = []
    # every rank's records (one process: its own) in batch order, each image
    # once: the final batch's padding repeats records
    seen: set = set()
    gathered, records = mesh.all_gather_object(records), []
    for _, rec in sorted((item for part in gathered for item in part), key=lambda t: t[0]):
        if rec["image_id"] not in seen:
            seen.add(rec["image_id"])
            records.append(rec)

    for rec in records:
        for ev in evaluators:
            ev.process_image(
                rec["image_id"], rec["boxes"], rec["scores"], rec["classes"], rec["gt_boxes"], rec["gt_classes"]
            )

    if dump_json and mesh.is_main():
        dump = []
        for rec in records:
            for b, sc, c in zip(rec["boxes"], rec["scores"], rec["classes"]):
                cat = category_ids.get(int(c), int(c) + 1) if category_ids else int(c) + 1
                dump.append(
                    {
                        "image_id": rec["image_id"],
                        "category_id": cat,
                        "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
                        "score": float(sc),
                    }
                )
        os.makedirs(os.path.dirname(dump_json) or ".", exist_ok=True)
        with open(dump_json, "w") as f:
            json.dump(dump, f)

    results = {}
    for ev in evaluators:
        results.update(ev.evaluate())
    return results
