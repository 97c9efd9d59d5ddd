"""ctypes binding of the repo's C++ COCO evaluator (`native/cocoeval.cpp`,
built by host_libs.py): the port's own binding, with the contract of
`simple_sfod_tpu/evaluation/native.py`.

The C ABI carries int64 image ids; records keyed by other ids (the
file-stem strings of the VOC tooling) take the plain `coco_map` instead
(`takes_ids`). A library that does not build, or whose result layout
disagrees with this module's, raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np

from .. import host_libs

NUM_THR = 10
NUM_AREAS = 4
BLOCK = NUM_AREAS * NUM_THR + 1

_lib = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = host_libs.load("cocoeval")
            nt, na = ctypes.c_int32(0), ctypes.c_int32(0)
            lib.coco_layout(ctypes.byref(nt), ctypes.byref(na))
            if (nt.value, na.value) != (NUM_THR, NUM_AREAS):
                raise RuntimeError(
                    f"cocoeval library layout ({nt.value} thresholds, {na.value} areas) differs from the "
                    f"binding's ({NUM_THR}, {NUM_AREAS})"
                )
            i64, i32, f64 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)
            lib.coco_evaluate.restype = ctypes.c_int
            lib.coco_evaluate.argtypes = [
                i64, i32, f64, f64, ctypes.c_int64,
                i64, i32, f64, ctypes.c_int64,
                i64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f64,
            ]
            _lib = lib
        return _lib


def takes_ids(detections: Dict, ground_truth: Dict) -> bool:
    """Whether every image id is an integer (the C ABI's int64)."""
    return all(isinstance(k, (int, np.integer)) for d in (detections, ground_truth) for k in d)


def _flatten(d: Dict, with_scores: bool):
    img, cat, score, box = [], [], [], []
    for image_id, rec in d.items():
        boxes = np.asarray(rec["boxes"], np.float64).reshape(-1, 4)
        classes = np.asarray(rec["classes"], np.int32).reshape(-1)
        n = len(classes)
        # the C side indexes the boxes by the classes' count: a mismatched
        # record must fail here, not read past the buffer
        if len(boxes) != n:
            raise ValueError(f"record {image_id!r}: {len(boxes)} boxes vs {n} classes")
        if with_scores:
            s = np.asarray(rec["scores"], np.float64).reshape(-1)
            if len(s) != n:
                raise ValueError(f"record {image_id!r}: {len(s)} scores vs {n} classes")
            score.extend(s.tolist())
        img.extend([image_id] * n)
        cat.extend(classes.tolist())
        box.append(boxes)
    box_arr = np.concatenate(box, axis=0) if box else np.zeros((0, 4))
    return (
        np.asarray(img, np.int64),
        np.asarray(cat, np.int32),
        np.asarray(score, np.float64),
        np.ascontiguousarray(box_arr),
    )


def coco_map_native(detections: Dict[int, dict], ground_truth: Dict[int, dict], num_classes: int, max_dets: int = 100) -> dict:
    """The contract of coco_eval.coco_map, in C++. Image ids must be integers
    (`takes_ids`)."""
    if not takes_ids(detections, ground_truth):
        raise TypeError("coco_map_native takes integer image ids; use coco_eval.coco_map for others")
    lib = _load()
    d_img, d_cat, d_score, d_box = _flatten(detections, True)
    g_img, g_cat, _, g_box = _flatten(ground_truth, False)
    image_ids = np.asarray(sorted(ground_truth.keys()), np.int64)
    out = np.full((num_classes * BLOCK,), -1.0, np.float64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.coco_evaluate(
        ptr(d_img, ctypes.c_int64), ptr(d_cat, ctypes.c_int32), ptr(d_score, ctypes.c_double),
        ptr(d_box, ctypes.c_double), len(d_img),
        ptr(g_img, ctypes.c_int64), ptr(g_cat, ctypes.c_int32), ptr(g_box, ctypes.c_double), len(g_img),
        ptr(image_ids, ctypes.c_int64), len(image_ids), num_classes, max_dets, ptr(out, ctypes.c_double),
    )
    if rc != 0:
        raise RuntimeError(f"coco_evaluate failed (code {rc})")

    out = out.reshape(num_classes, BLOCK)
    aps = out[:, : NUM_AREAS * NUM_THR].reshape(num_classes, NUM_AREAS, NUM_THR)
    ar = out[:, -1]

    def mean_valid(x):
        valid = x >= 0
        return float(x[valid].mean()) if valid.any() else float("nan")

    per_class_ap = np.where(np.all(aps[:, 0] >= 0, axis=1), aps[:, 0].mean(axis=1), np.nan)
    per_class_ap50 = np.where(aps[:, 0, 0] >= 0, aps[:, 0, 0], np.nan)
    per_class_ap75 = np.where(aps[:, 0, 5] >= 0, aps[:, 0, 5], np.nan)

    def nanmean(x):
        ok = ~np.isnan(x)
        return float(x[ok].mean()) if ok.any() else float("nan")

    return {
        "AP": 100 * nanmean(per_class_ap),
        "AP50": 100 * nanmean(per_class_ap50),
        "AP75": 100 * nanmean(per_class_ap75),
        "APs": 100 * mean_valid(aps[:, 1].reshape(-1)),
        "APm": 100 * mean_valid(aps[:, 2].reshape(-1)),
        "APl": 100 * mean_valid(aps[:, 3].reshape(-1)),
        "AR100": 100 * mean_valid(ar),
        "per_class_AP": (100 * per_class_ap).tolist(),
        "per_class_AP50": (100 * per_class_ap50).tolist(),
    }
