"""Spatio-temporal tube evaluator, STT-IoU AP over video tubes (the port's
copy of `simple_sfod_tpu/evaluation/tube.py`, a re-build of the
reference's tube evaluator, daod/src/evaluators/tube_evaluator.py and
daod/src/tube.py, which its vendored toolkit registers and nothing calls).
A host-side metric in numpy.

Semantics mirrored from the reference:
  - A tube is (category_id, video_id, track), track = list of
    {"frame": int, "bbox": [x, y, w, h], ["confidence": float]}
    (tube.py:11-36). Tube confidence = mean of frame confidences
    (tube.py:53-62); tube volume = sum of per-frame box areas w*h
    (tube.py:96-105 — computed on the xywh boxes before conversion).
  - STT-IoU(pred, gt) = I / (V_pred + V_gt - I) where I sums the
    per-common-frame box intersection areas (tube_evaluator.py:189-263).
  - Per (class, video), predictions and GTs are greedily matched
    gt-coverage-first: repeatedly take the GT tube with the highest
    remaining best-pred overlap, match it to that pred, mark both used;
    the pred is a TP iff the overlap >= thr (tube_evaluator.py:132-187).
  - Per class, predictions sorted by decreasing tube confidence across
    all videos; recall denominator = #GT tubes of the class; AP by
    every-point or 11-point interpolation (tube_evaluator.py:63-130);
    mAP = mean over the annotation file's categories.

Deviations (documented):
  - a class with zero GT tubes contributes AP 0.0 instead of the
    reference's 0/0 = nan propagation (tube_evaluator.py:101);
  - "total TP/FP/FN" accumulate over videos; the reference overwrites
    them each video iteration (tube_evaluator.py:89-93), so with >1
    video its totals report only the last video. The AP itself is
    unaffected (it reads the per-tube flags, which both versions set).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Tube:
    """One spatio-temporal tube: a (frame -> box) track with a class and video.

    Boxes arrive xywh (reference tube.py:34-36 converts to xyxy after
    computing the volume); stored here as xyxy with the xywh-derived volume.
    """

    def __init__(self, category_id: int, video_id: int, track: List[dict], **kwargs):
        self.category_id = int(category_id)
        self.video_id = int(video_id)
        frames = np.asarray([t["frame"] for t in track], np.int64)
        xywh = np.asarray([t["bbox"] for t in track], np.float64).reshape(-1, 4)
        order = np.argsort(frames, kind="stable")
        self.frames = frames[order]
        # volume from xywh areas (w*h), like the reference's pre-conversion prod
        self.volume = float(np.prod(xywh[:, 2:], axis=1).sum())
        xyxy = xywh.copy()
        xyxy[:, 2:] = xywh[:, :2] + xywh[:, 2:]
        self.boxes = xyxy[order]
        self.confidence: Optional[float] = None
        if track and "confidence" in track[0]:
            self.confidence = float(np.mean([t["confidence"] for t in track]))
        self.extra = dict(kwargs)

    def frame_box(self, frame: int) -> Optional[np.ndarray]:
        idx = np.nonzero(self.frames == frame)[0]
        return self.boxes[idx[0]] if len(idx) else None


def stt_iou(a: Tube, b: Tube) -> float:
    """Spatio-temporal tube IoU: summed common-frame intersection over the
    union of the two tubes' volumes (tube_evaluator.py:189-263)."""
    common = np.intersect1d(a.frames, b.frames)
    inter = 0.0
    for f in common:
        ba, bb = a.frame_box(int(f)), b.frame_box(int(f))
        wh = np.minimum(ba[2:], bb[2:]) - np.maximum(ba[:2], bb[:2])
        wh = np.clip(wh, 0.0, None)
        inter += float(wh[0] * wh[1])
    union = a.volume + b.volume - inter
    return inter / union if union > 0 else 0.0


def _classify_tubes(
    preds: Sequence[Tube], gts: Sequence[Tube], thr: float
) -> Tuple[np.ndarray, int, int, int]:
    """Greedy gt-coverage-first matching (tube_evaluator.py:132-187).

    Returns (is_tp flags aligned with `preds`, n_tp, n_fp, n_fn)."""
    overlaps = np.array([[stt_iou(p, g) for g in gts] for p in preds], np.float64).reshape(
        len(preds), len(gts)
    )
    is_tp = np.zeros(len(preds), bool)
    work = overlaps.copy()
    gt_overlaps = np.zeros(min(len(preds), len(gts)))
    for j in range(min(len(preds), len(gts))):
        # best remaining pred per gt, then the best-covered gt
        per_gt_best = work.max(axis=0)
        per_gt_arg = work.argmax(axis=0)
        gt_ind = int(per_gt_best.argmax())
        box_ind = int(per_gt_arg[gt_ind])
        gt_ovr = float(per_gt_best[gt_ind])
        if gt_ovr >= thr:
            is_tp[box_ind] = True
        gt_overlaps[j] = gt_ovr
        work[box_ind, :] = -1.0
        work[:, gt_ind] = -1.0
    n_tp = int((gt_overlaps >= thr).sum())
    return is_tp, n_tp, len(preds) - n_tp, len(gts) - n_tp


def _ap_every_point(rec: np.ndarray, prec: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    return ap, mpre, mrec


def _ap_11_point(rec: np.ndarray, prec: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    ap = 0.0
    for r in np.linspace(0, 1, 11):
        above = prec[rec >= r]
        ap += float(above.max()) if above.size else 0.0
    return ap / 11.0, prec, rec


class TubeEvaluator:
    """Evaluate predicted tubes against annotated tubes at an STT-IoU threshold.

    Annotation JSON: {"videos": [{"id": ...}], "categories": [{"id", "name"}],
    "annotations": [tube dicts]}. Prediction JSON: a list of tube dicts whose
    track entries carry "confidence" (tube_evaluator.py:47-61)."""

    def __init__(self, anno_filepath: str, preds_filepath: str, method: str = "all_point"):
        if not str(anno_filepath).endswith(".json"):
            raise ValueError(f"Invalid extension file: {anno_filepath}")
        if not str(preds_filepath).endswith(".json"):
            raise ValueError(f"Invalid extension file: {preds_filepath}")
        if method not in ("all_point", "11_point"):
            raise ValueError(f"Invalid interpolation method: {method}")
        self._anno_filepath = anno_filepath
        self._preds_filepath = preds_filepath
        self._method = method

    def evaluate(self, thr: float = 0.5) -> Tuple[Dict[str, dict], float]:
        if not 0 < thr <= 1:
            raise ValueError(f"IOU threshold must be 0 < thr <= 1: {thr}")
        with open(self._anno_filepath) as f:
            anno = json.load(f)
        with open(self._preds_filepath) as f:
            pred_data = json.load(f)
        gts = [Tube(**a) for a in anno["annotations"]]
        preds = [Tube(**p) for p in pred_data]
        return evaluate_tubes(
            gts, preds, anno["videos"], anno["categories"], thr=thr, method=self._method
        )


def evaluate_tubes(
    gts: Sequence[Tube],
    preds: Sequence[Tube],
    videos: Sequence[dict],
    categories: Sequence[dict],
    thr: float = 0.5,
    method: str = "all_point",
) -> Tuple[Dict[str, dict], float]:
    """In-memory core of TubeEvaluator.evaluate (tube_evaluator.py:63-130)."""
    res: Dict[str, dict] = {}
    for cat in categories:
        gt_cls = [g for g in gts if g.category_id == cat["id"]]
        preds_cls = sorted(
            [p for p in preds if p.category_id == cat["id"]],
            key=lambda t: -(t.confidence if t.confidence is not None else 0.0),
        )
        tp_flags = np.zeros(len(preds_cls), bool)
        n_tp = n_fp = n_fn = 0
        for vid in videos:
            vid_pred_idx = [i for i, p in enumerate(preds_cls) if p.video_id == vid["id"]]
            vid_gts = [g for g in gt_cls if g.video_id == vid["id"]]
            flags, t, f, n = _classify_tubes([preds_cls[i] for i in vid_pred_idx], vid_gts, thr)
            tp_flags[vid_pred_idx] = flags
            n_tp, n_fp, n_fn = n_tp + t, n_fp + f, n_fn + n
        acc_tp = np.cumsum(tp_flags.astype(np.int64))
        acc_fp = np.cumsum((~tp_flags).astype(np.int64))
        if len(gt_cls) == 0:
            ap, mpre, mrec = 0.0, np.zeros(0), np.zeros(0)
            rec = prec = np.zeros(len(preds_cls))
        else:
            rec = acc_tp / len(gt_cls)
            prec = acc_tp / np.maximum(acc_tp + acc_fp, 1)
            fn = _ap_every_point if method == "all_point" else _ap_11_point
            ap, mpre, mrec = fn(rec, prec)
        res[cat["name"]] = {
            "precision": prec,
            "recall": rec,
            "AP": ap,
            "interpolated precision": mpre,
            "interpolated recall": mrec,
            "total TP": n_tp,
            "total FP": n_fp,
            "total FN": n_fn,
        }
    mAP = float(sum(r["AP"] for r in res.values()) / max(len(categories), 1))
    return res, mAP
