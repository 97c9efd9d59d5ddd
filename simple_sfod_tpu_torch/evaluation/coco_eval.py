"""COCO-style mAP (the port's copy of `simple_sfod_tpu/evaluation/coco_eval.py`),
from the COCO metric's definition, without pycocotools: greedy per-image
matching at IoU .50:.05:.95 with pycocotools' tie and threshold semantics,
101-point interpolated precision, area ranges, maxDets 100.

`coco_map` is the plain implementation; `COCOEvaluator.evaluate` runs the C++
one (evaluation/native.py) on integer image ids and `coco_map` on others.
The evaluator reports per-class AP and AP50, and takes an optional class
remap of the predictions (the car-only Sim10k/KITTI protocol).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _iou(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[D, 4] x [G, 4] XYXY -> [D, G]."""
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = a_d[:, None] + a_g[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def _match_image(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    amin: float,
    amax: float,
    max_dets: int,
):
    """Greedy matching for one (image, category, area range) at all IoU
    thresholds, with COCOeval's ignore semantics: GT outside the area range
    are IGNORED (they can still absorb detections, which then count neither
    as TP nor FP), and unmatched detections outside the range are ignored
    too. Matching prefers non-ignored GT (ignored GT sort last and the scan
    stops there once a non-ignored match is held).

    Returns (det_scores_sorted [D], matched [T, D], ignored [T, D], npig).
    """
    order = np.argsort(-det_scores, kind="stable")[:max_dets]
    det_boxes = det_boxes[order]
    det_scores = det_scores[order]
    d, g = len(det_boxes), len(gt_boxes)
    t = len(IOU_THRS)

    g_areas = (
        (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        if g
        else np.zeros(0)
    )
    gt_ig = ~((g_areas >= amin) & (g_areas < amax))
    gind = np.argsort(gt_ig, kind="stable")  # non-ignored first
    gt_boxes, gt_ig = gt_boxes[gind], gt_ig[gind]

    matched = np.zeros((t, d), bool)
    ignored = np.zeros((t, d), bool)
    if d and g:
        ious = _iou(det_boxes, gt_boxes)
        for ti, thr in enumerate(IOU_THRS):
            gt_taken = np.zeros(g, bool)
            for di in range(d):
                # pycocotools-exact: threshold min(thr, 1-1e-10), a
                # candidate is accepted at ious >= running best (so equal-IoU
                # ties go to the LATER gt, as COCOeval's evaluateImg does)
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in range(g):
                    if gt_taken[gi]:
                        continue
                    if best >= 0 and not gt_ig[best] and gt_ig[gi]:
                        break
                    if ious[di, gi] >= best_iou:
                        best, best_iou = gi, ious[di, gi]
                if best >= 0:
                    gt_taken[best] = True
                    matched[ti, di] = True
                    ignored[ti, di] = gt_ig[best]
    if d:
        d_areas = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
        d_out = ~((d_areas >= amin) & (d_areas < amax))
        ignored |= (~matched) & d_out[None, :]
    return det_scores, matched, ignored, int((~gt_ig).sum())


def coco_map(
    detections: Dict[int, dict],
    ground_truth: Dict[int, dict],
    num_classes: int,
    max_dets: int = 100,
) -> dict:
    """Compute COCO AP metrics.

    detections:   {image_id: {boxes [D,4], scores [D], classes [D]}}
    ground_truth: {image_id: {boxes [G,4], classes [G]}}
    Returns {'AP', 'AP50', 'AP75', 'APs', 'APm', 'APl',
             'per_class_AP': [C], 'per_class_AP50': [C], 'AR100': float}.
    """
    t = len(IOU_THRS)
    per_class_ap = np.full(num_classes, np.nan)
    per_class_ap50 = np.full(num_classes, np.nan)
    per_class_ap75 = np.full(num_classes, np.nan)
    area_ap = {k: [] for k in ("small", "medium", "large")}
    recalls = []

    image_ids = sorted(ground_truth.keys())

    for area_name, (amin, amax) in AREA_RANGES.items():
        for c in range(num_classes):
            all_scores, all_matched, all_ignored, npig = [], [], [], 0
            for img_id in image_ids:
                gt = ground_truth[img_id]
                gsel = np.asarray(gt["classes"]) == c
                gboxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[gsel]
                det = detections.get(img_id, {"boxes": [], "scores": [], "classes": []})
                dsel = np.asarray(det["classes"]) == c
                dboxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)[dsel]
                dscores = np.asarray(det["scores"], np.float64)[dsel]
                sscores, matched, ignored, g = _match_image(
                    dboxes, dscores, gboxes, amin, amax, max_dets
                )
                all_scores.append(sscores)
                all_matched.append(matched)
                all_ignored.append(ignored)
                npig += g
            if npig == 0:
                continue
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            if scores.size == 0:  # GT exists but no detections: AP = 0
                if area_name == "all":
                    per_class_ap[c] = 0.0
                    per_class_ap50[c] = 0.0
                    per_class_ap75[c] = 0.0
                    recalls.append(0.0)
                else:
                    area_ap[area_name].append(0.0)
                continue
            matched = np.concatenate(all_matched, axis=1)
            ignored = np.concatenate(all_ignored, axis=1)
            order = np.argsort(-scores, kind="stable")
            matched, ignored = matched[:, order], ignored[:, order]
            tp = np.cumsum(matched & ~ignored, axis=1).astype(np.float64)
            fp = np.cumsum(~matched & ~ignored, axis=1).astype(np.float64)
            recall = tp / npig
            precision = tp / np.maximum(tp + fp, 1e-12)
            # precision envelope + 101-point interpolation
            ap_t = np.zeros(t)
            for ti in range(t):
                p = precision[ti].copy()
                for i in range(len(p) - 1, 0, -1):
                    p[i - 1] = max(p[i - 1], p[i])
                idx = np.searchsorted(recall[ti], RECALL_THRS, side="left")
                p_interp = np.where(idx < len(p), p[np.minimum(idx, len(p) - 1)], 0.0)
                ap_t[ti] = p_interp.mean()
            if area_name == "all":
                per_class_ap[c] = ap_t.mean()
                per_class_ap50[c] = ap_t[0]
                per_class_ap75[c] = ap_t[5]
                recalls.append(recall[:, -1].mean() if recall.shape[1] else 0.0)
            else:
                area_ap[area_name].append(ap_t.mean())

    def nanmean(x):
        x = np.asarray(x, np.float64)
        ok = ~np.isnan(x)
        return float(x[ok].mean()) if ok.any() else float("nan")

    return {
        "AP": 100 * nanmean(per_class_ap),
        "AP50": 100 * nanmean(per_class_ap50),
        "AP75": 100 * nanmean(per_class_ap75),
        "APs": 100 * nanmean(area_ap["small"]) if area_ap["small"] else float("nan"),
        "APm": 100 * nanmean(area_ap["medium"]) if area_ap["medium"] else float("nan"),
        "APl": 100 * nanmean(area_ap["large"]) if area_ap["large"] else float("nan"),
        "AR100": 100 * nanmean(recalls) if recalls else float("nan"),
        "per_class_AP": (100 * per_class_ap).tolist(),
        "per_class_AP50": (100 * per_class_ap50).tolist(),
    }


class COCOEvaluator:
    """Streaming evaluator: process_image() per image, then evaluate().

    class_remap maps predicted contiguous ids to evaluated ones before
    matching (-1 drops the prediction): the car-only Sim10k/KITTI protocol
    sends the car-family predictions onto a car-only ground truth.
    """

    def __init__(
        self,
        thing_classes: Sequence[str],
        class_remap: Optional[Dict[int, int]] = None,
        max_dets: int = 100,
    ):
        self.thing_classes = list(thing_classes)
        self.class_remap = class_remap
        self.max_dets = max_dets
        self.reset()

    def reset(self):
        self._dets: Dict[int, dict] = {}
        self._gts: Dict[int, dict] = {}

    def process_image(
        self,
        image_id: int,
        det_boxes: np.ndarray,
        det_scores: np.ndarray,
        det_classes: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
    ):
        det_classes = np.asarray(det_classes)
        if self.class_remap is not None:
            remapped = np.array(
                [self.class_remap.get(int(c), int(c)) for c in det_classes], np.int64
            )
            keep = remapped >= 0
            det_boxes = np.asarray(det_boxes)[keep]
            det_scores = np.asarray(det_scores)[keep]
            det_classes = remapped[keep]
        self._dets[image_id] = {
            "boxes": np.asarray(det_boxes),
            "scores": np.asarray(det_scores),
            "classes": det_classes,
        }
        self._gts[image_id] = {
            "boxes": np.asarray(gt_boxes),
            "classes": np.asarray(gt_classes),
        }

    def evaluate(self) -> dict:
        from .native import coco_map_native, takes_ids

        if takes_ids(self._dets, self._gts):
            res = coco_map_native(self._dets, self._gts, len(self.thing_classes), self.max_dets)
        else:
            res = coco_map(self._dets, self._gts, len(self.thing_classes), self.max_dets)
        res["per_class"] = {
            name: {"AP": res["per_class_AP"][i], "AP50": res["per_class_AP50"][i]}
            for i, name in enumerate(self.thing_classes)
        }
        return res
