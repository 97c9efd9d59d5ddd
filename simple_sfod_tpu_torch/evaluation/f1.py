"""Dataset-level F1 at IoU 0.5 (the port's copy of
`simple_sfod_tpu/evaluation/f1.py`). Two matching modes:

- ``mode="reference"``, the reference evaluator's semantics: detections
  with score >= ``score_thresh``, the ``top_n`` highest-scoring per image,
  boxes cast to int32; within-class matching, global-max-IoU first, a strict
  ``iou > thresh`` test and the +1 pixel-area IoU convention.
- ``mode="greedy"``: score-ordered greedy matching with >= threshold and
  exact areas, without the cap.

Both report the same keys; ``F1_mode`` says which semantics made the number.
"""

from __future__ import annotations


import numpy as np

from .coco_eval import _iou


def _iou_plus1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the reference's +1 pixel-area convention."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    xx1 = np.maximum(a[:, None, 0], b[None, :, 0])
    yy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    xx2 = np.minimum(a[:, None, 2], b[None, :, 2])
    yy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    w = np.maximum(0.0, xx2 - xx1 + 1)
    h = np.maximum(0.0, yy2 - yy1 + 1)
    inter = w * h
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def count_confusions_reference(
    eval_boxes: np.ndarray, output_boxes: np.ndarray, iou_thresh: float
) -> dict:
    """The reference's count_confusions: repeatedly take the first entry tied
    with the global max IoU while it is strictly above the threshold, zeroing
    its row and column."""
    ious = _iou_plus1(eval_boxes, output_boxes)
    eval_trues: list = []
    output_trues: list = []
    while True:
        ret = np.where((ious > iou_thresh) & (ious == ious.max()))
        if len(ret[0]) > 0:
            ei, oi = int(ret[0][0]), int(ret[1][0])
            ious[ei, :] = 0
            ious[:, oi] = 0
            eval_trues.append(ei)
            output_trues.append(oi)
        else:
            break
    return {
        "true_positive": len(eval_trues),
        "false_positive": sum(1 for i in range(len(output_boxes)) if i not in output_trues),
        "false_negative": sum(1 for i in range(len(eval_boxes)) if i not in eval_trues),
        "true_negative": 0,
    }


class F1Evaluator:
    def __init__(
        self,
        iou_thresh: float = 0.5,
        score_thresh: float = 0.5,
        mode: str = "reference",
        top_n: int = 5,
    ):
        if mode not in ("reference", "greedy"):
            raise ValueError(f"unknown F1 mode {mode!r}")
        self.iou_thresh = iou_thresh
        self.score_thresh = score_thresh
        self.mode = mode
        self.top_n = top_n
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0
        self.fn = 0

    def process_image(self, image_id, det_boxes, det_scores, det_classes, gt_boxes, gt_classes):
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float64)
        det_classes = np.asarray(det_classes)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes)

        if self.mode == "reference":
            self._process_reference(det_boxes, det_scores, det_classes, gt_boxes, gt_classes)
        else:
            self._process_greedy(det_boxes, det_scores, det_classes, gt_boxes, gt_classes)

    # -- the reference's semantics ---------------------------------------------
    def _process_reference(self, det_boxes, det_scores, det_classes, gt_boxes, gt_classes):
        if len(det_boxes) > 0:
            keep = np.where(det_scores >= self.score_thresh)[0]
            det_boxes, det_classes, det_scores = det_boxes[keep], det_classes[keep], det_scores[keep]
            # top_n per image by score (argsort is ascending; reversed)
            keep = np.argsort(det_scores)[::-1][: self.top_n]
            det_boxes, det_classes = det_boxes[keep], det_classes[keep]
            det_boxes = det_boxes.astype(np.int32).astype(np.float64)  # the reference's int cast

        # per-class partition; classes absent from both sides contribute
        # zero, so iterating the union equals a loop over every class
        for cls in np.union1d(np.unique(det_classes), np.unique(gt_classes)):
            ek = np.where(gt_classes == cls)[0]
            ok = np.where(det_classes == cls)[0]
            if len(ek) == 0:
                self.fp += len(ok)
            if len(ok) == 0:
                self.fn += len(ek)
            if len(ek) > 0 and len(ok) > 0:
                r = count_confusions_reference(gt_boxes[ek], det_boxes[ok], self.iou_thresh)
                self.tp += r["true_positive"]
                self.fp += r["false_positive"]
                self.fn += r["false_negative"]

    # -- cap-free greedy semantics ------------------------------------------------
    def _process_greedy(self, det_boxes, det_scores, det_classes, gt_boxes, gt_classes):
        keep = det_scores >= self.score_thresh
        det_boxes, det_classes = det_boxes[keep], det_classes[keep]
        det_scores = det_scores[keep]
        order = np.argsort(-det_scores, kind="stable")
        det_boxes, det_classes = det_boxes[order], det_classes[order]

        g = len(gt_boxes)
        taken = np.zeros(g, bool)
        tp = 0
        if len(det_boxes) and g:
            ious = _iou(det_boxes, gt_boxes)
            for di in range(len(det_boxes)):
                best, best_iou = -1, self.iou_thresh
                for gi in range(g):
                    if taken[gi] or gt_classes[gi] != det_classes[di]:
                        continue
                    if ious[di, gi] >= best_iou:
                        best, best_iou = gi, ious[di, gi]
                if best >= 0:
                    taken[best] = True
                    tp += 1
        self.tp += tp
        self.fp += len(det_boxes) - tp
        self.fn += g - tp

    def evaluate(self) -> dict:
        if self.mode == "reference":
            # the reference's aggregation: 0 when degenerate
            prec = self.tp / (self.tp + self.fp) if (self.tp + self.fp) else 0
            rec = self.tp / (self.tp + self.fn) if (self.tp + self.fn) else 0
            f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
        else:
            prec = self.tp / max(self.tp + self.fp, 1)
            rec = self.tp / max(self.tp + self.fn, 1)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return {"precision": prec, "recall": rec, "F1": f1, "F1_mode": self.mode}
