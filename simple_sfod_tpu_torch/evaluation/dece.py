"""Detection expected calibration error (the port's copy of
`simple_sfod_tpu/evaluation/dece.py`): detections above ``score_thresh``,
each matched greedily in score order to an unmatched same-class GT at IoU
>= 0.5, then equal-width confidence binning of matched against unmatched.

The default is 10 fixed bins; ``bins="netcal"`` reproduces the reference's
netcal call with one bin per collected detection.
"""

from __future__ import annotations

import numpy as np

from .coco_eval import _iou


class DECEEvaluator:
    def __init__(self, iou_thresh: float = 0.5, bins=10, score_thresh: float = 0.05):
        self.iou_thresh = iou_thresh
        self.bins = bins
        self.score_thresh = score_thresh
        self.reset()

    def reset(self):
        self.confidences = []
        self.correct = []

    def process_image(self, image_id, det_boxes, det_scores, det_classes, gt_boxes, gt_classes):
        det_boxes = np.asarray(det_boxes, np.float64).reshape(-1, 4)
        det_scores = np.asarray(det_scores, np.float64)
        det_classes = np.asarray(det_classes)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_classes = np.asarray(gt_classes)
        keep = det_scores >= self.score_thresh
        det_boxes, det_scores, det_classes = det_boxes[keep], det_scores[keep], det_classes[keep]
        order = np.argsort(-det_scores, kind="stable")
        det_boxes, det_scores, det_classes = det_boxes[order], det_scores[order], det_classes[order]
        taken = np.zeros(len(gt_boxes), bool)
        ious = _iou(det_boxes, gt_boxes) if len(det_boxes) and len(gt_boxes) else None
        for di in range(len(det_boxes)):
            hit = False
            if ious is not None:
                for gi in range(len(gt_boxes)):
                    if taken[gi] or gt_classes[gi] != det_classes[di]:
                        continue
                    if ious[di, gi] >= self.iou_thresh:
                        taken[gi] = True
                        hit = True
                        break
            self.confidences.append(det_scores[di])
            self.correct.append(hit)

    def evaluate(self) -> dict:
        conf = np.asarray(self.confidences)
        corr = np.asarray(self.correct, np.float64)
        if len(conf) == 0:
            return {"DECE": float("nan")}
        # bins="netcal": one bin per detection, as the reference's netcal call
        nbins = len(conf) if self.bins == "netcal" else int(self.bins)
        # equal-width bins by searchsorted + bincount: O(n log n) where a
        # loop over n bins would be O(n^2) (conf in [edges[b], edges[b+1]),
        # the last bin closed)
        edges = np.linspace(0, 1, nbins + 1)
        idx = np.clip(np.searchsorted(edges, conf, side="right") - 1, 0, nbins - 1)
        cnt = np.bincount(idx, minlength=nbins).astype(np.float64)
        csum = np.bincount(idx, weights=conf, minlength=nbins)
        hsum = np.bincount(idx, weights=corr, minlength=nbins)
        nz = cnt > 0
        ece = np.sum(
            cnt[nz] / len(conf) * np.abs(csum[nz] / cnt[nz] - hsum[nz] / cnt[nz])
        )
        return {"DECE": float(ece)}
