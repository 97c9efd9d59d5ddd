"""Pascal-VOC detection evaluation (the port's copy of
`simple_sfod_tpu/evaluation/voc.py`): AP50 with VOC2010+ all-point or
VOC2007 11-point interpolation, for the clipart/comic/watercolor datasets.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .coco_eval import _iou


class PascalVOCEvaluator:
    """method="all_point" (VOC2010+) or "11_point" (VOC2007).

    protocol="d2" (default) is detectron2's voc_eval, the evaluator of
    clipart/comic/watercolor: detections in global score order match their
    max-IoU GT (difficult GT included in the argmax), strict `> thresh`,
    a second match to an already-taken GT is a FALSE POSITIVE, detections
    matched to difficult GT are IGNORED (neither TP nor FP), and difficult
    GT do not count toward the AP denominator. voc_eval's +1 inclusive-pixel
    arithmetic in VOC coordinates reduces exactly to continuous IoU in the
    d2/file coordinates this evaluator receives (the -1/+1 shifts cancel).

    protocol="toolkit" is the padilla evaluator's matching: `>=`
    threshold, no difficult handling (the offline metrics toolkit's).
    """

    def __init__(
        self,
        thing_classes: Sequence[str],
        iou_thresh: float = 0.5,
        method: str = "all_point",
        protocol: str = "d2",
        difficult_map=None,
    ):
        """difficult_map: optional {image_id: difficult flags in record/GT
        row order} for callers whose process_image GT does not carry the
        flags (the fixed-capacity eval batches); evaluation/build.py fills
        it from the dataset registry. An explicit gt_difficult wins."""
        assert protocol in ("d2", "toolkit"), protocol
        self.thing_classes = list(thing_classes)
        self.iou_thresh = iou_thresh
        self.method = method
        self.protocol = protocol
        self.difficult_map = difficult_map or {}
        self.reset()

    def reset(self):
        self._dets: Dict[int, dict] = {}
        self._gts: Dict[int, dict] = {}

    def process_image(
        self,
        image_id,
        det_boxes,
        det_scores,
        det_classes,
        gt_boxes,
        gt_classes,
        gt_difficult=None,
    ):
        self._dets[image_id] = {
            "boxes": np.asarray(det_boxes, np.float64).reshape(-1, 4),
            "scores": np.asarray(det_scores, np.float64).reshape(-1),
            "classes": np.asarray(det_classes).reshape(-1),
        }
        gb = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        n = gb.shape[0]
        if gt_difficult is None:
            gt_difficult = self.difficult_map.get(image_id)
        if gt_difficult is None:
            diff = np.zeros(n, bool)
        else:
            # GT rows are the record's boxes in order (capacity-truncated),
            # so a record-order flag list aligns; pad short lists with False
            diff = np.zeros(n, bool)
            flags = np.asarray(gt_difficult).reshape(-1).astype(bool)[:n]
            diff[: len(flags)] = flags
        self._gts[image_id] = {
            "boxes": gb,
            "classes": np.asarray(gt_classes).reshape(-1),
            "difficult": diff,
        }

    def evaluate(self, return_curves: bool = False) -> dict:
        aps = []
        per_class = {}
        curves = {}
        use_difficult = self.protocol == "d2"
        for c, name in enumerate(self.thing_classes):
            scores, tp_flags, n_gt = [], [], 0
            for img_id, gt in self._gts.items():
                gsel = gt["classes"] == c
                gboxes = gt["boxes"][gsel]
                gdiff = gt["difficult"][gsel] if use_difficult else np.zeros(gsel.sum(), bool)
                n_gt += int((~gdiff).sum())
                det = self._dets.get(img_id)
                if det is None:
                    continue
                dsel = det["classes"] == c
                dboxes, dscores = det["boxes"][dsel], det["scores"][dsel]
                order = np.argsort(-dscores, kind="stable")
                dboxes, dscores = dboxes[order], dscores[order]
                taken = np.zeros(len(gboxes), bool)
                ious = _iou(dboxes, gboxes) if len(dboxes) and len(gboxes) else None
                for di in range(len(dboxes)):
                    hit = False
                    ignored = False
                    if ious is not None and len(gboxes):
                        # voc_eval/padilla: argmax over ALL gt (taken and
                        # difficult included); a re-match is a FP
                        gi = int(np.argmax(ious[di]))
                        ovmax = ious[di, gi]
                        over = (
                            ovmax > self.iou_thresh
                            if self.protocol == "d2"
                            else ovmax >= self.iou_thresh
                        )
                        if over:
                            if gdiff[gi]:
                                ignored = True  # matched difficult: no TP, no FP
                            elif not taken[gi]:
                                taken[gi] = True
                                hit = True
                    if not ignored:
                        scores.append(dscores[di])
                        tp_flags.append(hit)
            if n_gt == 0:
                continue
            if not scores:
                aps.append(0.0)
                per_class[name] = 0.0
                continue
            order = np.argsort(-np.asarray(scores), kind="stable")
            tp = np.cumsum(np.asarray(tp_flags)[order])
            fp = np.cumsum(~np.asarray(tp_flags)[order])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, 1e-12)
            curves[name] = (rec.copy(), prec.copy())
            if self.method == "11_point":
                # VOC2007 11-point interpolation
                ap = 0.0
                for r in np.linspace(0, 1, 11):
                    above = prec[rec >= r]
                    ap += float(above.max()) if above.size else 0.0
                ap /= 11.0
            else:
                # VOC2010+ all-point interpolation
                mrec = np.concatenate([[0.0], rec, [1.0]])
                mpre = np.concatenate([[0.0], prec, [0.0]])
                for i in range(len(mpre) - 2, -1, -1):
                    mpre[i] = max(mpre[i], mpre[i + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
            aps.append(ap)
            per_class[name] = 100 * ap
        out = {
            "VOC_AP50": 100 * float(np.mean(aps)) if aps else float("nan"),
            "voc_per_class": per_class,
        }
        if return_curves:
            out["curves"] = curves
        return out
