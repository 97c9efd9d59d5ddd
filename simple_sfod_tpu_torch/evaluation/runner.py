"""The load-and-evaluate core of the offline metrics toolkit (the port's
copy of `simple_sfod_tpu/evaluation/runner.py`): the CLI
(tools/metrics_tool.py) and the web GUI (evaluation/gui.py) both go through
`load_inputs` and `run_metrics`, over the port's COCO, Pascal VOC (the
toolkit's protocol) and F1 evaluators.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .toolkit import load_detections, load_ground_truth

GT_FORMATS = ("coco", "voc", "yolo", "abs-xywh", "abs-xyxy")
DET_FORMATS = ("coco", "yolo", "abs-xywh", "abs-xyxy")


def load_inputs(
    gt: str,
    gt_format: str,
    det: Optional[str],
    det_format: Optional[str],
    names: Optional[List[str]] = None,
    images_dir: Optional[str] = None,
) -> Tuple[Dict, Optional[Dict], List[str]]:
    """Load GT (and detections when det is given) into the toolkit's record
    dicts. Returns (gts, dets-or-None, class_names)."""
    gts, class_names, table = load_ground_truth(gt, gt_format, names=names, images_dir=images_dir)
    dets = None
    if det:
        dets = load_detections(
            det,
            det_format,
            table=table,
            gt_path=gt if gt_format == "coco" else None,
            images_dir=images_dir,
        )
    return gts, dets, class_names


def record_arrays(rec: dict, detections: bool):
    """Normalise a toolkit record to (boxes, [scores,] classes) numpy arrays."""
    b = np.asarray(rec.get("boxes", []), np.float64).reshape(-1, 4)
    c = np.asarray(rec.get("classes", []), np.int64).reshape(-1)
    if detections:
        s = np.asarray(rec.get("scores", []), np.float64).reshape(-1)
        return b, s, c
    return b, c


def run_metrics(
    gts: Dict,
    dets: Dict,
    class_names: List[str],
    metrics: Iterable[str] = ("coco", "voc", "f1"),
    iou: float = 0.5,
    voc_method: str = "all_point",
    want_curves: bool = False,
    f1_mode: str = "reference",
) -> Tuple[Dict[str, dict], Optional[Dict]]:
    """Evaluate the requested metric families; returns (results, voc curves)."""
    wanted = set(metrics)
    curves = None
    results: Dict[str, dict] = {}
    if "coco" in wanted:
        from .coco_eval import COCOEvaluator

        ev = COCOEvaluator(class_names)
        # the evaluator's native path wants integer image ids; formats with
        # filename-stem ids get a dense remap
        for int_id, (img_id, gt) in enumerate(sorted(gts.items(), key=lambda kv: str(kv[0]))):
            db, ds, dc = record_arrays(dets.get(img_id, {}), True)
            gb, gc = record_arrays(gt, False)
            ev.process_image(int_id, db, ds, dc, gb, gc)
        results["coco"] = ev.evaluate()
    if "voc" in wanted:
        from .voc import PascalVOCEvaluator

        # the toolkit's reference counterpart is the vendored padilla
        # evaluator (>= threshold, no difficult handling), not d2's voc_eval
        ev = PascalVOCEvaluator(
            class_names, iou_thresh=iou, method=voc_method, protocol="toolkit"
        )
        for img_id, gt in gts.items():
            db, ds, dc = record_arrays(dets.get(img_id, {}), True)
            gb, gc = record_arrays(gt, False)
            ev.process_image(img_id, db, ds, dc, gb, gc)
        results["voc"] = ev.evaluate(return_curves=want_curves)
        curves = results["voc"].pop("curves", None)
    if "f1" in wanted:
        from .f1 import F1Evaluator

        # default 'reference' = the daod evaluator's semantics (score>=0.5,
        # top-5/image); pass f1_mode='greedy' for the cap-free variant the
        # toolkit reported before round 4 — the output's F1_mode labels which
        ev = F1Evaluator(iou_thresh=iou, mode=f1_mode)
        for img_id, gt in gts.items():
            db, ds, dc = record_arrays(dets.get(img_id, {}), True)
            gb, gc = record_arrays(gt, False)
            ev.process_image(img_id, db, ds, dc, gb, gc)
        results["f1"] = ev.evaluate()
    return results, curves
