"""Evaluators of one dataset (the port of `simple_sfod_tpu/evaluation/build.py`):
COCO mAP, F1 and DECE by default; the car-only remapped COCO protocol for the
Sim10k/KITTI cross-domain evaluations (the car-family predictions collapse
onto the single 'car' class); VOC AP50 and F1 for clipart/comic/watercolor.

One deliberate difference: a `class_remap` registered with the dataset
(data/datasets.py:register_dataset) is applied. The JAX function imports
`get_dataset` only inside its VOC branch, so in the other branch the name is
unbound, the lookup raises inside its `try` and a registered remap is always
dropped (tests/test_torch_evaluation.py pins both behaviours).
"""

from __future__ import annotations

from ..data.datasets import DATASET_REGISTRY, get_dataset
from .coco_eval import COCOEvaluator
from .dece import DECEEvaluator
from .f1 import F1Evaluator
from .voc import PascalVOCEvaluator

# Cityscapes contiguous ids: person 0, rider 1, car 2, truck 3, bus 4,
# train 5, motorcycle 6, bicycle 7. The car-only protocol sends the car
# family onto the car class and drops the rest.
CAR_ONLY_REMAP = {0: -1, 1: -1, 2: 0, 3: 0, 4: 0, 5: -1, 6: -1, 7: -1}

VOC_DATASET_PREFIXES = ("clipart", "comic", "watercolor")


def build_evaluators(cfg, dataset_name: str, thing_classes):
    f1_mode = getattr(cfg.TEST, "F1_MODE", "reference")
    evaluators = []
    if any(dataset_name.startswith(p) for p in VOC_DATASET_PREFIXES):
        # detectron2's voc_eval needs the difficult flags, which the batches
        # do not carry: a per-image map from the registry's records (in the
        # order of the batches' GT rows); none for a dataset that cannot be
        # loaded (an evaluator built on its own)
        try:
            difficult_map = {r["image_id"]: r.get("difficult", ()) for r in get_dataset(dataset_name)["records"]}
        except (KeyError, OSError):
            difficult_map = None
        evaluators.append(PascalVOCEvaluator(thing_classes, difficult_map=difficult_map))
        evaluators.append(F1Evaluator(mode=f1_mode))
        return evaluators
    entry = DATASET_REGISTRY.get(dataset_name)
    registered_remap = entry.get("class_remap") if entry else None
    car_only = len(thing_classes) == 1 and (
        "sim10k" in dataset_name or "kitti" in dataset_name or list(thing_classes) == ["car"]
    )
    if registered_remap is not None:
        evaluators.append(
            COCOEvaluator(thing_classes, class_remap=registered_remap, max_dets=cfg.TEST.DETECTIONS_PER_IMAGE)
        )
    elif car_only and cfg.MODEL.ROI_HEADS.NUM_CLASSES == 8:
        evaluators.append(COCOEvaluator(["car"], class_remap=CAR_ONLY_REMAP, max_dets=cfg.TEST.DETECTIONS_PER_IMAGE))
    else:
        evaluators.append(COCOEvaluator(thing_classes, max_dets=cfg.TEST.DETECTIONS_PER_IMAGE))
    evaluators.append(F1Evaluator(mode=f1_mode))
    evaluators.append(DECEEvaluator())
    return evaluators
