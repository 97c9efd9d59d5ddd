"""Detection evaluators (the port of `simple_sfod_tpu/evaluation/`): COCO
mAP (plain and C++), F1, DECE, Pascal-VOC AP50, and their per-dataset
selection."""

from .coco_eval import COCOEvaluator, coco_map
from .dece import DECEEvaluator
from .f1 import F1Evaluator

__all__ = ["COCOEvaluator", "coco_map", "F1Evaluator", "DECEEvaluator"]
