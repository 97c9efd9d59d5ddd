"""Splice a model's COCO detection dump into a train JSON as pseudo ground
truth: the second stage of fixed-pseudo-label self-training (the port's own
copy of the JAX package's `tools/converters/prediction_to_gt.py`; standard
library only).

    python -m simple_sfod_tpu_torch.tools.prediction_to_gt \\
        --predictions inference/coco_instances_results.json \\
        --annotations instancesonly_filtered_gtFine_train_foggy_beta_0.02.json \\
        --output .../instancesonly_filtered_gtFine_train_adabn.json \\
        [--score-thresh 0.7]

Every detection scoring at least the threshold becomes an annotation (its
XYWH box, category, score, area w * h, iscrowd 0, ids from 1 in the dump's
order); the train JSON's other keys are kept and its annotations replaced.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def convert(predictions: list, annotations: dict, score_thresh: float = 0.7) -> dict:
    pseudo = []
    next_id = 1
    for p in predictions:
        if p["score"] < score_thresh:
            continue
        pseudo.append(
            {
                "image_id": p["image_id"],
                "bbox": p["bbox"],  # XYWH, as in detection dumps
                "category_id": p["category_id"],
                "id": next_id,
                "area": float(p["bbox"][2] * p["bbox"][3]),
                "iscrowd": 0,
                "score": p["score"],
            }
        )
        next_id += 1
    out = dict(annotations)
    out["annotations"] = pseudo
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Splice detections into a train JSON as pseudo ground truth.")
    ap.add_argument("--predictions", required=True)
    ap.add_argument("--annotations", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--score-thresh", type=float, default=0.7)
    args = ap.parse_args(argv)
    with open(args.predictions) as f:
        preds = json.load(f)
    with open(args.annotations) as f:
        anns = json.load(f)
    out = convert(preds, anns, args.score_thresh)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(out['annotations'])} pseudo-GT annotations -> {args.output}")
    return len(out["annotations"])


if __name__ == "__main__":
    main()
