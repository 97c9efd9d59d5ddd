"""COCO-JSON dataset loading without pycocotools (the port's copy of
`simple_sfod_tpu/data/coco.py`): the per-image record schema of
detectron2's `load_coco_json` (file_name, height, width, image_id, XYXY
boxes and contiguous class ids)."""

from __future__ import annotations

import json
import os
from typing import Dict, List


def load_coco_json(
    json_file: str,
    image_root: str,
    filter_empty: bool = False,
) -> Dict:
    """Returns {'records': [...], 'thing_classes': [...], 'id_map': {...}}.

    Each record: {file_name, height, width, image_id,
                  boxes: [[x1,y1,x2,y2], ...], classes: [contiguous ids]}.

    Crowd annotations and boxes of zero width or height are dropped.
    filter_empty defaults to False as in detectron2: dropping images without
    annotations is the train loader's decision
    (DATALOADER.FILTER_EMPTY_ANNOTATIONS, data/loader.py); at evaluation
    every image is scored, so false positives on empty images count.
    """
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    thing_classes = [c["name"] for c in cats]
    id_map = {c["id"]: i for i, c in enumerate(cats)}

    anns_by_img: Dict[int, List[dict]] = {}
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd", 0):
            continue
        anns_by_img.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in coco["images"]:
        anns = anns_by_img.get(img["id"], [])
        boxes, classes = [], []
        for a in anns:
            x, y, w, h = a["bbox"]
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            classes.append(id_map[a["category_id"]])
        if filter_empty and not boxes:
            continue
        records.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "height": img["height"],
                "width": img["width"],
                "image_id": img["id"],
                "boxes": boxes,
                "classes": classes,
            }
        )
    return {"records": records, "thing_classes": thing_classes, "id_map": id_map}
