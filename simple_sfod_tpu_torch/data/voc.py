"""Pascal-VOC XML dataset loading (the port's copy of
`simple_sfod_tpu/data/voc.py`), for clipart (the 20 VOC classes), comic and
watercolor (a 6-class subset), in the records of data/coco.py.

Layout:
    <dirname>/ImageSets/Main/<split>.txt   one file id per line
    <dirname>/Annotations/<id>.xml         objects with 1-based inclusive boxes
    <dirname>/JPEGImages/<id>.jpg
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Sequence

# detectron2's pascal_voc CLASS_NAMES: the clipart classes
VOC_CLASS_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
# the comic / watercolor subset
VOC6_CLASS_NAMES = ["bicycle", "bird", "car", "cat", "dog", "person"]


def load_voc_instances(
    dirname: str,
    split: str,
    class_names: Sequence[str],
    filter_empty: bool = False,
) -> Dict:
    """Returns {'records': [...], 'thing_classes': [...], 'id_map': {...}}.

    Box semantics follow d2's load_voc_instances: VOC annotations are 1-based
    inclusive pixel indices, so xmin/ymin get -1 to land in [0, W) coordinate
    space; "difficult" objects are kept WITH their flag (records carry a
    'difficult' list — d2's voc_eval excludes difficult GT from the AP
    denominator and ignores detections matched to them). image_id is the
    dense index of the file id within the split file (the eval loop requires
    integer ids); the VOC file id is kept as 'voc_id'. Objects whose class
    name is outside class_names are skipped (the 6-class subsets).

    filter_empty defaults to False, as in data/coco.py."""
    class_index = {n: i for i, n in enumerate(class_names)}
    split_file = os.path.join(dirname, "ImageSets", "Main", f"{split}.txt")
    with open(split_file) as f:
        fileids = [ln.strip() for ln in f if ln.strip()]

    records = []
    for image_id, fileid in enumerate(fileids):
        ann_file = os.path.join(dirname, "Annotations", f"{fileid}.xml")
        tree = ET.parse(ann_file)
        height = int(tree.findall("./size/height")[0].text)
        width = int(tree.findall("./size/width")[0].text)
        boxes, classes, difficult = [], [], []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in class_index:
                continue
            bb = obj.find("bndbox")
            x1, y1, x2, y2 = (
                float(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")
            )
            boxes.append([x1 - 1.0, y1 - 1.0, x2, y2])
            classes.append(class_index[cls])
            diff = obj.find("difficult")
            difficult.append(int(diff.text) if diff is not None else 0)
        if filter_empty and not boxes:
            continue
        records.append(
            {
                "file_name": os.path.join(dirname, "JPEGImages", f"{fileid}.jpg"),
                "height": height,
                "width": width,
                "image_id": image_id,
                "voc_id": fileid,
                "boxes": boxes,
                "classes": classes,
                "difficult": difficult,
            }
        )
    return {
        "records": records,
        "thing_classes": list(class_names),
        "id_map": {i: i for i in range(len(class_names))},
    }
