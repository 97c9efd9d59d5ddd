"""Annotation and detection readers of the offline metrics toolkit (the
port's copy of `simple_sfod_tpu/evaluation/toolkit.py`, a re-build of the
reference's vendored "review_object_detection_metrics" readers).

Supported formats:
  GT:   coco (JSON), voc (Pascal XML dir), yolo (relative txt dir + images),
        abs-xywh / abs-xyxy ("<class> x y w h|x2 y2" txt dir)
  DET:  coco (results JSON), yolo ("<class> <conf> xc yc w h" relative),
        abs-xywh / abs-xyxy ("<class> <conf> ..." txt dir)

All readers return ({image_id: {"boxes" [N,4] xyxy, "classes" [N],
("scores" [N])}}, class_names) with contiguous class ids. YOLO's relative
coordinates take each image's size from its header (any format
`data/native_codec.py:image_size` reads, the image file's bytes deciding
as Image.open decides: a DIB under a .bmp name, say), not from an image
library.
"""

from __future__ import annotations

import glob
import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple


class ClassTable:
    """Name <-> contiguous-id mapping shared by GT and detections."""

    def __init__(self, names: Optional[List[str]] = None):
        self.names: List[str] = list(names) if names else []
        self._idx = {n: i for i, n in enumerate(self.names)}
        self.frozen = names is not None

    def id_for(self, name: str) -> int:
        name = str(name)
        if name not in self._idx:
            if self.frozen:
                # yolo-style numeric class tokens index the (frozen) names
                # list; anything else is unknown (-1, dropped with a warning
                # by the loaders so every evaluator sees the same records)
                try:
                    i = int(name)
                except ValueError:
                    return -1
                return i if 0 <= i < len(self.names) else -1
            self._idx[name] = len(self.names)
            self.names.append(name)
        return self._idx[name]


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


# ---------------------------------------------------------------- COCO JSON


def read_coco_gt(path: str) -> Tuple[Dict, List[str]]:
    with open(path) as f:
        data = json.load(f)
    cats = sorted(data.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    names = [c["name"] for c in cats]
    records: Dict = {}
    for img in data.get("images", []):
        records[img["id"]] = {"boxes": [], "classes": []}
    for ann in data.get("annotations", []):
        x, y, w, h = ann["bbox"]
        rec = records.setdefault(ann["image_id"], {"boxes": [], "classes": []})
        rec["boxes"].append([x, y, x + w, y + h])
        rec["classes"].append(id_map.get(ann["category_id"], -1))
    return records, names


def read_coco_dets(path: str, id_map: Optional[Dict[int, int]] = None) -> Dict:
    """COCO results JSON: [{image_id, category_id, bbox xywh, score}].
    id_map maps category_id -> contiguous id (from the GT's categories)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):  # full COCO file with "annotations"
        data = data.get("annotations", [])
    records: Dict = {}
    for d in data:
        x, y, w, h = d["bbox"]
        rec = records.setdefault(d["image_id"], {"boxes": [], "classes": [], "scores": []})
        rec["boxes"].append([x, y, x + w, y + h])
        cat = d["category_id"]
        # with a GT id_map, an unmapped category_id is unknown (-1) —
        # passing the raw id through could collide with a contiguous id
        rec["classes"].append(id_map.get(cat, -1) if id_map else cat)
        rec["scores"].append(d.get("score", 1.0))
    return records


# ------------------------------------------------------------- Pascal VOC XML


def read_voc_dir(xml_dir: str, table: ClassTable) -> Dict:
    records: Dict = {}
    for path in sorted(glob.glob(os.path.join(xml_dir, "*.xml"))):
        root = ET.parse(path).getroot()
        boxes, classes = [], []
        for obj in root.iter("object"):
            name = obj.findtext("name")
            bb = obj.find("bndbox")
            boxes.append(
                [
                    float(bb.findtext("xmin")),
                    float(bb.findtext("ymin")),
                    float(bb.findtext("xmax")),
                    float(bb.findtext("ymax")),
                ]
            )
            classes.append(table.id_for(name))
        records[_stem(path)] = {"boxes": boxes, "classes": classes}
    return records


# ------------------------------------------------------------------ txt dirs


def _image_size(images_dir: str, stem: str) -> Tuple[int, int]:
    """(w, h) of the image `stem` in images_dir, from its header as
    `data/native_codec.py:image_size` reads every format the port decodes
    (PIL's `size`, which the JAX toolkit reads); another format raises
    ValueError."""
    from ..data.native_codec import image_size

    for ext in (".jpg", ".jpeg", ".png", ".bmp"):
        p = os.path.join(images_dir, stem + ext)
        if os.path.exists(p):
            h, w = image_size(p)
            return w, h
    raise FileNotFoundError(f"no image for {stem} in {images_dir}")


def read_txt_dir(
    txt_dir: str,
    table: ClassTable,
    fmt: str,  # "yolo" | "abs-xywh" | "abs-xyxy"
    detections: bool,
    images_dir: Optional[str] = None,
    image_sizes: Optional[Dict[str, Tuple[int, int]]] = None,
) -> Dict:
    """One txt per image; per line:
      GT:  <class> [coords]        DET: <class> <conf> [coords]
    yolo coords are relative xc yc w h (needs the image size)."""
    records: Dict = {}
    for path in sorted(glob.glob(os.path.join(txt_dir, "*.txt"))):
        stem = _stem(path)
        boxes, classes, scores = [], [], []
        if fmt == "yolo":
            if image_sizes and stem in image_sizes:
                iw, ih = image_sizes[stem]
            elif images_dir:
                iw, ih = _image_size(images_dir, stem)
            else:
                raise ValueError("yolo format needs --img-dir or image sizes")
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                cls = table.id_for(parts[0])
                vals = [float(v) for v in (parts[2:] if detections else parts[1:])]
                if detections:
                    scores.append(float(parts[1]))
                if fmt == "yolo":
                    xc, yc, w, h = vals[:4]
                    boxes.append(
                        [
                            (xc - w / 2) * iw,
                            (yc - h / 2) * ih,
                            (xc + w / 2) * iw,
                            (yc + h / 2) * ih,
                        ]
                    )
                elif fmt == "abs-xywh":
                    x, y, w, h = vals[:4]
                    boxes.append([x, y, x + w, y + h])
                else:  # abs-xyxy
                    boxes.append(vals[:4])
                classes.append(cls)
        rec = {"boxes": boxes, "classes": classes}
        if detections:
            rec["scores"] = scores
        records[stem] = rec
    return records


# --------------------------------------------------------------- entry point


def _drop_unknown(records: Dict, detections: bool, context: str) -> Dict:
    """Remove class -1 entries (unknown names / out-of-range ids) so COCO,
    VOC and F1 all see the same inputs, and say so — silently diverging
    evaluators are worse than a warning."""
    import warnings

    dropped = 0
    for rec in records.values():
        keep = [i for i, c in enumerate(rec["classes"]) if c != -1]
        if len(keep) == len(rec["classes"]):
            continue
        dropped += len(rec["classes"]) - len(keep)
        rec["boxes"] = [rec["boxes"][i] for i in keep]
        rec["classes"] = [rec["classes"][i] for i in keep]
        if detections and "scores" in rec:
            rec["scores"] = [rec["scores"][i] for i in keep]
    if dropped:
        warnings.warn(
            f"{context}: dropped {dropped} entr{'y' if dropped == 1 else 'ies'} "
            "with class names/ids not in the class table"
        )
    return records


def load_ground_truth(path: str, fmt: str, names=None, images_dir=None):
    table = ClassTable(names)
    if fmt == "coco":
        records, coco_names = read_coco_gt(path)
        # frozen table over the GT categories so txt/yolo DETECTIONS map
        # through the same name/index space instead of first-seen order
        table = ClassTable(names or coco_names)
        return _drop_unknown(records, False, "ground truth"), table.names, table
    if fmt == "voc":
        records = read_voc_dir(path, table)
    elif fmt in ("yolo", "abs-xywh", "abs-xyxy"):
        records = read_txt_dir(path, table, fmt, detections=False, images_dir=images_dir)
    else:
        raise ValueError(f"unknown GT format {fmt}")
    return _drop_unknown(records, False, "ground truth"), table.names, table


def load_detections(path: str, fmt: str, table=None, gt_path=None, images_dir=None):
    if fmt == "coco":
        id_map = None
        if gt_path:
            with open(gt_path) as f:
                cats = sorted(json.load(f).get("categories", []), key=lambda c: c["id"])
            id_map = {c["id"]: i for i, c in enumerate(cats)}
            return _drop_unknown(read_coco_dets(path, id_map), True, "detections")
        return read_coco_dets(path, id_map)
    if fmt in ("yolo", "abs-xywh", "abs-xyxy"):
        table = table or ClassTable()
        records = read_txt_dir(path, table, fmt, detections=True, images_dir=images_dir)
        return _drop_unknown(records, True, "detections")
    raise ValueError(f"unknown detection format {fmt}")
