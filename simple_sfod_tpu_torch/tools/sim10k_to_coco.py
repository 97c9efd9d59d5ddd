"""Sim10k VOC-XML annotations -> COCO JSON (the car class): the port's copy
of the repo's tools/converters/sim10k_to_coco.py, with its flags and its
output.

    python -m simple_sfod_tpu_torch.tools.sim10k_to_coco --voc-root sim10k/Annotations \\
        --output sim10k/annotations/sim10k_trainval.json

`sim10k_trainval` (data/datasets.py) reads that JSON with the images under
sim10k/JPEGImages, which the port's own JPEG decoder reads.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import xml.etree.ElementTree as ET


def convert(voc_root: str, classes=("car",)) -> dict:
    """Every *.xml under `voc_root` (sorted; image ids from 1) -> a COCO dict
    of its `classes` boxes; degenerate boxes are dropped."""
    cat_map = {name: i + 1 for i, name in enumerate(classes)}
    images, annotations = [], []
    for img_id, path in enumerate(sorted(glob.glob(os.path.join(voc_root, "*.xml"))), 1):
        root = ET.parse(path).getroot()
        size = root.find("size")
        images.append({
            "id": img_id,
            "file_name": root.findtext("filename"),
            "height": int(size.findtext("height")),
            "width": int(size.findtext("width")),
        })
        for obj in root.findall("object"):
            name = obj.findtext("name")
            if name not in cat_map:
                continue
            bb = obj.find("bndbox")
            x1, y1 = float(bb.findtext("xmin")), float(bb.findtext("ymin"))
            x2, y2 = float(bb.findtext("xmax")), float(bb.findtext("ymax"))
            if x2 <= x1 or y2 <= y1:
                continue
            annotations.append({
                "id": len(annotations) + 1,
                "image_id": img_id,
                "category_id": cat_map[name],
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": (x2 - x1) * (y2 - y1),
                "iscrowd": 0,
            })
    return {"images": images, "annotations": annotations,
            "categories": [{"id": i, "name": n} for n, i in cat_map.items()]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voc-root", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    out = convert(args.voc_root)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"{len(out['images'])} images, {len(out['annotations'])} annotations")
    return out


if __name__ == "__main__":
    main()
