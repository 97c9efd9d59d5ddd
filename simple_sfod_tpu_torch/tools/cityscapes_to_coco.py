"""Cityscapes gtFine polygons -> COCO instances JSON (the port's copy of the
repo's tools/converters/cityscapes_to_coco.py, itself a re-build of the
reference's cityscapes-to-coco-conversion/main.py): polygon -> bbox, the 8
instance classes, the optional foggy file-name suffix; the same flags and
the same JSON. The first data step of the Cityscapes -> Foggy Cityscapes
path (tools/prepare_cityscapes.sh, whose downloads need the datasets'
credentials). Runs on the host with the standard library alone.

    python -m simple_sfod_tpu_torch.tools.cityscapes_to_coco --gt-root cityscapes/gtFine \\
        --img-root cityscapes/leftImg8bit --split train \\
        --output annotations/instancesonly_filtered_gtFine_train.json \\
        [--foggy-beta 0.02]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

INSTANCE_CLASSES = [
    "person",
    "rider",
    "car",
    "truck",
    "bus",
    "train",
    "motorcycle",
    "bicycle",
]


def polygon_bbox(poly):
    xs = [p[0] for p in poly]
    ys = [p[1] for p in poly]
    x1, y1, x2, y2 = min(xs), min(ys), max(xs), max(ys)
    return [x1, y1, x2 - x1, y2 - y1]


def convert(gt_root: str, img_root: str, split: str, foggy_beta: str = None) -> dict:
    cat_map = {name: i + 1 for i, name in enumerate(INSTANCE_CLASSES)}
    images, annotations = [], []
    ann_id = 1
    files = sorted(glob.glob(os.path.join(gt_root, split, "*", "*_polygons.json")))
    for img_id, path in enumerate(files, start=1):
        with open(path) as f:
            gt = json.load(f)
        city = os.path.basename(os.path.dirname(path))
        stem = os.path.basename(path).replace("_gtFine_polygons.json", "")
        suffix = f"_leftImg8bit_foggy_beta_{foggy_beta}.png" if foggy_beta else "_leftImg8bit.png"
        # --img-root, when given, prefixes file_name so the JSON resolves
        # from the dataset root (e.g. leftImg8bit/train/<city>/...)
        file_name = os.path.join(img_root, split, city, stem + suffix) if img_root else os.path.join(city, stem + suffix)
        images.append(
            {
                "id": img_id,
                "file_name": file_name,
                "height": gt["imgHeight"],
                "width": gt["imgWidth"],
            }
        )
        for obj in gt["objects"]:
            label = obj["label"]
            if label.endswith("group"):
                continue  # crowd regions, like the reference's filtered set
            if label not in cat_map:
                continue
            bbox = polygon_bbox(obj["polygon"])
            if bbox[2] <= 0 or bbox[3] <= 0:
                continue
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": cat_map[label],
                    "bbox": bbox,
                    "area": bbox[2] * bbox[3],
                    "iscrowd": 0,
                    "segmentation": [sum(obj["polygon"], [])],
                }
            )
            ann_id += 1
    return {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i, "name": n} for n, i in cat_map.items()],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gt-root", required=True)
    ap.add_argument("--img-root", default="")
    ap.add_argument("--split", default="train")
    ap.add_argument("--output", required=True)
    ap.add_argument("--foggy-beta", default=None)
    args = ap.parse_args(argv)
    out = convert(args.gt_root, args.img_root, args.split, args.foggy_beta)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"{len(out['images'])} images, {len(out['annotations'])} annotations -> {args.output}")
    return out


if __name__ == "__main__":
    main()
