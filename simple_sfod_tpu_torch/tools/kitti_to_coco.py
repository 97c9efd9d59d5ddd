"""KITTI label files -> COCO JSON (Car, Pedestrian, Cyclist): the port's
copy of the repo's tools/converters/kitti_to_coco.py, with its flags and its
output. Image sizes come from the PNG headers (data/native_codec.py:
image_size), so no PIL is needed.

    python -m simple_sfod_tpu_torch.tools.kitti_to_coco --label-dir kitti/training/label_2 \\
        --image-dir kitti/training/image_2 --output kitti/annotations/kitti_train.json

`kitti_train` (data/datasets.py) reads that JSON with the images under
kitti/training/image_2.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..data.native_codec import image_size

# KITTI class -> category id (the reference's kitti_to_coco/transfer.py)
CLASS_MAP = {"Car": 1, "Pedestrian": 2, "Cyclist": 3}
CATEGORIES = [{"id": v, "name": k.lower()} for k, v in CLASS_MAP.items()]


def convert(label_dir: str, image_dir: str) -> dict:
    """Every <id>.txt under `label_dir` (sorted) with its <id:06d>.png under
    `image_dir` -> a COCO dict; other classes and degenerate boxes are
    dropped."""
    images, annotations = [], []
    for path in sorted(glob.glob(os.path.join(label_dir, "*.txt"))):
        img_id = int(os.path.basename(path).split(".")[0])
        img_name = f"{img_id:06d}.png"
        height, width = image_size(os.path.join(image_dir, img_name))
        images.append({"id": img_id, "file_name": img_name, "height": height, "width": width})
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0] not in CLASS_MAP:
                    continue
                x1, y1, x2, y2 = map(float, parts[4:8])
                if x2 <= x1 or y2 <= y1:
                    continue
                annotations.append({
                    "id": len(annotations) + 1,
                    "image_id": img_id,
                    "category_id": CLASS_MAP[parts[0]],
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "area": (x2 - x1) * (y2 - y1),
                    "iscrowd": 0,
                })
    return {"images": images, "annotations": annotations, "categories": CATEGORIES}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label-dir", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    out = convert(args.label_dir, args.image_dir)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"{len(out['images'])} images, {len(out['annotations'])} annotations")
    return out


if __name__ == "__main__":
    main()
