"""Render COCO ground truth onto its images for visual inspection, as PNG
files (the port's copy of the repo's tools/inspect_coco.py, which rebuilds
the reference's cityscapes-to-coco-conversion/inspect_coco.py): the port's
COCO loader (data/coco.py), its own PNG/JPEG decoder and PNG writer
(data/native_codec.py), and utils/visualize.py:draw_detections.

    python -m simple_sfod_tpu_torch.tools.inspect_coco --json annotations/x.json \\
        --image-root imgs --out vis/ --limit 10

A host tool for the CPU: draw_detections draws with PIL, which the GPU
machine's installation does not have, so chip_smoke.py does not run it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.coco import load_coco_json
from ..data.native_codec import decode, encode_png
from ..utils.visualize import draw_detections


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", required=True)
    ap.add_argument("--image-root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--limit", type=int, default=10)
    args = ap.parse_args(argv)

    data = load_coco_json(args.json, args.image_root, filter_empty=False)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for rec in data["records"][: args.limit]:
        vis = draw_detections(
            decode(rec["file_name"]).astype(np.float32),
            np.asarray(rec["boxes"]),
            np.asarray(rec["classes"]),
            class_names=data["thing_classes"],
            input_format="RGB",
        )
        out_path = os.path.join(args.out, os.path.basename(rec["file_name"]) + ".vis.png")
        with open(out_path, "wb") as f:
            f.write(encode_png(vis))
        print(out_path)
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
