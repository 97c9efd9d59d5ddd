"""Offline detection metrics (the port's copy of the repo's
tools/metrics_tool.py, a CLI re-build of the reference's vendored
"review_object_detection_metrics" toolkit): loads ground truth and
detections from the common annotation formats and prints COCO AP, Pascal
VOC AP (all-point or 11-point) and F1 tables, with the same flags and the
same output. Runs on the host; needs neither a GPU nor torch.

    python -m simple_sfod_tpu_torch.tools.metrics_tool --gt ann.json --gt-format coco \\
        --det results.json --det-format coco
    python -m simple_sfod_tpu_torch.tools.metrics_tool --gt gts/ --gt-format voc \\
        --det dets/ --det-format abs-xyxy --metrics voc --voc-method 11_point
    python -m simple_sfod_tpu_torch.tools.metrics_tool --gt labels/ --gt-format yolo \\
        --img-dir imgs/ --det dets/ --det-format yolo --names names.txt
"""

from __future__ import annotations

import argparse
import sys

from ..evaluation.report import render_report
from ..evaluation.runner import DET_FORMATS, GT_FORMATS, load_inputs, run_metrics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gt", required=True, help="GT file (coco) or directory")
    ap.add_argument("--gt-format", required=True, choices=list(GT_FORMATS))
    ap.add_argument("--det", required=True, help="detections file (coco) or directory")
    ap.add_argument("--det-format", required=True, choices=list(DET_FORMATS))
    ap.add_argument("--metrics", default="coco,voc,f1", help="comma list: coco,voc,f1")
    ap.add_argument("--iou", type=float, default=0.5, help="IoU for VOC/F1")
    ap.add_argument("--voc-method", default="all_point", choices=["all_point", "11_point"])
    ap.add_argument(
        "--f1-mode",
        default="reference",
        choices=["reference", "greedy"],
        help="reference = daod F1 semantics (score>=0.5, top-5/image); "
        "greedy = the cap-free score-ordered variant",
    )
    ap.add_argument("--names", default=None, help="optional class-names file, one per line")
    ap.add_argument("--img-dir", default=None, help="images dir (yolo relative coords)")
    ap.add_argument(
        "--html",
        default=None,
        help="also write a self-contained HTML report (stat tiles, per-class "
        "table, PR curves) — the GUI-equivalent artifact",
    )
    args = ap.parse_args(argv)

    names = None
    if args.names:
        with open(args.names) as f:
            names = [line.strip() for line in f if line.strip()]

    gts, dets, class_names = load_inputs(
        args.gt, args.gt_format, args.det, args.det_format, names=names, images_dir=args.img_dir
    )

    wanted = {m.strip() for m in args.metrics.split(",") if m.strip()}
    if args.html and "voc" not in wanted:
        print("[metrics] --html computes VOC PR curves: adding the voc metric", file=sys.stderr)
        wanted.add("voc")
    results, curves = run_metrics(
        gts,
        dets,
        class_names,
        metrics=wanted,
        iou=args.iou,
        voc_method=args.voc_method,
        want_curves=bool(args.html),
        f1_mode=args.f1_mode,
    )

    for key, res in results.items():
        print(f"== {key} ==")
        for k, v in res.items():
            if isinstance(v, dict):
                continue
            if isinstance(v, float):
                print(f"  {k}: {v:.3f}")
            else:
                print(f"  {k}: {v}")
        per_class = res.get("per_class") or res.get("voc_per_class")
        if per_class:
            width = max(len(str(n)) for n in per_class) + 2
            for name, vals in per_class.items():
                if isinstance(vals, dict):
                    cells = "  ".join(f"{kk}={vv:.2f}" for kk, vv in vals.items())
                else:
                    cells = f"AP={vals:.2f}"
                print(f"  {str(name):<{width}}{cells}")

    if args.html:
        doc = render_report(
            results,
            class_names,
            curves=curves,
            title="Detection metrics",
            subtitle=f"GT: {args.gt} ({args.gt_format}) · detections: {args.det} "
            f"({args.det_format}) · IoU {args.iou}",
        )
        with open(args.html, "w") as f:
            f.write(doc)
        print(f"HTML report written to {args.html}")
    return results


if __name__ == "__main__":
    main()
