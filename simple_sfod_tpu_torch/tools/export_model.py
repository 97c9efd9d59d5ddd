"""Export a trained or adapted detector as one standalone serving artifact
(the port of the JAX package's `tools/export_model.py`).

Builds the config's trainer, loads its weights as the training CLIs do
(MODEL.WEIGHTS, or --resume from OUTPUT_DIR), then exports the inference of
the teacher or the student with `torch.export` (engine/export.py) into one
file that a process reloads with this package's op library and without its
model code, and serves with `python -m simple_sfod_tpu_torch.tools.serve_model`.

    python -m simple_sfod_tpu_torch.tools.export_model --config-file configs/X.yaml \
        --out model.sfodx [--model teacher|student] [--batch N|poly] [--device cpu] \
        [--train-mode-bn] [--no-bundle-params] [--params-dtype bfloat16] \
        [--selfcheck] [--resume] [KEY VALUE ...]

--batch poly exports a symbolic batch dim (one artifact, any batch).
--selfcheck reloads the written artifact and checks that its detections on
a synthetic batch equal eager `Detector.infer` on the same weights.
The device is CUDA unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export the detector's inference as a serving artifact.")
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--model", choices=("teacher", "student"), default="teacher",
                   help="which model of a teacher-student trainer to export (others have one)")
    p.add_argument("--batch", default="1", help="batch size, or 'poly' for a symbolic batch")
    p.add_argument("--device", default=None, help="where the program is traced and placed; default cuda")
    p.add_argument("--train-mode-bn", action="store_true",
                   help="batch-statistics BatchNorm at inference (the AdaBN probe)")
    p.add_argument("--no-bundle-params", action="store_true",
                   help="make the weights a call-time argument instead of putting them in the artifact")
    p.add_argument("--params-dtype", default=None, metavar="DTYPE",
                   help="store the floating weights in DTYPE (bfloat16 halves the artifact)")
    p.add_argument("--selfcheck", action="store_true")
    p.add_argument("--resume", action="store_true", help="load the last OUTPUT_DIR checkpoint")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p.parse_args(argv)


def export_meta(cfg, args, batch) -> dict:
    """The artifact's serving metadata: the JAX tool's keys and values."""
    class_names = None
    if cfg.DATASETS.TEST:
        try:
            from ..data.datasets import get_dataset

            class_names = list(get_dataset(cfg.DATASETS.TEST[0])["thing_classes"])
        except (LookupError, OSError):  # unregistered or not on disk: the artifact serves class ids
            pass
    return {
        "canvas": [int(cfg.TPU.CANVAS[0]), int(cfg.TPU.CANVAS[1])],
        "batch": batch,
        "min_size": int(cfg.INPUT.MIN_SIZE_TEST),
        "max_size": int(cfg.INPUT.MAX_SIZE_TEST),
        "image_format": cfg.INPUT.FORMAT,
        "class_names": class_names,
        "model": args.model,
        "params_dtype": args.params_dtype,
        "train_mode_bn": bool(args.train_mode_bn),
        "bundle_params": not args.no_bundle_params,
        "config": os.path.basename(args.config_file),
    }


def selfcheck(program, detector, weights, batch_images, bundle_params: bool, train_mode_bn: bool) -> dict:
    """The reloaded program against eager `detector.infer` on one synthetic
    batch: classes and validity equal, boxes and scores within 1e-5 (the
    JAX tool's bound). -> the largest differences and the detection count."""
    import torch

    from ..engine.export import weights_argument

    dev = detector.device
    images = torch.from_numpy(batch_images["images"]).to(dev)
    sizes = torch.from_numpy(batch_images["sizes"]).to(dev)
    if bundle_params:
        args = (images, sizes)
    else:
        args = (weights_argument(program, {k: v.to(dev) for k, v in weights.items()}), images, sizes)
    with torch.inference_mode():
        got = program.module()(*args)
    want = vars(detector.infer(images, sizes, train_mode_bn=train_mode_bn))
    for key in ("classes", "valid"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"selfcheck: {key} of the artifact differ from eager inference")
    diff = {}
    for key in ("boxes", "scores"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-5)
        diff[key] = float((got[key] - want[key]).abs().max()) if got[key].numel() else 0.0
    diff["detections"] = int(want["valid"].sum())
    return diff


def main(argv=None):
    args = parse_args(argv)
    from ..config import get_cfg
    from ..utils.bench import synthetic_bench_batch
    from ..device import resolve_device
    from ..engine.export import cast_detector, cast_floating, export_inference, load_exported, save_exported
    from ..engine.trainers import build_trainer

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file, allow_new=True)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # export is one program on one device; a training config's mesh axes
    # have no meaning for it
    cfg.TPU.MESH_DATA = 1
    cfg.TPU.MESH_MODEL = 1
    cfg.TPU.SPATIAL_SHARD = False
    cfg.freeze()
    device = resolve_device(args.device)

    # the trainer gives the exact init + checkpoint-overlay path of the
    # training CLIs (synthetic: no dataset is touched)
    trainer = build_trainer(cfg, device=device, synthetic=True)
    trainer.resume_or_load(resume=args.resume)
    detector = trainer.teacher if args.model == "teacher" and hasattr(trainer, "teacher") else trainer.detector
    weights = detector.model.state_dict()
    batch = None if args.batch == "poly" else int(args.batch)
    t0 = time.perf_counter()
    program = export_inference(
        detector, weights, tuple(cfg.TPU.CANVAS), batch=batch, bundle_params=not args.no_bundle_params,
        device=device, train_mode_bn=args.train_mode_bn, params_dtype=args.params_dtype,
    )
    size = save_exported(program, args.out, meta=export_meta(cfg, args, batch))
    print(
        f"exported {args.model} inference ({cfg.TPU.CANVAS[0]}x{cfg.TPU.CANVAS[1]} canvas, "
        f"batch={'poly' if batch is None else batch}, device={device.type}) -> {args.out} "
        f"({size / 2**20:.1f} MiB) in {time.perf_counter() - t0:.2f} s",
        flush=True,
    )
    if args.selfcheck:
        if args.params_dtype:
            # the eager detector on the same cast weights
            weights = cast_floating(weights, args.params_dtype)
            detector = cast_detector(detector, args.params_dtype)
        reloaded, _ = load_exported(args.out, device)
        b = synthetic_bench_batch(cfg, n=batch or 2)
        diff = selfcheck(reloaded, detector, weights, b, not args.no_bundle_params, args.train_mode_bn)
        print(
            f"selfcheck OK: reloaded artifact matches eager inference at batch {len(b['images'])} "
            f"({diff['detections']} detections; max difference boxes {diff['boxes']:.3g}, "
            f"scores {diff['scores']:.3g})",
            flush=True,
        )


if __name__ == "__main__":
    main()
