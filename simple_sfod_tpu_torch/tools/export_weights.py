"""Export a port checkpoint as the Detectron2 .pth that the reference stack
reads (the port's counterpart of the repo's tools/export_weights.py; see
checkpoint/torch_export.py): fvcore's {"model", "iteration"}, Detectron2's
names, the EnsembleTSModel prefixes for a teacher-student state.

    python -m simple_sfod_tpu_torch.tools.export_weights --ckpt output/model_final.pth \\
        --output model_final_d2.pth [--which auto|student|teacher|ensemble] \\
        [--config-file configs/X.yaml [KEY VALUE ...]]

--ckpt takes a checkpoint file or an OUTPUT_DIR (its newest checkpoint).
With --config-file, each exported detector is also loaded strictly into the
config's detector on the CPU, so a file the config cannot read is refused.
Runs on the host; needs no GPU.
"""

from __future__ import annotations

import argparse

from ..checkpoint.torch_export import STUDENT, TEACHER, WHICH, export_checkpoint, save_torch_file


def check_loads(sd, config_file: str, opts=()) -> None:
    """Load each detector of `sd` strictly into the config's detector."""
    from ..config import detector_config_from_cfg, get_cfg
    from ..models.faster_rcnn import empty_model

    cfg = get_cfg()
    cfg.merge_from_file(config_file, allow_new=True)
    if opts:
        cfg.merge_from_list(list(opts))
    model = empty_model(detector_config_from_cfg(cfg))
    prefixes = [p for p in (TEACHER, STUDENT) if any(k.startswith(p) for k in sd)] or [""]
    for p in prefixes:
        model.load_state_dict({k[len(p):]: v for k, v in sd.items() if k.startswith(p)}, strict=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="a checkpoint .pth of the port, or an OUTPUT_DIR")
    ap.add_argument("--output", required=True, help=".pth to write")
    ap.add_argument("--which", choices=list(WHICH), default="auto",
                    help="auto: ensemble when the checkpoint has a teacher, else plain student")
    ap.add_argument("--config-file", default=None, help="also load the result strictly into this config's detector")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    args = ap.parse_args(argv)

    sd, iteration = export_checkpoint(args.ckpt, args.which)
    if args.config_file:
        check_loads(sd, args.config_file, args.opts)
    save_torch_file(sd, args.output, iteration=iteration)
    kind = args.which
    if kind == "auto":
        kind = "ensemble" if any(k.startswith(TEACHER) for k in sd) else "student"
    print(f"exported {args.ckpt} -> {args.output} ({kind}, {len(sd)} tensors)")
    return sd


if __name__ == "__main__":
    main()
