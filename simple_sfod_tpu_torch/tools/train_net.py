"""Training and evaluation CLI of the port (the port of the JAX package's
`tools/train_net.py`):

    python -m simple_sfod_tpu_torch.tools.train_net --config-file configs/X.yaml \
        [--eval-only [--adabn-batches N]] [--resume] [--synthetic] [--device cpu] [KEY VALUE ...]

It reads the config (the file, then the KEY VALUE overrides), registers the
datasets (with --synthetic, every DATASETS name that resolves to no
annotation file becomes 8 synthetic images), builds cfg.TRAINER, restores
the newest checkpoint of OUTPUT_DIR (--resume) or loads MODEL.WEIGHTS, and
trains. --eval-only refines the BatchNorm statistics on the train set from
the loaded ones, evaluates and saves `adabn.pth` (test_refinement);
`train_net_mt` resets them first (AdaBN). The device is CUDA unless
--device says otherwise, and a run without a GPU raises. One GPU: more
GPUs, machines or mesh axes raise until data parallelism is ported.
The last line is the NMS kernels' launch counts of the run.
"""

from __future__ import annotations

import argparse
import json

MULTI_DEVICE = "ROADMAP item 6.9 (data parallelism) is not ported yet: the port runs on one GPU"


def default_argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train or evaluate a detector (PyTorch/CUDA port).")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true", help="synthetic data (no dataset on disk)")
    p.add_argument("--device", default=None, help="default: cuda (fails without a GPU)")
    p.add_argument("--adabn-batches", type=int, default=None, metavar="N",
                   help="batches of the --eval-only BatchNorm refinement (default 1400, the reference's)")
    p.add_argument("--num-gpus", "--num-chips", dest="num_gpus", type=int, default=1,
                   help="data-parallel width; only 1 is supported")
    p.add_argument("--num-machines", "--num-processes", dest="num_machines", type=int, default=1,
                   help="processes; only 1 is supported")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p


def setup(args):
    """The frozen config of `args`; multi-device settings raise."""
    from ..config import get_cfg

    if args.num_gpus > 1 or args.num_machines > 1:
        raise NotImplementedError(f"--num-gpus {args.num_gpus} --num-machines {args.num_machines}: {MULTI_DEVICE}")
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file, allow_new=True)
    if args.opts:
        cfg.merge_from_list(args.opts)
    tpu = cfg.TPU
    if tpu.MESH_DATA > 1 or tpu.MESH_MODEL > 1 or tpu.SPATIAL_SHARD:
        raise NotImplementedError(
            f"TPU.MESH_DATA {tpu.MESH_DATA}, TPU.MESH_MODEL {tpu.MESH_MODEL}, TPU.SPATIAL_SHARD {tpu.SPATIAL_SHARD}: "
            f"{MULTI_DEVICE}")
    cfg.freeze()
    return cfg


def register_datasets(cfg, synthetic: bool) -> None:
    """register_all_datasets(); with `synthetic`, each DATASETS name that
    resolves to no annotation file is registered as 8 synthetic images
    (names that resolve keep their annotations, with synthesized pixels).
    A corrupt annotation file raises."""
    from ..data.datasets import get_dataset, register_all_datasets
    from ..data.synthetic import register_synthetic

    register_all_datasets()
    if not synthetic:
        return
    for name in list(cfg.DATASETS.TRAIN) + list(cfg.DATASETS.TRAIN_TARGET) + list(cfg.DATASETS.TEST):
        try:
            get_dataset(name)
            print(f"[synthetic] {name}: on-disk annotations + synthesized pixels", flush=True)
        except (KeyError, LookupError, FileNotFoundError):
            print(f"[synthetic] {name}: fully synthetic (no on-disk annotations)", flush=True)
            register_synthetic(name, num_images=8, num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES)


def main(args, eval_mode: str = "test"):
    """Run the CLI; returns the evaluation results with --eval-only."""
    from ..device import resolve_device
    from ..engine.trainers import build_trainer
    from ..ops import _kernels

    cfg = setup(args)
    device = resolve_device(args.device)
    register_datasets(cfg, args.synthetic)
    trainer = build_trainer(cfg, device=device, synthetic=args.synthetic)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        refine = trainer.adabn_refinement if eval_mode == "adabn" else trainer.test_refinement
        result = refine(max_batches=args.adabn_batches)
    else:
        trainer.train()
        result = None
    print(f"[launches] {json.dumps(dict(_kernels.LAUNCHES))}", flush=True)
    return result


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
