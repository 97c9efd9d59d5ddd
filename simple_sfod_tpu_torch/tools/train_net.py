"""Training and evaluation CLI of the port (the port of the JAX package's
`tools/train_net.py`):

    python -m simple_sfod_tpu_torch.tools.train_net --config-file configs/X.yaml \
        [--eval-only [--adabn-batches N]] [--resume] [--synthetic] [--device cpu] \
        [--num-gpus N] [--num-machines M --machine-rank r --dist-url tcp://host:port] \
        [--dist-backend nccl|gloo] [KEY VALUE ...]

It reads the config (the file, then the KEY VALUE overrides), registers the
datasets (with --synthetic, every DATASETS name that resolves to no
annotation file becomes 8 synthetic images), builds cfg.TRAINER, restores
the newest checkpoint of OUTPUT_DIR (--resume) or loads MODEL.WEIGHTS, and
trains. --eval-only refines the BatchNorm statistics on the train set from
the loaded ones, evaluates and saves `adabn.pth` (test_refinement);
`train_net_mt` resets them first (AdaBN). The device is CUDA unless
--device says otherwise, and a run without a GPU raises.

Several processes (parallel/launch.py): --num-gpus N starts N processes on
this machine, one a device (N local processes on the CPU); --num-machines M
with --machine-rank r and --dist-url joins M such groups into one world
(the JAX package's spellings --num-processes, --process-id and
--coordinator work too). --dist-backend defaults to nccl on CUDA and gloo on
the CPU; several ranks sharing one GPU take gloo. The trainer lays the world
out as TPU.MESH_DATA x TPU.MESH_MODEL (engine/trainers/base.py) and its
numbers are those of one process on the global batch. TPU.SPATIAL_SHARD
runs each image in height bands over the model ranks (parallel/spatial.py);
without TPU.MESH_MODEL > 1 it raises ValueError. On several ranks each prints a hash of its state
(`[state] rank r: sha256 ...`, student and teacher, box heads whole), and
each rank's last line is the NMS kernels' launch counts of its run.
"""

from __future__ import annotations

import argparse
import json


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
                   help="processes on this machine, one a device")
    p.add_argument("--num-machines", "--num-processes", dest="num_machines", type=int, default=1,
                   help="machines, each with --num-gpus processes")
    p.add_argument("--machine-rank", "--process-id", dest="machine_rank", type=int, default=0,
                   help="this machine's index in [0, --num-machines)")
    p.add_argument("--dist-url", "--coordinator", dest="dist_url", default=None,
                   help="tcp://host:port of machine 0 (default with one machine: a free localhost port)")
    p.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on CUDA, gloo on the CPU")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p


def setup(args):
    """The frozen config of `args`; TPU.SPATIAL_SHARD without a model axis
    raises ValueError."""
    from ..config import get_cfg
    from ..parallel.spatial import check_config

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file, allow_new=True)
    if args.opts:
        cfg.merge_from_list(args.opts)
    check_config(cfg.TPU)
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
    """Run the CLI on the processes of --num-gpus / --num-machines; returns
    the evaluation results with --eval-only where it runs in this process."""
    from ..device import resolve_device
    from ..parallel.launch import launch

    setup(args)  # a config that raises raises here, before any process starts
    device = resolve_device(args.device)
    return launch(_main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url, args.dist_backend,
                  str(device), args=(args, eval_mode))


def _main(args, eval_mode: str):
    """One rank's run."""
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
    if trainer.layout is not None:  # the ranks must hold the same state
        from ..parallel import mesh

        with trainer.full_state():
            print(f"[state] rank {mesh.rank()}: sha256 {mesh.state_hash(trainer.state)}", flush=True)
    print(f"[launches] {json.dumps(dict(_kernels.LAUNCHES))}", flush=True)
    return result


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
