"""A dry run of the adaptation step on several processes (the counterpart of
the JAX package's `__graft_entry__.py:dryrun_multichip`).

    python -m simple_sfod_tpu_torch.parallel.dryrun N [--device cuda]

`dryrun_multigpu(n)` starts n ranks (gloo on the CPU by default) that each
build the source-free adaptive-teacher trainer on the tiny backbone
(models/backbones/tiny.py) at a 32x64 canvas and take one full step on a
seeded uint8 batch of n images, rank r holding image r: teacher forward,
pseudo-labels, student forward and backward, the collectives. Each rank
checks a finite loss and that every rank holds the same parameters, teacher
included (a hash of the state). With n >= 4 and even, a second trainer runs
data n/2 x model 2 (the box head split over the model axis) on n/2 images.
The JAX dry run also bands the images over the model axis
(TPU.SPATIAL_SHARD); the port refuses that setting (ROADMAP item 1).
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np


def tiny_cfg(data: int, canvas=(32, 64), model: int = 1, output_dir: str = ""):
    """The JAX dry run's configuration (`__graft_entry__._tiny_cfg` with the
    tiny backbone) in the port."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.TRAINER = "source_free_adaptive_teacher"
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 8
    cfg.MODEL.BACKBONE.NAME = "build_tiny_backbone"
    cfg.MODEL.ROI_HEADS.IN_FEATURES = ("tiny1",)
    cfg.MODEL.RPN.IN_FEATURES = ("tiny1",)
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.TEST.DETECTIONS_PER_IMAGE = 16
    cfg.TPU.GT_CAPACITY = 8
    cfg.SOLVER.IMS_PER_BATCH = data
    cfg.SOLVER.IMS_PER_BATCH_TARGET = data
    cfg.TPU.CANVAS = tuple(canvas)
    cfg.TPU.MESH_DATA = data
    cfg.TPU.MESH_MODEL = model
    cfg.TPU.DTYPE = "float32"
    cfg.SEED = 0
    cfg.OUTPUT_DIR = output_dir or tempfile.mkdtemp(prefix="sfod_dryrun_")
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.TEST.EVAL_PERIOD = 0
    return cfg


def _step(n_images: int, data: int, model: int, device: str) -> float:
    from ..engine.trainers import build_trainer
    from . import mesh

    cfg = tiny_cfg(data, model=model)
    cfg.freeze()
    trainer = build_trainer(cfg, device=device)
    batch = {
        "images": np.random.RandomState(0).randint(0, 256, (n_images, 32, 64, 3)).astype(np.uint8),
        "sizes": np.tile(np.asarray([[32, 64]], np.int32), (n_images, 1)),
    }
    total = float(mesh.sum_metrics(trainer.run_step(batch), trainer.layout)["total_loss"])
    if not np.isfinite(total):
        raise FloatingPointError(f"non-finite loss {total}")
    with trainer.full_state():  # the full box heads of a tensor-parallel layout
        hashes = mesh.all_gather_object(mesh.state_hash(trainer.state))
    if len(set(hashes)) != 1:
        raise AssertionError(f"the ranks' states differ after the step: {hashes}")
    return total


def _rank(n: int, device: str) -> None:
    from . import mesh

    total = _step(n, n, 1, device)
    if mesh.is_main():
        print(f"dryrun_multigpu({n}): total_loss={total:.4f} OK", flush=True)
    if n >= 4 and n % 2 == 0:
        total = _step(n // 2, n // 2, 2, device)
        if mesh.is_main():
            print(f"dryrun_multigpu({n}) data {n // 2} x model 2: total_loss={total:.4f} OK", flush=True)


def dryrun_multigpu(n: int, device: str = "cpu", backend: str = None) -> None:
    """n ranks, one SFAT step each (module docstring); raises on a failure."""
    from .launch import launch

    launch(_rank, n, device=device, backend=backend, args=(n, device), threads=1)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cpu")
    p.add_argument("--backend", default=None)
    a = p.parse_args()
    dryrun_multigpu(a.n, a.device, a.backend)
