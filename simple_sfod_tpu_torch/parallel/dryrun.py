"""A dry run of the adaptation step on several processes (the counterpart of
the JAX package's `__graft_entry__.py:dryrun_multichip`).

    python -m simple_sfod_tpu_torch.parallel.dryrun N [--device cpu]

`dryrun_multigpu(n)` starts n ranks, one GPU each (NCCL), or on the CPU
(gloo) when asked for with `device="cpu"`; without a GPU the default
raises. Each rank builds the source-free adaptive-teacher trainer on the
tiny backbone (models/backbones/tiny.py) at a 32x64 canvas and takes one
full step on a seeded uint8 batch of n images, rank r holding image r:
teacher forward, pseudo-labels, student forward and backward, the
collectives. Each rank
checks a finite loss and that every rank holds the same parameters, teacher
included (a hash of the state). With n even, a second trainer runs data
n/2 x model 2 on n/2 images with the box head split over the model axis
and each image in height bands over it (TPU.SPATIAL_SHARD, as the JAX dry
run's mesh).

`compare_bands(cases)`, on every rank of a group, runs each case's backbone
(seeded weights, train-mode BatchNorm) forward and backward on the whole
image in the rank's own process and then in height bands over all ranks
(parallel/spatial.py), and returns how far the two are apart, and a whole
pass in another summation order from the first: the maps, the input
gradient, every parameter gradient (summed over the bands) and every
running statistic.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np


def tiny_cfg(data: int, canvas=(32, 64), model: int = 1, output_dir: str = "", spatial: bool = False):
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
    cfg.TPU.SPATIAL_SHARD = spatial
    cfg.TPU.DTYPE = "float32"
    cfg.SEED = 0
    cfg.OUTPUT_DIR = output_dir or tempfile.mkdtemp(prefix="sfod_dryrun_")
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.TEST.EVAL_PERIOD = 0
    return cfg


def _step(n_images: int, data: int, model: int, device: str, spatial: bool = False) -> float:
    from ..engine.trainers import build_trainer
    from . import mesh

    cfg = tiny_cfg(data, model=model, spatial=spatial)
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
    if n % 2 == 0:
        total = _step(n // 2, n // 2, 2, device, spatial=True)
        if mesh.is_main():
            print(f"dryrun_multigpu({n}) data {n // 2} x model 2, height bands: total_loss={total:.4f} OK", flush=True)


@contextlib.contextmanager
def resnet_blocks(depth: int, blocks: Optional[Sequence[int]]):
    """Within: ResNet-`depth`'s block plan cut to `blocks` (None: as it is)."""
    from ..models.backbones import resnet

    keep = resnet.BLOCK_COUNTS[depth]
    if blocks is not None:
        resnet.BLOCK_COUNTS[depth] = tuple(blocks)
    try:
        yield
    finally:
        resnet.BLOCK_COUNTS[depth] = keep


def seeded_backbone(det: dict, blocks: Optional[Sequence[int]] = None, seed: int = 0):
    """The backbone of DetectorConfig(**det) with seeded weights, drawn on
    the CPU: convs normal(1/sqrt(fan_in)), conv biases, BN and FrozenBN
    affines and statistics random around their identity."""
    import torch

    from ..models.backbones.resnet import FrozenBatchNorm2d
    from ..models.backbones.vgg import BatchNorm2d
    from ..models.faster_rcnn import DetectorConfig, build_backbone

    cfg = DetectorConfig(**det)
    with resnet_blocks(101 if cfg.backbone == "resnet101" else 50, blocks):
        bb = build_backbone(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / m.weight[0].numel() ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
            elif isinstance(m, (BatchNorm2d, FrozenBatchNorm2d)):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    return bb


def bn_fed_convs(bb) -> list:
    """The names of `bb`'s convs with a bias whose output a BatchNorm takes
    (the bias's exact gradient is 0)."""
    import torch

    from ..models.backbones.vgg import BatchNorm2d

    out = []
    for name, m in bb.named_modules():
        kids = list(m.named_children())
        for (n, a), (_, b) in zip(kids, kids[1:]):
            if isinstance(a, torch.nn.Conv2d) and a.bias is not None and isinstance(b, BatchNorm2d):
                out.append(f"{name}.{n}" if name else n)
    return out


def backbone_pass(bb, x, gys: Optional[Dict], lay=None):
    """A train-mode forward and backward of backbone `bb` on images x [B, 3,
    H, W] (in height bands over `lay`'s model ranks where given: its band
    in, every map gathered, the parameter gradients summed over the bands)
    with the gradients `gys` of its maps (None: drawn here from seed 1).
    -> ({"map.*", "grad.input", "grad.<param>", "stat.<buffer>": tensor},
    gys)."""
    import torch

    from . import mesh, spatial

    x = x.clone().requires_grad_(True)
    with spatial.bands(lay):
        maps = spatial.gather(bb(spatial.take_band(x, bb.band_stride), train=True, update_stats=True))
    if gys is None:
        g = torch.Generator().manual_seed(1)
        gys = {k: torch.randn(v.shape, generator=g, dtype=v.dtype).to(v.device) for k, v in maps.items()}
    sum((maps[k] * gys[k]).sum() for k in maps).backward()
    if lay is not None:
        spatial.tag_banded(bb)
        mesh.all_reduce_grads(list(bb.parameters()), lay)
    out = {f"map.{k}": v.detach() for k, v in maps.items()}
    out["grad.input"] = x.grad
    out.update({f"grad.{n}": p.grad for n, p in bb.named_parameters()})
    out.update({f"stat.{n}": b.clone() for n, b in bb.named_buffers() if "running_" in n})
    return out, gys


def compare_bands(cases: Dict[str, dict], device: str = "cpu") -> Dict[str, dict]:
    """On every rank of the group: each case's backbone (`det` a
    DetectorConfig's fields, `blocks` a cut ResNet block plan, `shape` the
    images', `dtype` default float64; channels-last on CUDA, as the
    detector runs) on the whole image in this process, then in height bands
    over every rank (data 1 x model W) from the same weights and inputs ->
    {case: {"errs": {tensor: {"max": the largest difference over the whole
    pass's largest entry, "norm": the difference's L2 norm over the whole
    pass's}}, "control": the same errors of a whole pass in the other
    memory format (other kernels, so another summation order), the floor
    that a summation order alone gives, "plan": the band plan, "ms": the
    banded pass's wall}}. A BN-fed conv bias's gradient (exactly 0: both
    passes hold rounding) is measured against its weight gradient. In
    float32 a rounding difference can flip a ReLU or a max pool's choice,
    which moves single gradient entries whole: their largest difference is
    not a rounding error, and their norm is bounded by such flips."""
    import time

    import torch

    from . import mesh, spatial

    lay = mesh.make_layout(1, mesh.world_size())
    lay.spatial = True
    out = {}
    for name, case in cases.items():
        dtype = getattr(torch, case.get("dtype", "float64"))
        fmt = torch.channels_last if torch.device(device).type == "cuda" else torch.contiguous_format
        bb = seeded_backbone(case["det"], case.get("blocks")).to(device=device, dtype=dtype, memory_format=fmt)
        x = (torch.randn(case["shape"], generator=torch.Generator().manual_seed(2)) * 50.0).to(device, dtype)
        x = x.contiguous(memory_format=fmt)
        whole, gys = backbone_pass(copy.deepcopy(bb), x, None)
        scale = {f"grad.{c}.bias": whole[f"grad.{c}.weight"] for c in bn_fed_convs(bb)}

        def errors(other):
            if set(other) != set(whole):
                raise AssertionError(f"{name}: tensors {set(other) ^ set(whole)}")
            errs = {}
            for k, w in whole.items():
                d, s = (other[k] - w).double(), scale.get(k, w).double()
                errs[k] = {"max": float(d.abs().max() / s.abs().max().clamp_min(1e-30)),
                           "norm": float(d.norm() / s.norm().clamp_min(1e-30))}
            return errs

        alt = torch.contiguous_format if fmt == torch.channels_last else torch.channels_last
        res = {"control": errors(backbone_pass(copy.deepcopy(bb).to(memory_format=alt),
                                               x.contiguous(memory_format=alt), gys)[0])}
        t0 = time.perf_counter()
        banded, _ = backbone_pass(bb, x, gys, lay)
        if x.is_cuda:
            torch.cuda.synchronize()
        res["ms"] = 1e3 * (time.perf_counter() - t0)
        res["errs"] = errors(banded)
        res["plan"] = spatial.band_plan(case["shape"][2], bb.band_stride, lay.model)
        out[name] = res
        del bb, whole, banded
    return out


def dryrun_multigpu(n: int, device: str = "cuda", backend: str = None) -> None:
    """n ranks, one SFAT step each (module docstring); raises on a failure,
    and on `device="cuda"` without a GPU."""
    from ..device import resolve_device
    from .launch import launch

    resolve_device(device)
    launch(_rank, n, device=device, backend=backend, args=(n, device), threads=1)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    a = p.parse_args()
    dryrun_multigpu(a.n, a.device, a.backend)
