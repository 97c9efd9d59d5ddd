"""Supervised trainer, its train loop and AdaBN (the port of
`simple_sfod_tpu/engine/trainers/base.py`).

One step: uint8 images to float32, random horizontal flip of images and
GT, supervised losses with train-mode BatchNorm (running statistics
updated), backward, SGD, step + 1. Every random decision of a step comes
from a `Draws` bundle, so a test can hand over the JAX package's draws;
without one the trainer draws from its own seeded generator on the device.
The step reads nothing back to the host: metrics come back as device
tensors.

`train()` runs the JAX package's loop rule for rule: TPU.STEPS_PER_DISPATCH
steps a loop iteration (with TPU.CHUNK_STAGE_AHEAD chunks staged ahead on a
thread), data_time and lr every iteration, the metrics read back and
written (console, `metrics.json`, TensorBoard where a backend imports)
every 20 iterations and at the last, a non-blocking checkpoint every
SOLVER.CHECKPOINT_PERIOD, `test()` every TEST.EVAL_PERIOD and the
validation loss beside it (TEST.VAL_LOSS), a final `test()` when MAX_ITER
is not a multiple of EVAL_PERIOD, and `model_final`. SIGTERM finishes the
steps in flight, saves `model_preempt_<iter>` and returns (on several
ranks at the next multiple of 20 iterations, where they agree); an exception
saves `model_crash_<iter>` and is raised again. `resume_or_load` restores a
checkpoint or loads MODEL.WEIGHTS (checkpoint/checkpointer.py).

`test` evaluates the model on each of DATASETS.TEST (engine/eval_loop.py),
after PreciseBN where TEST.PRECISE_BN is on. AdaBN: `reset_bn_stats`,
`refine_bn_stats` (train-mode forwards over the train loader),
`test_refinement` (refine, test, save `adabn`) and `adabn_refinement`
(reset first).

Several processes (parallel/mesh.py; the JAX package's mesh width,
`base.py:143-180`): in a process group the trainer lays the world out as
data x model, the data width TPU.MESH_DATA or, at -1, the world over
TPU.MESH_MODEL reduced by gcd to divide every batch in `_SHARD_BATCH_KEYS`
(again after SOLVER.REFERENCE_WORLD_SIZE's scaling at that width); a world
the layout does not fill raises. Each rank stages its rows of the global
batch, draws for the global batch and keeps its rows, steps under
`mesh.data_parallel` (BatchNorm and the loss counts over the global batch),
sums the gradients over the data group and updates: every rank holds the
same parameters, and they are those of one process on the global batch.
With MESH_MODEL > 1 each model rank holds its slices of the box heads'
fc1/fc2; checkpoints, evaluation and MODEL.WEIGHTS see the full tensors.
Logged metrics are summed over the data group (each rank's are partial
sums over global counts); rank 0 alone writes metrics, TensorBoard,
checkpoints and results. Evaluation deals the test batches round-robin
over the ranks and gathers the records; AdaBN and PreciseBN take the
global batch's statistics. A trainer whose augmentation mixes the images
of a batch (`augments_whole_batch`: mosaic, mixup) stages and augments the
whole global batch on every rank, then keeps its rows.

TPU.SPATIAL_SHARD (MESH_MODEL > 1, else ValueError as in the JAX package):
the model ranks of a data index run each image in height bands through the
backbone (parallel/spatial.py), with halo exchanges, BatchNorm statistics
over every rank and the backbone's gradients summed over the bands; the
heads run on the gathered maps. Evaluation then deals the test batches over
the data indices and runs each banded on that index's model ranks.
"""

from __future__ import annotations

import json
import math
import os
import queue as queue_mod
import signal
import threading
import time
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ...checkpoint.checkpointer import Checkpointer, overlay_state_dict
from ...config.defaults import detector_config_from_cfg
from ...data.datasets import get_dataset
from ...data.loader import build_test_loader, build_train_loader
from ...data.transforms import random_hflip
from ...device import resolve_device
from ...models.backbones.vgg import BatchNorm2d
from ...models.detector import DetectionBatch, Detector
from ...models.faster_rcnn import anchor_counts, box_dropout_masks, init_weights, keep_on, roi_pool_size
from ...parallel import mesh, spatial
from ...solver.build import auto_scale_workers, build_optimizer
from ...structures.instances import Instances
from ..eval_loop import inference_on_dataset
from ..events import ConsoleWriter, EventStorage, JSONWriter, TensorboardWriter
from ..hooks import ValLossHook, detect_anomaly, precise_bn
from ..train_state import TrainState
from . import register_trainer


class Draws(NamedTuple):
    """Every random decision of one training step."""

    flip: torch.Tensor  # [B] bool: flip image i (bernoulli 0.5)
    rpn: torch.Tensor  # [B, N_anchors] float32 uniform: RPN sampler priorities
    roi: torch.Tensor  # [B, pool] float32 uniform: ROI sampler priorities
    # the box head's dropout keep masks, one bool [B * ROI batch, FC_DIM] a
    # fc layer (`box_dropout_masks`); None without MODEL.ROI_BOX_HEAD.DROPOUT
    box_keep: Optional[Tuple[torch.Tensor, ...]] = None

    # how each field lays out the global batch's images (parallel.mesh.shard_draws)
    SHARD = {"flip": "batch", "rpn": "batch", "roi": "batch", "box_keep": "batch"}


def _flip_enabled(cfg) -> bool:
    """INPUT.RANDOM_FLIP: "horizontal" or "none"; "vertical" is refused
    rather than flipping the wrong axis."""
    mode = cfg.INPUT.RANDOM_FLIP
    if mode not in ("horizontal", "none"):
        raise ValueError(f"INPUT.RANDOM_FLIP={mode!r} unsupported (horizontal|none)")
    return mode != "none"


def apply_weak_aug(
    flip: torch.Tensor, images: torch.Tensor, sizes: torch.Tensor, gt: Instances, enabled: bool = True
) -> Tuple[torch.Tensor, Instances]:
    """Horizontal flip of image i and its GT boxes where flip[i] (the weak
    augmentation). `enabled=False` (INPUT.RANDOM_FLIP "none") passes the
    batch through."""
    if not enabled:
        return images, gt
    out = [random_hflip(flip[i], images[i], gt.boxes[i], sizes[i, 1])[:2] for i in range(images.shape[0])]
    return torch.stack([o[0] for o in out]), Instances(
        boxes=torch.stack([o[1] for o in out]), scores=gt.scores, classes=gt.classes, valid=gt.valid
    )


def weak_flip(flip: torch.Tensor, images: torch.Tensor, sizes: torch.Tensor, enabled: bool = True) -> torch.Tensor:
    """`apply_weak_aug` of an unlabelled batch: the flipped images alone."""
    b, dev = images.shape[0], images.device
    empty = Instances(
        boxes=torch.zeros((b, 1, 4), dtype=torch.float32, device=dev),
        scores=torch.zeros((b, 1), dtype=torch.float32, device=dev),
        classes=torch.zeros((b, 1), dtype=torch.int32, device=dev),
        valid=torch.zeros((b, 1), dtype=torch.bool, device=dev),
    )
    return apply_weak_aug(flip, images, sizes, empty, enabled)[0]


LOG_PERIOD = 20
# the BatchNorm refinement's batches (the reference's test_refinement count)
ADABN_MAX_BATCHES = 1400


def to_device(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array on `device`. To a GPU it goes through pinned memory and
    is copied without blocking: a copy from pageable memory would
    synchronise the stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def crossed(period: int, lo: int, hi: int) -> bool:
    """Did a multiple of `period` land in (lo, hi]?"""
    return period > 0 and hi // period > lo // period


class _ChunkFeeder:
    """Staging ahead for the chunked loop (TPU.STEPS_PER_DISPATCH > 1 with
    TPU.CHUNK_STAGE_AHEAD > 0): a thread pulls each chunk's batches from
    the loader and stages them on the device (trainer.stage: pinned buffers,
    copies that do not block), keeping up to `depth` chunks in a bounded
    queue, while the main thread steps. The batch stream is the synchronous
    path's, so trajectories do not change. A loader or staging error is
    raised again in the main thread by `get`."""

    def __init__(self, trainer, it, chunk: int, total_steps: int, depth: int = 1):
        self._q = queue_mod.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stopped = False

        def work():
            try:
                done = 0
                while done < total_steps and not self._stopped:
                    k = min(chunk, total_steps - done)
                    t0 = time.perf_counter()
                    batches = [next(it) for _ in range(k)]
                    staged = [trainer.stage(b) for b in batches]
                    self._q.put((k, batches, staged, time.perf_counter() - t0))
                    done += k
            except BaseException as e:  # raised again by get()
                self._err = e
            self._q.put(None)

        self._thread = threading.Thread(target=work, daemon=True, name="sfod-chunk-feeder")
        self._thread.start()

    def stop(self) -> None:
        """Join the thread (draining the queue so a blocked put wakes)."""
        self._stopped = True
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue_mod.Empty:
                pass
            self._thread.join(timeout=0.2)

    def get(self):
        """The next (k, batches, staged batches, staging seconds)."""
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise RuntimeError("chunk feeder exhausted before the train loop")
        return item


@register_trainer("base")
class BaseTrainer:
    """cfg.TRAINER = "base": supervised training of the detector.

    `device=None` means CUDA and raises without a GPU; tests pass
    `device="cpu"`. Weights come from `state_dict` (a port state dict, for
    example from checkpoint/from_jax.py) or from `init_weights(max(cfg.SEED,
    0))`, and `resume_or_load` then overlays MODEL.WEIGHTS or restores a
    checkpoint. `synthetic` renders the loaders' images from their records
    (no files). `det_cfg` replaces the DetectorConfig that the config
    lowers to: a detector that no backbone name of the YAML schema builds,
    ResNet under FPN (as the JAX package, which builds it only from a
    DetectorConfig). SOLVER.REFERENCE_WORLD_SIZE applies the linear-scaling
    rule at the data width before anything is built. float32 work runs in full
    float32: TF32 is switched off for cuDNN and cuBLAS when the trainer is
    built (bfloat16 runs under autocast, `TPU.DTYPE`)."""

    # the batch sizes this trainer splits over the data width: the auto
    # width divides these, and only these (an unused one would collapse it)
    _SHARD_BATCH_KEYS = ("IMS_PER_BATCH",)
    # the augmentation mixes the images of a batch (mosaic, mixup): every
    # rank stages and augments the whole global batch, then keeps its rows
    augments_whole_batch = False

    def __init__(
        self,
        cfg,
        device: Optional[Union[str, torch.device]] = None,
        state_dict=None,
        synthetic: bool = False,
        det_cfg=None,
    ):
        cfg, self.layout = self._layout(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = cfg.OUTPUT_DIR
        self.synthetic = synthetic
        self.max_iter = int(cfg.SOLVER.MAX_ITER)
        self.det_cfg = det_cfg if det_cfg is not None else detector_config_from_cfg(cfg)
        self.flip = _flip_enabled(cfg)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        seed = max(cfg.SEED, 0)
        self.detector = Detector(self.det_cfg, self.device)
        if state_dict is None:
            init_weights(self.detector.model, seed)
        else:
            self.detector.load_state_dict(state_dict)
        self.state = self._init_state()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.storage = EventStorage()
        self.checkpointer = Checkpointer(self.output_dir)
        self.train_loader = None
        self.writers: List = []
        self._feeder: Optional[_ChunkFeeder] = None
        self._preempted = False
        for head in self._box_heads():
            mesh.shard_box_head(head, self.layout, self.state.optimizer)
        if self.layout is not None and self.layout.spatial:
            spatial.tag_banded(self.state.model.backbone)

    def _layout(self, cfg):
        """(cfg scaled by SOLVER.REFERENCE_WORLD_SIZE at the data width, the
        process layout or None): the class docstring's rule."""
        tpu = cfg.TPU
        spatial.check_config(tpu)
        world, model = mesh.world_size(), max(int(tpu.MESH_MODEL), 1)

        def width(c, n):
            return mesh.data_width(n, int(tpu.MESH_DATA), model, [getattr(c.SOLVER, k) for k in self._SHARD_BATCH_KEYS])

        n = width(cfg, world)
        cfg = auto_scale_workers(cfg, n)
        n = width(cfg, n * model)  # the scaled batches may no longer split over the auto width
        for key in self._SHARD_BATCH_KEYS:
            if getattr(cfg.SOLVER, key) % n:
                raise ValueError(f"SOLVER.{key} {getattr(cfg.SOLVER, key)} does not split over the data width {n}")
        layout = mesh.make_layout(n, model)
        if layout is not None:
            layout.spatial = bool(tpu.SPATIAL_SHARD)
        return cfg, layout

    def _box_heads(self) -> List[torch.nn.Module]:
        """The box heads that tensor parallelism splits (the trained model's)."""
        return [self.detector.model.roi_heads.box_head]

    def full_state(self):
        """Within: the box heads and their momentum whole (mesh.full_box_heads)."""
        return mesh.full_box_heads(self.layout, self._box_heads(), self.state.optimizer)

    def save(self, name: str, block: bool = True) -> None:
        """`checkpoint_state()` as `<name>.pth` (with the full box heads;
        several ranks: rank 0 writes, synchronously, and every rank waits)."""
        with self.full_state():
            self.checkpointer.save(name, self.checkpoint_state(), block=block)

    def _shard(self, batch: Mapping[str, np.ndarray]) -> Mapping[str, np.ndarray]:
        """This rank's rows of a global batch in the loader's layout."""
        return mesh.shard_batch(self.layout, batch, len(batch["images"]))

    def _local_draws(self, draws, batch_size: int, target_size: Optional[int] = None):
        """This rank's part of the draws of a global batch of `batch_size`
        images (and of `target_size` target images, for a paired trainer),
        by the layout the draws' class declares (mesh.shard_draws), and under
        tensor parallelism its columns of the box heads' first keep masks."""
        draws = mesh.shard_draws(self.layout, draws, {"batch": batch_size, "target": target_size})
        keep = {f: mesh.slice_box_keep(getattr(draws, f), self.layout)
                for f in ("box_keep", "box_keep_t") if getattr(draws, f, None) is not None}
        return draws._replace(**keep)

    def _optimizer_step(self) -> None:
        """The gradient summed over the data group, then the update."""
        if self.layout is not None:
            mesh.all_reduce_grads(self.state.optimizer.params, self.layout)
        self.state.optimizer.step()

    def _init_state(self) -> TrainState:
        model = self.detector.model
        return TrainState(step=0, model=model, optimizer=build_optimizer(self.cfg, model))

    # -- checkpoints -------------------------------------------------------
    def checkpoint_state(self) -> Dict:
        """The checkpoint file's content (checkpoint/checkpointer.py), its
        tensors still on the device."""
        return {
            "model": float_state_dict(self.state.model),
            "iteration": self.state.step,
            "optimizer": self.state.optimizer.state_dict(),
            "trainer": {"generator": self.generator.get_state()},
        }

    def load_checkpoint(self, data: Dict) -> None:
        """Restore a `checkpoint_state()` exactly: weights and statistics,
        momentum, the schedule's count, the generator and the step."""
        self.state.model.load_state_dict(data["model"], strict=True)
        self.state.optimizer.load_state_dict(data["optimizer"])
        self.generator.set_state(data["trainer"]["generator"])
        self.state.step = int(data["iteration"])

    def load_weights(self, sd: Dict[str, torch.Tensor]) -> list:
        """Overlay a detector state dict (MODEL.WEIGHTS) non-strictly;
        returns the names that kept their initialisation."""
        return overlay_state_dict(self.state.model, sd)

    def resume_or_load(self, resume: bool = False) -> None:
        """With `resume` and a checkpoint in OUTPUT_DIR, restore it; else
        load MODEL.WEIGHTS (detector weights only). Sets the storage's
        iteration to the steps taken."""
        with self.full_state():
            self._resume_or_load(resume)
        self.storage.iter = self.state.step

    def _resume_or_load(self, resume: bool) -> None:
        kind, data = self.checkpointer.resume_or_load(self.cfg.MODEL.WEIGHTS, resume, self.det_cfg)
        if kind == "resume":
            self.load_checkpoint(data)
            print(f"[checkpoint] resumed from {self.checkpointer.last_checkpoint()} at iteration {self.state.step}",
                  flush=True)
        elif kind == "weights":
            kept = self.load_weights(data)
            # the backbone network's: an FPN's lateral and output convs are not an ImageNet file's
            backbone = sum(k.startswith("backbone.") and not k.startswith("backbone.fpn_") for k in kept)
            print(f"[checkpoint] loaded {self.cfg.MODEL.WEIGHTS}; {len(kept)} tensors kept their initialisation "
                  f"({backbone} of the backbone's)", flush=True)

    # -- the step ------------------------------------------------------------
    def make_draws(self, batch_size: int, canvas_hw: Tuple[int, int], gt_capacity: int) -> Draws:
        """One step's draws from the trainer's generator, on the device."""
        counts = anchor_counts(self.det_cfg, canvas_hw)
        n, pool = sum(counts), roi_pool_size(self.det_cfg, counts, gt_capacity)
        g, dev = self.generator, self.device
        return Draws(
            flip=torch.rand((batch_size,), generator=g, device=dev) < 0.5,
            rpn=torch.rand((batch_size, n), generator=g, device=dev),
            roi=torch.rand((batch_size, pool), generator=g, device=dev),
            box_keep=box_dropout_masks(self.det_cfg, batch_size * self.det_cfg.roi_batch_size_per_image, g, dev),
        )

    def stage(self, batch: Mapping[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor, Instances]:
        """A batch in the loader's layout (this rank's rows of it) on the
        device: (images uint8, sizes int32, padded GT with scores 1)."""
        dev = self.device
        check_gt_classes(batch, self.det_cfg.num_classes)
        if not self.augments_whole_batch:
            batch = self._shard(batch)
        classes = to_device(batch["gt_classes"], dev, torch.int32)
        gt = Instances(
            boxes=to_device(batch["gt_boxes"], dev, torch.float32),
            scores=torch.ones(classes.shape, dtype=torch.float32, device=dev),
            classes=classes,
            valid=to_device(batch["gt_valid"], dev, torch.bool),
        )
        return to_device(batch["images"], dev), to_device(batch["sizes"], dev, torch.int32), gt

    def augment(
        self, images: torch.Tensor, sizes: torch.Tensor, gt: Instances, draws: Draws
    ) -> Tuple[torch.Tensor, torch.Tensor, Instances]:
        """The step's augmentation of float images, sizes and GT: the weak
        flip. -> (images, sizes, GT) that the losses see."""
        images, gt = apply_weak_aug(draws.flip.to(self.device), images, sizes, gt, self.flip)
        return images, sizes, gt

    def step_staged(self, staged, draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """One training step on a staged batch and the global batch's draws.
        Returns the metrics (losses, num_fg, num_sampled, total_loss) as
        tensors on the device (this rank's partial sums on several ranks)."""
        images, sizes, gt = staged
        dev = self.device
        images = images.to(torch.float32)
        b = images.shape[0] if self.augments_whole_batch else mesh.global_batch(images.shape[0], self.layout)
        if draws is None:
            draws = self.make_draws(b, tuple(images.shape[1:3]), gt.boxes.shape[1])
        if self.augments_whole_batch:  # the global batch's augmentation, then this rank's rows
            images, sizes, gt = self.augment(images, sizes, gt, draws)
            images, sizes = mesh.shard_batch(self.layout, (images, sizes), b)
            gt = Instances(*mesh.shard_batch(self.layout, (gt.boxes, gt.scores, gt.classes, gt.valid), b))
        draws = self._local_draws(draws, b)

        state = self.state
        for p in state.optimizer.params:
            p.grad = None
        with mesh.data_parallel(self.layout):
            if not self.augments_whole_batch:
                images, sizes, gt = self.augment(images, sizes, gt, draws)
            total, metrics = self.detector.supervised_losses(
                DetectionBatch(images, sizes, gt), draws.rpn.to(dev), draws.roi.to(dev),
                box_keep=keep_on(draws.box_keep, dev),
            )
            total.backward()
        self._optimizer_step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    def run_step(self, batch: Mapping[str, np.ndarray], draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """One training step on a batch in the loader's layout (images uint8
        [B, H, W, 3], sizes [B, 2], gt_boxes, gt_classes, gt_valid)."""
        return self.step_staged(self.stage(batch), draws)

    def _after_steps(self, batch) -> None:
        """Called once a loop iteration, after its steps, with its last batch."""

    # -- the loop ------------------------------------------------------------
    def _build_val_loss_hook(self) -> Optional[ValLossHook]:
        """TEST.VAL_LOSS: the losses on the first TEST set every EVAL_PERIOD."""
        if not (self.cfg.TEST.VAL_LOSS and self.cfg.TEST.EVAL_PERIOD > 0 and self.cfg.DATASETS.TEST):
            return None
        name = self.cfg.DATASETS.TEST[0]
        return ValLossHook(
            self.detector,
            lambda: build_test_loader(self.cfg, name, synthetic=self.synthetic),
            period=self.cfg.TEST.EVAL_PERIOD,
            seed=max(self.cfg.SEED, 0),
        )

    def _open_writers(self) -> None:
        if not mesh.is_main():
            self.writers = []
            return
        self.writers = [ConsoleWriter(self.max_iter), JSONWriter(os.path.join(self.output_dir, "metrics.json"))]
        try:
            self.writers.append(TensorboardWriter(os.path.join(self.output_dir, "tb")))
            print(f"[trainer] TensorBoard writer built ({os.path.join(self.output_dir, 'tb')})", flush=True)
        except ImportError:
            print("[trainer] TensorBoard writer not built: neither tensorboardX nor torch.utils.tensorboard "
                  "imports", flush=True)

    def _close_writers(self) -> None:
        for w in self.writers:
            w.close()
        self.writers = []

    def _check_before_train(self) -> None:
        """What a configuration needs before the loop starts."""

    def train(self) -> None:
        """The train loop (module docstring) with the crash checkpoint and
        SIGTERM handling: on SIGTERM the loop finishes the steps in flight,
        saves `model_preempt_<iter>` and returns, so `--resume` continues."""
        self._check_before_train()
        self._preempted = False
        prev_handler = None

        def on_term(signum, frame):
            print("[trainer] SIGTERM: will checkpoint after the steps in flight", flush=True)
            self._preempted = True

        try:  # a signal handler installs only from the main thread
            prev_handler = signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            pass
        self._open_writers()
        try:
            self._train_loop()
        except Exception:
            if self._feeder is not None:
                self._feeder.stop()
            step = self.state.step
            if self.layout is not None:  # the save is collective, and the other ranks may not be there
                print(f"[trainer] exception at iteration {step} on rank {self.layout.rank}; several ranks: no "
                      "emergency checkpoint", flush=True)
                raise
            print(f"[trainer] exception at iteration {step}; saving emergency checkpoint", flush=True)
            try:
                self.save(f"model_crash_{step:07d}")
            except Exception as save_err:  # the original error stays the one raised
                print(f"[trainer] emergency save failed: {save_err!r}", flush=True)
            raise
        finally:
            self._close_writers()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _train_loop(self) -> None:
        cfg = self.cfg
        self.train_loader = self.train_loader or self.build_train_loader()
        it = iter(self.train_loader)
        start = self.state.step
        val_hook = self._build_val_loss_hook()
        chunk = max(1, int(cfg.TPU.STEPS_PER_DISPATCH))
        i = start
        feeder = None
        if chunk > 1 and int(cfg.TPU.CHUNK_STAGE_AHEAD) > 0 and self.max_iter > start:
            feeder = _ChunkFeeder(self, it, chunk, self.max_iter - start, depth=int(cfg.TPU.CHUNK_STAGE_AHEAD))
        self._feeder = feeder
        step_s = []  # each loop iteration's steps, host clock, a step
        try:
            while i < self.max_iter:
                if feeder is not None:
                    k, batches, staged, data_time = feeder.get()
                else:
                    k = min(chunk, self.max_iter - i)
                    t0 = time.perf_counter()
                    batches = [next(it) for _ in range(k)]
                    staged = [self.stage(b) for b in batches]
                    data_time = time.perf_counter() - t0
                t_step = time.perf_counter()
                for s in staged:
                    metrics = self.step_staged(s)
                step_s.append((time.perf_counter() - t_step) / k)
                self._after_steps(batches[-1])
                last = i + k - 1
                for _ in range(k - 1):  # the writers see iter == last
                    self.storage.step()
                self.storage.put_scalar("data_time", data_time / k)
                self.storage.put_scalar("lr", float(self.state.optimizer.schedule(last)))
                logged = crossed(LOG_PERIOD, i, last + 1)
                if logged or last == self.max_iter - 1:
                    for name, v in mesh.sum_metrics(metrics, self.layout).items():
                        v = float(v)
                        if name.startswith("loss") or name == "total_loss":
                            detect_anomaly(last, v, name)
                        self.storage.put_scalar(name, v)
                    for w in self.writers:
                        w.write(self.storage)
                if crossed(cfg.SOLVER.CHECKPOINT_PERIOD, i, last + 1):
                    self.save(f"model_{last:07d}", block=False)
                if crossed(cfg.TEST.EVAL_PERIOD, i, last + 1):
                    self.test()
                if val_hook is not None:
                    val_hook.after_step(last, self.storage, prev_step=i - 1)
                self.storage.step()
                i += k
                stop = self._preempted
                if self.layout is not None:
                    # the ranks stop together: they agree on the flag where
                    # the metrics are read back anyway, every LOG_PERIOD
                    # steps, so no other step waits for the device
                    stop = logged and mesh.any_rank(self._preempted, self.layout)
                if stop:
                    if feeder is not None:
                        feeder.stop()  # nothing staged beside the save
                    name = f"model_preempt_{i - 1:07d}"
                    print(f"[trainer] preempted: saving {name} and stopping", flush=True)
                    self.save(name)
                    return
        finally:
            if feeder is not None:
                feeder.stop()
            self._feeder = None
        if self.layout is not None and len(step_s) > 1:
            # gloo's gradient all-reduce waits for the device every step, so
            # there the host clock times the step (under nccl, the host's part)
            print(f"[trainer] rank {self.layout.rank}: {1e3 * float(np.median(step_s[1:])):.2f} ms a step (median of "
                  f"the loop's {len(step_s) - 1} iterations after the first, host clock)", flush=True)
        # the final evaluation of detectron2's EvalHook, except at
        # EVAL_PERIOD 0, which means no evaluation (the JAX package's rule)
        ep = cfg.TEST.EVAL_PERIOD
        if ep > 0 and self.max_iter % ep != 0 and cfg.DATASETS.TEST:
            self.test()
        self.save("model_final")

    # -- data and evaluation --------------------------------------------------
    def build_train_loader(self):
        return build_train_loader(self.cfg, synthetic=self.synthetic)

    def _maybe_precise_bn(self) -> None:
        """TEST.PRECISE_BN: the BatchNorm statistics of the trained model
        recomputed over NUM_ITER batches of the train loader before an
        evaluation."""
        if not self.cfg.TEST.PRECISE_BN.ENABLED:
            return
        loader = (self._shard(b) for b in self.build_train_loader())
        with mesh.data_parallel(self.layout):
            n = precise_bn(self.detector, loader, int(self.cfg.TEST.PRECISE_BN.NUM_ITER))
        print(f"[precise_bn] BatchNorm statistics from {n} batches", flush=True)

    def _evaluate(self, detector: Detector, name: str, **kw) -> Dict:
        """One dataset through the eval loop with its evaluators."""
        from ...evaluation.build import build_evaluators

        ds = get_dataset(name)
        return inference_on_dataset(
            detector,
            build_test_loader(self.cfg, name, synthetic=self.synthetic),
            ds["thing_classes"],
            build_evaluators(self.cfg, name, ds["thing_classes"]),
            pipeline_depth=self.cfg.TPU.EVAL_PIPELINE_DEPTH,
            layout=self.layout,
            **kw,
        )

    def _write_results(self, results: Dict) -> None:
        if not mesh.is_main():
            return
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "eval_results.json"), "w") as f:
            json.dump(_jsonable(results), f, indent=2)

    def test(self, dataset_names=None) -> Dict:
        """Evaluate the model on each dataset (default DATASETS.TEST): COCO
        detections to `inference/coco_instances_results.json` under
        OUTPUT_DIR (`inference/<name>/` with several datasets), an `[eval]`
        line and the per-class table for each, `<name>/AP50` into the
        storage, and every result to `eval_results.json`."""
        with self.full_state():
            return self._test(dataset_names)

    def _test(self, dataset_names=None) -> Dict:
        self._maybe_precise_bn()
        results = {}
        names = list(dataset_names or self.cfg.DATASETS.TEST)
        for name in names:
            id_map = get_dataset(name).get("id_map") or {}
            inf_dir = os.path.join(self.output_dir, "inference", *([name] if len(names) > 1 else []))
            res = self._evaluate(
                self.detector,
                name,
                dump_json=os.path.join(inf_dir, "coco_instances_results.json"),
                category_ids={v: k for k, v in id_map.items()},
            )
            results[name] = res
            ap_line = {k: res.get(k) for k in ("AP", "AP50", "AP75", "F1")}
            print(f"[eval] {name}: {ap_line}", flush=True)
            print_per_class_table(res)
            self.storage.put_scalar(f"{name}/AP50", res.get("AP50", float("nan")))
        self._write_results(results)
        return results

    # -- AdaBN ------------------------------------------------------------------
    def _batchnorms(self) -> List[BatchNorm2d]:
        """The trained model's BatchNorm layers (the student's, in adaptation)."""
        return [m for m in self.detector.model.modules() if isinstance(m, BatchNorm2d)]

    @torch.no_grad()
    def reset_bn_stats(self) -> None:
        """Running means to 0 and running variances to 1 in every BatchNorm."""
        for m in self._batchnorms():
            m.running_mean.zero_()
            m.running_var.fill_(1.0)

    def refine_bn_stats(self, max_batches: Optional[int] = None, loader=None) -> int:
        """Up to `max_batches` (default ADABN_MAX_BATCHES) train-mode
        forwards over the train loader (or `loader`), each moving the running
        statistics by the update rule, in order. Returns the batches taken
        (on a detector without live BatchNorm the forwards change nothing, as
        in the JAX package)."""
        max_batches = ADABN_MAX_BATCHES if max_batches is None else max_batches
        loader = loader if loader is not None else self.build_train_loader()
        taken = 0
        for batch in loader:
            if taken >= max_batches:
                break
            with mesh.data_parallel(self.layout):
                self.detector.bn_update(to_device(self._shard(batch)["images"], self.device))
            taken += 1
        return taken

    def test_refinement(self, max_batches: Optional[int] = None, loader=None) -> Dict:
        """`refine_bn_stats` from the loaded statistics, `test()`, then save
        `adabn` (the reference's `train_net.py --eval-only`)."""
        n = self.refine_bn_stats(max_batches=max_batches, loader=loader)
        print(f"[adabn] BatchNorm statistics refined over {n} batches", flush=True)
        results = self.test()
        self.save("adabn")
        return results

    def adabn_refinement(self, max_batches: Optional[int] = None, loader=None) -> Dict:
        """AdaBN: `reset_bn_stats`, then `test_refinement` (the reference's
        `train_net_mt.py --eval-only`)."""
        self.reset_bn_stats()
        return self.test_refinement(max_batches=max_batches, loader=loader)


def check_gt_classes(batch: Mapping[str, np.ndarray], num_classes: int) -> None:
    """Raise ValueError where a valid GT box of a loader batch (host arrays)
    has a class outside the model's `num_classes`: index num_classes is the
    background and anything above it is out of range. The JAX package
    trains such a box as background, or logs a NaN loss_cls (ROADMAP.md,
    faults of the reference); `kitti_to_coco` keeps Pedestrian and Cyclist
    as categories 2 and 3, which the 1-class KITTI YAMLs do not name."""
    classes, valid = batch["gt_classes"], batch["gt_valid"]
    if not isinstance(classes, np.ndarray) or not isinstance(valid, np.ndarray) or not valid.any():
        return
    top = int(classes[valid].max())
    if top >= num_classes:
        raise ValueError(f"a training box has class {top}, outside the model's {num_classes} class(es) "
                         "(MODEL.ROI_HEADS.NUM_CLASSES): the dataset's categories are more than the config "
                         "names (a KITTI JSON with Pedestrian or Cyclist boxes under a car-only config?)")


def float_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A module's state dict with every floating tensor as float32 (a
    bfloat16 teacher's parameters included; the cast back is exact)."""
    return {k: v.float() if v.is_floating_point() else v for k, v in model.state_dict().items()}


def print_per_class_table(res: Dict):
    """Per-class AP / AP50 table."""
    per_class = res.get("per_class")
    if not per_class:
        return
    name_w = max(len(n) for n in per_class) + 2
    print(f"{'class':<{name_w}}{'AP':>8}{'AP50':>8}")
    for name, vals in per_class.items():
        ap = vals.get("AP", float("nan"))
        ap50 = vals.get("AP50", float("nan"))
        print(f"{name:<{name_w}}{ap:8.2f}{ap50:8.2f}")


def _jsonable(obj):
    """Results as JSON: string keys, NaN as null, numpy scalars as Python's."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, float) and math.isnan(obj):
        return None
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


class PairedTargetMixin:
    """For trainers that step on a labelled source batch and an unlabelled
    target batch: the target loader (DATASETS.TRAIN_TARGET at
    IMS_PER_BATCH_TARGET, seed SEED + 1) is built on first use, and `stage`
    pulls one target batch for each source batch in step order, so
    TPU.STEPS_PER_DISPATCH and staging ahead leave a trajectory as it is."""

    target_loader = None

    def _build_target_loader(self):
        return build_train_loader(
            self.cfg,
            dataset_names=self.cfg.DATASETS.TRAIN_TARGET,
            batch_size=self.cfg.SOLVER.IMS_PER_BATCH_TARGET,
            seed=self.cfg.SEED + 1,
            synthetic=self.synthetic,
        )

    def next_target(self) -> Mapping[str, np.ndarray]:
        """The target loader's next batch."""
        if self.target_loader is None:
            self.target_loader = iter(self._build_target_loader())
        return next(self.target_loader)

    def stage(self, batch: Mapping[str, np.ndarray], target: Optional[Mapping[str, np.ndarray]] = None):
        """A source batch staged with its GT (BaseTrainer.stage) and a target
        batch (`target`, else the target loader's next): (images, sizes, GT,
        target images, target sizes) on the device, this rank's rows of
        each."""
        target = self._shard(self.next_target() if target is None else target)
        return (*BaseTrainer.stage(self, batch), to_device(target["images"], self.device),
                to_device(target["sizes"], self.device, torch.int32))

    def run_step(self, batch, draws=None, target=None) -> Dict[str, torch.Tensor]:
        """One step on a source batch in the loader's layout and a target
        batch (`target`, else the target loader's next)."""
        return self.step_staged(self.stage(batch, target), draws)
