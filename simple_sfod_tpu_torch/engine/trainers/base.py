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
steps in flight, saves `model_preempt_<iter>` and returns; an exception
saves `model_crash_<iter>` and is raised again. `resume_or_load` restores a
checkpoint or loads MODEL.WEIGHTS (checkpoint/checkpointer.py).

`test` evaluates the model on each of DATASETS.TEST (engine/eval_loop.py),
after PreciseBN where TEST.PRECISE_BN is on. AdaBN: `reset_bn_stats`,
`refine_bn_stats` (train-mode forwards over the train loader),
`test_refinement` (refine, test, save `adabn`) and `adabn_refinement`
(reset first).
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
from ...models.faster_rcnn import anchors_for, init_weights, roi_pool_size
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
    (no files). SOLVER.REFERENCE_WORLD_SIZE applies the linear-scaling rule
    for one device before anything is built. float32 work runs in full
    float32: TF32 is switched off for cuDNN and cuBLAS when the trainer is
    built (bfloat16 runs under autocast, `TPU.DTYPE`)."""

    def __init__(
        self,
        cfg,
        device: Optional[Union[str, torch.device]] = None,
        state_dict=None,
        synthetic: bool = False,
    ):
        cfg = auto_scale_workers(cfg, 1)  # one device until data parallelism is ported
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = cfg.OUTPUT_DIR
        self.synthetic = synthetic
        self.max_iter = int(cfg.SOLVER.MAX_ITER)
        self.det_cfg = detector_config_from_cfg(cfg)
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
        kind, data = self.checkpointer.resume_or_load(self.cfg.MODEL.WEIGHTS, resume)
        if kind == "resume":
            self.load_checkpoint(data)
            print(f"[checkpoint] resumed from {self.checkpointer.last_checkpoint()} at iteration {self.state.step}",
                  flush=True)
        elif kind == "weights":
            kept = self.load_weights(data)
            print(f"[checkpoint] loaded {self.cfg.MODEL.WEIGHTS}; {len(kept)} tensors kept their initialisation",
                  flush=True)
        self.storage.iter = self.state.step

    # -- the step ------------------------------------------------------------
    def make_draws(self, batch_size: int, canvas_hw: Tuple[int, int], gt_capacity: int) -> Draws:
        """One step's draws from the trainer's generator, on the device."""
        n = anchors_for(self.det_cfg, canvas_hw, torch.device("cpu")).shape[0]
        pool = roi_pool_size(self.det_cfg, n, gt_capacity)
        g, dev = self.generator, self.device
        return Draws(
            flip=torch.rand((batch_size,), generator=g, device=dev) < 0.5,
            rpn=torch.rand((batch_size, n), generator=g, device=dev),
            roi=torch.rand((batch_size, pool), generator=g, device=dev),
        )

    def stage(self, batch: Mapping[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor, Instances]:
        """A batch in the loader's layout on the device: (images uint8,
        sizes int32, padded GT with scores 1)."""
        dev = self.device
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
        """One training step on a staged batch. Returns the metrics (losses,
        num_fg, num_sampled, total_loss) as tensors on the device."""
        images, sizes, gt = staged
        dev = self.device
        images = images.to(torch.float32)
        if draws is None:
            draws = self.make_draws(images.shape[0], tuple(images.shape[1:3]), gt.boxes.shape[1])
        images, sizes, gt = self.augment(images, sizes, gt, draws)

        state = self.state
        for p in state.optimizer.params:
            p.grad = None
        total, metrics = self.detector.supervised_losses(
            DetectionBatch(images, sizes, gt), draws.rpn.to(dev), draws.roi.to(dev)
        )
        total.backward()
        state.optimizer.step()
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
            print(f"[trainer] exception at iteration {step}; saving emergency checkpoint", flush=True)
            try:
                self.checkpointer.save(f"model_crash_{step:07d}", self.checkpoint_state())
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
                for s in staged:
                    metrics = self.step_staged(s)
                self._after_steps(batches[-1])
                last = i + k - 1
                for _ in range(k - 1):  # the writers see iter == last
                    self.storage.step()
                self.storage.put_scalar("data_time", data_time / k)
                self.storage.put_scalar("lr", float(self.state.optimizer.schedule(last)))
                if crossed(LOG_PERIOD, i, last + 1) or last == self.max_iter - 1:
                    for name, v in metrics.items():
                        v = float(v)
                        if name.startswith("loss") or name == "total_loss":
                            detect_anomaly(last, v, name)
                        self.storage.put_scalar(name, v)
                    for w in self.writers:
                        w.write(self.storage)
                if crossed(cfg.SOLVER.CHECKPOINT_PERIOD, i, last + 1):
                    self.checkpointer.save(f"model_{last:07d}", self.checkpoint_state(), block=False)
                if crossed(cfg.TEST.EVAL_PERIOD, i, last + 1):
                    self.test()
                if val_hook is not None:
                    val_hook.after_step(last, self.storage, prev_step=i - 1)
                self.storage.step()
                i += k
                if self._preempted:
                    if feeder is not None:
                        feeder.stop()  # nothing staged beside the save
                    name = f"model_preempt_{i - 1:07d}"
                    print(f"[trainer] preempted: saving {name} and stopping", flush=True)
                    self.checkpointer.save(name, self.checkpoint_state())
                    return
        finally:
            if feeder is not None:
                feeder.stop()
            self._feeder = None
        # the final evaluation of detectron2's EvalHook, except at
        # EVAL_PERIOD 0, which means no evaluation (the JAX package's rule)
        ep = cfg.TEST.EVAL_PERIOD
        if ep > 0 and self.max_iter % ep != 0 and cfg.DATASETS.TEST:
            self.test()
        self.checkpointer.save("model_final", self.checkpoint_state())

    # -- data and evaluation --------------------------------------------------
    def build_train_loader(self):
        return build_train_loader(self.cfg, synthetic=self.synthetic)

    def _maybe_precise_bn(self) -> None:
        """TEST.PRECISE_BN: the BatchNorm statistics of the trained model
        recomputed over NUM_ITER batches of the train loader before an
        evaluation."""
        if not self.cfg.TEST.PRECISE_BN.ENABLED:
            return
        loader = self.build_train_loader()
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
            **kw,
        )

    def _write_results(self, results: Dict) -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "eval_results.json"), "w") as f:
            json.dump(_jsonable(results), f, indent=2)

    def test(self, dataset_names=None) -> Dict:
        """Evaluate the model on each dataset (default DATASETS.TEST): COCO
        detections to `inference/coco_instances_results.json` under
        OUTPUT_DIR (`inference/<name>/` with several datasets), an `[eval]`
        line and the per-class table for each, `<name>/AP50` into the
        storage, and every result to `eval_results.json`."""
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
        statistics by the update rule, in order. Returns the batches taken."""
        max_batches = ADABN_MAX_BATCHES if max_batches is None else max_batches
        loader = loader if loader is not None else self.build_train_loader()
        taken = 0
        for batch in loader:
            if taken >= max_batches:
                break
            self.detector.bn_update(to_device(batch["images"], self.device))
            taken += 1
        return taken

    def test_refinement(self, max_batches: Optional[int] = None, loader=None) -> Dict:
        """`refine_bn_stats` from the loaded statistics, `test()`, then save
        `adabn` (the reference's `train_net.py --eval-only`)."""
        n = self.refine_bn_stats(max_batches=max_batches, loader=loader)
        print(f"[adabn] BatchNorm statistics refined over {n} batches", flush=True)
        results = self.test()
        self.checkpointer.save("adabn", self.checkpoint_state())
        return results

    def adabn_refinement(self, max_batches: Optional[int] = None, loader=None) -> Dict:
        """AdaBN: `reset_bn_stats`, then `test_refinement` (the reference's
        `train_net_mt.py --eval-only`)."""
        self.reset_bn_stats()
        return self.test_refinement(max_batches=max_batches, loader=loader)


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
        target images, target sizes) on the device."""
        target = self.next_target() if target is None else target
        return (*BaseTrainer.stage(self, batch), to_device(target["images"], self.device),
                to_device(target["sizes"], self.device, torch.int32))

    def run_step(self, batch, draws=None, target=None) -> Dict[str, torch.Tensor]:
        """One step on a source batch in the loader's layout and a target
        batch (`target`, else the target loader's next)."""
        return self.step_staged(self.stage(batch, target), draws)
