"""Supervised trainer (the port of the `base` trainer's step,
`simple_sfod_tpu/engine/trainers/base.py:_build_train_step`).

One step: uint8 images to float32, random horizontal flip of images and
GT, supervised losses with train-mode BatchNorm (running statistics
updated), backward, SGD, step + 1. Every random decision of a step comes
from a `Draws` bundle, so a test can hand over the JAX package's draws;
without one the trainer draws from its own seeded generator on the device.
The step reads nothing back to the host: metrics come back as device
tensors, for the caller to convert after the step.

`build_train_loader` gives the trainer's loader over DATASETS.TRAIN, and
`test` evaluates the model on each of DATASETS.TEST (engine/eval_loop.py),
writing `eval_results.json` and the detections under cfg.OUTPUT_DIR.
The train loop, checkpointing, hooks (PreciseBN among them), event
writers and the CLI are not ported yet.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ...config.defaults import detector_config_from_cfg
from ...data.datasets import get_dataset
from ...data.loader import build_test_loader, build_train_loader, gt_instances
from ...data.transforms import random_hflip
from ...device import resolve_device
from ...models.detector import DetectionBatch, Detector
from ...models.faster_rcnn import anchors_for, init_weights, roi_pool_size
from ...solver.build import build_optimizer
from ...structures.instances import Instances
from ..eval_loop import inference_on_dataset
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


@register_trainer("base")
class BaseTrainer:
    """cfg.TRAINER = "base": supervised training of the detector.

    `device=None` means CUDA and raises without a GPU; tests pass
    `device="cpu"`. Weights come from `state_dict` (a port state dict, for
    example from checkpoint/from_jax.py) or from `init_weights(max(cfg.SEED,
    0))`. float32 work runs in full float32: TF32 is switched off for cuDNN
    and cuBLAS when the trainer is built (bfloat16 runs under autocast,
    `TPU.DTYPE`)."""

    def __init__(
        self,
        cfg,
        device: Optional[Union[str, torch.device]] = None,
        state_dict=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = cfg.OUTPUT_DIR
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

    def _init_state(self) -> TrainState:
        model = self.detector.model
        return TrainState(step=0, model=model, optimizer=build_optimizer(self.cfg, model))

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

    def run_step(self, batch: Mapping[str, np.ndarray], draws: Optional[Draws] = None) -> Dict[str, torch.Tensor]:
        """One training step on a batch in the loader's layout (images uint8
        [B, H, W, 3], sizes [B, 2], gt_boxes, gt_classes, gt_valid). Returns
        the metrics (losses, num_fg, num_sampled, total_loss) as tensors on
        the device."""
        dev = self.device
        images = torch.as_tensor(np.asarray(batch["images"])).to(dev).to(torch.float32)
        sizes = torch.as_tensor(np.asarray(batch["sizes"])).to(dev, torch.int32)
        gt = gt_instances(batch, dev)
        if draws is None:
            draws = self.make_draws(images.shape[0], tuple(images.shape[1:3]), gt.boxes.shape[1])
        images, gt = apply_weak_aug(draws.flip.to(dev), images, sizes, gt, self.flip)

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

    # -- data and evaluation --------------------------------------------------
    def build_train_loader(self):
        return build_train_loader(self.cfg)

    def _maybe_precise_bn(self):
        """TEST.PRECISE_BN recomputes the BatchNorm statistics before an
        evaluation; the hook is not ported yet, so the key is refused rather
        than ignored."""
        if self.cfg.TEST.PRECISE_BN.ENABLED:
            raise NotImplementedError("TEST.PRECISE_BN (the precise_bn hook) is not ported yet")

    def _evaluate(self, detector: Detector, name: str, **kw) -> Dict:
        """One dataset through the eval loop with its evaluators."""
        from ...evaluation.build import build_evaluators

        ds = get_dataset(name)
        return inference_on_dataset(
            detector,
            build_test_loader(self.cfg, name),
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
        line and the per-class table for each, and every result to
        `eval_results.json`."""
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
        self._write_results(results)
        return results


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
