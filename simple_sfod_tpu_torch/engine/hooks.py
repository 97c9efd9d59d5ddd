"""Periodic hooks (the port of `simple_sfod_tpu/engine/hooks.py`): the
validation loss, the anomaly guard and PreciseBN.

  ValLossHook   every TEST.EVAL_PERIOD steps, the detector's supervised
                losses on a batch of the first TEST set, without a gradient
                and without moving the BatchNorm statistics, logged as
                `<name>_val` scalars and held finite by `detect_anomaly`.
  precise_bn    the BatchNorm running statistics replaced by the equal-weight
                mean of NUM_ITER batches' statistics (fvcore's update_bn_stats).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.loader import gt_instances
from ..models.backbones.vgg import BatchNorm2d
from ..models.detector import DetectionBatch, Detector
from ..models.faster_rcnn import anchor_counts, box_dropout_masks, keep_on, roi_pool_size


class ValLossHook:
    """The supervised losses of `detector` on the next batch of
    `loader_factory()`'s loader (restarted when it ends) every `period`
    steps. The samplers' priorities come from a generator of the hook's
    own, seeded with `seed` at every firing (the JAX hook passes the same
    key each time), unless `after_step` is given them."""

    def __init__(self, detector: Detector, loader_factory: Callable, period: int = 100, seed: int = 0):
        self.detector = detector
        self.loader_factory = loader_factory
        self.period = period
        self.seed = seed
        self._iter = None
        self._generator: Optional[torch.Generator] = None

    def _next_batch(self):
        if self._iter is None:
            self._iter = iter(self.loader_factory())
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = iter(self.loader_factory())
            return next(self._iter)

    def draws(self, batch_size: int, canvas_hw, gt_capacity: int):
        """(rpn [B, N_anchors], roi [B, pool]) uniform priorities and the box
        head's dropout keep masks (None without dropout; the JAX hook's
        losses run dropout too), from the hook's generator reseeded with
        `seed`."""
        det, dev = self.detector, self.detector.device
        if self._generator is None:
            self._generator = torch.Generator(device=dev)
        g = self._generator.manual_seed(self.seed)
        counts = anchor_counts(det.cfg, tuple(canvas_hw))
        n, pool = sum(counts), roi_pool_size(det.cfg, counts, gt_capacity)
        return (torch.rand((batch_size, n), generator=g, device=dev),
                torch.rand((batch_size, pool), generator=g, device=dev),
                box_dropout_masks(det.cfg, batch_size * det.cfg.roi_batch_size_per_image, g, dev))

    def fires(self, step: int, prev_step: Optional[int] = None) -> bool:
        """Did a multiple of `period` fall in (prev_step, step] (counting
        steps from 1)? With K steps a dispatch the loop lands on chunk
        boundaries only; prev_step None means step - 1."""
        if self.period <= 0:
            return False
        lo = step - 1 if prev_step is None else prev_step
        return (step + 1) // self.period > (lo + 1) // self.period

    @torch.no_grad()
    def after_step(self, step: int, storage, prev_step: Optional[int] = None, draws=None) -> Dict[str, float]:
        """Log and return the `_val` losses where the hook fires, else {}."""
        if not self.fires(step, prev_step):
            return {}
        batch = self._next_batch()
        dev = self.detector.device
        images = torch.as_tensor(np.asarray(batch["images"])).to(dev).to(torch.float32)
        sizes = torch.as_tensor(np.asarray(batch["sizes"])).to(dev, torch.int32)
        gt = gt_instances(batch, dev)
        if draws is None:
            draws = self.draws(images.shape[0], images.shape[1:3], gt.boxes.shape[1])
        rpn, roi, keep = draws
        _, metrics = self.detector.supervised_losses(DetectionBatch(images, sizes, gt), rpn.to(dev), roi.to(dev),
                                                     update_bn=False, box_keep=keep_on(keep, dev))
        out = {}
        for k, v in metrics.items():
            v = float(v)
            detect_anomaly(step, v, k)
            out[f"{k}_val"] = v
            storage.put_scalar(f"{k}_val", v)
        return out


def detect_anomaly(step: int, value: float, name: str) -> None:
    """Raise FloatingPointError on a NaN or infinite loss."""
    if not math.isfinite(value):
        raise FloatingPointError(f"Loss became infinite or NaN at iteration={step}! loss {name} = {value}")


@torch.no_grad()
def precise_bn(detector: Detector, batches: Iterable, num_iter: int = 200) -> int:
    """Set every BatchNorm's running statistics of `detector` to the mean,
    with equal weights, of the batch statistics of up to `num_iter` batches
    (dicts in the loader's layout, or image tensors). Each batch's
    statistics are read directly: a train-mode forward with the update's
    momentum at 1 writes them into the running buffers. The JAX package
    recovers them from its 0.9 EMA as (new - 0.9 old) / 0.1, which differs
    from them by float32 rounding. A train-mode forward normalises by the
    batch's own statistics, so each batch's statistics do not depend on the
    running ones. Returns the number of batches taken (0 leaves the
    statistics as they were). On a detector without BatchNorm the forwards
    change nothing, as in the JAX package."""
    bns = [m for m in detector.model.modules() if isinstance(m, BatchNorm2d)]
    sums = [(torch.zeros_like(m.running_mean), torch.zeros_like(m.running_var)) for m in bns]
    momenta = [m.momentum for m in bns]
    n = 0
    try:
        for m in bns:
            m.momentum = 1.0
        for batch in batches:
            if n >= num_iter:
                break
            detector.bn_update(batch["images"] if isinstance(batch, dict) else batch)
            for m, (s_mean, s_var) in zip(bns, sums):
                s_mean.add_(m.running_mean)
                s_var.add_(m.running_var)
            n += 1
    finally:
        for m, mom in zip(bns, momenta):
            m.momentum = mom
    if n:
        for m, (s_mean, s_var) in zip(bns, sums):
            m.running_mean.copy_(s_mean / n)
            m.running_var.copy_(s_var / n)
    return n
