"""Fixed-pseudo-label self-training (the port of
`simple_sfod_tpu/engine/trainers/wq.py`): the reference's BaseWQTrainer
family (base_wq, base_mosaic, base_mixup, base_mosaic_wq and
base_mosaic_wq_new, forks that differ only in their dataset wrapper), one
trainer here with an `aug` setting.

An AdaBN model's detections are spliced into the target's train JSON as
ground truth (tools/prediction_to_gt.py), and this trainer trains on them
supervised, with one step in this order, all on the device:

  1. the weak flip (BaseTrainer's);
  2. mosaic (`mosaic`, `mosaic_wq`; content-aware, then the YOLOX affine
     under INPUT.MOSAIC.RANDOM_AFFINE; the sizes become the canvas), or
     mixup (`mixup`; content-aware, INPUT.MIXUP.FLIP and SCALE_JITTER);
  3. the strong view (`wq`, `mosaic_wq`; data/transforms.py);
  4. the supervised losses with train-mode BatchNorm, and SGD (FREEZE_AT
     as in BaseTrainer).

Every random decision of a step is a `WQDraws` input, so a test can hand
over the JAX package's draws; without one the trainer draws on the device
from its seeded generator (the strong view's scalar decisions from a CPU
generator of its own, read without a sync). The ROI sampler's priorities
are sized for the GT capacity after the augmentation: 4N after mosaic, 2N
after mixup. The train loop, checkpoints (with both generators), resume,
test() and AdaBN are BaseTrainer's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...data.mosaic import mixup_batch, mosaic_batch, random_affine_batch
from ...data.transforms import StrongDraws, make_strong_draws, strong_augment_batch
from ...models.faster_rcnn import anchor_counts, box_dropout_masks, keep_on, roi_pool_size
from ...structures.instances import Instances
from . import register_trainer
from .base import BaseTrainer, apply_weak_aug

MOSAIC_AUGS = ("mosaic", "mosaic_wq")
STRONG_AUGS = ("wq", "mosaic_wq")
# how many times the staged GT capacity each augmentation's GT holds
GT_GROWTH = {"wq": 1, "mosaic": 4, "mosaic_wq": 4, "mixup": 2}


class WQDraws(NamedTuple):
    """Every random decision of one WQ-family step; the fields an `aug`
    does not use are None. The U[0, 1) draws are mapped to their ranges by
    data/mosaic.py exactly as the JAX package maps its own."""

    flip: torch.Tensor  # [B] bool: the weak flip
    mosaic: Optional[torch.Tensor]  # [B, 2] U[0, 1): the mosaic centre (y, x)
    affine: Optional[torch.Tensor]  # [B, 6] U[0, 1): angle, scale, shear x, shear y, tx, ty
    mixup_flip: Optional[torch.Tensor]  # [B] bool: the mixup companion's flip
    jitter: Optional[torch.Tensor]  # [B] U[0, 1): the companion's scale-jitter factor
    jitter_offset: Optional[torch.Tensor]  # [B, 2] U[0, 1): its crop offset (x, y)
    crop: Optional[torch.Tensor]  # [B, 2] U[0, 1): the companion's crop offset (y, x), floored on the device
    strong: Optional[StrongDraws]  # the strong view's draws
    rpn: torch.Tensor  # [B, N_anchors]: the RPN sampler's priorities
    roi: torch.Tensor  # [B, pool]: the ROI sampler's, pool for the augmented GT capacity
    box_keep: Optional[Tuple[torch.Tensor, ...]] = None  # the box head's dropout keep masks (base.Draws)

    # how each field lays out the global batch's images (parallel.mesh.shard_draws)
    SHARD = {f: "batch" for f in ("flip", "mosaic", "affine", "mixup_flip", "jitter", "jitter_offset", "crop",
                                  "strong", "rpn", "roi", "box_keep")}

    def to(self, device) -> "WQDraws":
        """The draws on `device` (the strong view's CPU-side ones stay)."""
        return WQDraws(*(
            keep_on(v, device) if v is None or type(v) is tuple else v.to(device) for v in self
        ))


class WQTrainer(BaseTrainer):
    """The fixed-pseudo-label trainer; `aug` is set by the registered
    subclasses: "wq" | "mosaic" | "mixup" | "mosaic_wq"."""

    aug: str = "wq"
    augments_whole_batch = True  # mosaic and mixup take other images of the batch

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        m = cfg.INPUT.MOSAIC
        self.affine = bool(m.RANDOM_AFFINE)
        self.affine_kw = dict(degrees=float(m.DEGREES), translate=float(m.TRANSLATE), scales=tuple(m.SCALE),
                              shear=float(m.SHEAR))
        self.mixup_flip = bool(cfg.INPUT.MIXUP.FLIP)
        self.mixup_jitter = tuple(cfg.INPUT.MIXUP.SCALE_JITTER) or None
        # the strong view's scalar decisions: a CPU generator of its own
        self.host_generator = torch.Generator().manual_seed(self.generator.initial_seed() + 1)

    # -- checkpoints -------------------------------------------------------
    def checkpoint_state(self) -> Dict:
        """BaseTrainer's file with the strong view's host generator beside
        the device generator."""
        data = super().checkpoint_state()
        data["trainer"]["host_generator"] = self.host_generator.get_state()
        return data

    def load_checkpoint(self, data: Dict) -> None:
        super().load_checkpoint(data)
        self.host_generator.set_state(data["trainer"]["host_generator"])

    # -- the step ------------------------------------------------------------
    def make_draws(self, batch_size: int, canvas_hw: Tuple[int, int], gt_capacity: int) -> WQDraws:
        """One step's draws for a staged GT capacity, on the device (the
        strong view's scalar decisions from the host generator)."""
        counts = anchor_counts(self.det_cfg, canvas_hw)
        n, pool = sum(counts), roi_pool_size(self.det_cfg, counts, GT_GROWTH[self.aug] * gt_capacity)
        g, dev, b = self.generator, self.device, batch_size

        def u(*shape):
            return torch.rand(shape, generator=g, device=dev)

        mosaic = self.aug in MOSAIC_AUGS
        mixup = self.aug == "mixup"
        return WQDraws(
            flip=u(b) < 0.5,
            mosaic=u(b, 2) if mosaic else None,
            affine=u(b, 6) if mosaic and self.affine else None,
            mixup_flip=u(b) < 0.5 if mixup and self.mixup_flip else None,
            jitter=u(b) if mixup and self.mixup_jitter else None,
            jitter_offset=u(b, 2) if mixup and self.mixup_jitter else None,
            crop=u(b, 2) if mixup else None,
            strong=make_strong_draws(b, canvas_hw, self.host_generator, g, dev) if self.aug in STRONG_AUGS else None,
            rpn=u(b, n),
            roi=u(b, pool),
            box_keep=box_dropout_masks(self.det_cfg, b * self.det_cfg.roi_batch_size_per_image, g, dev),
        )

    def augment(
        self, images: torch.Tensor, sizes: torch.Tensor, gt: Instances, draws: WQDraws
    ) -> Tuple[torch.Tensor, torch.Tensor, Instances]:
        """The weak flip, then mosaic (and the affine) or mixup, then the
        strong view. After mosaic the sizes are the canvas."""
        d = draws.to(self.device)
        images, gt = apply_weak_aug(d.flip, images, sizes, gt, self.flip)
        if self.aug in MOSAIC_AUGS:
            images, gt = mosaic_batch(d.mosaic, images, gt, sizes=sizes)
            if self.affine:
                images, gt = random_affine_batch(d.affine, images, gt, **self.affine_kw)
            h, w = images.shape[1], images.shape[2]
            full = torch.full_like(sizes[:, 0], h)
            sizes = torch.stack([full, torch.full_like(full, w)], dim=1)
        elif self.aug == "mixup":
            images, gt = mixup_batch(
                images, gt, flip=d.mixup_flip, scale_jitter=self.mixup_jitter, jitter=d.jitter,
                jitter_offset=d.jitter_offset, crop=d.crop, sizes=sizes,
            )
        if self.aug in STRONG_AUGS:
            images = strong_augment_batch(images, sizes, d.strong)
        return images, sizes, gt


@register_trainer("base_wq")
class BaseWQTrainer(WQTrainer):
    aug = "wq"


@register_trainer("base_mosaic")
class BaseMosaicTrainer(WQTrainer):
    aug = "mosaic"


@register_trainer("base_mixup")
class BaseMixupTrainer(WQTrainer):
    aug = "mixup"


@register_trainer("base_mosaic_wq")
class BaseMosaicWQTrainer(WQTrainer):
    # the strong view on the assembled canvas (reference mosaic_wq.py:218-219)
    aug = "mosaic_wq"


@register_trainer("base_mosaic_wq_new")
class BaseMosaicWQNewTrainer(WQTrainer):
    # the reference's fork applies the strong view per tile
    # (mosaic_wq_new.py:152-153); as in the JAX package, the canvas-level
    # pipeline stands in for it (the photometric ops commute with the
    # composite up to where the erasing lands)
    aug = "mosaic_wq"
