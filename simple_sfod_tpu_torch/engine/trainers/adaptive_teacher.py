"""The source-available Adaptive Teacher (the port of
`simple_sfod_tpu/engine/trainers/adaptive_teacher.py`): burn-in on the
labelled source for SEMISUPNET.BURN_UP_STEP steps, then joint source and
pseudo-labelled target training with domain classifiers and an EMA teacher.

One step, on a labelled source batch (B) and an unlabelled target batch:

  1. the weak flip of the source (with its GT) and of the target; the strong
     view of each;
  2. at the start of step BURN_UP_STEP, the teacher becomes a copy of the
     student (parameters and statistics);
  3. the teacher's pseudo-labels on the weak target view: a train-mode-BN
     forward that moves its running statistics, detections above
     BBOX_THRESHOLD;
  4. the supervised losses on both source views at 2B (strong, then weak,
     the GT twice) with train-mode BN, times SUP_LOSS_WEIGHT;
  5. the pseudo losses on the strong target view (a student pass whose
     statistics are discarded) with loss_rpn_loc and loss_box_reg weighted
     0, times UNSUP_LOSS_WEIGHT;
  6. the domain classifiers on the weak source half against a weak-target
     student pass (statistics discarded), behind GRL(-1): the image one
     (DOMAIN_CLASSIFIER.ENABLED) times DIS_LOSS_WEIGHT, the instance one
     (SEMISUPNET.INS_DC or DOMAIN_CLASSIFIER.INSTANCE) times 1;
  7. SGD; the EMA teacher when step > BURN_UP_STEP and
     (step - BURN_UP_STEP) % TEACHER_UPDATE_ITER == 0.

The pseudo and classifier losses are computed in burn-in too and multiplied
by a gate of 0 (1 after), the JAX package's arithmetic: a non-finite one
shows in the total in both packages alike.

The EMA phase is the JAX package's: the update runs at the end of step S
when (S - BURN_UP_STEP) % TEACHER_UPDATE_ITER == 0, where the original
code's update at the start of iteration S + 1 tests
(S + 1 - BURN_UP_STEP) % TEACHER_UPDATE_ITER; above 1 the two are one step
apart. The port keeps the JAX package's phase, and its tests pin it.

Every random decision of a step is an `ATDraws` input. The train loader is
the labelled source (DATASETS.TRAIN at IMS_PER_BATCH); the target loader is
built on first use (DATASETS.TRAIN_TARGET at IMS_PER_BATCH_TARGET, seed
SEED + 1) and `stage` pulls one target batch for each source batch.
Checkpoints, MODEL.WEIGHTS (into student and teacher) and `test` (student
and teacher) are the source-free trainer's; there is no pseudo-label
visualisation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...data.loader import build_train_loader
from ...data.transforms import StrongDraws, make_strong_draws, strong_augment_batch
from ...models.detector import DetectionBatch
from ...models.faster_rcnn import anchors_for, roi_pool_size
from ...structures.instances import Instances
from ..train_state import ema_tensors, ema_update
from . import register_trainer
from .base import BaseTrainer, PairedTargetMixin, apply_weak_aug, weak_flip
from .source_free_adaptive_teacher import SourceFreeAdaptiveTeacherTrainer, dc_losses

PSEUDO_LOSS_WEIGHTS = {"loss_rpn_loc": 0.0, "loss_box_reg": 0.0}


class ATDraws(NamedTuple):
    """Every random decision of one Adaptive Teacher step."""

    flip: torch.Tensor  # [B] bool: flip source image i
    strong: StrongDraws  # the source's strong view
    rpn: torch.Tensor  # [2B, N_anchors]: the supervised RPN sampler's priorities (strong half, then weak)
    roi: torch.Tensor  # [2B, pool]: the supervised ROI sampler's
    flip_t: torch.Tensor  # [B_t] bool: flip target image i
    strong_t: StrongDraws  # the target's strong view
    rpn_t: torch.Tensor  # [B_t, N_anchors]: the pseudo losses' RPN sampler priorities
    roi_t: torch.Tensor  # [B_t, pool]: their ROI sampler's
    dropout: Optional[Tuple[torch.Tensor, ...]] = None  # the instance classifier's keep masks, source's two then target's

    def to(self, device) -> "ATDraws":
        """The draws on `device` (the strong views' CPU-side ones stay)."""
        moved = {k: v.to(device) for k, v in self._asdict().items() if k != "dropout"}
        return ATDraws(**moved, dropout=None if self.dropout is None else tuple(t.to(device) for t in self.dropout))


def concat_instances(a: Instances, b: Instances) -> Instances:
    """Two padded GT batches [B, M] stacked along the batch -> [2B, M]."""
    return Instances(**{f.name: torch.cat([getattr(a, f.name), getattr(b, f.name)]) for f in dataclasses.fields(a)})


@register_trainer("adaptive_teacher")
class AdaptiveTeacherTrainer(PairedTargetMixin, SourceFreeAdaptiveTeacherTrainer):
    pseudo_from_student = False
    ema_enabled = True

    def __init__(self, cfg, *args, **kw):
        super().__init__(cfg, *args, **kw)
        s = cfg.SEMISUPNET
        self.burn_up = int(s.BURN_UP_STEP)
        self.sup_w = float(s.SUP_LOSS_WEIGHT)

    # no pseudo-label visualisation: the pseudo stream is the target loader's
    _check_before_train = BaseTrainer._check_before_train
    _after_steps = BaseTrainer._after_steps

    # -- data ----------------------------------------------------------------
    def build_train_loader(self):
        """The labelled source domain."""
        return build_train_loader(
            self.cfg, dataset_names=self.cfg.DATASETS.TRAIN, batch_size=self.cfg.SOLVER.IMS_PER_BATCH,
            synthetic=self.synthetic,
        )

    # -- the step ------------------------------------------------------------
    def make_draws(self, batch_size: int, canvas_hw: Tuple[int, int], gt_capacity: int,
                   target_size: Optional[int] = None) -> ATDraws:
        """One step's draws: the strong views' scalar decisions from the host
        generator, the rest from the device generator."""
        target_size = batch_size if target_size is None else target_size
        det_cfg = self.det_cfg
        n = anchors_for(det_cfg, canvas_hw, torch.device("cpu")).shape[0]
        g, hg, dev = self.generator, self.host_generator, self.device
        bs, bt = batch_size, target_size
        return ATDraws(
            flip=torch.rand((bs,), generator=g, device=dev) < 0.5,
            strong=make_strong_draws(bs, canvas_hw, hg, g, dev),
            rpn=torch.rand((2 * bs, n), generator=g, device=dev),
            roi=torch.rand((2 * bs, roi_pool_size(det_cfg, n, gt_capacity)), generator=g, device=dev),
            flip_t=torch.rand((bt,), generator=g, device=dev) < 0.5,
            strong_t=make_strong_draws(bt, canvas_hw, hg, g, dev),
            rpn_t=torch.rand((bt, n), generator=g, device=dev),
            roi_t=torch.rand((bt, roi_pool_size(det_cfg, n, det_cfg.detections_per_image)), generator=g, device=dev),
            dropout=self._dropout_draws(bs, bt, n) if self.ins_dc_enabled else None,
        )

    @torch.no_grad()
    def _copy_student_to_teacher(self) -> None:
        for t, s in zip(ema_tensors(self.state.teacher), ema_tensors(self.state.model)):
            t.copy_(s)

    def step_on_device(self, images, sizes, gt: Instances, t_images, t_sizes, draws: ATDraws) -> Dict[str, torch.Tensor]:
        """One step on a (source, target) pair already on the device. Reads
        nothing back to the host. Returns the metrics (the supervised losses,
        the pseudo ones suffixed `_pseudo`, the DC losses where built,
        total_loss, num_pseudo) as tensors on the device."""
        st, det = self.state, self.detector
        model = det.model
        images, t_images = images.to(torch.float32), t_images.to(torch.float32)
        b = images.shape[0]
        canvas, t_canvas = tuple(images.shape[1:3]), tuple(t_images.shape[1:3])
        gate = 0.0 if st.step < self.burn_up else 1.0

        images, gt = apply_weak_aug(draws.flip, images, sizes, gt, self.flip)
        src_strong = strong_augment_batch(images, sizes, draws.strong)
        sup_images = torch.cat([src_strong, images])
        sup_sizes = torch.cat([sizes, sizes])
        tgt_weak = weak_flip(draws.flip_t, t_images, t_sizes, self.flip)
        tgt_strong = strong_augment_batch(tgt_weak, t_sizes, draws.strong_t)

        if st.step == self.burn_up:  # before the pseudo forward: its labels come from the burnt-in student
            self._copy_student_to_teacher()
        dets = self.teacher.pseudo_labels(tgt_weak, t_sizes)
        pseudo_gt = Instances(dets.boxes, dets.scores, dets.classes, dets.valid & (dets.scores > self.bbox_threshold))

        for p in st.optimizer.params:
            p.grad = None
        feat_sup = model.features(sup_images, train=True, update_bn=True)
        sup_total, metrics = det.losses_from_feature(
            feat_sup, DetectionBatch(sup_images, sup_sizes, concat_instances(gt, gt)), draws.rpn, draws.roi
        )
        feat_tgt_s = model.features(tgt_strong, train=True, update_bn=False)
        unsup_total, unsup = det.losses_from_feature(
            feat_tgt_s, DetectionBatch(tgt_strong, t_sizes, pseudo_gt), draws.rpn_t, draws.roi_t,
            loss_weights=PSEUDO_LOSS_WEIGHTS,
        )
        metrics.update({f"{k}_pseudo": v for k, v in unsup.items()})
        total = self.sup_w * sup_total + gate * self.unsup_w * unsup_total
        if self.dc_enabled or self.ins_dc_enabled:
            feat_tw = model.features(tgt_weak, train=True, update_bn=False)
            dc = dc_losses(det, st.dc, feat_sup[b:], feat_tw, (sizes, t_sizes), (canvas, t_canvas), draws.dropout,
                           self.dc_enabled, self.ins_dc_enabled)
            metrics.update(dc)
            if self.dc_enabled:
                total = total + gate * self.dis_w * (dc["loss_DC_img_s"] + dc["loss_DC_img_t"])
            if self.ins_dc_enabled:
                total = total + gate * (dc["loss_DC_ins_s"] + dc["loss_DC_ins_t"])
        total.backward()
        st.optimizer.step()
        if st.step > self.burn_up and (st.step - self.burn_up) % self.update_iter == 0:
            ema_update(ema_tensors(st.teacher), ema_tensors(st.model), self.keep_rate)
        st.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        metrics["num_pseudo"] = pseudo_gt.valid.to(torch.int32).sum()
        return metrics

    def step_staged(self, staged, draws: Optional[ATDraws] = None) -> Dict[str, torch.Tensor]:
        """Draw (unless `draws` is given) and step on a staged pair."""
        images, sizes, gt, t_images, t_sizes = staged
        if draws is None:
            draws = self.make_draws(images.shape[0], tuple(images.shape[1:3]), gt.boxes.shape[1], t_images.shape[0])
        return self.step_on_device(images, sizes, gt, t_images, t_sizes, draws)
