"""Source-free adaptive-teacher self-training (the port of
`simple_sfod_tpu/engine/trainers/source_free_adaptive_teacher.py`), the
repo's main path.

One step, on an unlabelled target batch:

  1. the weak view: the random horizontal flip;
  2. the student's view of the weak one, on the device: under STYLE.ENABLED
     the AdaIN style enhancement toward the style image
     (models/style_transfer.py:StyleTransfer.stylize, float32, no
     gradient; it takes precedence over WEAK_STRONG_AUGMENT), else the
     strong view (WEAK_STRONG_AUGMENT; data/transforms.py:strong_augment_batch),
     or the weak view itself;
  3. pseudo-labels on the weak view: the teacher's train-mode-BN forward
     (its running statistics move, as the reference's never-eval'd teacher),
     or, in the `_single` variant, the student's own;
  4. the pseudo-label pipeline: BBOX_THRESHOLD, or the FlexMatch adaptive
     threshold after ADAPTIVE_THRESHOLD.WARM_UP, with its rolling reserve;
  5. the student's supervised losses on the strong view against the pseudo
     labels, with train-mode BN, times UNSUP_LOSS_WEIGHT; BPC logged at
     weight 0;
  6. the domain classifiers (`dc_losses`), where DOMAIN_CLASSIFIER.IMAGE or
     INSTANCE weights them: the strong view's features as the source (0),
     a weak-view student pass (train-mode BN, statistics left as they
     were; the `_single` variant's weak features) as the target (1), each
     loss behind GRL(-1) and times SEMISUPNET.DIS_LOSS_WEIGHT; zeros are
     logged, and no pass made, for a classifier built but not weighted;
  7. SGD over the student and the domain classifiers;
  8. the EMA teacher update every TEACHER_UPDATE_ITER steps (EMA variants).

Variants, by the JAX package's names:
  source_free_adaptive_teacher         teacher pseudo-labels, fixed teacher
                                       (bfloat16 parameters under TPU.DTYPE
                                       bfloat16), no EMA
  source_free_adaptive_teacher_single  student pseudo-labels, one fused
                                       weak+strong pass (two passes under
                                       SEMISUPNET.SPLIT_VIEW_BN), EMA
  source_free_adaptive_teacher_mosaic  teacher pseudo-labels, EMA

Every random decision of a step is an `AdaptDraws` input, so a test can
hand over the JAX package's draws. `run_step` stages a numpy batch on the
device; `step_on_device` runs the step and reads nothing back to the host
(the strong view's scalar decisions are CPU tensors, read without a sync);
`run_steps(batch, n)` takes n steps on one staged batch.

`build_train_loader` reads the target domain (DATASETS.TRAIN_TARGET, else
DATASETS.TRAIN) at SOLVER.IMS_PER_BATCH_TARGET; `test` evaluates both the
student and the teacher on each of DATASETS.TEST into `<name>/student` and
`<name>/teacher` of `eval_results.json` under OUTPUT_DIR, after PreciseBN
of the student where TEST.PRECISE_BN is on. The train loop, checkpoints and
AdaBN are BaseTrainer's: a checkpoint holds the teacher and the student
(modelTeacher.* / modelStudent.*), the domain classifiers, the threshold
statistics and both generators; MODEL.WEIGHTS loads a source detector into
both; AdaBN and PreciseBN work on the student's statistics. Every
VIS_PERIOD steps of the loop the teacher's pseudo-labels of the step's
first image go to TensorBoard.

STYLE.* (`_build_style_transfer`): the style image STYLE.STYLE_IMAGE (read
by the port's own codec), the pytorch-AdaIN encoder STYLE.VGG_MODEL and
decoder STYLE.DECODER, each a file; a missing one is announced and replaced,
as in the JAX package, by the flat-gray 64x64 style at 0.6 or seeded random
weights. The style weights are constants: not trained, not checkpointed.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...checkpoint.checkpointer import overlay_state_dict
from ...checkpoint.from_jax import TeacherStudentWeights
from ...data.loader import build_train_loader
from ...data.transforms import StrongDraws, make_strong_draws, strong_augment_batch
from ...models.backbones.resnet import FrozenBatchNorm2d
from ...models.dann import DAInsHead, FCDiscriminatorImg, dropout_masks, gradient_scalar, init_dc_weights
from ...models.detector import DetectionBatch, Detector
from ...models.faster_rcnn import (
    anchor_counts,
    box_dropout_masks,
    dc_image_feature,
    detach_feature,
    keep_on,
    proposal_counts,
    roi_pool_size,
    split_feature,
)
from ...ops.losses import masked_mean, sigmoid_ce
from ...parallel import mesh
from ...solver.build import build_optimizer
from ...structures.instances import Instances
from ..train_state import AdaptiveThresholdState, TeacherStudentState, ema_tensors, ema_update
from . import register_trainer
from .base import BaseTrainer, float_state_dict, to_device, weak_flip

# Cityscapes classes 0 (person) and 2 (car) are pinned to acc = 1 by the
# reference's adaptive threshold: dominant classes whose counts would
# otherwise flatten every other class's threshold.
PINNED_CLASSES = (0, 2)


class AdaptDraws(NamedTuple):
    """Every random decision of one adaptation step."""

    flip: torch.Tensor  # [B] bool: flip image i (bernoulli 0.5)
    strong: Optional[StrongDraws]  # the strong view's draws; None without WEAK_STRONG_AUGMENT
    rpn: torch.Tensor  # [B, N_anchors] float32: the student's RPN sampler priorities
    roi: torch.Tensor  # [B, pool] float32: its ROI sampler priorities
    # the instance classifier's dropout keep masks (source call's two, then the
    # target call's; bool [B * R, 1024], R the training proposals); None unless weighted
    dropout: Optional[Tuple[torch.Tensor, ...]] = None
    # the box head's dropout keep masks on the student's ROI batch
    # (base.Draws.box_keep); None without MODEL.ROI_BOX_HEAD.DROPOUT
    box_keep: Optional[Tuple[torch.Tensor, ...]] = None

    # how each field lays out the global batch's images (parallel.mesh.shard_draws)
    SHARD = {"flip": "batch", "strong": "batch", "rpn": "batch", "roi": "batch", "dropout": "batch",
             "box_keep": "batch"}

    def to(self, device) -> "AdaptDraws":
        """The draws on `device` (the strong view's CPU-side ones stay)."""
        strong = self.strong.to(device) if self.strong is not None else None
        return AdaptDraws(self.flip.to(device), strong, self.rpn.to(device), self.roi.to(device),
                          keep_on(self.dropout, device), keep_on(self.box_keep, device))


def dc_losses(
    detector: Detector,
    dc: Mapping[str, torch.nn.Module],
    feat_s: torch.Tensor,
    feat_t: torch.Tensor,
    sizes: Tuple[torch.Tensor, torch.Tensor],
    canvases: Tuple[Tuple[int, int], Tuple[int, int]],
    keep: Optional[Sequence[torch.Tensor]],
    image: bool,
    instance: bool,
) -> Dict[str, torch.Tensor]:
    """The weighted domain classifiers' losses, unweighted, on a source
    feature (label 0) and a target feature (label 1), each behind GRL(-1):
    with `image`, loss_DC_img_s/_t, the image classifier's ("dc") mean BCE;
    with `instance`, loss_DC_ins_s/_t, the instance classifier's ("dc_ins")
    BCE over the box features of each image's training proposals
    (`Detector.box_features_from_feature`), averaged over the valid ones,
    in train mode on the keep masks `keep` (source's two, then target's).
    `sizes` and `canvases` are (source, target)."""
    cfg = detector.cfg
    out = {}
    if image:
        for tag, feat, label in (("s", feat_s, 0.0), ("t", feat_t, 1.0)):
            logits = dc["dc"](gradient_scalar(dc_image_feature(cfg, feat), -1.0))
            out[f"loss_DC_img_{tag}"] = mesh.batch_mean(sigmoid_ce(logits, torch.full_like(logits, label)))
    if instance:
        for i, (tag, feat, label) in enumerate((("s", feat_s, 0.0), ("t", feat_t, 1.0))):
            feats, valid = detector.box_features_from_feature(feat, sizes[i], canvases[i])
            logits = dc["dc_ins"](gradient_scalar(feats, -1.0), keep[2 * i:2 * i + 2])[:, 0]
            out[f"loss_DC_ins_{tag}"] = masked_mean(sigmoid_ce(logits, torch.full_like(logits, label)), valid)
    return out


class SourceFreeAdaptiveTeacherTrainer(BaseTrainer):
    """The adaptation trainer. `device=None` means CUDA and raises without a
    GPU; tests pass `device="cpu"`. Weights: `weights` (a whole adaptation
    state, for example from checkpoint/from_jax.py:teacher_student_from_jax),
    or `state_dict` (a source checkpoint, for the student and the teacher
    both), or seeded random weights (the teacher a copy of the student)."""

    pseudo_from_student = False
    ema_enabled = False
    _SHARD_BATCH_KEYS = ("IMS_PER_BATCH_TARGET",)

    def __init__(
        self,
        cfg,
        device: Optional[Union[str, torch.device]] = None,
        state_dict=None,
        weights: Optional[TeacherStudentWeights] = None,
        synthetic: bool = False,
    ):
        if cfg.SEMISUPNET.PSEUDO_BBOX_SAMPLE != "thresholding":
            raise ValueError(f"Unknown pseudo label boxes methods {cfg.SEMISUPNET.PSEUDO_BBOX_SAMPLE}")
        self.dc_enabled = bool(cfg.DOMAIN_CLASSIFIER.ENABLED)
        self.ins_dc_enabled = self.dc_enabled and (bool(cfg.SEMISUPNET.INS_DC) or bool(cfg.DOMAIN_CLASSIFIER.INSTANCE))
        # the classifiers whose losses are weighted (the rest log zeros)
        self.dc_image = self.dc_enabled and bool(cfg.DOMAIN_CLASSIFIER.IMAGE)
        self.dc_instance = self.ins_dc_enabled and bool(cfg.DOMAIN_CLASSIFIER.INSTANCE)
        if self.dc_enabled:
            from ...config.defaults import detector_config_from_cfg

            dc_feat = detector_config_from_cfg(cfg).dc_in_feature
            if cfg.SEMISUPNET.DIS_TYPE != dc_feat:
                raise ValueError(
                    f"SEMISUPNET.DIS_TYPE={cfg.SEMISUPNET.DIS_TYPE!r} must equal the image DC's input "
                    f"feature {dc_feat!r} (single-level: the heads' in-feature; FPN: the coarsest ROI level)"
                )
        self._weights = weights
        super().__init__(
            cfg, device=device, state_dict=weights.student if weights is not None else state_dict, synthetic=synthetic
        )
        self._weights = None
        s = cfg.SEMISUPNET
        self.bbox_threshold = float(s.BBOX_THRESHOLD)
        self.unsup_w = float(s.UNSUP_LOSS_WEIGHT)
        self.dis_w = float(s.DIS_LOSS_WEIGHT)
        self.keep_rate = float(s.EMA_KEEP_RATE)
        self.update_iter = max(int(s.TEACHER_UPDATE_ITER), 1)
        self.split_view_bn = bool(s.SPLIT_VIEW_BN)
        # the style view takes precedence over the strong one (no strong draws then)
        self.style = self._build_style_transfer() if cfg.STYLE.ENABLED else None
        self.weak_strong = bool(cfg.WEAK_STRONG_AUGMENT) and self.style is None
        self.adaptive_on = bool(cfg.ADAPTIVE_THRESHOLD.ENABLED)
        self.warm_up = int(cfg.ADAPTIVE_THRESHOLD.WARM_UP)
        # the strong view's scalar decisions: a CPU generator of its own
        self.host_generator = torch.Generator().manual_seed(self.generator.initial_seed() + 1)
        self._vis_hook = None

    # -- state ---------------------------------------------------------------
    def _init_state(self) -> TeacherStudentState:
        cfg, det_cfg, dev = self.cfg, self.det_cfg, self.device
        w = self._weights
        seed = max(cfg.SEED, 0)
        student = self.detector.model
        self.teacher = Detector(det_cfg, dev)
        self.teacher.load_state_dict(w.teacher if w is not None else student.state_dict())
        # the fixed teacher is inference-only: under bfloat16 its parameters
        # are bfloat16 (BN weight and bias included), its running statistics
        # stay float32; EMA teachers stay float32 (keep-rate increments sit
        # below bfloat16's resolution)
        if not self.ema_enabled and det_cfg.dtype == torch.bfloat16:
            for p in self.teacher.model.parameters():
                p.data = p.data.to(torch.bfloat16)
            for m in self.teacher.model.modules():  # a FrozenBN affine is a parameter in the JAX package
                if isinstance(m, FrozenBatchNorm2d):
                    m.weight, m.bias = m.weight.to(torch.bfloat16), m.bias.to(torch.bfloat16)
        for p in self.teacher.model.parameters():
            p.requires_grad_(False)
        dc: Dict[str, torch.nn.Module] = {}
        if self.dc_enabled:
            dc["dc"] = FCDiscriminatorImg(det_cfg.dc_channels, dtype=det_cfg.dtype)
        if self.ins_dc_enabled:
            dc["dc_ins"] = DAInsHead(det_cfg.fc_dim, dtype=det_cfg.dtype)
        for name, module in dc.items():
            if w is not None:
                module.load_state_dict(w.dc[name], strict=True)
            else:
                init_dc_weights(module, seed)
            dc[name] = module.to(dev)
        num_classes, reserve = det_cfg.num_classes, int(cfg.ADAPTIVE_THRESHOLD.RESERVE)
        if w is not None:
            thresh = AdaptiveThresholdState(
                w.thresh["reserve"].to(dev), w.thresh["classwise_acc"].to(dev), int(w.thresh["cursor"])
            )
        else:
            thresh = AdaptiveThresholdState.create(num_classes, reserve, dev)
        return TeacherStudentState(
            step=0,
            model=student,
            optimizer=build_optimizer(cfg, student, extra=dc),
            teacher=self.teacher.model,
            dc=dc,
            thresh=thresh,
        )

    def _build_style_transfer(self):
        """The AdaIN module of STYLE.* on the trainer's device (module
        docstring)."""
        import os

        from ...checkpoint.checkpointer import load_torch_weights
        from ...data import native_codec
        from ...models.style_transfer import import_adain_decoder, import_adain_encoder, load_style_transfer

        st = self.cfg.STYLE
        if st.STYLE_IMAGE and os.path.exists(str(st.STYLE_IMAGE)):
            rgb = native_codec.decode(str(st.STYLE_IMAGE))
            style = torch.from_numpy(np.ascontiguousarray(rgb.transpose(2, 0, 1))).to(torch.float32) / 255.0
        else:
            print("[style] STYLE.STYLE_IMAGE missing; using a flat gray style", flush=True)
            style = torch.full((3, 64, 64), 0.6, dtype=torch.float32)
        sds = {}
        for key, kind, importer in (("VGG_MODEL", "encoder", import_adain_encoder),
                                    ("DECODER", "decoder", import_adain_decoder)):
            path = getattr(st, key)
            if path and os.path.exists(str(path)):
                sds[kind] = importer(load_torch_weights(str(path)))
            elif path:
                print(f"[style] {key} {path} missing; random {kind}", flush=True)
        module = load_style_transfer(style, sds.get("encoder"), sds.get("decoder"), float(st.ALPHA),
                                     max(self.cfg.SEED, 0)).to(self.device)
        if self.device.type == "cuda":
            module = module.to(memory_format=torch.channels_last)
        return module

    def _box_heads(self):
        """The student's box head and the teacher's (both split under tensor
        parallelism: the EMA blends slice with slice)."""
        return [self.detector.model.roi_heads.box_head, self.teacher.model.roi_heads.box_head]

    # -- checkpoints -------------------------------------------------------
    def checkpoint_state(self) -> Dict:
        """BaseTrainer's file with the teacher beside the student, both
        float32 (modelTeacher.* then modelStudent.*, as the JAX package's
        export_ensemble writes them), and under "trainer" the domain
        classifiers, the threshold statistics and the strong view's host
        generator."""
        data = super().checkpoint_state()
        st = self.state
        model = {f"modelTeacher.{k}": v for k, v in float_state_dict(st.teacher).items()}
        model.update({f"modelStudent.{k}": v for k, v in data["model"].items()})
        data["model"] = model
        data["trainer"].update(
            host_generator=self.host_generator.get_state(),
            dc={name: m.state_dict() for name, m in st.dc.items()},
            thresh=st.thresh.state_dict(),
        )
        return data

    def load_checkpoint(self, data: Dict) -> None:
        """Restore a `checkpoint_state()`: the teacher from the file's
        teacher (cast back to its dtype), the student and the rest exactly."""
        st = self.state
        model = data["model"]
        student = {k[len("modelStudent."):]: v for k, v in model.items() if k.startswith("modelStudent.")}
        teacher = {k[len("modelTeacher."):]: v for k, v in model.items() if k.startswith("modelTeacher.")}
        st.teacher.load_state_dict(teacher, strict=True)
        super().load_checkpoint({**data, "model": student})
        tr = data["trainer"]
        for name, m in st.dc.items():
            m.load_state_dict(tr["dc"][name], strict=True)
        st.thresh.load_state_dict(tr["thresh"])
        self.host_generator.set_state(tr["host_generator"])

    def load_weights(self, sd: Dict[str, torch.Tensor]) -> list:
        """A source detector (MODEL.WEIGHTS) into the student and the
        teacher both, non-strictly; the domain classifiers and the threshold
        statistics keep their initialisation."""
        kept = super().load_weights(sd)
        overlay_state_dict(self.state.teacher, sd)
        return kept

    # -- draws ---------------------------------------------------------------
    def make_draws(self, batch_size: int, canvas_hw: Tuple[int, int]) -> AdaptDraws:
        """One step's draws for a (global) batch of `batch_size`: the scalar
        decisions of the strong view from the host generator, the rest from
        the device generator."""
        counts = anchor_counts(self.det_cfg, canvas_hw)
        n, pool = sum(counts), roi_pool_size(self.det_cfg, counts, self.det_cfg.detections_per_image)
        g, dev = self.generator, self.device
        strong = (
            make_strong_draws(batch_size, canvas_hw, self.host_generator, g, dev) if self.weak_strong else None
        )
        return AdaptDraws(
            flip=torch.rand((batch_size,), generator=g, device=dev) < 0.5,
            strong=strong,
            rpn=torch.rand((batch_size, n), generator=g, device=dev),
            roi=torch.rand((batch_size, pool), generator=g, device=dev),
            dropout=self._dropout_draws(batch_size, batch_size, counts) if self.dc_instance else None,
            box_keep=box_dropout_masks(self.det_cfg, batch_size * self.det_cfg.roi_batch_size_per_image, g, dev),
        )

    def _dropout_draws(self, source: int, target: int, num_anchors) -> Tuple[torch.Tensor, ...]:
        """The instance classifier's keep masks: two for the source call on
        `source` images' training proposals, then two for the target's."""
        r = proposal_counts(self.det_cfg, num_anchors, True)[1]
        g, dev = self.generator, self.device
        return dropout_masks(source * r, 1, g, dev) + dropout_masks(target * r, 1, g, dev)

    # -- the step ------------------------------------------------------------
    def pseudo_pipeline(self, dets: Instances, step: int) -> Tuple[Instances, Dict[str, torch.Tensor]]:
        """Pseudo-labels from detections [B, K] at step `step`: the
        adaptive-threshold bookkeeping (the step's per-class count of
        detections above BBOX_THRESHOLD into reserve row step % RESERVE,
        classwise_acc = count / max count with the pinned classes at 1),
        then the threshold: BBOX_THRESHOLD, or after WARM_UP with the
        adaptive threshold on, the FlexMatch convex threshold
        thr * acc / (2 - acc) of each detection's class. Updates the
        trainer's threshold state. -> (pseudo GT, stats)."""
        th = self.state.thresh
        c = self.det_cfg.num_classes
        fixed_mask = dets.valid & (dets.scores > self.bbox_threshold)
        cls = torch.arange(c, dtype=dets.classes.dtype, device=dets.classes.device)
        counts = ((dets.classes[..., None] == cls) & fixed_mask[..., None]).sum(dim=(0, 1)).to(torch.int32)
        counts = mesh.global_sum(counts)  # over the global batch
        reserve = th.reserve.clone()
        reserve[step % reserve.shape[0]] = counts
        # the pinned classes as a mask made on the device: writing a Python
        # scalar into a CUDA tensor by index would copy it from the host
        pinned = torch.zeros_like(cls, dtype=torch.bool)
        for k in PINNED_CLASSES:
            pinned |= cls == k
        counter = torch.where(pinned, 0.0, reserve.sum(dim=0).to(torch.float32))
        acc = torch.where(pinned, 1.0, counter / torch.clamp_min(counter.max(), 1.0))
        self.state.thresh = AdaptiveThresholdState(reserve=reserve, classwise_acc=acc, cursor=th.cursor + 1)
        if self.adaptive_on and step >= self.warm_up:
            per_det = acc[dets.classes.long()]
            pseudo_valid = dets.valid & (dets.scores >= self.bbox_threshold * per_det / (2.0 - per_det))
        else:
            pseudo_valid = dets.valid & (dets.scores >= self.bbox_threshold)
        valid_f = dets.valid.to(torch.float32)
        stats = {
            "num_pseudo": pseudo_valid.to(torch.int32).sum(),
            "pseudo_mean_conf": torch.sum(dets.scores * valid_f) / torch.clamp_min(mesh.global_sum(valid_f.sum()), 1.0),
        }
        return Instances(boxes=dets.boxes, scores=dets.scores, classes=dets.classes, valid=pseudo_valid), stats

    def _single_losses(self, images_w, images_s, sizes, draws: AdaptDraws):
        """`_single`: pseudo-labels from the student's own weak-view features.
        One fused train-mode pass over both views (BN statistics pooled over
        both, one running-statistics update), or under SPLIT_VIEW_BN two
        passes, weak first (its features carry a gradient only for weighted
        domain classifiers), each view by its own statistics. -> (total,
        metrics, pseudo stats, strong features, weak features)."""
        model = self.detector.model
        b = images_w.shape[0]
        if self.split_view_bn:
            with torch.set_grad_enabled(self.dc_image or self.dc_instance):
                feat_w = model.features(images_w, train=True, update_bn=True)
            feat_s = model.features(images_s, train=True, update_bn=True)
        else:
            feat = model.features(torch.cat([images_w, images_s]), train=True, update_bn=True)
            feat_w, feat_s = split_feature(feat, b)
        with torch.no_grad():
            dets = self.detector.detect(detach_feature(feat_w), sizes, tuple(images_w.shape[1:3]))
        pseudo_gt, pstats = self.pseudo_pipeline(dets, self.state.step)
        total, metrics = self.detector.losses_from_feature(
            feat_s, DetectionBatch(images_s, sizes, pseudo_gt), draws.rpn, draws.roi, with_bpc=True,
            box_keep=draws.box_keep,
        )
        return total, metrics, pstats, feat_s, feat_w

    def step_on_device(self, images: torch.Tensor, sizes: torch.Tensor, draws: AdaptDraws) -> Dict[str, torch.Tensor]:
        """One adaptation step on a batch already on the device: images
        [B, H, W, 3] (uint8 or float), sizes [B, 2] int32, and their draws
        (on several ranks this rank's rows of each, `step_staged`). Reads
        nothing back to the host. Returns the metrics (the losses suffixed
        `_pseudo`, total_loss, num_pseudo, pseudo_mean_conf, and the DC
        losses where built, zeros where not weighted) as tensors on the
        device."""
        with mesh.data_parallel(self.layout):
            metrics = self._step_losses(images, sizes, draws)
        self._optimizer_step()
        st = self.state
        if self.ema_enabled and st.step % self.update_iter == 0:
            ema_update(ema_tensors(st.teacher), ema_tensors(st.model), self.keep_rate)
        st.step += 1
        return metrics

    def _step_losses(self, images: torch.Tensor, sizes: torch.Tensor, draws: AdaptDraws) -> Dict[str, torch.Tensor]:
        """The step up to the gradients: views, pseudo-labels, losses and
        backward. -> the metrics."""
        st = self.state
        images = images.to(torch.float32)
        dev = images.device
        images_w = weak_flip(draws.flip, images, sizes, self.flip)
        if self.style is not None:
            images_s = self.style.stylize(images_w)
        else:
            images_s = strong_augment_batch(images_w, sizes, draws.strong) if self.weak_strong else images_w

        for p in st.optimizer.params:
            p.grad = None
        weighted = self.dc_image or self.dc_instance
        if self.pseudo_from_student:
            total, metrics, pstats, feat_s, feat_t = self._single_losses(images_w, images_s, sizes, draws)
        else:
            dets = self.teacher.pseudo_labels(images_w, sizes)
            pseudo_gt, pstats = self.pseudo_pipeline(dets, st.step)
            model = self.detector.model
            feat_s = model.features(images_s, train=True, update_bn=True)
            total, metrics = self.detector.losses_from_feature(
                feat_s, DetectionBatch(images_s, sizes, pseudo_gt), draws.rpn, draws.roi, with_bpc=True,
                box_keep=draws.box_keep,
            )
            # the weak view's student pass for the classifiers: its statistics are discarded
            feat_t = model.features(images_w, train=True, update_bn=False) if weighted else None
        metrics = {f"{k}_pseudo": v for k, v in metrics.items()}
        total = total * self.unsup_w
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if self.dc_enabled:
            metrics["loss_DC_img_s"] = metrics["loss_DC_img_t"] = zero
        if self.ins_dc_enabled:
            metrics["loss_DC_ins_s"] = metrics["loss_DC_ins_t"] = zero
        if weighted:
            canvas = tuple(images.shape[1:3])
            dc = dc_losses(self.detector, st.dc, feat_s, feat_t, (sizes, sizes), (canvas, canvas), draws.dropout,
                           self.dc_image, self.dc_instance)
            metrics.update(dc)
            for kind in ("img", "ins"):
                if f"loss_DC_{kind}_s" in dc:
                    total = total + self.dis_w * (dc[f"loss_DC_{kind}_s"] + dc[f"loss_DC_{kind}_t"])
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        metrics.update(pstats)
        return metrics

    # -- data and evaluation --------------------------------------------------
    def build_train_loader(self):
        """The unlabelled target domain is the train set (source-free)."""
        return build_train_loader(
            self.cfg,
            dataset_names=self.cfg.DATASETS.TRAIN_TARGET or self.cfg.DATASETS.TRAIN,
            batch_size=self.cfg.SOLVER.IMS_PER_BATCH_TARGET,
            synthetic=self.synthetic,
        )

    def test(self, dataset_names=None) -> Dict:
        """Evaluate the student (`self.detector`) and the teacher
        (`self.teacher`, with its bfloat16 parameters where the fixed teacher
        has them) on each dataset (default DATASETS.TEST): results under
        `<name>/student` and `<name>/teacher`, an `[eval:<tag>]` line each,
        `<name>/<tag>/AP50` into the storage, all written to
        `eval_results.json`."""
        with self.full_state():
            return self._test(dataset_names)

    def _test(self, dataset_names=None) -> Dict:
        self._maybe_precise_bn()
        results = {}
        for tag, detector in (("student", self.detector), ("teacher", self.teacher)):
            for name in dataset_names or self.cfg.DATASETS.TEST:
                res = self._evaluate(detector, name)
                results[f"{name}/{tag}"] = res
                ap_line = {k: res.get(k) for k in ("AP", "AP50", "VOC_AP50", "F1") if res.get(k) is not None}
                print(f"[eval:{tag}] {name}: {ap_line}", flush=True)
                ap50 = res.get("AP50")
                self.storage.put_scalar(f"{name}/{tag}/AP50", float("nan") if ap50 is None else ap50)
        self._write_results(results)
        return results

    def stage(self, batch: Mapping[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """A target batch in the loader's layout (images uint8 [B, H, W, 3],
        sizes [B, 2]; this rank's rows of it) on the device, copied without
        blocking."""
        batch = self._shard(batch)
        return to_device(batch["images"], self.device), to_device(batch["sizes"], self.device, torch.int32)

    def step_staged(self, staged, draws: Optional[AdaptDraws] = None) -> Dict[str, torch.Tensor]:
        """Draw for the global batch (unless `draws`, the global batch's, is
        given), keep this rank's rows and step on a staged batch."""
        images, sizes = staged
        b = mesh.global_batch(images.shape[0], self.layout)
        if draws is None:
            draws = self.make_draws(b, tuple(images.shape[1:3]))
        return self.step_on_device(images, sizes, self._local_draws(draws, b))

    def run_step(self, batch: Mapping[str, np.ndarray], draws: Optional[AdaptDraws] = None) -> Dict[str, torch.Tensor]:
        """Stage the batch, draw (unless `draws` is given) and step."""
        return self.step_staged(self.stage(batch), draws)

    def run_steps(self, batch: Mapping[str, np.ndarray], n: int) -> Dict[str, torch.Tensor]:
        """n steps on one batch, staged once (a paired trainer's one target
        batch with it): `run_step_chunk` on it n times. Each step takes its
        own draws, as the JAX package's fold on the step. Reads nothing back
        to the host; returns the last step's metrics."""
        return self.run_step_chunk([batch] * n, xs=self.stage_chunk([batch]) * n)

    # -- visualisation ---------------------------------------------------------
    def _check_before_train(self) -> None:
        """VIS_PERIOD > 0 writes to TensorBoard: the hook is built here, so a
        machine without a backend fails before the first step (the JAX
        package fails at step VIS_PERIOD - 1)."""
        if self.cfg.VIS_PERIOD > 0 and self._vis_hook is None and mesh.is_main():
            from ...utils.visualize import VisualizationHook

            try:
                self._vis_hook = VisualizationHook(self.output_dir, self.cfg.VIS_PERIOD, input_format=self.cfg.INPUT.FORMAT)
            except ImportError as e:
                raise RuntimeError(
                    f"VIS_PERIOD {self.cfg.VIS_PERIOD} writes pseudo-labels to TensorBoard, but neither tensorboardX "
                    "nor torch.utils.tensorboard imports; set VIS_PERIOD 0"
                ) from e

    def _close_writers(self) -> None:
        super()._close_writers()
        if self._vis_hook is not None:
            self._vis_hook.close()
            self._vis_hook = None

    def _after_steps(self, batch) -> None:
        self._maybe_visualize(batch)

    def _maybe_visualize(self, batch) -> None:
        """Every VIS_PERIOD steps, the teacher's detections on the batch's
        first image above BBOX_THRESHOLD to TensorBoard (the only read-back
        of those steps)."""
        hook = self._vis_hook
        period, step = self.cfg.VIS_PERIOD, self.storage.iter
        if period <= 0 or (step + 1) % period:
            return
        # rank 0 writes; a tensor-parallel teacher's forward takes its model group
        if hook is None and (self.layout is None or self.layout.model == 1 or mesh.is_main()):
            return
        dets = self.teacher.infer(batch["images"][:1], batch["sizes"][:1])
        if hook is None:
            return
        valid = dets.valid[0].cpu().numpy()
        scores = dets.scores[0].float().cpu().numpy()
        keep = valid & (scores > self.bbox_threshold)
        hook.after_step(
            self.storage.iter,
            batch["images"][0],
            dets.boxes[0].float().cpu().numpy()[keep],
            dets.classes[0].cpu().numpy()[keep],
            scores[keep],
            tag="train/teacher_pseudo_labels",
        )


@register_trainer("source_free_adaptive_teacher")
class SFATMain(SourceFreeAdaptiveTeacherTrainer):
    pseudo_from_student = False
    ema_enabled = False  # fixed teacher (the reference's update is commented out)


@register_trainer("source_free_adaptive_teacher_single")
class SFATSingle(SourceFreeAdaptiveTeacherTrainer):
    pseudo_from_student = True
    ema_enabled = True


@register_trainer("source_free_adaptive_teacher_mosaic")
class SFATMosaic(SourceFreeAdaptiveTeacherTrainer):
    pseudo_from_student = False
    ema_enabled = True
