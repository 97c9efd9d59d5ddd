"""Detector API (the port of `simple_sfod_tpu/models/detector.py`): the
supervised losses (`supervised_losses`, `losses_from_feature`, with the BPC
loss logged on request) with train-mode BatchNorm; inference (`infer`,
`infer_from_feature`, and `infer_raw` without score filter or class-wise
NMS) under `torch.inference_mode`, with eval-mode or
batch-statistics BatchNorm, through `InferenceModule`, the inference path
as an `nn.Module` that `engine/export.py` exports; and the teacher's side of
adaptation: `pseudo_labels`, a train-mode-BN forward that moves the running
statistics and returns detections made under `torch.no_grad` (tensors that
autograd may save, as the student's losses do with them), and `bn_update`;
and the box-head features of the training proposals that the
instance-level domain classifiers take (`box_features_from_feature`).

A "feature" is the backbone's output that the heads take: one map
[B, C, h, w], or for an FPN detector the dict of its pyramid levels; every
function here takes either."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..structures.instances import Instances
from ..losses.bpc import bpc_loss
from .faster_rcnn import (
    DetectorConfig,
    FasterRCNN,
    Feature,
    RPNOutput,
    anchors_for,
    bpc_candidates,
    empty_model,
    feature_device,
    label_and_sample_proposals,
    pool_rois,
    propose,
    roi_inference,
    roi_losses,
    rpn_losses,
)


class DetectionBatch(NamedTuple):
    """One training batch on the detector's device: images [B, H, W, 3]
    raw pixels, sizes [B, 2] int32 true (h, w), gt padded Instances [B, M]."""

    images: torch.Tensor
    sizes: torch.Tensor
    gt: Instances


def detect(model: FasterRCNN, feature: Feature, sizes: torch.Tensor, canvas_hw: Tuple[int, int], **roi) -> Instances:
    """Head-side inference of `model` on a backbone feature computed from
    padded canvases of size canvas_hw, sizes int32 [B, 2], all images at
    once, in the caller's grad mode. `roi` goes to `roi_inference` (its
    thresholds, topk and switches; the config's TEST values by default)."""
    cfg = model.cfg
    anchors = anchors_for(cfg, canvas_hw, feature_device(feature))
    proposals = propose(cfg, anchors, model.rpn(feature), sizes)
    scores, deltas = model.box(pool_rois(cfg, feature, proposals.boxes))
    b, r = proposals.boxes.shape[:2]
    return roi_inference(cfg, scores.reshape(b, r, -1), deltas.reshape(b, r, -1), proposals, sizes, **roi)


class InferenceModule(nn.Module):
    """The detector's standard inference as an `nn.Module` (the counterpart
    of the JAX package's `engine/export.py:detection_infer_fn`), in plain
    types so that an exported program's calling convention needs nothing of
    this package:

        images uint8 [B, H, W, 3], sizes int32 [B, 2] (true h, w)
        -> {"boxes" f32 [B, K, 4], "scores" f32 [B, K], "classes" i32 [B, K],
            "valid" bool [B, K]},  K = TEST.DETECTIONS_PER_IMAGE

    `train_mode_bn` normalises by the batch statistics without moving the
    running ones (the AdaBN probe); `roi` overrides `roi_inference`'s
    thresholds and topk (K). It sets no grad mode: `Detector.infer` runs it
    under inference mode, `engine/export.py` traces it under no_grad."""

    def __init__(self, model: FasterRCNN, train_mode_bn: bool = False, **roi):
        super().__init__()
        self.model = model
        self.train_mode_bn = train_mode_bn
        self.roi = roi

    def forward(self, images: torch.Tensor, sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        feature = self.model.features(images, train=self.train_mode_bn, update_bn=False)
        dets = detect(self.model, feature, sizes, tuple(images.shape[1:3]), **self.roi)
        return {"boxes": dets.boxes, "scores": dets.scores, "classes": dets.classes, "valid": dets.valid}


class Detector:
    """A FasterRCNN module bound to its config and device.

    `device=None` means CUDA, and raises when no GPU is present; tests pass
    `device="cpu"`. Weights come from `load_state_dict` (a port state dict,
    for example from checkpoint/from_jax.py) or `models.faster_rcnn.init_weights`,
    each of which writes every parameter and buffer: the modules are built
    without PyTorch's default initialisation (`faster_rcnn.empty_model`),
    and hold uninitialised memory until one of them runs.
    """

    def __init__(self, cfg: DetectorConfig, device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = empty_model(cfg, self.device).eval()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)

    def load_state_dict(self, state_dict) -> "Detector":
        """Load a port state dict strictly: every key present, no extra."""
        self.model.load_state_dict(state_dict, strict=True)
        return self

    def losses_from_feature(
        self,
        feature: Feature,
        batch: DetectionBatch,
        rpn_priorities: torch.Tensor,
        roi_priorities: torch.Tensor,
        loss_weights: Optional[Dict[str, float]] = None,
        with_bpc: bool = False,
        box_keep: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Head-side supervised losses on a backbone feature.
        rpn_priorities [B, N_anchors] and roi_priorities [B, pool] are the
        samplers' uniform draws (`faster_rcnn.roi_pool_size` gives pool);
        box_keep the box head's dropout keep masks on the sampled ROIs
        (`faster_rcnn.box_dropout_masks`), None without dropout.
        Returns (total, metrics): the total weights each loss by
        `loss_weights` (default 1); metrics hold the unweighted losses,
        num_fg and num_sampled (and `loss_bpc` with `with_bpc`), all
        tensors on the device."""
        cfg = self.cfg
        anchors = anchors_for(cfg, tuple(batch.images.shape[1:3]), feature_device(feature))
        rpn_out = self.model.rpn(feature)
        losses = rpn_losses(cfg, anchors, rpn_out, batch.gt, rpn_priorities)
        # proposal boxes carry no gradient (the JAX package's stop_gradient)
        detached = RPNOutput(rpn_out.objectness.detach(), rpn_out.deltas.detach())
        proposals = propose(cfg, anchors, detached, batch.sizes, training=True)
        sampled = label_and_sample_proposals(cfg, proposals, batch.gt, roi_priorities)
        if (box_keep is None) != (cfg.box_head_dropout <= 0):
            raise ValueError(f"box_head_dropout {cfg.box_head_dropout} needs keep masks, and only it takes them")
        scores, deltas = self.model.box(pool_rois(cfg, feature, sampled.boxes), box_keep)
        losses.update(roi_losses(cfg, scores, deltas, sampled))

        weights = loss_weights or {}
        total = sum(v * weights.get(k, 1.0) for k, v in losses.items())
        metrics = dict(losses)
        metrics["num_fg"] = sampled.is_fg.sum()
        metrics["num_sampled"] = sampled.valid.sum()
        if with_bpc:
            # logged only, outside the total and without a gradient: every
            # (sampled proposal, class) pair, no threshold, no NMS
            with torch.no_grad():
                preds = bpc_candidates(cfg, scores.detach(), deltas.detach(), sampled, batch.sizes)
                metrics["loss_bpc"] = bpc_loss(preds, batch.gt)
        return total, metrics

    def supervised_losses(
        self,
        batch: DetectionBatch,
        rpn_priorities: torch.Tensor,
        roi_priorities: torch.Tensor,
        update_bn: bool = True,
        loss_weights: Optional[Dict[str, float]] = None,
        with_bpc: bool = False,
        box_keep: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The full supervised Faster R-CNN loss with train-mode BatchNorm.
        With `update_bn` the BatchNorm running statistics move in place (the
        JAX package returns them as new batch_stats); without it they stay
        as they were. Returns (total, metrics) as `losses_from_feature`."""
        feature = self.model.features(batch.images, train=True, update_bn=update_bn)
        return self.losses_from_feature(
            feature, batch, rpn_priorities, roi_priorities, loss_weights=loss_weights, with_bpc=with_bpc,
            box_keep=box_keep,
        )

    def box_features_from_feature(
        self, feature: Feature, sizes: torch.Tensor, canvas_hw: Tuple[int, int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Box-head features of the post-NMS training proposals on a backbone
        feature, for the instance-level domain classifier:
        (features [B*R, fc_dim], valid [B*R]). Gradients reach the backbone
        and the box head, not the proposal boxes (made under no_grad: the
        supervised path detaches them too)."""
        cfg = self.cfg
        with torch.no_grad():
            anchors = anchors_for(cfg, canvas_hw, feature_device(feature))
            proposals = propose(cfg, anchors, self.model.rpn(feature), sizes, training=True)
        feats = self.model.box_feature(pool_rois(cfg, feature, proposals.boxes))
        return feats, proposals.valid.reshape(-1)

    def box_features(self, images, sizes) -> Tuple[torch.Tensor, torch.Tensor]:
        """`box_features_from_feature` on the eval-mode BatchNorm features of
        images [B, H, W, 3]."""
        images = self._tensor(images)
        feature = self.model.features(images, train=False)
        return self.box_features_from_feature(feature, self._tensor(sizes, torch.int32), tuple(images.shape[1:3]))

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype=dtype) if dtype else x.to(self.device)

    def detect(self, feature: Feature, sizes, canvas_hw: Tuple[int, int], **roi) -> Instances:
        """Head-side inference on a backbone feature computed from a padded
        canvas of size canvas_hw, in the caller's grad mode (`roi` as in
        the module function `detect`)."""
        return detect(self.model, feature, self._tensor(sizes, torch.int32), canvas_hw, **roi)

    @torch.inference_mode()
    def infer_from_feature(
        self,
        feature: Feature,
        sizes: torch.Tensor,
        canvas_hw: Tuple[int, int],
        score_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None,
        topk: Optional[int] = None,
    ) -> Instances:
        """`detect` under inference mode, with the JAX package's overrides
        of the config's TEST thresholds and detections per image."""
        return self.detect(feature, sizes, canvas_hw, score_thresh=score_thresh, nms_thresh=nms_thresh, topk=topk)

    @torch.inference_mode()
    def infer(
        self,
        images,
        sizes,
        score_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None,
        topk: Optional[int] = None,
        train_mode_bn: bool = False,
    ) -> Instances:
        """images [B, H, W, 3] (uint8 canvases, the loader's layout), sizes
        [B, 2] int32 true (h, w) -> detections [B, topk]: boxes, scores,
        classes, valid. `score_thresh`, `nms_thresh` and `topk` override the
        config's TEST values. `train_mode_bn` normalises by the batch
        statistics without moving the running ones (the JAX package's AdaBN
        probe). The code of an exported program (`InferenceModule`)."""
        module = InferenceModule(self.model, train_mode_bn, score_thresh=score_thresh, nms_thresh=nms_thresh, topk=topk)
        return Instances(**module(self._tensor(images), self._tensor(sizes, torch.int32)))

    @torch.inference_mode()
    def infer_raw(self, images, sizes, topk: int = 512) -> Instances:
        """No score filter and no class-wise NMS: the reference's
        fast_rcnn_inference_new, which feeds raw (box, score) pairs to the
        BPC loss. Eval-mode BatchNorm; the RPN's proposals as in `infer`
        (its NMS included). -> Instances [B, topk], the top-k of the
        capped candidates by score."""
        images = self._tensor(images)
        feature = self.model.features(images, train=False)
        return self.detect(feature, sizes, tuple(images.shape[1:3]), topk=topk, apply_nms=False,
                           apply_score_thresh=False)

    @torch.no_grad()
    def pseudo_labels(self, images: torch.Tensor, sizes: torch.Tensor) -> Instances:
        """The adaptive teacher's forward: train-mode BatchNorm on the batch
        statistics, which also moves the running statistics (the JAX
        package's mutable train-mode `_features` whose batch_stats become the
        new teacher statistics), then inference. The detections are made
        under no_grad, not inference mode, so the student's losses can save
        them for backward."""
        images = self._tensor(images)
        feature = self.model.features(images, train=True, update_bn=True)
        return self.detect(feature, sizes, tuple(images.shape[1:3]))

    @torch.no_grad()
    def bn_update(self, images) -> None:
        """One AdaBN accumulation step: a train-mode forward that moves the
        running statistics in place (the JAX package returns them); a
        forward that changes nothing on a detector without BatchNorm."""
        self.model.features(self._tensor(images), train=True, update_bn=True)
