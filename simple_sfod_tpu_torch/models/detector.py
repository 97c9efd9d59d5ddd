"""Detector API (the port of `simple_sfod_tpu/models/detector.py`): the
supervised losses (`supervised_losses`, `losses_from_feature`, with the BPC
loss logged on request) with train-mode BatchNorm; inference (`infer`,
`infer_from_feature`) under `torch.inference_mode`, with eval-mode or
batch-statistics BatchNorm, through `InferenceModule`, the inference path
as an `nn.Module` that `engine/export.py` exports; and the teacher's side of
adaptation: `pseudo_labels`, a train-mode-BN forward that moves the running
statistics and returns detections made under `torch.no_grad` (tensors that
autograd may save, as the student's losses do with them), and `bn_update`;
and the box-head features of the training proposals that the
instance-level domain classifiers take (`box_features_from_feature`)."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..structures.instances import Instances
from ..losses.bpc import bpc_loss
from .faster_rcnn import (
    DetectorConfig,
    FasterRCNN,
    RPNOutput,
    anchors_for,
    bpc_candidates,
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


def detect(model: FasterRCNN, feature: torch.Tensor, sizes: torch.Tensor, canvas_hw: Tuple[int, int]) -> Instances:
    """Head-side inference of `model` on a backbone feature [B, C, h, w]
    computed from padded canvases of size canvas_hw, sizes int32 [B, 2], all
    images at once, in the caller's grad mode."""
    cfg = model.cfg
    anchors = anchors_for(cfg, canvas_hw, feature.device)
    proposals = propose(cfg, anchors, model.rpn(feature), sizes)
    scores, deltas = model.box(pool_rois(cfg, feature, proposals.boxes))
    b, r = proposals.boxes.shape[:2]
    return roi_inference(cfg, scores.reshape(b, r, -1), deltas.reshape(b, r, -1), proposals, sizes)


class InferenceModule(nn.Module):
    """The detector's standard inference as an `nn.Module` (the counterpart
    of the JAX package's `engine/export.py:detection_infer_fn`), in plain
    types so that an exported program's calling convention needs nothing of
    this package:

        images uint8 [B, H, W, 3], sizes int32 [B, 2] (true h, w)
        -> {"boxes" f32 [B, K, 4], "scores" f32 [B, K], "classes" i32 [B, K],
            "valid" bool [B, K]},  K = TEST.DETECTIONS_PER_IMAGE

    `train_mode_bn` normalises by the batch statistics without moving the
    running ones (the AdaBN probe). It sets no grad mode: `Detector.infer`
    runs it under inference mode, `engine/export.py` traces it under
    no_grad."""

    def __init__(self, model: FasterRCNN, train_mode_bn: bool = False):
        super().__init__()
        self.model = model
        self.train_mode_bn = train_mode_bn

    def forward(self, images: torch.Tensor, sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        feature = self.model.features(images, train=self.train_mode_bn, update_bn=False)
        dets = detect(self.model, feature, sizes, tuple(images.shape[1:3]))
        return {"boxes": dets.boxes, "scores": dets.scores, "classes": dets.classes, "valid": dets.valid}


class Detector:
    """A FasterRCNN module bound to its config and device.

    `device=None` means CUDA, and raises when no GPU is present; tests pass
    `device="cpu"`. Weights come from `load_state_dict` (a port state dict,
    for example from checkpoint/from_jax.py) or `models.faster_rcnn.init_weights`.
    """

    def __init__(self, cfg: DetectorConfig, device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = FasterRCNN(cfg).to(self.device).eval()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)

    def load_state_dict(self, state_dict) -> "Detector":
        """Load a port state dict strictly: every key present, no extra."""
        self.model.load_state_dict(state_dict, strict=True)
        return self

    def losses_from_feature(
        self,
        feature: torch.Tensor,
        batch: DetectionBatch,
        rpn_priorities: torch.Tensor,
        roi_priorities: torch.Tensor,
        loss_weights: Optional[Dict[str, float]] = None,
        with_bpc: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Head-side supervised losses on a backbone feature [B, C, h, w].
        rpn_priorities [B, N_anchors] and roi_priorities [B, pool] are the
        samplers' uniform draws (`faster_rcnn.roi_pool_size` gives pool).
        Returns (total, metrics): the total weights each loss by
        `loss_weights` (default 1); metrics hold the unweighted losses,
        num_fg and num_sampled (and `loss_bpc` with `with_bpc`), all
        tensors on the device."""
        cfg = self.cfg
        anchors = anchors_for(cfg, tuple(batch.images.shape[1:3]), feature.device)
        rpn_out = self.model.rpn(feature)
        losses = rpn_losses(cfg, anchors, rpn_out, batch.gt, rpn_priorities)
        # proposal boxes carry no gradient (the JAX package's stop_gradient)
        detached = RPNOutput(rpn_out.objectness.detach(), rpn_out.deltas.detach())
        proposals = propose(cfg, anchors, detached, batch.sizes, training=True)
        sampled = label_and_sample_proposals(cfg, proposals, batch.gt, roi_priorities)
        scores, deltas = self.model.box(pool_rois(cfg, feature, sampled.boxes))
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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The full supervised Faster R-CNN loss with train-mode BatchNorm.
        With `update_bn` the BatchNorm running statistics move in place (the
        JAX package returns them as new batch_stats); without it they stay
        as they were. Returns (total, metrics) as `losses_from_feature`."""
        feature = self.model.features(batch.images, train=True, update_bn=update_bn)
        return self.losses_from_feature(
            feature, batch, rpn_priorities, roi_priorities, loss_weights=loss_weights, with_bpc=with_bpc
        )

    def box_features_from_feature(
        self, feature: torch.Tensor, sizes: torch.Tensor, canvas_hw: Tuple[int, int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Box-head features of the post-NMS training proposals on a backbone
        feature [B, C, h, w], for the instance-level domain classifier:
        (features [B*R, fc_dim], valid [B*R]). Gradients reach the backbone
        and the box head, not the proposal boxes (made under no_grad: the
        supervised path detaches them too)."""
        cfg = self.cfg
        with torch.no_grad():
            anchors = anchors_for(cfg, canvas_hw, feature.device)
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

    def detect(self, feature: torch.Tensor, sizes, canvas_hw: Tuple[int, int]) -> Instances:
        """Head-side inference on a backbone feature [B, C, h, w] computed
        from a padded canvas of size canvas_hw, in the caller's grad mode."""
        return detect(self.model, feature, self._tensor(sizes, torch.int32), canvas_hw)

    @torch.inference_mode()
    def infer_from_feature(
        self,
        feature: torch.Tensor,
        sizes: torch.Tensor,
        canvas_hw: Tuple[int, int],
    ) -> Instances:
        """`detect` under inference mode."""
        return self.detect(feature, sizes, canvas_hw)

    @torch.inference_mode()
    def infer(self, images, sizes, train_mode_bn: bool = False) -> Instances:
        """images [B, H, W, 3] (uint8 canvases, the loader's layout), sizes
        [B, 2] int32 true (h, w) -> detections [B, topk]: boxes, scores,
        classes, valid. `train_mode_bn` normalises by the batch statistics
        without moving the running ones (the JAX package's AdaBN probe).
        The code of an exported program (`InferenceModule`)."""
        out = InferenceModule(self.model, train_mode_bn)(self._tensor(images), self._tensor(sizes, torch.int32))
        return Instances(**out)

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
        running statistics in place (the JAX package returns them)."""
        self.model.features(self._tensor(images), train=True, update_bn=True)
