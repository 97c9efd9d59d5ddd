"""Faster R-CNN, single-level (the port of `simple_sfod_tpu/models/faster_rcnn.py`).

One `nn.Module` holds the parameterised layers, with Detectron2's names;
plain functions on tensors carry the inference pipeline:

    feature     = model.features(images)                 # uint8 NHWC in
    rpn_out     = model.rpn(feature)
    proposals   = propose(cfg, anchors, rpn_out, sizes)  # top-k, decode, NMS
    pooled      = pool_rois(cfg, feature, proposals.boxes)
    scores, dl  = model.box(pooled)
    detections  = roi_inference(cfg, scores, dl, proposals, sizes)

and the supervised training functions (losses take their sampler
priorities as inputs, so a caller can hand over the JAX package's draws):

    proposals   = propose(cfg, anchors, rpn_out, sizes, training=True)
    rpn         = rpn_losses(cfg, anchors, rpn_out, gt, rpn_priorities)
    sampled     = label_and_sample_proposals(cfg, proposals, gt, roi_priorities)
    roi         = roi_losses(cfg, scores, deltas, sampled)

This covers the single-level detector on VGG16-BN or ResNet-50/101 (C4:
the heads on "res4", BN or FrozenBN); FPN and box-head dropout are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import nn

from ..ops import nms
from ..ops.anchors import generate_anchors
from ..ops.losses import sigmoid_ce, smooth_l1, softmax_ce
from ..ops.matcher import ROI_MATCHER, RPN_MATCHER, match_boxes
from ..ops.roi_align import roi_align
from ..ops.sampler import subsample_labels, subsample_labels_mask
from ..structures.boxes import BoxTransform, clip_boxes, nonempty, pairwise_iou
from ..structures.instances import Instances, topk_indices
from .backbones.resnet import FrozenBatchNorm2d, ResNetBackbone
from .backbones.vgg import VGG16Backbone
from .heads import FastRCNNConvFCHead, FastRCNNPredictor, RPNHead


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static architecture and pipeline settings; the same fields and
    defaults as the JAX package's DetectorConfig, with a torch dtype."""

    num_classes: int = 8
    backbone: str = "vgg16"
    vgg_bn: bool = True
    resnet_norm: str = "BN"
    in_feature: str = "vgg4"
    fpn: bool = False
    fpn_in_features: Tuple[str, ...] = ()
    fpn_out_channels: int = 256
    fpn_norm: str = ""
    fpn_fuse_type: str = "sum"
    rpn_in_features: Tuple[str, ...] = ()
    roi_in_features: Tuple[str, ...] = ()
    anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    anchor_sizes_per_level: Tuple[Tuple[float, ...], ...] = ()
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_pre_nms_topk_train: int = 4096
    rpn_post_nms_topk_train: int = 2000
    rpn_pre_nms_topk_test: int = 4096
    rpn_post_nms_topk_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_smooth_l1_beta: float = 0.0
    rpn_loss_weight: float = 1.0
    roi_batch_size_per_image: int = 512
    roi_positive_fraction: float = 0.25
    proposal_append_gt: bool = True
    pooler_resolution: int = 7
    pooler_sampling_ratio: int = 2
    fc_dim: int = 1024
    num_fc: int = 2
    box_head_dropout: float = 0.0
    score_thresh_test: float = 0.05
    nms_thresh_test: float = 0.5
    detections_per_image: int = 100
    pixel_mean: Tuple[float, float, float] = (103.53, 116.28, 123.675)
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    dtype: Any = torch.float32

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.anchor_ratios)

    def _check_ported(self) -> None:
        if self.fpn or self.backbone not in _BACKBONES:
            raise NotImplementedError(
                f"only the single-level vgg16, resnet50 and resnet101 detectors are ported (got backbone="
                f"{self.backbone!r}, fpn={self.fpn})"
            )
        if self.box_head_dropout > 0:
            raise NotImplementedError(
                f"box-head dropout is not ported yet (box_head_dropout="
                f"{self.box_head_dropout}); the port would train without it"
            )

    @property
    def stride(self) -> int:
        self._check_ported()
        return _BACKBONES[self.backbone].out_strides()[self.in_feature]

    @property
    def feature_channels(self) -> int:
        self._check_ported()
        return _BACKBONES[self.backbone].out_channels()[self.in_feature]


_BACKBONES = {"vgg16": VGG16Backbone, "resnet50": ResNetBackbone, "resnet101": ResNetBackbone}


def build_backbone(cfg: DetectorConfig) -> nn.Module:
    """The backbone of `cfg`, as the JAX FasterRCNN.setup builds it."""
    if cfg.backbone == "vgg16":
        return VGG16Backbone(bn=cfg.vgg_bn)
    depth = 50 if cfg.backbone == "resnet50" else 101
    return ResNetBackbone(depth=depth, norm=cfg.resnet_norm, out_features=(cfg.in_feature,))


RPN_BOX_TRANSFORM = BoxTransform((1.0, 1.0, 1.0, 1.0))
ROI_BOX_TRANSFORM = BoxTransform((10.0, 10.0, 5.0, 5.0))


class _Namespace(nn.Module):
    """A container that only adds a level to the parameter names."""


class FasterRCNN(nn.Module):
    """Parameterised layers; the pipeline lives in the free functions.

    Convolutions and the box head run under autocast in `cfg.dtype` when it
    is bfloat16 (the JAX package's `TPU.DTYPE: bfloat16`); RPN and predictor
    outputs are float32."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        cfg._check_ported()
        self.cfg = cfg
        self.backbone = build_backbone(cfg)
        self.proposal_generator = _Namespace()
        self.proposal_generator.rpn_head = RPNHead(cfg.feature_channels, cfg.num_anchors)
        self.roi_heads = _Namespace()
        pool = cfg.pooler_resolution
        self.roi_heads.box_head = FastRCNNConvFCHead(
            cfg.feature_channels * pool * pool, cfg.fc_dim, cfg.num_fc
        )
        self.roi_heads.box_predictor = FastRCNNPredictor(cfg.fc_dim, cfg.num_classes)
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32).view(3, 1, 1))
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32).view(3, 1, 1))

    def _autocast(self, device: torch.device):
        return torch.autocast(
            device.type, dtype=torch.bfloat16, enabled=self.cfg.dtype == torch.bfloat16
        )

    def features(self, images: torch.Tensor, train: bool = False, update_bn: bool = True) -> torch.Tensor:
        """images [B, H, W, 3] raw pixels (uint8 or float) -> in_feature
        [B, C, h, w]. Integer images become float32 BEFORE the mean is
        subtracted (a uint8 subtraction would wrap around). `train` runs
        BatchNorm on batch statistics, and `update_bn` then moves the
        running ones (models/backbones/vgg.py; a FrozenBN layer has one
        mode)."""
        x = images.permute(0, 3, 1, 2)
        if not x.is_floating_point():
            x = x.to(torch.float32)
        x = (x - self.pixel_mean) / self.pixel_std
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        with self._autocast(x.device):
            return self.backbone(x, train, update_bn)[self.cfg.in_feature]

    def rpn(self, feature: torch.Tensor) -> "RPNOutput":
        with self._autocast(feature.device):
            return RPNOutput(*self.proposal_generator.rpn_head(feature))

    def box(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled [N, C, P, P] -> (scores [N, C+1], deltas [N, 4K]) float32.
        The same in training and inference: the box head's one train-mode
        difference in the JAX package is dropout, which is not ported."""
        with self._autocast(pooled.device):
            return self.roi_heads.box_predictor(self.roi_heads.box_head(pooled))


@torch.no_grad()
def init_weights(model: FasterRCNN, seed: int) -> FasterRCNN:
    """Seeded random weights with the JAX package's initialiser scales:
    convs normal with std 1/sqrt(fan_in), RPN convs normal(0.01), box-head FCs fan-in uniform,
    cls_score normal(0.01), bbox_pred normal(0.001), zero biases, BN and
    FrozenBN scale 1 / bias 0 / mean 0 / var 1. Drawn on the CPU from one
    torch.Generator, so a seed gives the same weights on every machine."""
    g = torch.Generator().manual_seed(seed)

    def fill(t: torch.Tensor, std: float = None, bound: float = None):
        cpu = torch.empty(t.shape, dtype=torch.float32)
        if std is not None:
            cpu.normal_(0.0, std, generator=g)
        else:
            cpu.uniform_(-bound, bound, generator=g)
        t.copy_(cpu)

    rpn = model.proposal_generator.rpn_head
    predictor = model.roi_heads.box_predictor
    special = {
        rpn.conv: 0.01, rpn.objectness_logits: 0.01, rpn.anchor_deltas: 0.01,
        predictor.cls_score: 0.01, predictor.bbox_pred: 0.001,
    }
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            if m in special:
                fill(m.weight, std=special[m])
            elif isinstance(m, nn.Conv2d):
                fill(m.weight, std=1.0 / math.sqrt(fan_in))
            else:
                fill(m.weight, bound=math.sqrt(3.0 / fan_in))
            if m.bias is not None:  # the ResNet convs have none
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, FrozenBatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return model


class RPNOutput(NamedTuple):
    objectness: torch.Tensor  # [B, N_anchors] float32
    deltas: torch.Tensor  # [B, N_anchors, 4] float32


class SampledProposals(NamedTuple):
    """The ROI heads' training batch, all [B, S, ...]."""

    boxes: torch.Tensor  # [B, S, 4] proposal boxes
    gt_classes: torch.Tensor  # [B, S] int64; num_classes = background
    reg_targets: torch.Tensor  # [B, S, 4] deltas to the matched GT
    is_fg: torch.Tensor  # [B, S] bool
    valid: torch.Tensor  # [B, S] bool


def proposal_counts(cfg: DetectorConfig, num_anchors: int, training: bool) -> Tuple[int, int]:
    """(pre-NMS, post-NMS) proposal counts of one image: the config's caps,
    bounded by the anchor count."""
    pre_k = cfg.rpn_pre_nms_topk_train if training else cfg.rpn_pre_nms_topk_test
    post_k = cfg.rpn_post_nms_topk_train if training else cfg.rpn_post_nms_topk_test
    pre_k = min(pre_k, num_anchors)
    return pre_k, min(post_k, pre_k)


def roi_pool_size(cfg: DetectorConfig, num_anchors: int, gt_capacity: int) -> int:
    """Candidates per image that `label_and_sample_proposals` samples from:
    the training proposals, plus the GT slots when they are appended."""
    return proposal_counts(cfg, num_anchors, True)[1] + (gt_capacity if cfg.proposal_append_gt else 0)


@functools.lru_cache(maxsize=32)
def _anchor_grid(feature_hw, stride, sizes, ratios, device: torch.device) -> torch.Tensor:
    return generate_anchors(feature_hw, stride, sizes, ratios, device=device)


def anchors_for(cfg: DetectorConfig, canvas_hw: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """Anchor grid [h*w*A, 4] of the padded canvas; the feature map is
    ceil(H / stride) x ceil(W / stride). Built on the host and copied to the
    device once per canvas and device, then shared (callers must not write
    to it): a step reads it without a host-to-device copy."""
    stride = cfg.stride
    fh = (canvas_hw[0] + stride - 1) // stride
    fw = (canvas_hw[1] + stride - 1) // stride
    return _anchor_grid(
        (fh, fw), stride, tuple(cfg.anchor_sizes), tuple(cfg.anchor_ratios), torch.device(device)
    )


def propose(
    cfg: DetectorConfig,
    anchors: torch.Tensor,
    rpn_out: RPNOutput,
    image_sizes: torch.Tensor,
    training: bool = False,
) -> Instances:
    """RPN proposals (detectron2 find_top_rpn_proposals with fixed shapes):
    pre-NMS top-k by objectness, decode, clip, NMS at `rpn_nms_thresh`,
    post-NMS top-k, with the training or the test caps. Returns Instances
    with a leading batch dim: boxes [B, post_k, 4]."""
    if rpn_out.objectness.shape[1] != anchors.shape[0]:
        raise ValueError(
            f"RPN prediction count {rpn_out.objectness.shape[1]} != anchor count {anchors.shape[0]}"
        )
    pre_k, post_k = proposal_counts(cfg, anchors.shape[0], training)
    idx = topk_indices(rpn_out.objectness, pre_k)  # [B, pre_k]
    vals = torch.gather(rpn_out.objectness, 1, idx)
    deltas = torch.gather(rpn_out.deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = RPN_BOX_TRANSFORM.apply_deltas(deltas, anchors[idx])
    boxes = clip_boxes(boxes, image_sizes)
    valid = nonempty(boxes) & torch.isfinite(vals)
    keep = nms.nms_mask_matrix(boxes, vals, valid, cfg.rpn_nms_thresh)
    inst = Instances(boxes=boxes, scores=vals, classes=torch.zeros_like(idx, dtype=torch.int32), valid=keep)
    return inst.top_k(post_k)


def rpn_losses(
    cfg: DetectorConfig,
    anchors: torch.Tensor,
    rpn_out: RPNOutput,
    gt: Instances,
    priorities: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """RPN objectness and box-regression losses, each a sum over the sampled
    anchors / (B * rpn_batch_size_per_image) (detectron2). gt: Instances
    [B, M]; priorities [B, N_anchors], the sampler's uniform draws."""
    b = rpn_out.objectness.shape[0]
    labels, sel, sel_pos, reg_targets = [], [], [], []
    for i in range(b):
        iou = pairwise_iou(gt.boxes[i], anchors)  # [M, N]
        matched_idx, lab = match_boxes(iou, gt.valid[i], RPN_MATCHER)
        s, sp = subsample_labels_mask(lab, cfg.rpn_batch_size_per_image, cfg.rpn_positive_fraction, priorities[i])
        labels.append(lab)
        sel.append(s)
        sel_pos.append(sp)
        reg_targets.append(RPN_BOX_TRANSFORM.get_deltas(anchors, gt.boxes[i][matched_idx]))
    labels, sel, sel_pos, reg_targets = (torch.stack(t) for t in (labels, sel, sel_pos, reg_targets))

    normalizer = float(b * cfg.rpn_batch_size_per_image)
    obj_loss = sigmoid_ce(rpn_out.objectness, (labels == 1).to(torch.float32))
    loss_cls = torch.sum(obj_loss * sel.to(torch.float32)) / normalizer
    reg = smooth_l1(rpn_out.deltas, reg_targets, cfg.rpn_smooth_l1_beta)
    loss_loc = torch.sum(reg * sel_pos[..., None].to(torch.float32)) / normalizer
    return {
        "loss_rpn_cls": loss_cls * cfg.rpn_loss_weight,
        "loss_rpn_loc": loss_loc * cfg.rpn_loss_weight,
    }


def label_and_sample_proposals(
    cfg: DetectorConfig,
    proposals: Instances,
    gt: Instances,
    priorities: torch.Tensor,
) -> SampledProposals:
    """Match proposals to the GT and sample the ROI heads' training batch
    (detectron2 ROIHeads.label_and_sample_proposals with fixed shapes). The
    GT boxes join the pool first when `proposal_append_gt`. proposals
    [B, K], gt [B, M], priorities [B, K (+ M)]."""
    s = cfg.roi_batch_size_per_image
    out = []
    for i in range(proposals.boxes.shape[0]):
        prop_i = Instances(proposals.boxes[i], proposals.scores[i], proposals.classes[i], proposals.valid[i])
        gt_i = Instances(gt.boxes[i], gt.scores[i], gt.classes[i], gt.valid[i])
        pool = Instances.concatenate(prop_i, gt_i) if cfg.proposal_append_gt else prop_i
        iou = pairwise_iou(gt_i.boxes, pool.boxes)
        matched_idx, match_labels = match_boxes(iou, gt_i.valid, ROI_MATCHER)
        # candidate labels: 1 foreground, 0 background, -1 ignored or padding
        cand = torch.where(pool.valid, match_labels, torch.full_like(match_labels, -1))
        idx, is_pos, valid = subsample_labels(cand, s, cfg.roi_positive_fraction, priorities[i])
        boxes = pool.boxes[idx]
        m_idx = matched_idx[idx]
        background = torch.full_like(m_idx, cfg.num_classes)
        classes = torch.where(is_pos & valid, gt_i.classes[m_idx].to(m_idx.dtype), background)
        reg_targets = ROI_BOX_TRANSFORM.get_deltas(boxes, gt_i.boxes[m_idx])
        out.append((boxes, classes, reg_targets, is_pos & valid, valid))
    return SampledProposals(*(torch.stack(t) for t in zip(*out)))


def roi_losses(
    cfg: DetectorConfig,
    scores: torch.Tensor,
    deltas: torch.Tensor,
    sampled: SampledProposals,
) -> Dict[str, torch.Tensor]:
    """Fast R-CNN classification and class-specific box-regression losses
    (detectron2 FastRCNNOutputLayers.losses): cross-entropy averaged over
    the sampled rows, smooth-L1 summed over the foreground rows, both
    divided by the sampled count. scores [B*S, C+1], deltas [B*S, 4C]."""
    classes = sampled.gt_classes.reshape(-1)
    valid = sampled.valid.reshape(-1).to(torch.float32)
    is_fg = sampled.is_fg.reshape(-1).to(torch.float32)
    reg_targets = sampled.reg_targets.reshape(-1, 4)

    ce = softmax_ce(scores, classes)
    denom = torch.clamp_min(torch.sum(valid), 1.0)
    loss_cls = torch.sum(ce * valid) / denom

    k = deltas.shape[-1] // 4
    deltas_k = deltas.reshape(-1, k, 4)
    cls_idx = torch.clamp(classes, 0, k - 1)
    fg_deltas = torch.gather(deltas_k, 1, cls_idx[:, None, None].expand(-1, 1, 4))[:, 0]
    reg = smooth_l1(fg_deltas, reg_targets, 0.0)
    loss_reg = torch.sum(reg * is_fg[:, None]) / denom
    return {"loss_cls": loss_cls, "loss_box_reg": loss_reg}


def bpc_candidates(
    cfg: DetectorConfig,
    scores: torch.Tensor,
    deltas: torch.Tensor,
    sampled: SampledProposals,
    image_sizes: torch.Tensor,
) -> Instances:
    """The BPC loss's input: every (sampled proposal, foreground class) pair
    as one candidate, S*C per image, with no score filter and no NMS.
    scores [B*S, C+1] logits, deltas [B*S, 4C] -> Instances [B, S*C].

    The reference first replaces each proposal box by its decoded box of the
    matched GT class, then decodes every class's deltas relative to that
    box: the double decode is kept. Scores are softmax probabilities with
    the background dropped; boxes are clipped to the image."""
    b, s = sampled.gt_classes.shape
    c = scores.shape[-1] - 1
    probs = torch.softmax(scores, dim=-1)[:, :-1]  # [B*S, C]
    k = deltas.shape[-1] // 4
    deltas_k = deltas.reshape(-1, k, 4)
    prop = sampled.boxes.reshape(-1, 4)
    gt_cls = torch.clamp(sampled.gt_classes.reshape(-1), 0, k - 1)
    gt_deltas = torch.gather(deltas_k, 1, gt_cls[:, None, None].expand(-1, 1, 4))[:, 0]
    base = ROI_BOX_TRANSFORM.apply_deltas(gt_deltas, prop)  # [B*S, 4]
    boxes_all = ROI_BOX_TRANSFORM.apply_deltas(deltas, base).reshape(b, s * c, 4)
    boxes_all = clip_boxes(boxes_all, image_sizes)
    classes = torch.arange(c, dtype=torch.int32, device=scores.device).repeat(b, s)
    return Instances(
        boxes=boxes_all.detach(),
        scores=probs.reshape(b, s * c),
        classes=classes,
        valid=sampled.valid[:, :, None].expand(b, s, c).reshape(b, s * c),
    )


def pool_rois(cfg: DetectorConfig, feature: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """feature [B, C, h, w], boxes [B, R, 4] -> pooled [B*R, C, P, P]."""
    pooled = roi_align(feature, boxes, 1.0 / cfg.stride, cfg.pooler_resolution, cfg.pooler_sampling_ratio)
    return pooled.flatten(0, 1)


def roi_inference(
    cfg: DetectorConfig,
    scores: torch.Tensor,
    deltas: torch.Tensor,
    proposals: Instances,
    image_sizes: torch.Tensor,
) -> Instances:
    """Fast R-CNN inference (detectron2 fast_rcnn_inference with fixed
    shapes), all images at once. scores [B, R, C+1] logits, deltas
    [B, R, 4C] -> Instances [B, topk]: softmax, per-class decode and clip,
    score threshold, a candidate cap of max(8 * topk, 1024), class-wise NMS,
    top-k."""
    topk = cfg.detections_per_image
    b, r = scores.shape[:2]
    num_classes = scores.shape[-1] - 1
    probs = torch.softmax(scores, dim=-1)[..., :-1]  # [B, R, C]
    boxes_k = ROI_BOX_TRANSFORM.apply_deltas(deltas, proposals.boxes)
    boxes_k = clip_boxes(boxes_k.reshape(b, r, num_classes, 4), image_sizes)
    flat_boxes = boxes_k.reshape(b, r * num_classes, 4)
    flat_scores = probs.reshape(b, r * num_classes)
    flat_classes = torch.arange(num_classes, dtype=torch.int32, device=scores.device).repeat(r).expand(b, -1)
    valid = proposals.valid[..., None].expand(b, r, num_classes).reshape(b, -1) & nonempty(flat_boxes)
    valid = valid & (flat_scores > cfg.score_thresh_test)
    cap = min(r * num_classes, max(8 * topk, 1024))
    key = torch.where(valid, flat_scores, torch.full_like(flat_scores, -float("inf")))
    cand = Instances(flat_boxes, flat_scores, flat_classes, valid).take(topk_indices(key, cap))
    keep = nms.batched_class_nms(cand.boxes, cand.scores, cand.classes, cand.valid, cfg.nms_thresh_test)
    return cand.mask(keep).top_k(topk)
