"""Faster R-CNN, single-level (the port of `simple_sfod_tpu/models/faster_rcnn.py`).

One `nn.Module` holds the parameterised layers, with Detectron2's names;
plain functions on tensors carry the inference pipeline:

    feature     = model.features(images)                 # uint8 NHWC in
    rpn_out     = model.rpn(feature)
    proposals   = propose(cfg, anchors, rpn_out, sizes)  # top-k, decode, NMS
    pooled      = pool_rois(cfg, feature, proposals.boxes)
    scores, dl  = model.box(pooled)
    detections  = roi_inference(cfg, scores, dl, proposals, sizes)

This slice ports the inference path of the single-level VGG16 detector;
FPN, ResNet, losses, matching and sampling are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch
from torch import nn

from ..ops import nms
from ..ops.anchors import generate_anchors
from ..ops.roi_align import roi_align
from ..structures.boxes import BoxTransform, clip_boxes, nonempty
from ..structures.instances import Instances, topk_indices
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
        if self.fpn or self.backbone != "vgg16":
            raise NotImplementedError(
                f"only the single-level vgg16 detector is ported (got backbone="
                f"{self.backbone!r}, fpn={self.fpn})"
            )

    @property
    def stride(self) -> int:
        self._check_ported()
        return VGG16Backbone.out_strides()[self.in_feature]

    @property
    def feature_channels(self) -> int:
        self._check_ported()
        return VGG16Backbone.out_channels()[self.in_feature]


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
        self.backbone = VGG16Backbone(bn=cfg.vgg_bn)
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

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] raw pixels (uint8 or float) -> in_feature
        [B, C, h, w]. Integer images become float32 BEFORE the mean is
        subtracted (a uint8 subtraction would wrap around)."""
        x = images.permute(0, 3, 1, 2)
        if not x.is_floating_point():
            x = x.to(torch.float32)
        x = (x - self.pixel_mean) / self.pixel_std
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        with self._autocast(x.device):
            return self.backbone(x)[self.cfg.in_feature]

    def rpn(self, feature: torch.Tensor) -> "RPNOutput":
        with self._autocast(feature.device):
            return RPNOutput(*self.proposal_generator.rpn_head(feature))

    def box(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled [N, C, P, P] -> (scores [N, C+1], deltas [N, 4K]) float32."""
        with self._autocast(pooled.device):
            return self.roi_heads.box_predictor(self.roi_heads.box_head(pooled))


@torch.no_grad()
def init_weights(model: FasterRCNN, seed: int) -> FasterRCNN:
    """Seeded random weights with the JAX package's initialiser scales:
    convs normal with std 1/sqrt(fan_in), RPN convs normal(0.01), box-head FCs fan-in uniform,
    cls_score normal(0.01), bbox_pred normal(0.001), zero biases, BN
    scale 1 / bias 0 / mean 0 / var 1. Drawn on the CPU from one
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
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    return model


class RPNOutput(NamedTuple):
    objectness: torch.Tensor  # [B, N_anchors] float32
    deltas: torch.Tensor  # [B, N_anchors, 4] float32


def anchors_for(cfg: DetectorConfig, canvas_hw: Tuple[int, int], device: torch.device) -> torch.Tensor:
    """Anchor grid [h*w*A, 4] of the padded canvas; the feature map is
    ceil(H / stride) x ceil(W / stride)."""
    stride = cfg.stride
    fh = (canvas_hw[0] + stride - 1) // stride
    fw = (canvas_hw[1] + stride - 1) // stride
    return generate_anchors((fh, fw), stride, cfg.anchor_sizes, cfg.anchor_ratios, device=device)


def propose(
    cfg: DetectorConfig,
    anchors: torch.Tensor,
    rpn_out: RPNOutput,
    image_sizes: torch.Tensor,
) -> Instances:
    """Test-time RPN proposals (detectron2 find_top_rpn_proposals with fixed
    shapes): pre-NMS top-k by objectness, decode, clip, NMS at
    `rpn_nms_thresh`, post-NMS top-k. Returns Instances with a leading batch
    dim: boxes [B, post_k, 4]."""
    if rpn_out.objectness.shape[1] != anchors.shape[0]:
        raise ValueError(
            f"RPN prediction count {rpn_out.objectness.shape[1]} != anchor count {anchors.shape[0]}"
        )
    pre_k = min(cfg.rpn_pre_nms_topk_test, anchors.shape[0])
    post_k = min(cfg.rpn_post_nms_topk_test, pre_k)
    out = []
    for obj, deltas, size in zip(rpn_out.objectness, rpn_out.deltas, image_sizes):
        idx = topk_indices(obj, pre_k)
        vals = obj[idx]
        boxes = RPN_BOX_TRANSFORM.apply_deltas(deltas[idx], anchors[idx])
        boxes = clip_boxes(boxes, size)
        valid = nonempty(boxes) & torch.isfinite(vals)
        keep = nms.nms_mask_matrix(boxes, vals, valid, cfg.rpn_nms_thresh)
        inst = Instances(
            boxes=boxes,
            scores=vals,
            classes=torch.zeros((pre_k,), dtype=torch.int32, device=boxes.device),
            valid=keep,
        )
        out.append(inst.top_k(post_k))
    return Instances.stack(out)


def pool_rois(cfg: DetectorConfig, feature: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """feature [B, C, h, w], boxes [B, R, 4] -> pooled [B*R, C, P, P]."""
    scale = 1.0 / cfg.stride
    pooled = [
        roi_align(f, bx, scale, cfg.pooler_resolution, cfg.pooler_sampling_ratio)
        for f, bx in zip(feature, boxes)
    ]
    return torch.cat(pooled, dim=0)


def roi_inference(
    cfg: DetectorConfig,
    scores: torch.Tensor,
    deltas: torch.Tensor,
    proposals: Instances,
    image_sizes: torch.Tensor,
) -> Instances:
    """Fast R-CNN inference (detectron2 fast_rcnn_inference with fixed
    shapes). scores [B, R, C+1] logits, deltas [B, R, 4C] -> Instances
    [B, topk]: softmax, per-class decode and clip, score threshold, a
    candidate cap of max(8 * topk, 1024), class-wise NMS, top-k."""
    topk = cfg.detections_per_image
    num_classes = scores.shape[-1] - 1
    out = []
    for sc, dl, prop_boxes, prop_valid, size in zip(
        scores, deltas, proposals.boxes, proposals.valid, image_sizes
    ):
        probs = torch.softmax(sc, dim=-1)[:, :-1]  # [R, C]
        boxes_k = ROI_BOX_TRANSFORM.apply_deltas(dl, prop_boxes)
        boxes_k = clip_boxes(boxes_k.reshape(-1, num_classes, 4), size)
        r = probs.shape[0]
        flat_boxes = boxes_k.reshape(r * num_classes, 4)
        flat_scores = probs.reshape(r * num_classes)
        flat_classes = torch.arange(num_classes, dtype=torch.int32, device=sc.device).repeat(r)
        valid = prop_valid.repeat_interleave(num_classes) & nonempty(flat_boxes)
        valid = valid & (flat_scores > cfg.score_thresh_test)
        cap = min(flat_scores.shape[0], max(8 * topk, 1024))
        key = torch.where(valid, flat_scores, torch.full_like(flat_scores, -float("inf")))
        idx = topk_indices(key, cap)
        cand = Instances(flat_boxes, flat_scores, flat_classes, valid).take(idx)
        keep = nms.batched_class_nms(cand.boxes, cand.scores, cand.classes, cand.valid, cfg.nms_thresh_test)
        out.append(cand.mask(keep).top_k(topk))
    return Instances.stack(out)
