"""Faster R-CNN (the port of `simple_sfod_tpu/models/faster_rcnn.py`).

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

This covers the single-level detector on VGG16 (with or without BN) or
ResNet-50/101 (C4: the heads on "res4", BN or FrozenBN), and the FPN
detector over VGG16 or ResNet-50/101 with Detectron2's multi-level semantics: `feature` is then a dict
of pyramid levels, `anchors_for` a tuple of per-level grids, the shared RPN
head's outputs concatenated in `rpn_in_features` order, proposals taken by
per-level top-k, one clip, a merged cap and ONE NMS (`_propose_fpn`), and
each ROI pooled from the level Detectron2's size rule assigns it
(`assign_boxes_to_levels`). Box-head dropout (`box_head_dropout`) runs in
the training losses on keep masks given as inputs (`box_dropout_masks`
draws them); inference is deterministic.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops import nms
from ..ops.anchors import generate_anchors
from ..ops.losses import sigmoid_ce, smooth_l1, softmax_ce
from ..ops.matcher import ROI_MATCHER, RPN_MATCHER, match_boxes
from ..ops.roi_align import roi_align
from ..ops.sampler import subsample_labels, subsample_labels_mask
from ..parallel import mesh, spatial
from ..structures.boxes import BoxTransform, clip_boxes, nonempty, pairwise_iou
from ..structures.instances import Instances, topk_indices
from .backbones.fpn import FPN
from .backbones.resnet import FrozenBatchNorm2d, ResNetBackbone
from .backbones.tiny import TinyBackbone
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
    def rpn_levels(self) -> Tuple[str, ...]:
        """The RPN's input level names (one without FPN: in_feature)."""
        return self.rpn_in_features or (self.in_feature,)

    @property
    def roi_levels(self) -> Tuple[str, ...]:
        """The ROI pooler's input level names (one without FPN)."""
        return self.roi_in_features or (self.in_feature,)

    @property
    def level_anchor_sizes(self) -> Tuple[Tuple[float, ...], ...]:
        """The anchor sizes of each RPN level (FPN): `anchor_sizes_per_level`,
        or `anchor_sizes` on every level."""
        if self.anchor_sizes_per_level:
            if len(self.anchor_sizes_per_level) != len(self.rpn_levels):
                raise ValueError(
                    f"anchor_sizes_per_level has {len(self.anchor_sizes_per_level)} "
                    f"entries for {len(self.rpn_levels)} RPN levels"
                )
            return self.anchor_sizes_per_level
        return tuple(self.anchor_sizes for _ in self.rpn_levels)

    @property
    def num_anchors(self) -> int:
        """Anchors per feature location; under FPN the RPN head is shared, so
        every level must have as many sizes."""
        if self.fpn:
            per = {len(s) for s in self.level_anchor_sizes}
            if len(per) != 1:
                raise ValueError(
                    "FPN RPN head is shared across levels; every level must "
                    f"have the same number of anchor sizes (got {per})"
                )
            return per.pop() * len(self.anchor_ratios)
        return len(self.anchor_sizes) * len(self.anchor_ratios)

    @staticmethod
    def _level_stride(name: str) -> int:
        return 2 ** int(name[1:])

    @property
    def dc_in_feature(self) -> str:
        """The map the image-level domain classifiers take: the heads' feature,
        or under FPN the coarsest ROI level."""
        return self.roi_in_features[-1] if self.fpn else self.in_feature

    @property
    def dc_stride(self) -> int:
        return self._level_stride(self.dc_in_feature) if self.fpn else self.stride

    @property
    def dc_channels(self) -> int:
        return self.fpn_out_channels if self.fpn else self.feature_channels

    def _check_ported(self) -> None:
        if self.backbone not in _BACKBONES:
            raise NotImplementedError(
                f"the vgg16, resnet50, resnet101 and tiny detectors are ported, with and without FPN (got backbone="
                f"{self.backbone!r})"
            )
        if self.fpn and not self.fpn_in_features:
            raise ValueError("fpn=True requires fpn_in_features")

    @property
    def stride(self) -> int:
        self._check_ported()
        if self.in_feature.startswith("p"):  # an FPN level: stride 2**level
            return self._level_stride(self.in_feature)
        return _BACKBONES[self.backbone].out_strides()[self.in_feature]

    @property
    def feature_channels(self) -> int:
        self._check_ported()
        if self.in_feature.startswith("p"):
            return self.fpn_out_channels
        return _BACKBONES[self.backbone].out_channels()[self.in_feature]


_BACKBONES = {"vgg16": VGG16Backbone, "resnet50": ResNetBackbone, "resnet101": ResNetBackbone, "tiny": TinyBackbone}


def build_backbone(cfg: DetectorConfig) -> nn.Module:
    """The backbone of `cfg`, as the JAX FasterRCNN.setup builds it."""
    if cfg.backbone == "vgg16":
        bottom_up = VGG16Backbone(bn=cfg.vgg_bn)
    elif cfg.backbone == "tiny":
        bottom_up = TinyBackbone(bn=cfg.vgg_bn)
    else:
        depth = 50 if cfg.backbone == "resnet50" else 101
        out_features = cfg.fpn_in_features if cfg.fpn else (cfg.in_feature,)
        bottom_up = ResNetBackbone(depth=depth, norm=cfg.resnet_norm, out_features=out_features)
    if cfg.fpn:
        return FPN(bottom_up, cfg.fpn_in_features, cfg.fpn_out_channels, cfg.fpn_norm, cfg.fpn_fuse_type)
    return bottom_up


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
            cfg.feature_channels * pool * pool, cfg.fc_dim, cfg.num_fc, cfg.box_head_dropout
        )
        self.roi_heads.box_predictor = FastRCNNPredictor(cfg.fc_dim, cfg.num_classes)
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32).view(3, 1, 1))
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32).view(3, 1, 1))

    def _autocast(self, device: torch.device):
        return torch.autocast(
            device.type, dtype=torch.bfloat16, enabled=self.cfg.dtype == torch.bfloat16
        )

    def features(self, images: torch.Tensor, train: bool = False, update_bn: bool = True) -> "Feature":
        """images [B, H, W, 3] raw pixels (uint8 or float) -> in_feature
        [B, C, h, w], or under FPN the dict of the levels the heads take
        (rpn_in_features then roi_in_features). Integer images become
        float32 BEFORE the mean is subtracted (a uint8 subtraction would
        wrap around). `train` runs BatchNorm on batch statistics, and
        `update_bn` then moves the running ones (models/backbones/vgg.py; a
        FrozenBN layer has one mode; a backbone without BN ignores both).
        Under height bands (parallel/spatial.py) the backbone runs on this
        rank's band of the normalised images and the maps it returns are
        gathered whole."""
        x = images.permute(0, 3, 1, 2)
        if not x.is_floating_point():
            x = x.to(torch.float32)
        x = (x - self.pixel_mean) / self.pixel_std
        if x.device.type == "cuda":
            x = x.contiguous(memory_format=torch.channels_last)
        x = spatial.take_band(x, self.backbone.band_stride)
        with self._autocast(x.device):
            feats = self.backbone(x, train, update_bn)
        if self.cfg.fpn:
            return spatial.gather({k: feats[k] for k in dict.fromkeys(self.cfg.rpn_in_features +
                                                                        self.cfg.roi_in_features)})
        return spatial.gather({self.cfg.in_feature: feats[self.cfg.in_feature]})[self.cfg.in_feature]

    def rpn(self, feature: "Feature") -> "RPNOutput":
        """A map -> RPN outputs; an FPN level dict -> the shared head on each
        `rpn_in_features` level, concatenated in that order (the order of
        `anchors_for`'s grids)."""
        head = self.proposal_generator.rpn_head
        with self._autocast(feature_device(feature)):
            if isinstance(feature, dict):
                outs = [head(feature[name]) for name in self.cfg.rpn_in_features]
                return RPNOutput(torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs], dim=1))
            return RPNOutput(*head(feature))

    def box(self, pooled: torch.Tensor, keep: Optional[Sequence[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled [N, C, P, P] -> (scores [N', C+1], deltas [N', 4K]) float32.
        `keep` None is the deterministic box head (inference, and training
        without dropout); the train mode of `box_head_dropout` takes a keep
        mask for each fc layer (FastRCNNConvFCHead: k * N rows run k
        dropout passes, N' = k * N)."""
        with self._autocast(pooled.device):
            return self.roi_heads.box_predictor(self.roi_heads.box_head(pooled, keep))

    def box_feature(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled [N, C, P, P] -> the box head's feature [N, fc_dim] (the
        predictor's input, which the instance-level domain classifiers
        take), in the autocast dtype."""
        with self._autocast(pooled.device):
            return self.roi_heads.box_head(pooled)


def empty_model(cfg: DetectorConfig, device="cpu") -> FasterRCNN:
    """FasterRCNN(cfg) allocated on `device` without PyTorch's default
    initialisation (built on the meta device), for a caller that writes
    every parameter and buffer next: `init_weights`, or a strict load.
    Each tensor is allocated by `torch.empty` from its shape: `to_empty`
    (`empty_like` of a meta tensor) imports ~480 modules on its first call,
    most of a second in a fresh process."""
    with torch.device("meta"):
        model = FasterRCNN(cfg)
    device = torch.device(device)
    for m in model.modules():
        for name, p in m._parameters.items():
            if p is not None:
                m._parameters[name] = nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device=device),
                                                   p.requires_grad)
        for name, b in m._buffers.items():
            if b is not None:
                m._buffers[name] = torch.empty(b.shape, dtype=b.dtype, device=device)
    return model


@torch.no_grad()
def init_weights(model: FasterRCNN, seed: int) -> FasterRCNN:
    """Seeded random weights with the JAX package's initialiser scales:
    convs normal with std 1/sqrt(fan_in), RPN convs normal(0.01), box-head FCs fan-in uniform,
    cls_score normal(0.01), bbox_pred normal(0.001), zero biases, BN and
    FrozenBN scale 1 / bias 0 / mean 0 / var 1, and the pixel mean and std of
    the config: every parameter and buffer (a model built without PyTorch's
    default initialisation, `empty_model`, needs no other). Drawn
    on the CPU from one torch.Generator, so a seed gives the same weights on
    every machine."""
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
    model.pixel_mean.copy_(torch.tensor(model.cfg.pixel_mean).view(3, 1, 1))
    model.pixel_std.copy_(torch.tensor(model.cfg.pixel_std).view(3, 1, 1))
    return model


def box_dropout_masks(cfg: DetectorConfig, rows: int, generator: Optional[torch.Generator],
                      device) -> Optional[Tuple[torch.Tensor, ...]]:
    """The box head's dropout keep masks for `rows` ROIs (a training step's:
    its images times `roi_batch_size_per_image`): one bool [rows, fc_dim]
    a fc layer, each entry kept with probability 1 - box_head_dropout,
    drawn on `device`. None without dropout."""
    if cfg.box_head_dropout <= 0:
        return None
    return tuple(torch.rand((rows, cfg.fc_dim), generator=generator, device=device) >= cfg.box_head_dropout
                 for _ in range(cfg.num_fc))


def keep_on(keep: Optional[Sequence[torch.Tensor]], device) -> Optional[Tuple[torch.Tensor, ...]]:
    """Keep masks (or None) on `device`."""
    return None if keep is None else tuple(t.to(device) for t in keep)


Feature = Union[torch.Tensor, Dict[str, torch.Tensor]]


def feature_device(feature: Feature) -> torch.device:
    return next(iter(feature.values())).device if isinstance(feature, dict) else feature.device


def feature_batch(feature: Feature) -> int:
    return next(iter(feature.values())).shape[0] if isinstance(feature, dict) else feature.shape[0]


def split_feature(feature: Feature, b: int) -> Tuple[Feature, Feature]:
    """A feature of a 2B-image batch -> (its first b images', the rest's)."""
    if isinstance(feature, dict):
        return {k: v[:b] for k, v in feature.items()}, {k: v[b:] for k, v in feature.items()}
    return feature[:b], feature[b:]


def detach_feature(feature: Feature) -> Feature:
    return {k: v.detach() for k, v in feature.items()} if isinstance(feature, dict) else feature.detach()


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


def proposal_counts(cfg: DetectorConfig, num_anchors: Union[int, Sequence[int]], training: bool) -> Tuple[int, int]:
    """(pre-NMS, post-NMS) proposal counts of one image: the config's caps,
    bounded by the anchor count. Under FPN `num_anchors` is the per-level
    counts (`anchor_counts`), and pre-NMS is the merged set: each level's
    top-k, capped back to the pre-NMS cap."""
    pre_k = cfg.rpn_pre_nms_topk_train if training else cfg.rpn_pre_nms_topk_test
    post_k = cfg.rpn_post_nms_topk_train if training else cfg.rpn_post_nms_topk_test
    counts = (num_anchors,) if isinstance(num_anchors, int) else tuple(num_anchors)
    pre_k = min(pre_k, sum(min(pre_k, n) for n in counts))
    return pre_k, min(post_k, pre_k)


def roi_pool_size(cfg: DetectorConfig, num_anchors: Union[int, Sequence[int]], gt_capacity: int) -> int:
    """Candidates per image that `label_and_sample_proposals` samples from:
    the training proposals, plus the GT slots when they are appended."""
    return proposal_counts(cfg, num_anchors, True)[1] + (gt_capacity if cfg.proposal_append_gt else 0)


@functools.lru_cache(maxsize=32)
def _anchor_grid(feature_hw, stride, sizes, ratios, device: torch.device) -> torch.Tensor:
    return generate_anchors(feature_hw, stride, sizes, ratios, device=device)


def _grid(cfg: DetectorConfig, canvas_hw, stride: int, sizes, device) -> torch.Tensor:
    fh = (canvas_hw[0] + stride - 1) // stride
    fw = (canvas_hw[1] + stride - 1) // stride
    return _anchor_grid((fh, fw), stride, tuple(sizes), tuple(cfg.anchor_ratios), torch.device(device))


def anchors_for(cfg: DetectorConfig, canvas_hw: Tuple[int, int], device: torch.device):
    """Anchor grid [h*w*A, 4] of the padded canvas; the feature map is
    ceil(H / stride) x ceil(W / stride). Under FPN a tuple of per-level
    grids in `rpn_in_features` order (the order of `FasterRCNN.rpn`'s
    concatenation). Built on the host and copied to the device once per
    canvas and device, then shared (callers must not write to it): a step
    reads it without a host-to-device copy."""
    if cfg.fpn:
        return tuple(_grid(cfg, canvas_hw, cfg._level_stride(name), sizes, device)
                     for name, sizes in zip(cfg.rpn_in_features, cfg.level_anchor_sizes))
    return _grid(cfg, canvas_hw, cfg.stride, cfg.anchor_sizes, device)


def anchor_counts(cfg: DetectorConfig, canvas_hw: Tuple[int, int]) -> Tuple[int, ...]:
    """The anchors of each RPN level on the canvas (one level without FPN);
    their sum is the RPN's prediction count."""
    anchors = anchors_for(cfg, canvas_hw, torch.device("cpu"))
    return tuple(a.shape[0] for a in anchors) if isinstance(anchors, tuple) else (anchors.shape[0],)


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
    with a leading batch dim: boxes [B, post_k, 4]. Under FPN (`anchors` a
    tuple) `_propose_fpn`."""
    if isinstance(anchors, tuple):
        return _propose_fpn(cfg, anchors, rpn_out, image_sizes, training)
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


def _propose_fpn(
    cfg: DetectorConfig,
    anchors: Tuple[torch.Tensor, ...],
    rpn_out: RPNOutput,
    image_sizes: torch.Tensor,
    training: bool,
) -> Instances:
    """Multi-level proposals (Detectron2's find_top_rpn_proposals over
    levels, as the JAX package bounds it): each level's pre-NMS top-k in
    `jax.lax.top_k`'s order, decoded; one clip of the merged set; the
    merged set capped back to the pre-NMS cap by score (invalid ranked
    last); ONE NMS over it; post-NMS top-k across levels. All images at
    once, no host read."""
    counts = [a.shape[0] for a in anchors]
    if rpn_out.objectness.shape[1] != sum(counts):
        raise ValueError(
            f"RPN prediction count {rpn_out.objectness.shape[1]} != anchor count {sum(counts)} (per level {counts})"
        )
    pre_k = cfg.rpn_pre_nms_topk_train if training else cfg.rpn_pre_nms_topk_test
    merged_k, post_k = proposal_counts(cfg, counts, training)
    boxes, vals = [], []
    for a, obj, dl in zip(anchors, rpn_out.objectness.split(counts, dim=1), rpn_out.deltas.split(counts, dim=1)):
        idx = topk_indices(obj, min(pre_k, a.shape[0]))
        vals.append(torch.gather(obj, 1, idx))
        d = torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4))
        boxes.append(RPN_BOX_TRANSFORM.apply_deltas(d, a[idx]))
    boxes = clip_boxes(torch.cat(boxes, dim=1), image_sizes)
    vals = torch.cat(vals, dim=1)
    valid = nonempty(boxes) & torch.isfinite(vals)
    key = torch.where(valid, vals, torch.full_like(vals, -float("inf")))
    cand = Instances(boxes, vals, torch.zeros_like(vals, dtype=torch.int32), valid).take(topk_indices(key, merged_k))
    keep = nms.nms_mask_matrix(cand.boxes, cand.scores, cand.valid, cfg.rpn_nms_thresh)
    return dataclasses.replace(cand, valid=keep).top_k(post_k)


def rpn_losses(
    cfg: DetectorConfig,
    anchors: torch.Tensor,
    rpn_out: RPNOutput,
    gt: Instances,
    priorities: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """RPN objectness and box-regression losses, each a sum over the sampled
    anchors / (B * rpn_batch_size_per_image) (detectron2; B the global
    batch within parallel.mesh.data_parallel). gt: Instances [B, M];
    priorities [B, N_anchors], the sampler's uniform draws."""
    if isinstance(anchors, tuple):  # FPN: matched over every level at once
        anchors = torch.cat(anchors, dim=0)
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

    normalizer = float(mesh.global_batch(b) * cfg.rpn_batch_size_per_image)
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
    divided by the sampled count (the global batch's within
    parallel.mesh.data_parallel). scores [B*S, C+1], deltas [B*S, 4C]."""
    classes = sampled.gt_classes.reshape(-1)
    valid = sampled.valid.reshape(-1).to(torch.float32)
    is_fg = sampled.is_fg.reshape(-1).to(torch.float32)
    reg_targets = sampled.reg_targets.reshape(-1, 4)

    ce = softmax_ce(scores, classes)
    denom = torch.clamp_min(mesh.global_sum(torch.sum(valid)), 1.0)
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


def assign_boxes_to_levels(
    boxes: torch.Tensor, min_level: int, max_level: int, canonical_box_size: float = 224.0, canonical_level: int = 4
) -> torch.Tensor:
    """Detectron2's ROIPooler level rule: floor(canonical_level +
    log2(sqrt(area) / canonical_box_size + 1e-8)) clamped to [min_level,
    max_level], in float32 as the JAX package computes it. boxes [..., 4]
    XYXY -> int64 levels [...]."""
    b = boxes.to(torch.float32)
    area = torch.clamp_min(b[..., 2] - b[..., 0], 0.0) * torch.clamp_min(b[..., 3] - b[..., 1], 0.0)
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_box_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int64)


def pool_rois(cfg: DetectorConfig, feature: Feature, boxes: torch.Tensor) -> torch.Tensor:
    """feature [B, C, h, w], boxes [B, R, 4] -> pooled [B*R, C, P, P].

    FPN (a level dict): each box pooled from the level
    `assign_boxes_to_levels` gives it. As the JAX package writes it: every
    box pooled on every ROI level and the level's result kept by a 0/1
    mask, accumulated level by level (the mask adds exact zeros, so this
    equals pooling each box from its own level alone)."""
    if isinstance(feature, dict):
        levels = [int(name[1:]) for name in cfg.roi_in_features]
        if levels != list(range(min(levels), max(levels) + 1)):
            raise ValueError(
                f"ROI_HEADS.IN_FEATURES levels {levels} must be contiguous: assign_boxes_to_levels clamps into "
                "[min, max], so a gap level would zero-pool every box assigned to it"
            )
        lvl = assign_boxes_to_levels(boxes, min(levels), max(levels))  # [B, R]
        pooled = None
        for name, level in zip(cfg.roi_in_features, levels):
            p = roi_align(feature[name], boxes, 1.0 / 2 ** level, cfg.pooler_resolution, cfg.pooler_sampling_ratio)
            p = p * (lvl == level).to(p.dtype)[..., None, None, None]
            pooled = p if pooled is None else pooled + p
        return pooled.flatten(0, 1)
    pooled = roi_align(feature, boxes, 1.0 / cfg.stride, cfg.pooler_resolution, cfg.pooler_sampling_ratio)
    return pooled.flatten(0, 1)


def dc_image_feature(cfg: DetectorConfig, feature: Feature) -> torch.Tensor:
    """The map the image-level domain classifiers take: the single-level
    backbone's feature itself, or under FPN `cfg.dc_in_feature` (the
    coarsest ROI level)."""
    return feature[cfg.dc_in_feature] if isinstance(feature, dict) else feature


def roi_inference(
    cfg: DetectorConfig,
    scores: torch.Tensor,
    deltas: torch.Tensor,
    proposals: Instances,
    image_sizes: torch.Tensor,
    score_thresh: Optional[float] = None,
    nms_thresh: Optional[float] = None,
    topk: Optional[int] = None,
    apply_nms: bool = True,
    apply_score_thresh: bool = True,
    candidate_cap: Optional[int] = None,
) -> Instances:
    """Fast R-CNN inference (detectron2 fast_rcnn_inference with fixed
    shapes), all images at once. scores [B, R, C+1] logits, deltas
    [B, R, 4C] -> Instances [B, topk]: softmax, per-class decode and clip,
    score threshold, a candidate cap (`candidate_cap`, else
    max(8 * topk, 1024), at most R*C), class-wise NMS, top-k. The
    thresholds and topk default to the config's TEST values.

    Without `apply_score_thresh` and `apply_nms` this is the reference's
    fast_rcnn_inference_new, which feeds raw (box, score) pairs to the BPC
    loss: the top-k of the capped candidates."""
    score_thresh = cfg.score_thresh_test if score_thresh is None else score_thresh
    nms_thresh = cfg.nms_thresh_test if nms_thresh is None else nms_thresh
    topk = cfg.detections_per_image if topk is None else topk
    b, r = scores.shape[:2]
    num_classes = scores.shape[-1] - 1
    probs = torch.softmax(scores, dim=-1)[..., :-1]  # [B, R, C]
    boxes_k = ROI_BOX_TRANSFORM.apply_deltas(deltas, proposals.boxes)
    boxes_k = clip_boxes(boxes_k.reshape(b, r, num_classes, 4), image_sizes)
    flat_boxes = boxes_k.reshape(b, r * num_classes, 4)
    flat_scores = probs.reshape(b, r * num_classes)
    flat_classes = torch.arange(num_classes, dtype=torch.int32, device=scores.device).repeat(r).expand(b, -1)
    valid = proposals.valid[..., None].expand(b, r, num_classes).reshape(b, -1) & nonempty(flat_boxes)
    if apply_score_thresh:
        valid = valid & (flat_scores > score_thresh)
    cap = min(r * num_classes, candidate_cap or max(8 * topk, 1024))
    if cap < topk:  # the JAX package's top_k refuses k above its input's size
        raise ValueError(f"topk {topk} exceeds the {cap} candidates (R*C {r * num_classes}, candidate_cap {candidate_cap})")
    key = torch.where(valid, flat_scores, torch.full_like(flat_scores, -float("inf")))
    cand = Instances(flat_boxes, flat_scores, flat_classes, valid).take(topk_indices(key, cap))
    if apply_nms:
        cand = cand.mask(nms.batched_class_nms(cand.boxes, cand.scores, cand.classes, cand.valid, nms_thresh))
    return cand.top_k(topk)
