"""Carry weights from the JAX package's flax tree to the port's state dict.

The port's parameter names are Detectron2's, the names that
`simple_sfod_tpu/checkpoint/torch_export.py:export_torch_checkpoint` writes,
so `FasterRCNN.load_state_dict(..., strict=True)` takes the result. This
module keeps its own copy of the layout conversions:

  conv kernel    flax HWIO [kh, kw, I, O]  ->  torch OIHW [O, I, kh, kw]
  dense kernel   flax [I, O]               ->  torch [O, I]
  box-head fc1   the JAX head flattens pooled NHWC [P, P, C]; the port
                 flattens NCHW [C, P, P], so the input dim is un-permuted
  BatchNorm      scale/bias/mean/var -> weight/bias/running_mean/running_var,
                 num_batches_tracked = 0 (ResNet: a live BN's leaves sit one
                 level deeper, under BatchNorm_0; a FrozenBN's do not)

`teacher_student_from_jax` carries a whole adaptation state (the source-free
and the source-available adaptive teacher's): the student and the teacher
(the keys of the JAX package's `export_ensemble` without their
modelStudent./modelTeacher. prefixes), the domain classifiers and the
adaptive-threshold statistics. `da_state_from_jax` carries a DA-Faster state:
the detector and its two DA heads.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..models.backbones import resnet
from ..models.backbones.vgg import STAGE_PLAN


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv(w) -> np.ndarray:
    return np.transpose(_f32(w), (3, 2, 0, 1))


def _dense(w) -> np.ndarray:
    return np.transpose(_f32(w), (1, 0))


def _fc0(w, pool: int, channels: int) -> np.ndarray:
    w = _dense(w)  # [out, P*P*C] in NHWC flatten order
    out_dim = w.shape[0]
    w = w.reshape(out_dim, pool, pool, channels)
    return np.transpose(w, (0, 3, 1, 2)).reshape(out_dim, channels * pool * pool)


def _bn(sd: Dict[str, np.ndarray], key: str, scale, bias, mean, var) -> None:
    sd[f"{key}.weight"] = _f32(scale)
    sd[f"{key}.bias"] = _f32(bias)
    sd[f"{key}.running_mean"] = _f32(mean)
    sd[f"{key}.running_var"] = _f32(var)
    sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


def _vgg(sd: Dict[str, np.ndarray], bp, bs) -> None:
    conv_i = 0
    for stage, widths in enumerate(STAGE_PLAN):
        for j in range(len(widths)):
            key = f"backbone.vgg{stage}.{3 * j}"
            sd[f"{key}.weight"] = _conv(bp[f"conv{conv_i}"]["kernel"])
            sd[f"{key}.bias"] = _f32(bp[f"conv{conv_i}"]["bias"])
            p, s = bp[f"bn{conv_i}"], bs[f"bn{conv_i}"]
            _bn(sd, f"backbone.vgg{stage}.{3 * j + 1}", p["scale"], p["bias"], s["mean"], s["var"])
            conv_i += 1


def _resnet(sd: Dict[str, np.ndarray], bp, bs, cfg) -> None:
    """Detectron2's backbone.stem / backbone.res{s}.{b} keys from the flax
    `stem_*` and `res{s}_block{b}` modules, up to the heads' stage."""
    frozen = cfg.resnet_norm == "FrozenBN"

    def conv_norm(key: str, p, s, conv: str, norm: str) -> None:
        sd[f"{key}.weight"] = _conv(p[conv]["kernel"])
        pn, sn = p[norm], s[norm]
        if not frozen:
            pn, sn = pn["BatchNorm_0"], sn["BatchNorm_0"]
        _bn(sd, f"{key}.norm", pn["scale"], pn["bias"], sn["mean"], sn["var"])

    conv_norm("backbone.stem.conv1", bp, bs, "stem_conv", "stem_norm")
    deepest = int(cfg.in_feature[3])
    depth = 50 if cfg.backbone == "resnet50" else 101
    for stage, n_blocks in enumerate(resnet.BLOCK_COUNTS[depth], start=2):
        if stage > deepest:
            break
        for b in range(n_blocks):
            p, s = bp[f"res{stage}_block{b}"], bs[f"res{stage}_block{b}"]
            key = f"backbone.res{stage}.{b}"
            for i in (1, 2, 3):
                conv_norm(f"{key}.conv{i}", p, s, f"conv{i}", f"norm{i}")
            if "shortcut" in p:
                conv_norm(f"{key}.shortcut", p, s, "shortcut", "shortcut_norm")


def state_dict_from_jax(variables: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of the JAX FasterRCNN (numpy
    leaves) -> the port's state dict (float32 tensors). `cfg` is the port's
    DetectorConfig: the single-level VGG16-BN or ResNet-50/101 detector."""
    if cfg.fpn or cfg.backbone not in ("vgg16", "resnet50", "resnet101") or (cfg.backbone == "vgg16" and not cfg.vgg_bn):
        raise NotImplementedError(
            "state_dict_from_jax carries the single-level VGG16-BN and ResNet-50/101 detectors only")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    if cfg.backbone == "vgg16":
        _vgg(sd, params["backbone"], stats["backbone"])
    else:
        _resnet(sd, params["backbone"], stats["backbone"], cfg)

    rpn = params["rpn_head"]
    for ours, theirs in (
        ("conv", "proposal_generator.rpn_head.conv"),
        ("objectness", "proposal_generator.rpn_head.objectness_logits"),
        ("deltas", "proposal_generator.rpn_head.anchor_deltas"),
    ):
        sd[f"{theirs}.weight"] = _conv(rpn[ours]["kernel"])
        sd[f"{theirs}.bias"] = _f32(rpn[ours]["bias"])

    pool = cfg.pooler_resolution
    for i in range(cfg.num_fc):
        fc = params["box_head"][f"fc{i}"]
        key = f"roi_heads.box_head.fc{i + 1}"
        sd[f"{key}.weight"] = _fc0(fc["kernel"], pool, cfg.feature_channels) if i == 0 else _dense(fc["kernel"])
        sd[f"{key}.bias"] = _f32(fc["bias"])
    for name in ("cls_score", "bbox_pred"):
        sd[f"roi_heads.box_predictor.{name}.weight"] = _dense(params["predictor"][name]["kernel"])
        sd[f"roi_heads.box_predictor.{name}.bias"] = _f32(params["predictor"][name]["bias"])

    sd["pixel_mean"] = np.asarray(cfg.pixel_mean, np.float32).reshape(3, 1, 1)
    sd["pixel_std"] = np.asarray(cfg.pixel_std, np.float32).reshape(3, 1, 1)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


class TeacherStudentWeights(NamedTuple):
    """An adaptation state in the port's layout (float32 tensors; the
    threshold's reserve int32 and its cursor an int)."""

    student: Dict[str, torch.Tensor]
    teacher: Dict[str, torch.Tensor]
    dc: Dict[str, Dict[str, torch.Tensor]]  # "dc" (image) and "dc_ins" (instance), where built
    thresh: Dict[str, Any]  # reserve [RESERVE, C], classwise_acc [C], cursor


_DC_LAYERS = {
    "dc": ("conv1", "conv2", "conv3", "classifier"),
    "dc_ins": ("fc1", "fc2", "fc3"),
    "da_img": ("conv1", "conv2"),
    "da_ins": ("fc1", "fc2", "fc3"),
}


def _get(tree, key):
    return tree[key] if isinstance(tree, dict) else getattr(tree, key)


def dc_state_dict_from_jax(tree: Dict[str, Any], name: str) -> Dict[str, torch.Tensor]:
    """The flax parameters of a domain classifier ("dc": FCDiscriminatorImg,
    "dc_ins" and "da_ins": DAInsHead, "da_img": DAImgHead) -> the port
    module's state dict."""
    sd = {}
    for layer in _DC_LAYERS[name]:
        kernel = tree[layer]["kernel"]
        sd[f"{layer}.weight"] = _conv(kernel) if np.ndim(kernel) == 4 else _dense(kernel)
        sd[f"{layer}.bias"] = _f32(tree[layer]["bias"])
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def teacher_student_from_jax(state_tree, cfg) -> TeacherStudentWeights:
    """A JAX `TeacherStudentState` with numpy leaves (a bfloat16 teacher
    included) -> TeacherStudentWeights. `cfg` is the port's DetectorConfig."""
    params = _get(state_tree, "params")
    student = state_dict_from_jax({"params": params["det"], "batch_stats": _get(state_tree, "batch_stats")}, cfg)
    teacher = state_dict_from_jax(
        {"params": _get(state_tree, "teacher_params"), "batch_stats": _get(state_tree, "teacher_stats")}, cfg
    )
    dc = {name: dc_state_dict_from_jax(params[name], name) for name in _DC_LAYERS if name in params}
    th = _get(state_tree, "thresh")
    thresh = {
        "reserve": torch.from_numpy(np.array(_get(th, "reserve"), dtype=np.int32)),
        "classwise_acc": torch.from_numpy(np.array(_get(th, "classwise_acc"), dtype=np.float32)),
        "cursor": int(_get(th, "cursor")),
    }
    return TeacherStudentWeights(student, teacher, dc, thresh)


class DAWeights(NamedTuple):
    """A domain-adversarial (DA/CDA) state in the port's layout: the
    detector and the DA heads ("da_img", "da_ins"), float32 tensors."""

    detector: Dict[str, torch.Tensor]
    heads: Dict[str, Dict[str, torch.Tensor]]


def da_state_from_jax(state_tree, cfg) -> DAWeights:
    """A JAX DA `TrainState` (params "det", "da_img", "da_ins"; numpy
    leaves) -> DAWeights. `cfg` is the port's DetectorConfig."""
    params = _get(state_tree, "params")
    detector = state_dict_from_jax({"params": params["det"], "batch_stats": _get(state_tree, "batch_stats")}, cfg)
    return DAWeights(detector, {name: dc_state_dict_from_jax(params[name], name) for name in ("da_img", "da_ins")})
