"""ImageNet VGG16(-BN) weights from torchvision for the detector's backbone
(the port of `simple_sfod_tpu/checkpoint/torch_import.py:import_torchvision_vgg`).

A torchvision `vgg16_bn.pth` / `vgg16.pth` holds `features.{i}.*` (the
13 convs, and with BN a BatchNorm after each) and `classifier.*` (the
ImageNet head, which the detector does not have and which is dropped). The
detector names its backbone as Detectron2 does (models/backbones/vgg.py):

  with BN     conv j of stage s is `backbone.vgg{s}.{3j}`, its BatchNorm
              `backbone.vgg{s}.{3j + 1}` (weight, bias, running_mean,
              running_var, num_batches_tracked = 0, as state_dict_from_jax
              writes it);
  without BN  the convs at the shifted module indices of the reference's
              converted checkpoints (`_D2_STAGE_CONVS_NOBN`);
  under FPN   the same keys under `backbone.bottom_up.`.

The JAX package maps the file to its flax backbone tree and its
`tools/import_weights.py` writes that tree over `params["backbone"]`; on an
FPN detector that drops the laterals and the output convs. The port renames
into the bottom-up network and leaves the pyramid's convs alone.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

# torchvision vgg16_bn / vgg16 `features.*` conv indices, in definition order
_TV_VGG16_BN_CONVS = (0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40)
_TV_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# the Detectron2 module index of each conv, and of each BatchNorm, stage by stage
_D2_STAGE_CONVS_BN = ((0, 3), (0, 3), (0, 3, 6), (0, 3, 6), (0, 3, 6))
_D2_STAGE_BNS_BN = ((1, 4), (1, 4), (1, 4, 7), (1, 4, 7), (1, 4, 7))
_D2_STAGE_CONVS_NOBN = ((0, 2, 5), (0, 3, 5), (0, 3, 5, 7), (0, 2, 4), ())

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def is_torchvision_vgg(sd: Mapping[str, torch.Tensor]) -> bool:
    """A torchvision VGG state dict: `features.0.weight` and no detector key."""
    return "features.0.weight" in sd and not any(k.startswith("backbone.") for k in sd)


def torchvision_vgg_has_bn(sd: Mapping[str, torch.Tensor]) -> bool:
    """vgg16_bn (module 1 is a BatchNorm) rather than vgg16 (module 1 is a ReLU)."""
    return "features.1.running_mean" in sd


def import_torchvision_vgg(sd: Mapping[str, torch.Tensor], bn: bool, fpn: bool = False) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16(_bn) state dict -> the detector's backbone keys
    (Detectron2's names, float32 tensors), for VGG.BN `bn`, under
    `backbone.bottom_up.` with `fpn`. A file with BatchNorms given for a
    detector without them, or the reverse, raises."""
    has_bn = torchvision_vgg_has_bn(sd)
    if has_bn != bn:
        raise ValueError(
            f"the torchvision file is vgg16{'_bn' if has_bn else ''} (conv indices "
            f"{_TV_VGG16_BN_CONVS if has_bn else _TV_VGG16_CONVS}), but the detector is VGG16 "
            f"{'with' if bn else 'without'} BatchNorm (VGG.BN {bn}, conv indices "
            f"{_TV_VGG16_BN_CONVS if bn else _TV_VGG16_CONVS}); give the matching ImageNet file"
        )
    prefix = "backbone.bottom_up" if fpn else "backbone"
    src = iter(_TV_VGG16_BN_CONVS if bn else _TV_VGG16_CONVS)
    out: Dict[str, torch.Tensor] = {}
    for stage, convs in enumerate(_D2_STAGE_CONVS_BN if bn else _D2_STAGE_CONVS_NOBN):
        for j, idx in enumerate(convs):
            i = next(src)
            for leaf in ("weight", "bias"):
                out[f"{prefix}.vgg{stage}.{idx}.{leaf}"] = sd[f"features.{i}.{leaf}"].to(torch.float32).clone()
            if bn:
                key = f"{prefix}.vgg{stage}.{_D2_STAGE_BNS_BN[stage][j]}"
                for leaf in _BN_LEAVES:
                    out[f"{key}.{leaf}"] = sd[f"features.{i + 1}.{leaf}"].to(torch.float32).clone()
                out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
