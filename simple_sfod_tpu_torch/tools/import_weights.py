"""Convert torch weights into a detector checkpoint of the port (the port of
the JAX package's `tools/import_weights.py`, which writes an orbax state):

    # ImageNet VGG16(-BN) from torchvision: a detector from the config's
    # seeded initialisation with the backbone spliced in
    python -m simple_sfod_tpu_torch.tools.import_weights --torch vgg16_bn.pth --kind torchvision_vgg \
        --config-file configs/faster_rcnn_VGG_cityscapes_source_new.yaml --output weights/vgg16_bn_init.pth

    # a Detectron2-named detector checkpoint (.pth or .pkl), checked against
    # the detector's names
    python -m simple_sfod_tpu_torch.tools.import_weights --torch model_final.pth --kind detector \
        --config-file configs/faster_rcnn_VGG_cityscapes_foggy_test.yaml --output weights/source_model.pth

The output is `{"model": Detectron2-named float32 tensors}`: MODEL.WEIGHTS
for the port, and a file that the JAX package's `load_torch_file` and
`import_torch_checkpoint` read. With `--kind torchvision_vgg` the file must
match VGG.BN (vgg16_bn.pth with BN, vgg16.pth without); under the VGG-FPN
config the backbone lands in `backbone.bottom_up.` beside the pyramid's
initialised convs. Runs on the CPU: nothing is computed on a device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from ..checkpoint.checkpointer import load_torch_weights
from ..config import detector_config_from_cfg, get_cfg
from ..models.faster_rcnn import empty_model, init_weights

SKIPPED = ("num_batches_tracked", "pixel_mean", "pixel_std")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert torch weights into a detector checkpoint of the port.")
    p.add_argument("--torch", required=True, help=".pth/.pt/.pth.tar or Detectron2 .pkl file")
    p.add_argument("--kind", choices=["torchvision_vgg", "detector"], required=True)
    p.add_argument("--config-file", required=True)
    p.add_argument("--output", required=True, help="the .pth to write")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p


def convert(path: str, kind: str, cfg) -> Dict[str, torch.Tensor]:
    """The detector state dict (float32) that `path` makes for `cfg`'s
    detector, read as MODEL.WEIGHTS reads it. torchvision_vgg:
    `init_weights(max(SEED, 0))` with every backbone conv (and BatchNorm)
    replaced by the file's; detector: every parameter and statistic of the
    detector from the file. A missing tensor or another shape raises."""
    det_cfg = detector_config_from_cfg(cfg)
    own = init_weights(empty_model(det_cfg), max(cfg.SEED, 0)).state_dict()
    sd = load_torch_weights(path, det_cfg)
    want = list(own)
    if kind == "torchvision_vgg":
        want = [k for k in own if k.startswith("backbone.") and not k.startswith("backbone.fpn_")]
    missing = [k for k in want if k not in sd and not k.endswith(SKIPPED)]
    bad = [k for k in want if k in sd and tuple(sd[k].shape) != tuple(own[k].shape)]
    if missing or bad:
        raise ValueError(f"{path} does not fit the detector of the config: missing {missing[:4]} "
                         f"({len(missing)}), shapes differ {bad[:4]} ({len(bad)})")
    taken = {k for k in want if not k.endswith(SKIPPED)}
    return {k: (sd[k] if k in taken else v).to(torch.float32 if v.is_floating_point() else v.dtype).clone()
            for k, v in own.items()}


def main(argv: Optional[List[str]] = None) -> str:
    args = parser().parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file, allow_new=True)
    if args.opts:
        cfg.merge_from_list(args.opts)
    sd = convert(args.torch, args.kind, cfg)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.save({"model": sd}, args.output)
    print(f"imported {args.torch} ({args.kind}) -> {args.output}: {len(sd)} tensors", flush=True)
    return args.output


if __name__ == "__main__":
    main()
