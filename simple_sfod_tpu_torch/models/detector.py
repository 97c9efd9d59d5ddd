"""Detector inference API (the port of `simple_sfod_tpu/models/detector.py`,
inference only: `infer` and `infer_from_feature`, eval-mode BatchNorm)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..structures.instances import Instances
from .faster_rcnn import DetectorConfig, FasterRCNN, anchors_for, pool_rois, propose, roi_inference


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

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype=dtype) if dtype else x.to(self.device)

    @torch.inference_mode()
    def infer_from_feature(
        self,
        feature: torch.Tensor,
        sizes: torch.Tensor,
        canvas_hw: Tuple[int, int],
    ) -> Instances:
        """Head-side inference on a backbone feature [B, C, h, w] computed
        from a padded canvas of size canvas_hw."""
        cfg = self.cfg
        sizes = self._tensor(sizes, torch.int32)
        anchors = anchors_for(cfg, canvas_hw, self.device)
        rpn_out = self.model.rpn(feature)
        proposals = propose(cfg, anchors, rpn_out, sizes)
        pooled = pool_rois(cfg, feature, proposals.boxes)
        scores, deltas = self.model.box(pooled)
        b, r = proposals.boxes.shape[:2]
        return roi_inference(
            cfg,
            scores.reshape(b, r, -1),
            deltas.reshape(b, r, -1),
            proposals,
            sizes,
        )

    @torch.inference_mode()
    def infer(self, images, sizes) -> Instances:
        """images [B, H, W, 3] (uint8 canvases, the loader's layout), sizes
        [B, 2] int32 true (h, w) -> detections [B, topk]: boxes, scores,
        classes, valid."""
        images = self._tensor(images)
        feature = self.model.features(images)
        return self.infer_from_feature(feature, sizes, tuple(images.shape[1:3]))
