"""ROIAlign, aligned (the port of `simple_sfod_tpu/ops/roi_align.py:roi_align`).

The same separable-weights formula as the JAX package: the bilinear kernel
and the s x s in-bin sample mean factorise over y and x, so for each ROI

    out[r] = Wy_r @ F @ Wx_r^T        (per channel)

with dense per-ROI weights Wy [R, P, H] and Wx [R, P, W]. This is not a
Pallas kernel in the JAX package; here the two contractions are
`torch.einsum` (cuBLAS on the card).

Coordinates and weights are always built in float32 (bfloat16's 8-bit
mantissa would snap a coordinate near 1000 to multiples of 4 px); only the
matmul operands take the feature's dtype.
"""

from __future__ import annotations

import torch


def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor, out: int, s: int, dim: int) -> torch.Tensor:
    """Per-ROI 1-D pooling weights [R, out, dim] in float32: the mean over
    the s in-bin samples of the clamped bilinear hat, zero for samples more
    than one pixel outside the map."""
    dev = start.device
    k = torch.arange(out * s, dtype=torch.float32, device=dev)
    grid = torch.floor(k / s) + (torch.remainder(k, s) + 0.5) / s
    p = start[:, None] + grid[None, :] * bin_size[:, None]  # [R, out*s]
    ok = (p >= -1.0) & (p <= dim)
    pc = p.clamp(0.0, dim - 1)
    rows = torch.arange(dim, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(pc[:, :, None] - rows[None, None, :]), min=0.0)
    w = w * ok[:, :, None].to(torch.float32)
    r = start.shape[0]
    return w.reshape(r, out, s, dim).mean(dim=2)


def roi_align(
    features: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """features [C, H, W]; rois [R, 4] XYXY in input-image coordinates ->
    [R, C, out, out] in the features' dtype; or a batch, features
    [B, C, H, W] and rois [B, R, 4] -> [B, R, C, out, out]. Aligned
    (continuous coordinates shifted by -0.5 after scaling), as detectron2's
    ROIAlignV2."""
    if features.dim() == 3:
        return roi_align(features[None], rois[None], spatial_scale, output_size, sampling_ratio)[0]
    b, r = rois.shape[:2]
    c, h, w = features.shape[1:]
    out = output_size
    dtype = features.dtype if features.dtype in (torch.float32, torch.bfloat16) else torch.float32

    r32 = rois.to(torch.float32).reshape(b * r, 4)
    x1 = r32[:, 0] * spatial_scale - 0.5
    y1 = r32[:, 1] * spatial_scale - 0.5
    x2 = r32[:, 2] * spatial_scale - 0.5
    y2 = r32[:, 3] * spatial_scale - 0.5
    roi_w = x2 - x1
    roi_h = y2 - y1

    wy = _axis_weights(y1, roi_h / out, out, sampling_ratio, h).to(dtype).reshape(b, r, out, h)
    wx = _axis_weights(x1, roi_w / out, out, sampling_ratio, w).to(dtype).reshape(b, r, out, w)
    f = features.to(dtype)
    # contract the wider spatial axis first (the JAX package's order); the
    # intermediate is rounded to the compute dtype between the two products
    if w >= h:
        tmp = torch.einsum("brxw,bchw->brchx", wx, f)
        res = torch.einsum("bryh,brchx->brcyx", wy, tmp.to(dtype))
    else:
        tmp = torch.einsum("bryh,bchw->brcyw", wy, f)
        res = torch.einsum("brxw,brcyw->brcyx", wx, tmp.to(dtype))
    return res.to(features.dtype)
