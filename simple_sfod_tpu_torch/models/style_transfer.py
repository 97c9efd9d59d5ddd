"""AdaIN style enhancement (the port of
`simple_sfod_tpu/models/style_transfer.py`): the VGG19-normalised encoder
through relu4_1, the mirrored decoder, adaptive instance normalisation,
CORAL colour alignment, and `StyleTransfer.stylize`, the adaptation
trainer's student view under STYLE.ENABLED. NCHW modules; `stylize` takes
and returns the loader's NHWC layout.

What the port keeps of the JAX package, deviations included:
  - the encoder's pools are 2x2/2 floor-mode (flax's VALID max_pool; the
    pytorch-AdaIN reference pools with ceil_mode);
  - the style image is resized to the content's size by JAX's
    `jax.image.resize(..., "bilinear")`: a triangle kernel that widens by
    the inverse scale when it downsamples (antialiasing), which
    `F.interpolate` does not compute (`resize_bilinear_like_jax`);
  - the value range: content / 255 into the encoder, and the decoder's
    output clipped to [0, 1] and times 255 back into the detector's range
    (the reference feeds 0-255 pixels into weights trained on [0, 1] and
    its output back unscaled; the JAX package documents and repairs this,
    `style_transfer.py:114-122`).

`stylize` runs in float32 under no_grad, whatever the detector's autocast:
the JAX package's style variables are constants of the step, in float32.
CORAL's 3x3 matrix powers come from Jacobi rotations in tensor ops
(`spd_power`), not from `torch.linalg.svd`/`eigh`, whose cuSOLVER calls
can read an info flag back to the host: the adaptation step stays free of
host syncs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

ENCODER_PLAN = ((64, 2), (128, 2), (256, 4), (512, 1))
# (width, convs, nearest 2x upsample after the stage)
DECODER_PLAN = ((256, 1, True), (256, 3, False), (128, 1, True), (128, 1, False), (64, 1, True), (64, 1, False))


def _reflect_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class StyleEncoder(nn.Module):
    """x [B, 3, H, W] in [0, 1] -> relu4_1 [B, 512, H/8, W/8]: the `pre` 1x1
    conv, then reflection-padded 3x3 convs with ReLU, 2x2 pools between the
    stages. Parameters `pre`, `conv{stage}_{i}` (the flax names)."""

    def __init__(self):
        super().__init__()
        self.pre = nn.Conv2d(3, 3, 1)
        c = 3
        for stage, (width, n) in enumerate(ENCODER_PLAN):
            for i in range(n):
                self.add_module(f"conv{stage}_{i}", nn.Conv2d(c, width, 3))
                c = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre(x)
        for stage, (_, n) in enumerate(ENCODER_PLAN):
            for i in range(n):
                x = torch.relu(_reflect_conv(getattr(self, f"conv{stage}_{i}"), x))
            if stage < len(ENCODER_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2)
        return x


class StyleDecoder(nn.Module):
    """relu4_1 features -> an image [B, 3, 8h, 8w]: reflection-padded 3x3
    convs with ReLU, a nearest 2x upsample after stages 0, 2 and 4, and a
    last 3x3 conv to 3 channels without ReLU. Parameters `conv{i}_{j}`,
    `out`."""

    def __init__(self):
        super().__init__()
        c = 512
        for i, (width, n, _) in enumerate(DECODER_PLAN):
            for j in range(n):
                self.add_module(f"conv{i}_{j}", nn.Conv2d(c, width, 3))
                c = width
        self.out = nn.Conv2d(c, 3, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (_, n, upsample) in enumerate(DECODER_PLAN):
            for j in range(n):
                x = torch.relu(_reflect_conv(getattr(self, f"conv{i}_{j}"), x))
            if upsample:
                x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return _reflect_conv(self.out, x)


def adaptive_instance_normalization(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Content features [B, C, H, W] with each (image, channel)'s mean and
    std replaced by the style's: unbiased variance (ddof 1), eps 1e-5 inside
    the square root."""
    eps = 1e-5
    c_var, c_mean = torch.var_mean(content, dim=(2, 3), keepdim=True, correction=1)
    s_var, s_mean = torch.var_mean(style, dim=(2, 3), keepdim=True, correction=1)
    return (content - c_mean) / torch.sqrt(c_var + eps) * torch.sqrt(s_var + eps) + s_mean


def _jacobi_eigh3(a: torch.Tensor, sweeps: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of symmetric 3x3 matrices [B, 3, 3] by cyclic
    Jacobi rotations: a fixed number of sweeps of tensor ops, so no host
    read (float64 inside; 8 sweeps take a 3x3 to float64 rounding).
    -> (eigenvalues [B, 3], eigenvectors [B, 3, 3] as columns)."""
    a = a.to(torch.float64)
    v = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a).clone()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
            small = apq.abs() < 1e-300
            theta = (aqq - app) / torch.where(small, torch.ones_like(apq), 2.0 * apq)
            t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(theta == 0, torch.ones_like(t), t)
            t = torch.where(small, torch.zeros_like(t), t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            rot = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a).clone()
            rot[:, p, p] = c
            rot[:, q, q] = c
            rot[:, p, q] = s
            rot[:, q, p] = -s
            a = rot.transpose(1, 2) @ a @ rot
            v = v @ rot
    return torch.diagonal(a, dim1=1, dim2=2), v


def spd_power(cov: torch.Tensor, power: float) -> torch.Tensor:
    """cov ** power of symmetric positive-definite [B, 3, 3] matrices, in
    float32 (CORAL's cov^-1/2 and cov^1/2: the JAX package takes them from
    an SVD, which for such a matrix is its eigen-decomposition)."""
    d, u = _jacobi_eigh3(cov)
    return ((u * d.clamp_min(1e-300).pow(power)[:, None, :]) @ u.transpose(1, 2)).to(torch.float32)


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Colour alignment of `source` [3, Hs, Ws] to each target [B, 3, H, W]
    (all in [0, 1]): whiten the source's 3 x N pixel matrix by its
    covariance and recolour it by the target's, where each matrix is
    standardised by its channel means and its unbiased std + 1e-8 and
    cov = norm @ norm.T + I; clipped to [0, 1]. -> [B, 3, Hs, Ws].

    A constant source (the flat-gray fallback style) gives each target's
    channel means exactly. The JAX package's float32 mean of a constant
    leaves a residue (3e-7 for 0.6), which the 1e-8 std then amplifies into
    a whitened offset: a fault of the reference, not copied."""
    b = target.shape[0]

    def flat(x):  # [B, 3, N] -> (mean, std, norm, cov)
        # the mean summed in float64: a constant channel's mean is then its
        # value exactly, so norm is 0 and no rounding residue is whitened
        mean = x.to(torch.float64).mean(dim=2, keepdim=True).to(x.dtype)
        std = x.std(dim=2, keepdim=True, correction=1) + 1e-8
        norm = (x - mean) / std
        cov = norm @ norm.transpose(1, 2) + torch.eye(3, dtype=x.dtype, device=x.device)
        return mean, std, norm, cov

    xs = source.reshape(1, 3, -1)
    _, _, ns, cs = flat(xs)
    mt, st, _, ct = flat(target.reshape(b, 3, -1))
    whiten = spd_power(cs, -0.5)
    recolor = spd_power(ct, 0.5)
    out = recolor @ (whiten @ ns)
    out = out * st + mt
    return torch.clamp(out, 0.0, 1.0).reshape(b, *source.shape)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """JAX's scale_and_translate weights [out, in] for the triangle kernel
    with antialiasing (jax/_src/image/scale.py:compute_weight_mat), in
    float32."""
    scale = out_size / in_size
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    x = (sample[:, None] - torch.arange(in_size, dtype=torch.float32, device=device)[None, :]).abs() / kernel_scale
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize_bilinear_like_jax(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` of [B, C, H, W] to hw: each
    spatial axis whose size changes contracted with JAX's weight matrix."""
    if x.shape[2] != hw[0]:
        x = torch.einsum("oh,bchw->bcow", _resize_weights(x.shape[2], hw[0], x.device), x)
    if x.shape[3] != hw[1]:
        x = torch.einsum("ow,bchw->bcho", _resize_weights(x.shape[3], hw[1], x.device), x)
    return x


class StyleTransfer(nn.Module):
    """A bound encoder and decoder and a fixed style image [3, Hs, Ws] in
    [0, 1] (a buffer). `alpha` is the AdaIN blend, 0.4 by default: the
    stylised features are alpha * AdaIN + (1 - alpha) * content."""

    def __init__(self, style_image: torch.Tensor, alpha: float = 0.4, use_coral: bool = True):
        super().__init__()
        self.encoder = StyleEncoder()
        self.decoder = StyleDecoder()
        self.register_buffer("style_image", style_image.to(torch.float32))
        self.alpha = float(alpha)
        self.use_coral = use_coral

    @torch.no_grad()
    def stylize(self, content: torch.Tensor) -> torch.Tensor:
        """content [B, H, W, 3] 0-255 -> the stylised view, same shape and
        range, float32 (outside any autocast, no gradient)."""
        with torch.autocast(content.device.type, enabled=False):
            x = content.to(torch.float32).permute(0, 3, 1, 2) / 255.0
            b = x.shape[0]
            if self.use_coral:
                style = coral(self.style_image, x)
            else:
                style = self.style_image[None].expand(b, -1, -1, -1)
            style = resize_bilinear_like_jax(style, tuple(x.shape[2:]))
            if x.device.type == "cuda":
                x, style = (t.contiguous(memory_format=torch.channels_last) for t in (x, style))
            f_c = self.encoder(x)
            f_s = self.encoder(style)
            feat = adaptive_instance_normalization(f_c, f_s)
            feat = self.alpha * feat + (1 - self.alpha) * f_c
            out = self.decoder(feat)
            return (torch.clamp(out, 0.0, 1.0) * 255.0).permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def init_style_weights(module: StyleTransfer, seed: int) -> StyleTransfer:
    """Seeded random encoder and decoder weights (flax's default scales:
    kernels normal with std 1/sqrt(fan_in), zero biases), drawn on the CPU
    from one torch.Generator: the weights when STYLE.VGG_MODEL or
    STYLE.DECODER is not given."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            w = torch.empty(m.weight.shape).normal_(0.0, m.weight[0].numel() ** -0.5, generator=g)
            m.weight.copy_(w)
            m.bias.zero_()
    return module


# pytorch-AdaIN's torch Sequential indices of the convs (vgg_normalised holds
# all of VGG19; only the 10 convs through relu4_1 are read), beside the
# port's (flax's) module names
ADAIN_VGG_CONVS = (0, 2, 5, 9, 12, 16, 19, 22, 25, 29)
ADAIN_VGG_NAMES = ("pre", "conv0_0", "conv0_1", "conv1_0", "conv1_1", "conv2_0", "conv2_1", "conv2_2", "conv2_3",
                   "conv3_0")
ADAIN_DEC_CONVS = (1, 5, 8, 11, 14, 18, 21, 25, 28)
ADAIN_DEC_NAMES = ("conv0_0", "conv1_0", "conv1_1", "conv1_2", "conv2_0", "conv3_0", "conv4_0", "conv5_0", "out")


def _renamed(sd: Dict[str, torch.Tensor], idxs, names) -> Dict[str, torch.Tensor]:
    out = {}
    for idx, name in zip(idxs, names):
        for k in ("weight", "bias"):
            out[f"{name}.{k}"] = torch.as_tensor(sd[f"{idx}.{k}"]).to(torch.float32)
    return out


def import_adain_encoder(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A pytorch-AdaIN `vgg_normalised.pth` state dict (Sequential keys
    '<idx>.weight') -> the StyleEncoder's state dict."""
    return _renamed(sd, ADAIN_VGG_CONVS, ADAIN_VGG_NAMES)


def import_adain_decoder(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A pytorch-AdaIN `decoder_iter_*.pth(.tar)` state dict -> the
    StyleDecoder's state dict."""
    return _renamed(sd, ADAIN_DEC_CONVS, ADAIN_DEC_NAMES)


def style_state_from_jax(encoder_params, decoder_params) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The flax StyleEncoder's and StyleDecoder's params (numpy leaves:
    {name: {"kernel" HWIO, "bias"}}) -> the port modules' state dicts."""
    import numpy as np

    def conv(tree):
        return {f"{name}.{k}": torch.from_numpy(np.array(
            np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1)) if k == "weight"
            else np.asarray(p["bias"], np.float32))) for name, p in tree.items() for k in ("weight", "bias")}

    return conv(encoder_params), conv(decoder_params)


def load_style_transfer(style_image: torch.Tensor, encoder_sd: Optional[Dict[str, torch.Tensor]],
                        decoder_sd: Optional[Dict[str, torch.Tensor]], alpha: float, seed: int,
                        use_coral: bool = True) -> StyleTransfer:
    """A StyleTransfer with the given encoder and decoder state dicts (a
    missing one seeded by `init_style_weights`)."""
    st = init_style_weights(StyleTransfer(style_image, alpha=alpha, use_coral=use_coral), seed)
    if encoder_sd is not None:
        st.encoder.load_state_dict(encoder_sd, strict=True)
    if decoder_sd is not None:
        st.decoder.load_state_dict(decoder_sd, strict=True)
    return st.eval()
