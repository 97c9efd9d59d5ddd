"""Image augmentation (the port of `simple_sfod_tpu/data/transforms.py`):
the weak view's horizontal flip and the strong view's photometric pipeline,
on the device, on float [H, W, 3] images in 0..255.

Every random decision is an input, not a draw, so a caller can hand over
the JAX package's draws. The strong view takes a `StrongDraws` bundle whose
scalar decisions (which ops apply, the jitter factors and order, the blur
sigma) are CPU tensors, read by Python without waiting on the device, so
an op that does not apply is skipped rather than computed and discarded;
the erasing geometry draws and the fill canvas are tensors on the images'
device, combined there with the device-side image sizes.

The reference feeds BGR arrays to PIL as "RGB" images, so the luma weights
and the HSV transform apply to the channels as stored, and PIL rounds to
uint8 after every op; both are reproduced (see the JAX module)."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F


def hflip(image: torch.Tensor, boxes: torch.Tensor, width: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal flip of the valid region of a canvas. image [H, W, C],
    boxes [..., 4] XYXY, width: the valid width (a scalar tensor). The
    valid columns are mirrored in place and the padding stays on the right,
    reversed, exactly as the JAX package's reverse-then-roll leaves it."""
    cols = image.shape[1]
    j = torch.arange(cols, device=image.device)
    w = width.to(j.dtype)
    src = torch.where(j < w, w - 1 - j, cols - 1 + w - j)
    flipped = image.index_select(1, src)
    wf = width.to(boxes.dtype)
    new_boxes = torch.stack(
        [wf - boxes[..., 2], boxes[..., 1], wf - boxes[..., 0], boxes[..., 3]], dim=-1
    )
    return flipped, new_boxes


def random_hflip(
    do: torch.Tensor, image: torch.Tensor, boxes: torch.Tensor, width: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hflip where the bool scalar `do` is set (the JAX package draws it as
    `jax.random.bernoulli(rng, 0.5)`). -> (image, boxes, do)."""
    fi, fb = hflip(image, boxes, width)
    return torch.where(do, fi, image), torch.where(do, fb, boxes), do


# ---------------------------------------------------------------------------
# Photometric (strong augmentation): ColorJitter(0.4, 0.4, 0.4, 0.1) p=0.8,
# RandomGrayscale p=0.2, GaussianBlur(sigma in [0.1, 2.0]) p=0.5, then three
# RandomErasing calls with their own probability, scale and ratio.
# ---------------------------------------------------------------------------

# PIL convert("L") weights, applied to the channels as stored
_LUMA = (0.299, 0.587, 0.114)
JITTER = (0.4, 0.4, 0.4, 0.1)  # brightness, contrast, saturation, hue
GRAY_P = 0.2
JITTER_P = 0.8
BLUR_P = 0.5
SIGMA_RANGE = (0.1, 2.0)
# (p, scale, ratio) of the three RandomErasing calls
_ERASE_PARAMS = (
    (0.7, (0.05, 0.2), (0.3, 3.3)),
    (0.5, (0.02, 0.2), (0.1, 6.0)),
    (0.3, (0.02, 0.2), (0.05, 8.0)),
)
ERASE_ATTEMPTS = 10


class StrongDraws(NamedTuple):
    """The draws of the strong view of B images.

    On the CPU (read by Python, no device sync):
      do       [B, 6] bool: jitter, grayscale, blur, erasing 0, 1, 2 apply
      jitter   [B, 4] float32: brightness, contrast, saturation factors in
               [0.6, 1.4], hue shift in [-0.1, 0.1]
      perm     [B, 4] int64: the order of the four jitter ops
      sigma    [B] float32 in [0.1, 2.0]
    On the images' device:
      erase_scale      [B, 3, 10] float32: area fractions, U(scale) of each call
      erase_log_ratio  [B, 3, 10] float32: log aspect, U(log ratio) of each call
      erase_offset     [B, 3, 2] float32: U[0, 1) for the top and left offsets
      fill             [B, H, W, 3] float32: N(0, 1), shared by the three calls
    """

    do: torch.Tensor
    jitter: torch.Tensor
    perm: torch.Tensor
    sigma: torch.Tensor
    erase_scale: torch.Tensor
    erase_log_ratio: torch.Tensor
    erase_offset: torch.Tensor
    fill: torch.Tensor

    def to(self, device) -> "StrongDraws":
        """The device-side draws moved to `device`; the CPU-side ones stay."""
        return self._replace(**{f: getattr(self, f).to(device) for f in self._fields[4:]})


def make_strong_draws(
    batch: int,
    canvas_hw: Tuple[int, int],
    host: torch.Generator,
    device_gen: torch.Generator,
    device: torch.device,
) -> StrongDraws:
    """Draws of the strong view from two generators: `host` (a CPU
    generator) for the scalar decisions, `device_gen` (on `device`) for the
    erasing draws and the fill canvas."""
    probs = torch.tensor([JITTER_P, GRAY_P, BLUR_P] + [p for p, _, _ in _ERASE_PARAMS])
    do = torch.rand((batch, 6), generator=host) < probs
    u = torch.rand((batch, 4), generator=host)
    lo = torch.tensor([1 - JITTER[0], 1 - JITTER[1], 1 - JITTER[2], -JITTER[3]])
    hi = torch.tensor([1 + JITTER[0], 1 + JITTER[1], 1 + JITTER[2], JITTER[3]])
    jitter = u * (hi - lo) + lo
    perm = torch.stack([torch.randperm(4, generator=host) for _ in range(batch)])
    sigma = torch.rand((batch,), generator=host) * (SIGMA_RANGE[1] - SIGMA_RANGE[0]) + SIGMA_RANGE[0]

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=device_gen, device=device) * (hi - lo) + lo

    scale = torch.stack([uniform(*sc, (batch, ERASE_ATTEMPTS)) for _, sc, _ in _ERASE_PARAMS], 1)
    log_ratio = torch.stack(
        [uniform(math.log(r[0]), math.log(r[1]), (batch, ERASE_ATTEMPTS)) for _, _, r in _ERASE_PARAMS], 1
    )
    offset = torch.rand((batch, 3, 2), generator=device_gen, device=device)
    fill = torch.randn((batch, *canvas_hw, 3), generator=device_gen, device=device)
    return StrongDraws(do, jitter, perm, sigma, scale, log_ratio, offset, fill)


def _blend(a, b, f: float):
    return a * f + b * (1.0 - f)


def _pil_u8(img: torch.Tensor) -> torch.Tensor:
    """PIL's uint8 after every op: round half up, clamp to 0..255."""
    return torch.clamp(torch.floor(img + 0.5), 0.0, 255.0)


def _pil_gray(img: torch.Tensor) -> torch.Tensor:
    """PIL convert("L") of the stored channels, quantized. [H, W, 3] -> [H, W]."""
    return torch.floor(img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1] + img[..., 2] * _LUMA[2] + 0.5)


def content_mask(hw: Tuple[int, int], true_hw: torch.Tensor) -> torch.Tensor:
    """[H, W] bool: the valid (top-left, true_hw) region of a padded canvas."""
    dev = true_hw.device
    rows = torch.arange(hw[0], device=dev)[:, None] < true_hw[0]
    cols = torch.arange(hw[1], device=dev)[None, :] < true_hw[1]
    return rows & cols


def adjust_brightness(img: torch.Tensor, factor: float) -> torch.Tensor:
    return img * factor


def adjust_contrast(img: torch.Tensor, factor: float, true_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PIL ImageEnhance.Contrast: a blend against the rounded mean of the
    quantized gray image, over the content region when `true_hw` is given
    (and zero outside it)."""
    gray = _pil_gray(img)
    if true_hw is None:
        return _blend(img, torch.floor(gray.mean() + 0.5), factor)
    mask = content_mask(img.shape[:2], true_hw).to(img.dtype)
    npix = torch.clamp_min(true_hw[0] * true_hw[1], 1).to(img.dtype)
    mean = torch.floor(torch.sum(gray * mask) / npix + 0.5)
    return _blend(img, mean, factor) * mask[..., None]


def adjust_saturation(img: torch.Tensor, factor: float) -> torch.Tensor:
    """PIL ImageEnhance.Color: a blend against the quantized gray image."""
    return _blend(img, _pil_gray(img)[..., None], factor)


def adjust_hue(img: torch.Tensor, delta: float) -> torch.Tensor:
    """HSV hue shift by `delta` turns, on the channels as stored, in
    continuous HSV."""
    x = img / 255.0
    mx = x.amax(dim=-1)
    mn = x.amin(dim=-1)
    c = mx - mn
    cs = torch.where(c == 0, 1.0, c)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = torch.where(
        mx == r,
        torch.remainder((g - b) / cs, 6.0),
        torch.where(mx == g, (b - r) / cs + 2.0, (r - g) / cs + 4.0),
    )
    h = torch.where(c == 0, 0.0, h) / 6.0
    s = torch.where(mx == 0, 0.0, c / torch.where(mx == 0, 1.0, mx))
    h = torch.remainder(h + delta, 1.0)

    def chan(n: float) -> torch.Tensor:
        k = torch.remainder(n + h * 6.0, 6.0)
        return mx - mx * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1) * 255.0


def color_jitter(
    img: torch.Tensor, factors: Sequence[float], perm: Sequence[int], true_hw: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """torchvision ColorJitter: the four ops in the order `perm` (0
    brightness, 1 contrast, 2 saturation, 3 hue) with `factors` in that
    numbering, quantized to PIL's uint8 after each."""
    fb, fc, fs, fh = (float(f) for f in factors)
    ops = (
        lambda x: adjust_brightness(x, fb),
        lambda x: adjust_contrast(x, fc, true_hw),
        lambda x: adjust_saturation(x, fs),
        lambda x: adjust_hue(x, fh),
    )
    for i in perm:
        img = _pil_u8(ops[int(i)](img))
    return img


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """torchvision RandomGrayscale: PIL convert("L") on all three channels."""
    return _pil_gray(img)[..., None].expand(img.shape)


def gaussian_blur(
    img: torch.Tensor, sigma: float, kernel_size: int = 9, true_hw: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Separable gaussian blur renormalised by the blurred validity mask, so
    the image borders and the content/padding boundary do not darken; the
    padding outside the content stays as it was."""
    r = kernel_size // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    # 2 * sigma^2 is exact in float64 and rounds to the JAX package's float32
    k = torch.exp(-(x**2) / (2.0 * float(sigma) ** 2))
    k = k / torch.sum(k)
    h, w = img.shape[:2]
    if true_hw is None:
        mask = torch.ones((h, w), dtype=torch.float32, device=img.device)
    else:
        mask = content_mask((h, w), true_hw).to(torch.float32)
    src = torch.cat([(img * mask[..., None]).permute(2, 0, 1), mask[None]], dim=0)[:, None]  # [C+1, 1, H, W]
    out = F.conv2d(src, k.view(1, 1, 1, kernel_size), padding=(0, r))
    out = F.conv2d(out, k.view(1, 1, kernel_size, 1), padding=(r, 0))
    out = out[:, 0].permute(1, 2, 0)  # [H, W, C+1]
    blurred = out[..., :-1] / torch.clamp_min(out[..., -1:], 1e-6)
    return torch.where(mask[..., None] > 0, blurred, img)


def erasing_rect(
    scale: torch.Tensor, log_ratio: torch.Tensor, offset: torch.Tensor, true_hw: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """torchvision RandomErasing's geometry on the content region, exactly:
    up to 10 attempts (area = scale * h * w, aspect = exp(log_ratio), sides
    rounded half up), the first with eh < h and ew < w (strict) wins, the
    offsets are floor(U * (h - eh + 1)) and floor(U * (w - ew + 1)), and no
    erase happens when every attempt fails. -> (found, y0, x0, eh, ew), 0-dim
    tensors on the device."""
    th, tw = true_hw[0], true_hw[1]
    area = (th * tw).to(torch.float32)
    target = scale * area
    aspect = torch.exp(log_ratio)
    ehs = torch.floor(torch.sqrt(target * aspect) + 0.5).to(torch.int32)
    ews = torch.floor(torch.sqrt(target / aspect) + 0.5).to(torch.int32)
    ok = (ehs < th) & (ews < tw)
    # the first winning attempt, gathered on the device (indexing by a 0-dim
    # tensor would read it back to the host)
    first = torch.argmax(ok.to(torch.uint8)).view(1)
    eh, ew = ehs.index_select(0, first)[0], ews.index_select(0, first)[0]
    y0 = torch.floor(offset[0] * (th - eh + 1).to(torch.float32)).to(torch.int32)
    x0 = torch.floor(offset[1] * (tw - ew + 1).to(torch.float32)).to(torch.int32)
    return ok.any(), y0, x0, eh, ew


def random_erasing(
    img: torch.Tensor,
    scale: torch.Tensor,
    log_ratio: torch.Tensor,
    offset: torch.Tensor,
    fill: torch.Tensor,
    true_hw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One RandomErasing call with its draws (`erasing_rect`): the rectangle
    takes the values of `fill` ([H, W, C], already through `_erasing_fill`)."""
    h, w = img.shape[:2]
    if true_hw is None:
        true_hw = torch.tensor([h, w], dtype=torch.int32, device=img.device)
    found, y0, x0, eh, ew = erasing_rect(scale, log_ratio, offset, true_hw)
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    mask = found & (rows >= y0) & (rows < y0 + eh) & (cols >= x0) & (cols < x0 + ew)
    return torch.where(mask[..., None], fill, img)


def _erasing_fill(normal: torch.Tensor) -> torch.Tensor:
    """The reference's erasing fill: N(0, 1) on the [0, 1] scale times 255,
    truncated toward zero and wrapped to uint8 (mod 256)."""
    return torch.remainder(torch.trunc(normal * 255.0), 256.0)


def strong_augment(img: torch.Tensor, draws: StrongDraws, i: int, true_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The strong view of image i of the draws' batch: ColorJitter,
    Grayscale, GaussianBlur, then the three RandomErasing calls, each where
    its bernoulli says. img float [H, W, 3]; true_hw [2] int32 on the device."""
    do = [bool(v) for v in draws.do[i]]
    if do[0]:
        img = color_jitter(img, draws.jitter[i].tolist(), draws.perm[i].tolist(), true_hw)
    if do[1]:
        img = to_grayscale(img)
    if do[2]:
        img = gaussian_blur(img, float(draws.sigma[i]), true_hw=true_hw)
    if any(do[3:]):
        fill = _erasing_fill(draws.fill[i])
        for k in range(3):
            if do[3 + k]:
                img = random_erasing(
                    img, draws.erase_scale[i, k], draws.erase_log_ratio[i, k], draws.erase_offset[i, k], fill, true_hw
                )
    return img


def strong_augment_batch(images: torch.Tensor, sizes: torch.Tensor, draws: StrongDraws) -> torch.Tensor:
    """The strong view of a batch: images float [B, H, W, 3], sizes [B, 2]
    int32 (the content region of each canvas)."""
    return torch.stack([strong_augment(images[i], draws, i, sizes[i]) for i in range(images.shape[0])])
