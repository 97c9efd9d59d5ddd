"""Mosaic, mixup and the YOLOX random affine on the device (the port of
`simple_sfod_tpu/data/mosaic.py`), batched over [B, H, W, 3] float images in
0..255 with fixed-capacity GT.

  mosaic  output i composites inputs i, i+1, i+2, i+3 (mod B) around a
          random centre; each source's content corner facing the centre is
          pinned there, and mosaic regions that no source content covers
          read YOLOX's 114 gray. GT grows to [B, 4N], scores carried with
          the tiles.
  mixup   the 0.5/0.5 blend of each image with the next (mod B): the
          companion's padding reads 114, then the optional scale jitter
          (sampled and then overwritten with 1 in the reference, so off in
          every config), the companion flip about the full canvas, and the
          random crop of the companion to the origin's frame, zero outside
          it. GT is concatenated to [B, 2N].
  affine  YOLOX's random_affine about the canvas centre (rotation, scale,
          shear, translation), bilinear inverse warp, boxes by their warped
          corners' hull. Off in every config (the reference's call is
          commented out); INPUT.MOSAIC.RANDOM_AFFINE turns it on.

Every random decision is an input: the U[0, 1) draws that the JAX package
takes from its keys, mapped to their ranges here by the JAX package's own
float32 arithmetic (`uniform`), so the JAX draws give the JAX results. Boxes
under 2 px on a side after a move are dropped, as the reference's
adjust_box_anns does. Nothing reads back to the host: bounds that depend on
the images' sizes stay on the device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..structures.boxes import nonempty
from ..structures.instances import Instances

PAD_GRAY = 114.0
MIXUP_ALPHA = 0.5  # the reference's fixed blend weight
SLIVER = 2.0  # boxes with a side at most this many px are dropped


def uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """U[0, 1) draws mapped to [lo, hi) as `jax.random.uniform(key, shape,
    minval=lo, maxval=hi)` maps its own: max(lo, u * (hi - lo) + lo), with
    lo, hi and their difference rounded to float32 first."""
    lo_t, hi_t = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    lo32, span32 = float(lo_t), float(hi_t - lo_t)  # exact float32 values, as Python scalars
    return torch.clamp_min(u * span32 + lo32, lo32)


def _gather4(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] -> [B, 4, ...]: row i holds x[i], x[i+1], x[i+2], x[i+3] (mod B)."""
    return torch.stack([torch.roll(x, -k, dims=0) for k in range(4)], dim=1)


def _take_pixels(images: torch.Tensor, b_idx, y_idx, x_idx) -> torch.Tensor:
    """images[b_idx, y_idx, x_idx] for index tensors of one shape [...]
    (in bounds) -> [..., C], as one gather of the flattened batch."""
    bsz, h, w, c = images.shape
    flat = ((b_idx.to(torch.int64) * h + y_idx.to(torch.int64)) * w + x_idx.to(torch.int64)).reshape(-1)
    return images.reshape(bsz * h * w, c).index_select(0, flat).reshape(*b_idx.shape, c)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip(x, lo, hi): min(max(x, lo), hi), bounds broadcast."""
    return torch.minimum(torch.maximum(x, lo), hi)


# ---------------------------------------------------------------- mosaic
def mosaic_batch(
    centre: torch.Tensor,
    images: torch.Tensor,
    gt: Instances,
    sizes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Instances]:
    """images [B, H, W, 3] float; gt [B, N]; centre [B, 2] U[0, 1) draws
    (the centre's y and x: `_mosaic_one`'s two uniforms); sizes [B, 2]
    content (h, w) per image for content-aware compositing (None: content
    fills the canvas). -> (images, Instances [B, 4N], tile-major)."""
    bsz, h, w = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    if sizes is None:
        sizes = torch.stack([torch.full((bsz,), h, dtype=torch.int32, device=dev),
                             torch.full((bsz,), w, dtype=torch.int32, device=dev)], dim=1)
    sizes4 = _gather4(sizes.to(torch.int32))  # [B, 4, 2]
    sh, sw = sizes4[..., 0], sizes4[..., 1]
    c = uniform(centre, 0.25, 0.75)
    cy = (c[:, 0] * h).to(torch.int32)  # [B]
    cx = (c[:, 1] * w).to(torch.int32)

    rows = torch.arange(h, device=dev, dtype=torch.int32)[None, :, None]
    cols = torch.arange(w, device=dev, dtype=torch.int32)[None, None, :]
    is_top = rows < cy[:, None, None]
    is_left = cols < cx[:, None, None]
    tile = torch.where(is_top, torch.where(is_left, 0, 1), torch.where(is_left, 2, 3)).to(torch.int64)  # [B, H, W]

    # each source's content corner facing the centre pinned there: TL shows
    # source 0's bottom-right content crop, src_y = y + (sh0 - cy)
    zero = torch.zeros_like(cy)
    off_y = torch.stack([sh[:, 0] - cy, sh[:, 1] - cy, zero - cy, zero - cy], dim=1)  # [B, 4]
    off_x = torch.stack([sw[:, 0] - cx, zero - cx, sw[:, 2] - cx, zero - cx], dim=1)
    flat_tile = tile.reshape(bsz, -1)

    def per_tile(v: torch.Tensor) -> torch.Tensor:  # [B, 4] -> [B, H, W] by tile
        return torch.gather(v, 1, flat_tile).reshape(bsz, h, w)

    raw_y = rows + per_tile(off_y)
    raw_x = cols + per_tile(off_x)
    src_y = torch.clamp(raw_y, 0, h - 1)
    src_x = torch.clamp(raw_x, 0, w - 1)
    src_b = torch.remainder(torch.arange(bsz, device=dev)[:, None, None] + tile, bsz)
    out = _take_pixels(images, src_b, src_y, src_x)
    inb = (raw_y >= 0) & (raw_y < per_tile(sh)) & (raw_x >= 0) & (raw_x < per_tile(sw))
    out = torch.where(inb[..., None], out, PAD_GRAY)

    # boxes: each source's shifted by -offset and clipped to its tile
    f32 = torch.float32
    cyf, cxf = cy.to(f32), cx.to(f32)
    zf = torch.zeros_like(cyf)
    tile_x1 = torch.stack([zf, cxf, zf, cxf], 1)[..., None]  # [B, 4, 1]
    tile_y1 = torch.stack([zf, zf, cyf, cyf], 1)[..., None]
    tile_x2 = torch.stack([cxf, zf + w, cxf, zf + w], 1)[..., None]
    tile_y2 = torch.stack([cyf, cyf, zf + h, zf + h], 1)[..., None]
    dx = (-off_x.to(f32))[..., None]
    dy = (-off_y.to(f32))[..., None]
    bx = _gather4(gt.boxes) + torch.stack([dx, dy, dx, dy], dim=-1)  # [B, 4, N, 4]
    nb = torch.stack(
        [
            _clip(bx[..., 0], tile_x1, tile_x2),
            _clip(bx[..., 1], tile_y1, tile_y2),
            _clip(bx[..., 2], tile_x1, tile_x2),
            _clip(bx[..., 3], tile_y1, tile_y2),
        ],
        dim=-1,
    )
    valid = _gather4(gt.valid) & nonempty(nb, SLIVER)
    n4 = 4 * gt.boxes.shape[1]
    return out, Instances(
        boxes=nb.reshape(bsz, n4, 4),
        scores=_gather4(gt.scores).reshape(bsz, n4),
        classes=_gather4(gt.classes).reshape(bsz, n4),
        valid=valid.reshape(bsz, n4),
    )


# ---------------------------------------------------------------- mixup
def mixup_batch(
    images: torch.Tensor,
    gt: Instances,
    flip: Optional[torch.Tensor] = None,
    scale_jitter: Optional[Sequence[float]] = None,
    jitter: Optional[torch.Tensor] = None,
    jitter_offset: Optional[torch.Tensor] = None,
    crop: Optional[torch.Tensor] = None,
    sizes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Instances]:
    """The 0.5/0.5 blend of image i with image i+1 (mod B), GT concatenated
    ([B, 2N]). Draws: `flip` [B] bool, the companion's flip about the full
    canvas width (None: no flip); with `scale_jitter` (lo, hi), `jitter` [B]
    U[0, 1) (the factor) and `jitter_offset` [B, 2] U[0, 1) (the crop
    offset when the factor upscales, x then y); with `sizes` [B, 2] (content
    h, w: the content-aware geometry), `crop` [B, 2] U[0, 1) whose floor of
    u * max(H - frame h, 1) (y) and of u * max(W - frame w, 1) (x) is the
    companion's crop offset, drawn by the JAX package with
    `jax.random.randint`. See the JAX function for the reference geometry."""
    bsz, h, w = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    other_images = torch.roll(images, -1, dims=0)
    other = Instances(*(torch.roll(t, -1, dims=0) for t in (gt.boxes, gt.scores, gt.classes, gt.valid)))
    oboxes, ovalid = other.boxes, other.valid
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]

    if sizes is not None:
        sizes = sizes.to(torch.int32)
        s_c = torch.roll(sizes, -1, dims=0)  # the companion's content
        in_content = (rows < s_c[:, 0, None, None]) & (cols < s_c[:, 1, None, None])
        other_images = torch.where(in_content[..., None], other_images, PAD_GRAY)

    if scale_jitter is not None:
        lo, hi = scale_jitter
        j = uniform(jitter, float(lo), float(hi))  # [B]
        omax = torch.clamp_min(torch.stack([j * float(w) - float(w), j * float(h) - float(h)], 1), 0.0)  # [B, 2]
        off = jitter_offset * omax
        zero = torch.zeros_like(j)
        m = torch.stack(
            [torch.stack([j, zero, -off[:, 0]], 1), torch.stack([zero, j, -off[:, 1]], 1)], dim=1
        )  # [B, 2, 3]
        other_images = affine_warp(other_images, m, pad_val=0.0)
        oboxes = affine_boxes(oboxes, m, w, h)
        ovalid = ovalid & nonempty(oboxes, SLIVER)

    if flip is not None:
        fboxes = torch.stack([w - oboxes[..., 2], oboxes[..., 1], w - oboxes[..., 0], oboxes[..., 3]], dim=-1)
        other_images = torch.where(flip[:, None, None, None], other_images.flip(2), other_images)
        oboxes = torch.where(flip[:, None, None], fboxes, oboxes)

    if sizes is not None:
        # the companion cropped to the origin's frame at a random offset, and
        # zero outside the frame (so the origin's padding stays as it was)
        fh, fw = sizes[:, 0], sizes[:, 1]
        y_off = torch.floor(crop[:, 0] * torch.clamp_min(h - fh, 1).to(torch.float32)).to(torch.int32)
        x_off = torch.floor(crop[:, 1] * torch.clamp_min(w - fw, 1).to(torch.float32)).to(torch.int32)
        ys = torch.clamp(rows + y_off[:, None, None], 0, h - 1)  # [B, H, 1]
        xs = torch.clamp(cols + x_off[:, None, None], 0, w - 1)  # [B, 1, W]
        b_idx = torch.arange(bsz, device=dev)[:, None, None]
        shifted = _take_pixels(other_images, b_idx.expand(bsz, h, w), ys.expand(bsz, h, w), xs.expand(bsz, h, w))
        in_frame = (rows < fh[:, None, None]) & (cols < fw[:, None, None])
        other_images = torch.where(in_frame[..., None], shifted, 0.0)
        xo, yo = x_off.to(oboxes.dtype)[:, None], y_off.to(oboxes.dtype)[:, None]
        fwf, fhf = fw.to(oboxes.dtype)[:, None], fh.to(oboxes.dtype)[:, None]
        zero = torch.zeros((), dtype=oboxes.dtype, device=dev)
        oboxes = torch.stack(
            [
                _clip(oboxes[..., 0] - xo, zero, fwf),
                _clip(oboxes[..., 1] - yo, zero, fhf),
                _clip(oboxes[..., 2] - xo, zero, fwf),
                _clip(oboxes[..., 3] - yo, zero, fhf),
            ],
            dim=-1,
        )
        ovalid = ovalid & nonempty(oboxes, SLIVER)

    out = images * MIXUP_ALPHA + other_images * (1.0 - MIXUP_ALPHA)
    return out, Instances(
        boxes=torch.cat([gt.boxes, oboxes], dim=1),
        scores=torch.cat([gt.scores, other.scores], dim=1),
        classes=torch.cat([gt.classes, other.classes], dim=1),
        valid=torch.cat([gt.valid, ovalid], dim=1),
    )


# ---------------------------------------------------------------- YOLOX affine
def affine_matrix(angle_deg, scale, shear_x_deg, shear_y_deg, tx, ty) -> torch.Tensor:
    """YOLOX get_affine_matrix from parameters of shape [...] -> M [..., 2, 3]
    with dst = M[:, :2] @ src + M[:, 2]: rotation and scale about the origin
    (cv2.getRotationMatrix2D at (0, 0)), rows mixed by tan(shear)."""
    rad = angle_deg * (math.pi / 180.0)
    a = scale * torch.cos(rad)
    b = scale * torch.sin(rad)
    sx = torch.tan(shear_x_deg * (math.pi / 180.0))
    sy = torch.tan(shear_y_deg * (math.pi / 180.0))
    m0 = torch.stack([a + sy * -b, b + sy * a], dim=-1)  # r0 + sy * r1, r1 = (-b, a)
    m1 = torch.stack([-b + sx * a, a + sx * b], dim=-1)  # r1 + sx * r0
    return torch.stack([torch.cat([m0, tx[..., None]], -1), torch.cat([m1, ty[..., None]], -1)], dim=-2)


def sample_affine_params(
    u: torch.Tensor, target_size: Tuple[int, int], degrees: float, translate: float, scales: Sequence[float], shear: float
):
    """YOLOX's parameter sampling from six U[0, 1) draws a row (u [..., 6]):
    angle and shears uniform in +-degrees and +-shear, scale in scales,
    translation uniform(0.5 +- translate) * target. -> (angle, scale,
    shear_x, shear_y, tx, ty)."""
    tw, th = target_size
    return (
        uniform(u[..., 0], -degrees, degrees),
        uniform(u[..., 1], float(scales[0]), float(scales[1])),
        uniform(u[..., 2], -shear, shear),
        uniform(u[..., 3], -shear, shear),
        uniform(u[..., 4], 0.5 - translate, 0.5 + translate) * tw,
        uniform(u[..., 5], 0.5 - translate, 0.5 + translate) * th,
    )


def affine_warp(images: torch.Tensor, m: torch.Tensor, pad_val: float = PAD_GRAY) -> torch.Tensor:
    """Inverse-warp bilinear resample of a batch: dst(x, y) = src(M^-1 (x, y, 1))
    for images [B, H, W, C] and m [B, 2, 3]; corners outside the image read
    pad_val (cv2.warpAffine's borderValue)."""
    bsz, h, w = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    a00, a01, a10, a11 = (m[:, i, j][:, None, None] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    t0, t1 = m[:, 0, 2][:, None, None], m[:, 1, 2][:, None, None]
    det = a00 * a11 - a01 * a10
    i00, i01, i10, i11 = a11 / det, -a01 / det, -a10 / det, a00 / det
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    dx, dy = xs - t0, ys - t1
    sx = i00 * dx + i01 * dy  # [B, H, W]
    sy = i10 * dx + i11 * dy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    b_idx = torch.arange(bsz, device=dev)[:, None, None].expand(bsz, h, w)

    def sample(yi, xi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        v = _take_pixels(images, b_idx, torch.clamp(yi, 0, h - 1).to(torch.int64), torch.clamp(xi, 0, w - 1).to(torch.int64))
        return torch.where(inb[..., None], v, pad_val)

    top = sample(y0, x0) * (1 - fx) + sample(y0, x0 + 1) * fx
    bot = sample(y0 + 1, x0) * (1 - fx) + sample(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def affine_boxes(boxes: torch.Tensor, m: torch.Tensor, out_w, out_h) -> torch.Tensor:
    """YOLOX apply_affine_to_bboxes for boxes [B, N, 4] and m [B, 2, 3]: the
    4 corners warped, their axis-aligned hull clipped to [0, out_w] x
    [0, out_h]."""
    x1, y1, x2, y2 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    cx = torch.stack([x1, x2, x1, x2], dim=-1)
    cy = torch.stack([y1, y2, y2, y1], dim=-1)
    mm = m[:, None, None]  # [B, 1, 1, 2, 3]
    nx = mm[..., 0, 0] * cx + mm[..., 0, 1] * cy + mm[..., 0, 2]
    ny = mm[..., 1, 0] * cx + mm[..., 1, 1] * cy + mm[..., 1, 2]
    return torch.stack(
        [
            torch.clamp(nx.amin(-1), 0, out_w),
            torch.clamp(ny.amin(-1), 0, out_h),
            torch.clamp(nx.amax(-1), 0, out_w),
            torch.clamp(ny.amax(-1), 0, out_h),
        ],
        dim=-1,
    )


def random_affine_batch(
    u: torch.Tensor,
    images: torch.Tensor,
    gt: Instances,
    degrees: float = 10.0,
    translate: float = 0.1,
    scales: Sequence[float] = (0.5, 1.5),
    shear: float = 2.0,
) -> Tuple[torch.Tensor, Instances]:
    """YOLOX random_affine of each image of the assembled mosaic, from six
    U[0, 1) draws an image (u [B, 6]). The matrix acts on coordinates from
    the canvas centre (dst = M (src - c)), which reproduces YOLOX's
    content-centred geometry on the 1x canvas; boxes under 2 px after the
    warp are dropped."""
    h, w = images.shape[1], images.shape[2]
    m = affine_matrix(*sample_affine_params(u, (w, h), degrees, translate, scales, shear))  # [B, 2, 3]
    c0, c1 = w / 2.0, h / 2.0
    shift = torch.stack([m[:, 0, 0] * c0 + m[:, 0, 1] * c1, m[:, 1, 0] * c0 + m[:, 1, 1] * c1], dim=1)
    m_eff = torch.cat([m[:, :, :2], (m[:, :, 2] - shift)[..., None]], dim=2)
    nb = affine_boxes(gt.boxes, m_eff, w, h)
    return affine_warp(images, m_eff, PAD_GRAY), Instances(
        boxes=nb, scores=gt.scores, classes=gt.classes, valid=gt.valid & nonempty(nb, SLIVER)
    )
