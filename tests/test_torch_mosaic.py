"""The port's mosaic, mixup and YOLOX affine (simple_sfod_tpu_torch/data/
mosaic.py) against the JAX package's (simple_sfod_tpu/data/mosaic.py), on
the CPU in float32, on the same numpy-seeded images and GT and the draws
that the JAX functions take from their keys.

Tolerances, and why:
  gathers and blends    0: mosaic_batch, and mixup_batch without the scale
                        jitter, move and blend pixels and boxes by the same
                        float32 operations (images and boxes bit-equal,
                        masks equal)
  the bilinear warp     1e-4 * 255 in the image, 1e-3 px in the boxes, masks
                        equal: the matrix goes through cos, sin, tan and a
                        division, whose last bits differ between XLA and
                        torch, and the weights of the bilinear blend follow
                        them (affine_warp, random_affine_batch, and
                        mixup_batch with the scale jitter)
  affine_matrix         1e-6 relative to its largest entry
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.data import mosaic as JM
from simple_sfod_tpu.structures.boxes import nonempty as jax_nonempty
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.data import mosaic as PM
from simple_sfod_tpu_torch.structures.boxes import nonempty
from simple_sfod_tpu_torch.structures.instances import Instances

CANVAS = (64, 128)
N = 8
WARP_IMAGE_TOL = 1e-4 * 255
WARP_BOX_TOL = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


def case(seed, b=4, content=None):
    """uint8-valued float32 images [B, H, W, 3] (zero outside each content
    region, as the loader pads), GT [B, N] inside the content with some
    slots invalid, and sizes [B, 2]."""
    rs = np.random.RandomState(seed)
    h, w = CANVAS
    sizes = np.asarray(content if content is not None else [CANVAS] * b, np.int32)
    images = rs.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    for i, (sh, sw) in enumerate(sizes):
        images[i, sh:] = 0
        images[i, :, sw:] = 0
    xy = rs.uniform(0, 1, (b, N, 2)) * (sizes[:, None, ::-1] - 12)
    wh = rs.uniform(3, 30, (b, N, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, sizes[:, None, ::-1])], -1).astype(np.float32)
    valid = rs.uniform(size=(b, N)) < 0.75
    scores = rs.uniform(0.5, 1.0, (b, N)).astype(np.float32)
    classes = rs.randint(0, 8, (b, N)).astype(np.int32)
    return images, (boxes, scores, classes, valid), sizes


def port_gt(g):
    return Instances(*(T(a) for a in g))


def jax_gt(g):
    return JaxInstances(*(jnp.asarray(a) for a in g))


def assert_gt_equal(got: Instances, want, box_tol=0.0):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=box_tol)


# ---------------------------------------------------------------- JAX draws
def uniforms(key, n):
    """The U[0, 1) draws behind jax.random.uniform(k, (), lo, hi) for each
    of split(key, n)."""
    return np.stack([np.float32(jax.random.uniform(k, ())) for k in jax.random.split(key, n)])


def jax_mosaic_centre(rng, b):
    """_mosaic_one's two uniforms of each image: split(rng, B), then split 2."""
    return T(np.stack([uniforms(r, 2) for r in jax.random.split(rng, b)]))


def jax_affine_draws(rng, b):
    """random_affine_batch's: split(rng, B), then sample_affine_params' split 6."""
    return T(np.stack([uniforms(r, 6) for r in jax.random.split(rng, b)]))


def jax_mixup_draws(rng, b, hw, sizes=None):
    """mixup_batch's: the flip bernoullis (fold_in 0), the jitter's factor
    and offset uniforms (fold_in 1, split B, split 2), and the crop's
    randint offsets (fold_in 2, split B, split 2) as U[0, 1) draws whose
    floor of u * bound is the offset."""
    flip = T(np.asarray(jax.random.bernoulli(jax.random.fold_in(rng, 0), 0.5, (b,))))
    jit, off = [], []
    for r in jax.random.split(jax.random.fold_in(rng, 1), b):
        kj, ko = jax.random.split(r)
        jit.append(np.float32(jax.random.uniform(kj, ())))
        off.append(np.asarray(jax.random.uniform(ko, (2,))))
    crop = None
    if sizes is not None:
        crop = []
        for r, (fh, fw) in zip(jax.random.split(jax.random.fold_in(rng, 2), b), sizes):
            ky, kx = jax.random.split(r)
            ny, nx = max(hw[0] - fh, 1), max(hw[1] - fw, 1)
            y = int(jax.random.randint(ky, (), 0, ny))
            x = int(jax.random.randint(kx, (), 0, nx))
            crop.append([(y + 0.5) / ny, (x + 0.5) / nx])
        crop = T(np.asarray(crop, np.float32))
    return flip, T(np.asarray(jit, np.float32)), T(np.stack(off)), crop


# ---------------------------------------------------------------- mosaic
MOSAIC_CASES = {
    "canvas_b4": (4, None, False),
    "content_b4": (4, [(50, 100), (64, 128), (40, 90), (60, 120)], True),
    "content_b3": (3, [(44, 110), (64, 100), (52, 128)], True),
    "content_b2": (2, [(36, 80), (58, 124)], True),
}


@pytest.mark.parametrize("name", list(MOSAIC_CASES))
def test_mosaic_batch_equals_jax(name):
    b, content, aware = MOSAIC_CASES[name]
    images, g, sizes = case(11 + b, b, content)
    rng = jax.random.key(5 + b)
    jsz = jnp.asarray(sizes) if aware else None
    want_img, want_gt = jax.jit(lambda r, im, gt, s: JM.mosaic_batch(r, im, gt, sizes=s))(rng, jnp.asarray(images), jax_gt(g), jsz)
    got_img, got_gt = PM.mosaic_batch(jax_mosaic_centre(rng, b), T(images), port_gt(g), sizes=T(sizes) if aware else None)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    assert got_gt.boxes.shape == (b, 4 * N, 4)
    assert_gt_equal(got_gt, want_gt)
    # scores ride with their tiles; gray where no content covers (content-aware)
    assert not np.array_equal(got_gt.scores.numpy(), np.tile(g[1], (1, 4)))
    assert ((got_img == PM.PAD_GRAY).all(-1).any()) == aware
    assert 0 < int(got_gt.valid.sum()) < int(np.asarray(_tile_valid(g[3])).sum())


def _tile_valid(v):
    return np.concatenate([np.roll(v, -k, 0) for k in range(4)], 1)


# ---------------------------------------------------------------- mixup
MIXUP_CASES = {
    "plain": (None, False, None),
    "flip": (None, True, None),
    "content_flip": ([(50, 100), (64, 128), (40, 90), (60, 120)], True, None),
    "content_no_flip": ([(64, 100), (48, 128), (40, 90), (60, 120)], False, None),
    "jitter_flip": (None, True, (0.5, 1.5)),
    "content_jitter_flip": ([(50, 100), (64, 128), (40, 90), (60, 120)], True, (0.8, 1.6)),
}


@pytest.mark.parametrize("name", list(MIXUP_CASES))
def test_mixup_batch_equals_jax(name):
    content, flip, jitter = MIXUP_CASES[name]
    b = 4
    images, g, sizes = case(23, b, content)
    rng = jax.random.key(17)
    aware = content is not None

    def jax_fn(r, im, gt, s):
        return JM.mixup_batch(r, im, gt, flip=flip, scale_jitter=jitter, sizes=s)

    want_img, want_gt = jax.jit(jax_fn)(rng, jnp.asarray(images), jax_gt(g), jnp.asarray(sizes) if aware else None)
    fl, jit, off, crop = jax_mixup_draws(rng, b, CANVAS, sizes if aware else None)
    got_img, got_gt = PM.mixup_batch(
        T(images), port_gt(g), flip=fl if flip else None, scale_jitter=jitter, jitter=jit, jitter_offset=off,
        crop=crop, sizes=T(sizes) if aware else None,
    )
    assert got_gt.boxes.shape == (b, 2 * N, 4)
    if jitter is None:
        np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
        assert_gt_equal(got_gt, want_gt)
    else:
        np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=WARP_IMAGE_TOL)
        assert_gt_equal(got_gt, want_gt, box_tol=WARP_BOX_TOL)
    if flip:
        assert fl.any() and not fl.all()
    if aware:  # the origin's padding stays untouched: 0.5 * 0 + 0.5 * 0
        for i, (sh, sw) in enumerate(sizes):
            assert float(got_img[i, sh:].abs().sum()) == 0.0 and float(got_img[i, :, sw:].abs().sum()) == 0.0


# ---------------------------------------------------------------- affine
AFFINE_PARAMS = [
    (7.5, 1.2, 1.5, -0.8, 70.0, 30.0),
    (-10.0, 0.6, -2.0, 2.0, 50.0, 35.0),
    (0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
]


@pytest.mark.parametrize("params", AFFINE_PARAMS)
def test_affine_matrix_equals_jax(params):
    want = np.asarray(JM.affine_matrix(*(jnp.float32(p) for p in params)))
    got = PM.affine_matrix(*(torch.tensor([p], dtype=torch.float32) for p in params))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("params", AFFINE_PARAMS[:2])
@pytest.mark.parametrize("pad_val", [114.0, 0.0])
def test_affine_warp_and_boxes_equal_jax(params, pad_val):
    images, g, _ = case(31, 2)
    m = JM.affine_matrix(*(jnp.float32(p) for p in params))
    want = jax.vmap(lambda im: JM.affine_warp(im, m, pad_val))(jnp.asarray(images))
    want_boxes = jax.vmap(lambda bx: JM.affine_boxes(bx, m, CANVAS[1], CANVAS[0]))(jnp.asarray(g[0]))
    pm = T(np.asarray(m))[None].expand(2, 2, 3)
    got = PM.affine_warp(T(images), pm, pad_val)
    got_boxes = PM.affine_boxes(T(g[0]), pm, CANVAS[1], CANVAS[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=WARP_IMAGE_TOL)
    np.testing.assert_allclose(got_boxes.numpy(), np.asarray(want_boxes), rtol=0, atol=WARP_BOX_TOL)
    assert (got == pad_val).all(-1).any()  # corners mapped outside the source read pad_val


@pytest.mark.parametrize("seed", [3, 4])
def test_sample_affine_params_equal_jax(seed):
    rng = jax.random.key(seed)
    kw = dict(degrees=10.0, translate=0.1, scales=(0.5, 1.5), shear=2.0)
    want = JM.sample_affine_params(rng, (CANVAS[1], CANVAS[0]), **kw)
    u = T(uniforms(rng, 6))
    got = PM.sample_affine_params(u, (CANVAS[1], CANVAS[0]), **kw)
    for a, w in zip(got, want):
        assert float(a) == float(w)


@pytest.mark.parametrize("kw", [{}, {"degrees": 5.0, "translate": 0.2, "scales": (0.8, 1.2), "shear": 0.5}], ids=["yolox", "mild"])
def test_random_affine_batch_equals_jax(kw):
    images, g, _ = case(41, 4)
    rng = jax.random.key(29)
    want_img, want_gt = jax.jit(lambda r, im, gt: JM.random_affine_batch(r, im, gt, **kw))(rng, jnp.asarray(images), jax_gt(g))
    got_img, got_gt = PM.random_affine_batch(jax_affine_draws(rng, 4), T(images), port_gt(g), **kw)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=WARP_IMAGE_TOL)
    assert_gt_equal(got_gt, want_gt, box_tol=WARP_BOX_TOL)
    assert not np.array_equal(got_gt.boxes.numpy(), g[0])


@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_nonempty_threshold_equals_jax(threshold):
    rs = np.random.RandomState(2)
    xy = rs.uniform(0, 50, (64, 2))
    wh = rs.choice([-1.0, 0.0, 1.0, 2.0, 2.0001, 3.0, 10.0], (64, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    got = nonempty(T(boxes), threshold).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_nonempty(jnp.asarray(boxes), threshold)))
    assert got.any() and not got.all()
    if threshold == 0.0:
        np.testing.assert_array_equal(got, nonempty(T(boxes)).numpy())  # the default keeps its meaning
