"""The port's training primitives against the JAX package's on the CPU:
losses, box encoding and IoA, Instances.concatenate, the matcher, the
sampler (on the JAX package's own priorities) and the horizontal flip (on
its own bernoulli draws).

Tolerances: losses and box math 1e-6 relative (+ 1e-6 absolute where a
value can be 0: log and division may round one ulp apart); matcher, sampler,
flip and concatenate exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.data import transforms as jax_transforms
from simple_sfod_tpu.engine.trainers.base import apply_weak_aug as jax_apply_weak_aug
from simple_sfod_tpu.ops import losses as jax_losses
from simple_sfod_tpu.ops import matcher as jax_matcher
from simple_sfod_tpu.ops import sampler as jax_sampler
from simple_sfod_tpu.structures import boxes as jax_boxes
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.data import transforms
from simple_sfod_tpu_torch.engine.trainers.base import apply_weak_aug
from simple_sfod_tpu_torch.ops import losses, matcher, sampler
from simple_sfod_tpu_torch.structures import boxes
from simple_sfod_tpu_torch.structures.instances import Instances

def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def random_boxes(rs, n, extent=200.0, degenerate=True):
    xy = rs.uniform(-10, extent, (n, 2))
    wh = rs.uniform(0.5, 80, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if degenerate:
        b[::7, 2] = b[::7, 0]  # zero width
        b[::11, 3] = b[::11, 1] - 3.0  # negative height
    return b


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("beta", [0.0, 0.1, 1.0])
def test_smooth_l1(beta):
    rs = np.random.RandomState(0)
    p, t = rs.normal(0, 1, (2, 500, 4)).astype(np.float32)
    close(losses.smooth_l1(T(p), T(t), beta), jax_losses.smooth_l1(jnp.asarray(p), jnp.asarray(t), beta))


def test_sigmoid_ce_stable_for_large_logits():
    rs = np.random.RandomState(1)
    x = np.concatenate([rs.normal(0, 5, 1000), [-200.0, -50.0, 0.0, 50.0, 200.0]]).astype(np.float32)
    y = (rs.rand(x.size) < 0.5).astype(np.float32)
    got = losses.sigmoid_ce(T(x), T(y))
    assert torch.isfinite(got).all()
    close(got, jax_losses.sigmoid_ce(jnp.asarray(x), jnp.asarray(y)), atol=1e-6)


def test_softmax_ce_and_masked_reductions():
    rs = np.random.RandomState(2)
    logits = rs.normal(0, 3, (300, 9)).astype(np.float32)
    labels = rs.randint(0, 9, 300).astype(np.int32)
    mask = rs.rand(300) < 0.3
    ce = losses.softmax_ce(T(logits), T(labels))
    want = jax_losses.softmax_ce(jnp.asarray(logits), jnp.asarray(labels))
    close(ce, want, atol=1e-6)
    close(losses.masked_mean(ce, T(mask)), jax_losses.masked_mean(want, jnp.asarray(mask)))
    close(losses.masked_sum(ce, T(mask)), jax_losses.masked_sum(want, jnp.asarray(mask)))
    none = np.zeros(300, bool)
    assert float(losses.masked_mean(ce, T(none))) == 0.0 == float(jax_losses.masked_mean(want, jnp.asarray(none)))


# ---------------------------------------------------------------- boxes
def test_pairwise_ioa_and_iou():
    rs = np.random.RandomState(3)
    a, b = random_boxes(rs, 40), random_boxes(rs, 50)
    close(boxes.pairwise_ioa(T(a), T(b)), jax_boxes.pairwise_ioa(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(
        boxes.pairwise_iou(T(a), T(b)).numpy(), np.asarray(jax_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    )


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_encode_deltas_and_round_trip(weights):
    rs = np.random.RandomState(4)
    src, tgt = random_boxes(rs, 500), random_boxes(rs, 500)
    tf = boxes.BoxTransform(weights)
    got = tf.get_deltas(T(src), T(tgt))
    want = jax_boxes.BoxTransform(weights).get_deltas(jnp.asarray(src), jnp.asarray(tgt))
    assert torch.isfinite(got).all()
    close(got, want, atol=1e-6)
    # on proper boxes, inside the decoder's scale clamp, decoding the deltas
    # gives the target back
    ok = (src[:, 2] > src[:, 0]) & (src[:, 3] > src[:, 1]) & (tgt[:, 2] > tgt[:, 0]) & (tgt[:, 3] > tgt[:, 1])
    scaled = got[:, 2:].numpy() / np.asarray(weights[2:], np.float32)
    ok &= (scaled < boxes.DEFAULT_SCALE_CLAMP).all(1)
    back = tf.apply_deltas(got[ok], T(src[ok]))
    close(back, tgt[ok], rtol=0, atol=1e-3)


def test_instances_concatenate():
    rs = np.random.RandomState(5)
    parts = []
    for n in (7, 3):
        parts.append((random_boxes(rs, n), rs.rand(n).astype(np.float32), rs.randint(0, 8, n).astype(np.int32), rs.rand(n) < 0.5))
    got = Instances.concatenate(*(Instances(*(T(x) for x in p)) for p in parts))
    want = JaxInstances.concatenate(*(JaxInstances(*(jnp.asarray(x) for x in p)) for p in parts))
    for field in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


# ---------------------------------------------------------------- matcher
def matcher_case(seed, m=8, n=600, n_valid=5):
    """GT with padded rows, anchors with exact duplicates (ties of a GT's
    best IoU) and GT boxes among the anchors (IoU 1)."""
    rs = np.random.RandomState(seed)
    gt = random_boxes(rs, m, degenerate=False)
    anchors = random_boxes(rs, n, degenerate=False)
    anchors[100:110] = anchors[0]  # ties
    anchors[200] = gt[0]
    anchors[201] = gt[0]
    anchors[300] = gt[m - 1]  # a padded GT row: must not match
    valid = np.zeros(m, bool)
    valid[:n_valid] = True
    return gt, anchors, valid


@pytest.mark.parametrize("name", ["RPN_MATCHER", "ROI_MATCHER"])
@pytest.mark.parametrize("n_valid", [0, 1, 5, 8])
def test_match_boxes_exact(name, n_valid):
    gt, anchors, valid = matcher_case(n_valid, n_valid=n_valid)
    iou = boxes.pairwise_iou(T(gt), T(anchors))
    idx, labels = matcher.match_boxes(iou, T(valid), getattr(matcher, name))
    jidx, jlabels = jax_matcher.match_boxes(jnp.asarray(iou.numpy()), jnp.asarray(valid), getattr(jax_matcher, name))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert getattr(matcher, name) == tuple(getattr(jax_matcher, name))
    if n_valid == 0:
        assert (labels == 0).all()


def test_low_quality_ties_are_all_forced_positive():
    """A GT whose best IoU (below 0.7) is shared by several anchors makes
    every one of them positive."""
    gt = np.asarray([[0, 0, 100, 100]], np.float32)
    anchors = np.asarray([[0, 0, 100, 160]] * 3 + [[0, 0, 100, 200], [500, 500, 510, 510]], np.float32)
    iou = boxes.pairwise_iou(T(gt), T(anchors))
    _, labels = matcher.match_boxes(iou, torch.ones(1, dtype=torch.bool), matcher.RPN_MATCHER)
    _, jlabels = jax_matcher.match_boxes(jnp.asarray(iou.numpy()), jnp.ones(1, bool), jax_matcher.RPN_MATCHER)
    np.testing.assert_array_equal(labels.numpy(), [1, 1, 1, -1, 0])
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


# ---------------------------------------------------------------- sampler
SAMPLER_CASES = {
    # (n, num_samples, fraction, share positive, share ignored)
    "rpn few positives": (2000, 256, 0.5, 0.01, 0.2),
    "rpn many positives": (2000, 256, 0.5, 0.4, 0.2),
    "roi": (1064, 512, 0.25, 0.05, 0.0),
    "all ignored": (300, 64, 0.5, 0.0, 1.0),
    "fewer labels than samples": (40, 64, 0.5, 0.2, 0.1),
}


def sampler_labels(n, pos, ign, seed):
    rs = np.random.RandomState(seed)
    u = rs.rand(n)
    return np.where(u < pos, 1, np.where(u < pos + ign, -1, 0)).astype(np.int32)


@pytest.mark.parametrize("label", list(SAMPLER_CASES))
def test_subsample_labels_on_jax_priorities(label):
    n, s, frac, pos, ign = SAMPLER_CASES[label]
    labels = sampler_labels(n, pos, ign, len(label))
    key = jax.random.key(len(label))
    prio = np.asarray(jax.random.uniform(key, (n,)))  # the JAX sampler's own draw
    got = sampler.subsample_labels(T(labels), s, frac, T(prio))
    want = jax_sampler.subsample_labels(jnp.asarray(labels), s, frac, key)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sel = sampler.subsample_labels_mask(T(labels), s, frac, T(prio))
    jsel = jax_sampler.subsample_labels_mask(jnp.asarray(labels), s, frac, key)
    for g, w in zip(sel, jsel):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(sel[0].sum()) == int(got[2].sum())


def test_subsample_labels_ties_and_duplicate_filler(monkeypatch):
    """Tied priorities (ranked by lower index, as jax.lax.top_k) and filler
    slots repeating a sampled index: the mask keeps every sampled bit."""
    n, s = 50, 64
    labels = sampler_labels(n, 0.3, 0.1, 7)
    prio = np.round(np.random.RandomState(7).rand(n) * 4) / 4  # many exact ties, zeros included
    prio = prio.astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda rng, shape: jnp.asarray(prio))
    key = jax.random.key(0)
    got = sampler.subsample_labels(T(labels), s, 0.5, T(prio))
    want = jax_sampler.subsample_labels(jnp.asarray(labels), s, 0.5, key)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sel, sel_pos = sampler.subsample_labels_mask(T(labels), s, 0.5, T(prio))
    jsel, jsel_pos = jax_sampler.subsample_labels_mask(jnp.asarray(labels), s, 0.5, key)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(sel_pos.numpy(), np.asarray(jsel_pos))
    assert int(sel.sum()) == int(got[2].sum())


# ---------------------------------------------------------------- flip
def flip_case(seed, b=3, canvas=(16, 24)):
    rs = np.random.RandomState(seed)
    images = rs.uniform(0, 255, (b,) + canvas + (3,)).astype(np.float32)
    sizes = np.asarray([[canvas[0], w] for w in (24, 17, 9)[:b]], np.int32)
    for i, (_, w) in enumerate(sizes):
        images[i, :, w:] = 0.0
    gt_boxes = random_boxes(rs, b * 4, extent=10, degenerate=False).reshape(b, 4, 4)
    classes = rs.randint(0, 8, (b, 4)).astype(np.int32)
    valid = rs.rand(b, 4) < 0.7
    return images, sizes, gt_boxes, classes, valid


def test_hflip_exact():
    images, sizes, gt_boxes, _, _ = flip_case(0)
    for i in range(images.shape[0]):
        w = sizes[i, 1]
        got = transforms.hflip(T(images[i]), T(gt_boxes[i]), torch.tensor(w, dtype=torch.int32))
        want = jax_transforms.hflip(jnp.asarray(images[i]), jnp.asarray(gt_boxes[i]), jnp.int32(w))
        for g, v in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(v))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_weak_aug_on_jax_draws(seed):
    images, sizes, gt_boxes, classes, valid = flip_case(seed)
    rng = jax.random.key(seed)
    flips = np.asarray([jax.random.bernoulli(k, 0.5) for k in jax.random.split(rng, images.shape[0])])
    jgt = JaxInstances(jnp.asarray(gt_boxes), jnp.ones(classes.shape), jnp.asarray(classes), jnp.asarray(valid))
    want_img, want_gt = jax_apply_weak_aug(rng, jnp.asarray(images), jnp.asarray(sizes), jgt)
    gt = Instances(T(gt_boxes), torch.ones(classes.shape), T(classes), T(valid))
    got_img, got_gt = apply_weak_aug(T(flips), T(images), T(sizes), gt)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_gt.boxes.numpy(), np.asarray(want_gt.boxes))
    same_img, same_gt = apply_weak_aug(T(flips), T(images), T(sizes), gt, enabled=False)
    assert torch.equal(same_img, T(images)) and same_gt is gt
