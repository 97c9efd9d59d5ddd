"""Box math, anchors and Instances of the port against the JAX package on
the CPU, on seeded numpy inputs. The float32 operation order is the same, so
most results are compared exactly; exp() differs by an ulp between the two
libraries, so decoded boxes get a relative tolerance of 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from simple_sfod_tpu.ops import anchors as jax_anchors
from simple_sfod_tpu.structures import boxes as jax_boxes
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.ops import anchors
from simple_sfod_tpu_torch.structures import boxes
from simple_sfod_tpu_torch.structures.instances import Instances, topk_indices


def rand_boxes(seed, n, extent=100.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-10, extent, (n, 2))
    wh = rng.uniform(-5, extent / 2, (n, 2))  # some degenerate (negative side)
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_area_nonempty_clip(seed):
    b = rand_boxes(seed, 50)
    np.testing.assert_array_equal(boxes.area(t(b)).numpy(), np.asarray(jax_boxes.area(jnp.asarray(b))))
    np.testing.assert_array_equal(boxes.nonempty(t(b)).numpy(), np.asarray(jax_boxes.nonempty(jnp.asarray(b))))
    size = np.asarray([70, 90], np.int32)
    got = boxes.clip_boxes(t(b), t(size)).numpy()
    want = np.asarray(jax_boxes.clip_boxes(jnp.asarray(b), jnp.asarray(size)))
    np.testing.assert_array_equal(got, want)


def test_clip_boxes_per_class_layout():
    """[R, C, 4] boxes clipped by one [2] size, as roi_inference does."""
    b = rand_boxes(5, 24).reshape(3, 8, 4)
    size = np.asarray([40, 55], np.int32)
    got = boxes.clip_boxes(t(b), t(size)).numpy()
    want = np.asarray(jax_boxes.clip_boxes(jnp.asarray(b), jnp.asarray(size)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_iou(seed):
    a, b = rand_boxes(seed, 30), rand_boxes(seed + 10, 40)
    got = boxes.pairwise_iou(t(a), t(b)).numpy()
    want = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    # and against the float64 golden oracle (float32 rounding only)
    np.testing.assert_allclose(got, golden.iou_matrix(a, b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_decode_deltas_with_clamp(weights):
    rng = np.random.RandomState(3)
    b = np.abs(rand_boxes(3, 40)) + np.asarray([0, 0, 50, 50], np.float32)
    d = rng.normal(0, 2, (40, 8 * 4)).astype(np.float32)
    d[:5, 2::4] = 50.0  # far past the scale clamp
    got = boxes.BoxTransform(weights).apply_deltas(t(d), t(b)).numpy()
    want = np.asarray(jax_boxes.BoxTransform(weights).apply_deltas(jnp.asarray(d), jnp.asarray(b)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("sizes,ratios", [((32, 64, 128, 256, 512), (0.5, 1.0, 2.0)), ((16, 48), (1.0,))])
def test_cell_anchors(sizes, ratios):
    np.testing.assert_array_equal(
        anchors.generate_cell_anchors(sizes, ratios), jax_anchors.generate_cell_anchors(sizes, ratios)
    )


@pytest.mark.parametrize("hw,stride", [((19, 38), 32), ((4, 8), 32), ((5, 3), 16)])
def test_anchor_grid(hw, stride):
    got = anchors.generate_anchors(hw, stride).numpy()
    want = np.asarray(jax_anchors.generate_anchors(hw, stride))
    assert got.shape == (hw[0] * hw[1] * 15, 4)
    np.testing.assert_array_equal(got, want)


def test_main_config_anchor_count():
    """vgg4 is stride 32: a 608x1216 canvas gives a 19x38 grid, 10,830 anchors."""
    assert anchors.generate_anchors((608 // 32, 1216 // 32), 32).shape[0] == 10830


@pytest.mark.parametrize("n,k", [(50, 10), (300, 128), (10830, 4096)])
def test_topk_indices_ties_match_lax_top_k(n, k):
    """Many exact ties at the boundary, as bf16-rounded RPN logits give."""
    rng = np.random.RandomState(n)
    key = np.round(rng.normal(0, 1, n), 1).astype(np.float32)
    key[rng.rand(n) < 0.1] = -np.inf  # and the rounding leaves -0.0 beside +0.0
    _, want = jax.lax.top_k(jnp.asarray(key), k)
    np.testing.assert_array_equal(topk_indices(t(key), k).numpy(), np.asarray(want))


def test_topk_indices_total_order():
    key = np.array([0.0, -0.0, np.nan, 1.0, -np.inf, np.inf, -1.0, -0.0], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(key), 8)
    np.testing.assert_array_equal(topk_indices(t(key), 8).numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_instances_top_k_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = 64
    b = rand_boxes(seed, n)
    s = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)
    c = rng.randint(0, 8, n).astype(np.int32)
    v = rng.rand(n) > 0.3
    got = Instances(t(b), t(s), t(c), t(v)).top_k(20)
    want = JaxInstances(jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), jnp.asarray(v)).top_k(20)
    for f in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    masked = Instances(t(b), t(s), t(c), t(v)).mask(t(s > 0.5))
    np.testing.assert_array_equal(masked.valid.numpy(), v & (s > 0.5))
