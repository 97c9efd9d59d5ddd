"""The port's NMS (simple_sfod_tpu_torch/ops/nms.py) against the JAX package
on the CPU: the plain suppression relation against the Pallas kernel in
interpret mode, the keep masks against nms_mask_matrix, nms_mask_pallas and
the sequential golden NMS, all exactly (same float32 operation order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import golden
from simple_sfod_tpu.ops.nms import batched_class_nms as jax_batched_class_nms
from simple_sfod_tpu.ops.nms import nms_mask_matrix as jax_nms_mask_matrix
from simple_sfod_tpu.ops.pallas_kernels import nms_mask_pallas, suppress_relation
from simple_sfod_tpu_torch.ops import _kernels, nms


def make_case(seed, n, tie=True, invalid=0.1, zero_area=True, extent=60.0):
    """Seeded boxes with exact score ties, zero-area and invalid boxes."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(1, extent / 3, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    if zero_area:
        boxes[::7, 2] = boxes[::7, 0]
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if tie:
        scores = np.round(scores, 1).astype(np.float32)
    valid = rng.rand(n) >= invalid
    return boxes, scores, valid


def t(a):
    return torch.from_numpy(np.asarray(a))


CASES = [(1, 0.5), (37, 0.5), (64, 0.7), (65, 0.5), (200, 0.7), (300, 0.5)]


@pytest.mark.parametrize("n,thr", CASES)
def test_relation_matches_pallas_interpret(n, thr):
    boxes, scores, valid = make_case(n, n)
    order = nms.score_order(t(scores), t(valid))
    sb, sv = t(boxes)[order], t(valid)[order]
    got = nms.suppress_relation_plain(sb, sv, thr).numpy()
    want = np.asarray(suppress_relation(jnp.asarray(sb.numpy()), jnp.asarray(sv.numpy()), thr, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,thr", CASES)
def test_keep_matches_jax_and_golden(n, thr):
    boxes, scores, valid = make_case(n + 1, n)
    got = nms.nms_mask_matrix(t(boxes), t(scores), t(valid), thr).numpy()
    jb, js, jv = jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)
    np.testing.assert_array_equal(got, np.asarray(jax_nms_mask_matrix(jb, js, jv, thr)))
    np.testing.assert_array_equal(got, np.asarray(nms_mask_pallas(jb, js, jv, thr, interpret=True)))
    # golden greedy NMS over the valid subset
    idx = np.nonzero(valid)[0]
    want = set(idx[golden.greedy_nms(boxes[idx], scores[idx], thr)].tolist())
    assert set(np.nonzero(got)[0].tolist()) == want


@pytest.mark.parametrize("n,thr", [(64, 0.5), (300, 0.5), (1024, 0.5)])
def test_batched_class_nms_matches_jax(n, thr):
    boxes, scores, valid = make_case(n + 2, n, extent=200.0)
    classes = np.random.RandomState(n).randint(0, 8, n).astype(np.int32)
    got = nms.batched_class_nms(t(boxes), t(scores), t(classes), t(valid), thr).numpy()
    want = jax_batched_class_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid), thr
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def test_keep_n1024_matches_jax_matrix():
    """The detection NMS's size: N = 1024 at IoU 0.5, clustered boxes."""
    boxes, scores, valid = make_case(7, 1024, extent=300.0)
    got = nms.nms_mask_matrix(t(boxes), t(scores), t(valid), 0.5).numpy()
    want = jax_nms_mask_matrix(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_all_invalid_keeps_nothing():
    boxes, scores, _ = make_case(3, 100)
    got = nms.nms_mask_matrix(t(boxes), t(scores), torch.zeros(100, dtype=torch.bool), 0.5)
    assert not got.any()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 130])
def test_pack_unpack_round_trip(n):
    rng = np.random.RandomState(n)
    rel = t(rng.rand(n, n) > 0.5)
    bits = nms.pack_bits(rel)
    assert bits.shape == (n, (n + 63) // 64) and bits.dtype == torch.int64
    np.testing.assert_array_equal(nms.unpack_bits(bits, n).numpy(), rel.numpy())
    # bit j % 64 of word j // 64, the uint64 layout of the CUDA kernel
    i, j = np.nonzero(rel.numpy())
    for a, b in list(zip(i.tolist(), j.tolist()))[:50]:
        word = int(bits[a, b // 64]) & ((1 << 64) - 1)
        assert (word >> (b % 64)) & 1


def test_cpu_path_uses_plain_versions_and_leaves_counters():
    """On CPU tensors the wrappers run the plain versions; the launch counts
    belong to the CUDA kernels alone."""
    _kernels.reset_launches()
    boxes, scores, valid = make_case(11, 150)
    order = nms.score_order(t(scores), t(valid))
    sb, sv = t(boxes)[order].contiguous(), t(valid)[order].contiguous()
    rel = nms.suppress_relation_plain(sb, sv, 0.5)
    bits = nms.suppress_relation_bits(sb, sv, 0.5)
    np.testing.assert_array_equal(bits.numpy(), nms.pack_bits(rel).numpy())
    keep = nms.greedy_keep_from_bits(bits, sv)
    np.testing.assert_array_equal(keep.numpy(), nms.greedy_keep_plain(rel, sv).numpy())
    assert _kernels.LAUNCHES == {"suppress_relation_bits": 0, "greedy_keep_from_bits": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    sb = torch.zeros((8, 4))
    sv = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.launch_suppress_relation_bits(sb, sv, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.launch_greedy_keep_from_bits(torch.zeros((8, 1), dtype=torch.int64), sv)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build("nms", build_dir=str(tmp_path / "build"))
