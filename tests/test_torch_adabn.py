"""AdaBN and PreciseBN of the port against the JAX package's, on the CPU
(configs/synthetic_tiny.yaml: VGG16-BN, 128x256, batch 2), from the same
weights (checkpoint/from_jax.py) on the same 4 batches.

  - reset_bn_stats: means 0 and variances 1, exactly.
  - refine_bn_stats, test_refinement, adabn_refinement: the running
    statistics within REFINE_TOL of each tensor's largest entry. Each
    refinement is 4 train-mode forwards, each moving the statistics by 0.1
    of the batch's: the batch statistics of the two packages differ by the
    convolutions' float32 summation order, which for the port's CPU
    convolutions depends on torch's thread count, and flax computes the
    variance as E[x^2] - E[x]^2. Measured at most 9.6e-5 with 1 thread,
    6.0e-5 with 2, 2.9e-5 with 4 and 1.9e-5 with 8, always on the second
    BatchNorm's mean (entries up to 0.35; 3.6e-5 of that layer's standard
    deviation at 1 thread).
  - precise_bn: within PRECISE_TOL. The port reads each batch's statistics
    directly; the JAX package recovers them from its EMA as
    (new - 0.9 old) / 0.1, which adds float32 rounding of about
    10 * 2^-24 * (|new| + 0.9 |old|) to each batch's value, on top of the
    summation-order differences above (measured at most 1.5e-4 with 1
    thread, 9.5e-5 with 2, 4.6e-5 with 4, 2.5e-5 with 8).
Both tolerances are twice the worst of those measurements, so that the
tests hold on a machine of any core count.
On a cut ResNet-101 the refinement is held the same way for NORM BN; for
FrozenBN the port departs from the JAX package on purpose (the frozen
statistics stay as loaded; the JAX reset zeroes them).
Evaluation after a refinement is held to the JAX eval loop by
test_torch_eval_loop.py; here both write their results and the port its
`adabn.pth`.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.engine.hooks import precise_bn as jax_precise_bn
from simple_sfod_tpu.engine.trainers import build_trainer as jax_build_trainer
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import get_cfg
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine import trainers
from simple_sfod_tpu_torch.engine.hooks import precise_bn
from test_torch_train_loop import free_disk, register_tiny, tiny_cfg  # noqa: F401  (free_disk: autouse)

REFINE_TOL = 2e-4
PRECISE_TOL = 3e-4
BATCHES = 4


def batches():
    records = make_synthetic_records(2 * BATCHES, (120, 250), 4, 6, seed=11)
    return [synthetic_batch(records[2 * i:2 * i + 2], (128, 256), 8) for i in range(BATCHES)]


def bn_stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def assert_stats_close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        err = (got[k] - want[k]).abs().max().item()
        assert err <= tol * want[k].abs().max().item() + 1e-12, (k, err)


class Pair:
    """A JAX BaseTrainer and the port's from its weights."""

    def __init__(self, out):
        register_tiny()
        self.jax = jax_build_trainer(tiny_cfg(jax_get_cfg, out / "jax"), synthetic=True)
        self.cfg = tiny_cfg(get_cfg, out / "port")
        self.init = self.jax.state

    def port(self):
        variables = jax.tree_util.tree_map(np.asarray, self.init.variables())
        tr = trainers.build_trainer(self.cfg, device="cpu", synthetic=True)
        tr.state.model.load_state_dict(state_dict_from_jax(variables, tr.det_cfg))
        return tr

    def jax_stats(self):
        variables = jax.tree_util.tree_map(np.asarray, self.jax.state.variables())
        return bn_stats(state_dict_from_jax(variables, self.port().det_cfg))

    def reset_jax(self):
        self.jax.state = self.init


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("adabn")
    yield Pair(out)
    shutil.rmtree(out, ignore_errors=True)


def test_reset_bn_stats_equals_jax(pair):
    pair.reset_jax()
    pair.jax.reset_bn_stats()
    tr = pair.port()
    tr.reset_bn_stats()
    got, want = bn_stats(tr.state.model.state_dict()), pair.jax_stats()
    assert_stats_close(got, want, 0.0)
    assert all(torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v)) for k, v in got.items())


def test_refine_bn_stats_equals_jax(pair):
    pair.reset_jax()
    pair.jax.refine_bn_stats(max_batches=BATCHES, loader=batches())
    tr = pair.port()
    before = bn_stats({k: v.clone() for k, v in tr.state.model.state_dict().items()})
    assert tr.refine_bn_stats(max_batches=BATCHES, loader=batches()) == BATCHES
    got = bn_stats(tr.state.model.state_dict())
    assert_stats_close(got, pair.jax_stats(), REFINE_TOL)
    assert all(not torch.equal(got[k], before[k]) for k in got)


@pytest.mark.parametrize("which", ["test_refinement", "adabn_refinement"])
def test_refinement_then_test_equals_jax(pair, which):
    pair.reset_jax()
    jax_results = getattr(pair.jax, which)(max_batches=BATCHES, loader=batches())
    tr = pair.port()
    results = getattr(tr, which)(max_batches=BATCHES, loader=batches())
    got = bn_stats(tr.state.model.state_dict())
    assert_stats_close(got, pair.jax_stats(), REFINE_TOL)
    assert results.keys() == jax_results.keys() == {"synthetic_test"}
    saved = tr.checkpointer.load("adabn")
    assert_stats_close(bn_stats(saved["model"]), got, 0.0)
    assert os.path.exists(os.path.join(tr.output_dir, "eval_results.json"))


def test_precise_bn_equals_jax(pair):
    tr = pair.port()
    variables = jax.tree_util.tree_map(np.asarray, pair.init.variables())
    stats = jax_precise_bn(pair.jax.detector, variables, iter(batches()), num_iter=BATCHES - 1)
    want = bn_stats(state_dict_from_jax({"params": variables["params"], "batch_stats": stats}, tr.det_cfg))
    assert precise_bn(tr.detector, batches(), num_iter=BATCHES - 1) == BATCHES - 1
    assert_stats_close(bn_stats(tr.state.model.state_dict()), want, PRECISE_TOL)


def test_precise_bn_runs_before_test(tmp_path, monkeypatch):
    """TEST.PRECISE_BN: test() first sets the student's statistics to
    precise_bn over NUM_ITER batches of the train loader (the adaptation
    trainer's target loader here); the teacher's stay."""
    register_tiny()
    opts = ["TRAINER", "source_free_adaptive_teacher", "TEST.PRECISE_BN.ENABLED", "True", "TEST.PRECISE_BN.NUM_ITER", "2"]
    tr = trainers.build_trainer(tiny_cfg(get_cfg, tmp_path, *opts), device="cpu", synthetic=True)
    ref = trainers.build_trainer(tiny_cfg(get_cfg, tmp_path / "ref", *opts), device="cpu", synthetic=True)
    teacher = bn_stats({k: v.clone() for k, v in tr.state.teacher.state_dict().items()})
    calls = []
    monkeypatch.setattr(tr, "_evaluate", lambda detector, name, **kw: calls.append(name) or {"AP50": 0.0})
    tr.test()
    assert calls == ["synthetic_test", "synthetic_test"]
    assert precise_bn(ref.detector, ref.build_train_loader(), 2) == 2
    assert_stats_close(bn_stats(tr.state.model.state_dict()), bn_stats(ref.state.model.state_dict()), 0.0)
    assert_stats_close(bn_stats(tr.state.teacher.state_dict()), teacher, 0.0)


# ResNet-101 C4 through the tiny config: the backbone and its norm swapped
# in, the block plan cut to (1, 1, 2) stages up to res4
R101_OPTS = ["MODEL.BACKBONE.NAME", "build_resnet_backbone", "MODEL.RESNETS.DEPTH", "101",
             "MODEL.ROI_HEADS.IN_FEATURES", "('res4',)", "MODEL.RPN.IN_FEATURES", "('res4',)",
             "MODEL.ROI_BOX_HEAD.FC_DIM", "64"]
R101_CUT = (1, 1, 2, 1)


def cut_r101(monkeypatch):
    """Both packages' ResNet-101 block plans cut to R101_CUT."""
    from simple_sfod_tpu.checkpoint import torch_import
    from simple_sfod_tpu.models.backbones import resnet as jax_resnet
    from simple_sfod_tpu_torch.models.backbones import resnet

    for blocks in (jax_resnet.BLOCK_COUNTS, torch_import._RESNET_BLOCKS, resnet.BLOCK_COUNTS):
        monkeypatch.setitem(blocks, 101, R101_CUT)


@pytest.mark.parametrize("norm", ["BN", "FrozenBN"])
def test_adabn_on_resnet_against_jax(tmp_path, monkeypatch, norm):
    """AdaBN (reset, then refine over 4 batches) on a cut ResNet-101 from the
    same weights and random statistics. BN: every statistic as the JAX
    package's within REFINE_TOL, the stem and res2 included (FREEZE_AT
    freezes their parameters, not their statistics, in both packages). FrozenBN:
    the JAX reset zeroes the frozen statistics and nothing recomputes them
    (the reference's fault, simple_sfod_tpu/engine/trainers/base.py:646-656);
    the port keeps them as loaded and refines nothing, as Detectron2's
    FrozenBatchNorm2d, which AdaBN does not touch."""
    cut_r101(monkeypatch)
    register_tiny()
    opts = R101_OPTS + ["MODEL.RESNETS.NORM", norm]
    jtr = jax_build_trainer(tiny_cfg(jax_get_cfg, tmp_path / "jax", *opts), synthetic=True)
    rs = np.random.RandomState(5)
    jtr.state = jtr.state.replace(batch_stats=jax.tree_util.tree_map(
        lambda x: rs.uniform(0.5, 2.0, x.shape).astype(np.float32), jtr.state.batch_stats))
    variables = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    tr = trainers.build_trainer(tiny_cfg(get_cfg, tmp_path / "port", *opts), device="cpu", synthetic=True)
    tr.state.model.load_state_dict(state_dict_from_jax(variables, tr.det_cfg))
    loaded = bn_stats({k: v.clone() for k, v in tr.state.model.state_dict().items()})
    assert len(loaded) == 2 * (1 + 3 * sum(R101_CUT[:3]) + 3)

    jtr.reset_bn_stats()
    jtr.refine_bn_stats(max_batches=BATCHES, loader=batches())
    tr.reset_bn_stats()
    assert tr.refine_bn_stats(max_batches=BATCHES, loader=batches()) == BATCHES
    got = bn_stats(tr.state.model.state_dict())
    want = bn_stats(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtr.state.variables()), tr.det_cfg))
    if norm == "BN":
        assert len(tr._batchnorms()) == len(loaded) // 2
        assert_stats_close(got, want, REFINE_TOL)
        stem = [k for k in got if k.startswith(("backbone.stem.", "backbone.res2."))]
        assert stem and all(not torch.equal(got[k], torch.zeros_like(got[k]) if k.endswith("mean")
                                            else torch.ones_like(got[k])) for k in stem)
    else:
        assert tr._batchnorms() == []
        assert_stats_close(got, loaded, 0.0)
        assert all(torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))
                   for k, v in want.items())
