"""Box-head dropout, MC dropout and the TCD loss in the port
(models/heads.py, models/uncertainty.py, losses/tcd.py and the keep masks
in every trainer's draws) against the JAX package's, on the CPU in float32.

The port cannot draw flax's bits (flax folds each Dropout's key by its
module path), so the masks cross over: `flax_dropout_masks`
(test_torch_sfat_trainer.py) records every mask flax draws while a JAX
function is traced and run, in trace order, and the port gets them as its
keep masks. For MC dropout, flax's K passes are vmapped over K keys; the
masks of each key are recorded from the JAX box head called with that key
alone (vmapped random bits equal the per-key ones), stacked pass-major.

Tolerances:
  the head on given masks     1e-6 of the output's largest entry (fc sums
                              in another order; dropout scales exactly)
  2-step base lockstep        test_torch_trainer.py's: each loss 1e-4
                              relative, the counts equal, every tensor
                              within 1e-4 of its largest entry plus 25% of
                              what the steps moved it
  mc_dropout_box_outputs      1e-5 absolute on the mean and the std of the
                              softmax, the valid set equal, proposal boxes
                              1e-4 relative plus 1e-3 px (the backbone's
                              float32 sums in another order move the RPN
                              deltas by about 1e-5 relative)
  tcd_loss                    exact
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.loader import gt_instances as jax_gt_instances
from simple_sfod_tpu.engine.trainers.base import BaseTrainer as JaxBaseTrainer
from simple_sfod_tpu.losses.tcd import tcd_loss as jax_tcd_loss
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.models.heads import FastRCNNConvFCHead as JaxHead
from simple_sfod_tpu.models.uncertainty import mc_dropout_box_outputs as jax_mc_dropout
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.checkpoint.from_jax import _dense, _fc0, state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.config.defaults import SOURCE_CONFIG, config_opts
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer
from simple_sfod_tpu_torch.losses.tcd import tcd_loss
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.models.faster_rcnn import anchors_for, roi_pool_size
from simple_sfod_tpu_torch.models.heads import FastRCNNConvFCHead
from simple_sfod_tpu_torch.models.uncertainty import mc_dropout_box_outputs
from simple_sfod_tpu_torch.structures.instances import Instances
from test_torch_imagenet_init import seeded_tree
from test_torch_sfat_trainer import flax_dropout_masks
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)
from test_torch_trainer import LOCKSTEP_OPTS, LOSSES, jax_step_draws, rel_err, within_tolerance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (64, 128)
GT_CAP = 8
BATCH = 2
DROPOUT = ["MODEL.ROI_BOX_HEAD.DROPOUT", "0.5"]


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_head_on_flax_masks_equals_flax(rate):
    """The port's FastRCNNConvFCHead on the masks flax drew equals flax's
    train-mode head (Dropout after each fc's ReLU, x / (1 - rate)); masks
    of 3N rows run 3 passes of N rows at once and equal 3 calls; without
    masks the head is flax's deterministic one."""
    n, p, c, fc = 40, 2, 4, 64
    head = JaxHead(fc_dims=(fc, fc), dropout=rate)
    x = np.random.RandomState(0).normal(0, 1, (n, p, p, c)).astype(np.float32)
    variables = head.init(jax.random.key(0), jnp.asarray(x))
    with flax_dropout_masks() as masks:
        want = head.apply(variables, jnp.asarray(x), True, rngs={"dropout": jax.random.key(3)})
        jax.effects_barrier()
    assert len(masks) == 2 and masks[0].shape == (n, fc) and 0.3 < masks[0].mean() < 0.95
    port = FastRCNNConvFCHead(p * p * c, fc, 2, rate)
    params = variables["params"]
    with torch.no_grad():
        port.fc1.weight.copy_(T(_fc0(params["fc0"]["kernel"], p, c)))
        port.fc2.weight.copy_(T(_dense(params["fc1"]["kernel"])))
        port.fc1.bias.copy_(T(params["fc0"]["bias"]))
        port.fc2.bias.copy_(T(params["fc1"]["bias"]))
        xt = T(x.transpose(0, 3, 1, 2))
        got = port(xt, tuple(T(m) for m in masks))
        det = port(xt)
        stacked = port(xt, tuple(torch.cat([T(m)] * 3) for m in masks))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    deterministic = np.asarray(head.apply(variables, jnp.asarray(x), False))
    assert np.abs(det.numpy() - deterministic).max() <= 1e-6 * np.abs(deterministic).max()
    assert torch.equal(stacked, torch.cat([got] * 3))
    with pytest.raises(ValueError, match="without dropout"):
        FastRCNNConvFCHead(p * p * c, fc, 2, 0.0)(xt, tuple(T(m) for m in masks))


# ---------------------------------------------------------------------------
# the base step with dropout, 2 steps against the JAX BaseTrainer
# ---------------------------------------------------------------------------


def lockstep_cfg(get, tmp_path):
    cfg = get()
    cfg.merge_from_list(config_opts(SOURCE_CONFIG) + config_opts(LOCKSTEP_OPTS) + DROPOUT)
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def test_lockstep_two_base_steps_with_dropout_against_jax(tmp_path):
    jtr = JaxBaseTrainer(lockstep_cfg(jax_get_cfg, tmp_path))
    pcfg_node = lockstep_cfg(get_cfg, tmp_path)
    pcfg = detector_config_from_cfg(pcfg_node)
    assert pcfg.box_head_dropout == jtr.det_cfg.box_head_dropout == 0.5
    init = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    start = state_dict_from_jax(init, pcfg)
    ptr = BaseTrainer(pcfg_node, device="cpu", state_dict=start)
    n = anchors_for(pcfg, CANVAS, torch.device("cpu")).shape[0]
    pool = roi_pool_size(pcfg, n, GT_CAP)
    records = make_synthetic_records(BATCH * 2, (60, 120), 8, 6, seed=3)
    state = jtr.state
    with flax_dropout_masks() as masks:
        jax_step = jax.jit(jtr._step_fn_raw)
        for step in range(2):
            batch = synthetic_batch(records[step * BATCH:(step + 1) * BATCH], CANVAS, GT_CAP)
            state, jm = jax_step(state, jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"]),
                                 jax_gt_instances(batch), jtr.base_rng)
            jax.effects_barrier()
            rows = BATCH * pcfg.roi_batch_size_per_image
            assert len(masks) == 2 and all(m.shape == (rows, pcfg.fc_dim) for m in masks)
            draws = jax_step_draws(jtr.base_rng, step, BATCH, n, pool)._replace(
                box_keep=tuple(T(m) for m in masks))
            pm = ptr.run_step(batch, draws)
            for k in LOSSES:
                assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (step, k, float(pm[k]), float(jm[k]))
            for k in ("num_fg", "num_sampled"):
                assert int(pm[k]) == int(jm[k]), (step, k)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()), pcfg)
    got = ptr.state.model.state_dict()
    bad = [k for k in want if not k.endswith("num_batches_tracked") and not within_tolerance(got[k], want[k], start[k])]
    assert not bad, bad


# ---------------------------------------------------------------------------
# every trainer builds and steps with dropout; inference stays deterministic
# ---------------------------------------------------------------------------

TRAINERS = {
    "base": ("faster_rcnn_VGG_cityscapes_source_new.yaml", []),
    "sfat": ("faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml", []),
    "sfat_single": ("faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml",
                    ["TRAINER", "source_free_adaptive_teacher_single"]),
    "adaptive_teacher": ("faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher.yaml", []),
    "wq": ("faster_rcnn_VGG_cityscapes_foggy_source_wq.yaml", []),
    "da": ("faster_rcnn_VGG_cityscapes_da.yaml", []),
}
SMALL = ["MODEL.ROI_BOX_HEAD.FC_DIM", "64", "TPU.CANVAS", str(CANVAS), "TPU.GT_CAPACITY", str(GT_CAP),
         "TPU.DTYPE", "float32", "SOLVER.IMS_PER_BATCH", "1", "SOLVER.IMS_PER_BATCH_TARGET", "1",
         "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "64", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "VIS_PERIOD", "0"]


@pytest.mark.parametrize("name", list(TRAINERS))
def test_every_trainer_builds_and_steps_with_dropout(tmp_path, name):
    """MODEL.ROI_BOX_HEAD.DROPOUT 0.5 builds each trainer family; its own
    draws carry one keep mask a fc layer for each losses call on the
    student's ROI batch (two calls in the adaptive teacher), and a step
    gives finite losses."""
    yaml, extra = TRAINERS[name]
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", yaml), allow_new=True)
    cfg.merge_from_list(SMALL + DROPOUT + extra + ["OUTPUT_DIR", str(tmp_path)])
    tr = build_trainer(cfg, device="cpu")
    assert tr.detector.model.roi_heads.box_head.dropout == 0.5
    batch = synthetic_batch(make_synthetic_records(1, (60, 120), 8, 6, seed=1), CANVAS, GT_CAP)
    staged = tr.stage(batch, batch) if hasattr(tr, "next_target") else tr.stage(batch)
    draws = tr.make_draws(*((1, CANVAS) if len(staged) == 2 else (1, CANVAS, GT_CAP)))
    rows = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    keeps = [draws.box_keep] + ([draws.box_keep_t] if name == "adaptive_teacher" else [])
    assert [tuple(k.shape for k in keep) for keep in keeps] == (
        [((2 * rows, 64),) * 2, ((rows, 64),) * 2] if name == "adaptive_teacher" else [((rows, 64),) * 2])
    metrics = tr.step_staged(staged, draws)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics


def test_inference_and_box_features_stay_deterministic():
    """With dropout the detector's inference, its box-head features for the
    instance classifiers and its pseudo-labels equal the same weights'
    without dropout, bit for bit."""
    cfgs = []
    for opts in (DROPOUT, []):
        c = get_cfg()
        c.merge_from_list(config_opts(SOURCE_CONFIG) + config_opts(LOCKSTEP_OPTS) + opts)
        cfgs.append(detector_config_from_cfg(c))
    from simple_sfod_tpu_torch.models.faster_rcnn import init_weights

    a = Detector(cfgs[0], device="cpu")
    init_weights(a.model, 0)
    b = Detector(cfgs[1], device="cpu").load_state_dict(a.model.state_dict())
    batch = synthetic_batch(make_synthetic_records(2, (60, 120), 8, 6, seed=2), CANVAS, GT_CAP)
    images, sizes = T(batch["images"]), T(batch["sizes"])
    for x, y in ((a.infer(images, sizes), b.infer(images, sizes)),
                 (a.pseudo_labels(images, sizes), b.pseudo_labels(images, sizes))):
        assert all(torch.equal(getattr(x, f), getattr(y, f)) for f in ("boxes", "scores", "classes", "valid"))
    with torch.no_grad():
        fa, va = a.box_features(images, sizes)
        fb, vb = b.box_features(images, sizes)
    assert torch.equal(fa, fb) and torch.equal(va, vb)


# ---------------------------------------------------------------------------
# MC dropout and TCD
# ---------------------------------------------------------------------------


def test_mc_dropout_box_outputs_against_jax(num_samples=4):
    cfgs = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_list(config_opts(SOURCE_CONFIG) + config_opts(LOCKSTEP_OPTS) + DROPOUT)
        cfgs.append(c)
    pcfg, jcfg = detector_config_from_cfg(cfgs[0]), jax_lower(cfgs[1])
    variables = seeded_tree(jcfg, seed=4)
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    jdet = JaxDetector(jcfg)
    batch = synthetic_batch(make_synthetic_records(2, (60, 120), 8, 6, seed=5), CANVAS, GT_CAP)
    rng = jax.random.key(7)
    want = jax.jit(lambda v, i, s, r: jax_mc_dropout(jdet, v, i, s, r, num_samples))(
        variables, jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"]), rng)
    b, r = want[2].shape[:2]
    pooled = jnp.zeros((b * r, pcfg.pooler_resolution, pcfg.pooler_resolution, pcfg.feature_channels))
    per_key = []
    with flax_dropout_masks() as masks:
        for k in jax.random.split(rng, num_samples):
            jdet._box(variables, pooled, train=True, rngs={"dropout": k})
            jax.effects_barrier()
            per_key.append([m.copy() for m in masks[-2:]])
    keep = tuple(T(np.concatenate([pk[i] for pk in per_key])) for i in range(2))
    mean, std, boxes, valid = mc_dropout_box_outputs(det, batch["images"], batch["sizes"], num_samples, keep=keep)
    wv = np.asarray(want[3])
    np.testing.assert_array_equal(valid.numpy(), wv)
    assert wv.sum() > 0 and mean.shape == (b, r, pcfg.num_classes + 1)
    np.testing.assert_allclose(boxes.numpy()[wv], np.asarray(want[2])[wv], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mean.numpy()[wv], np.asarray(want[0])[wv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(std.numpy()[wv], np.asarray(want[1])[wv], rtol=0, atol=1e-5)
    assert float(std.max()) > 0
    with pytest.raises(ValueError, match="rows"):
        mc_dropout_box_outputs(det, batch["images"], batch["sizes"], num_samples + 1, keep=keep)


@pytest.mark.parametrize("case", ["mixed", "none_confident", "out_of_range_classes"])
def test_tcd_loss_equals_jax_exactly(case):
    rs = np.random.RandomState({"mixed": 0, "none_confident": 1, "out_of_range_classes": 2}[case])
    b, k, c = 3, 50, 8
    scores = rs.uniform(0, 1, (b, k)).astype(np.float32)
    if case == "none_confident":
        scores *= 0.4
    classes = rs.randint(0, c + (3 if case == "out_of_range_classes" else 0), (b, k)).astype(np.int32)
    valid = rs.uniform(0, 1, (b, k)) < 0.7
    target = rs.dirichlet(np.ones(c)).astype(np.float32)
    boxes = np.zeros((b, k, 4), np.float32)
    want = jax_tcd_loss(JaxInstances(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid)),
                        jnp.asarray(target))
    got = tcd_loss(Instances(T(boxes), T(scores), T(classes), T(valid)), T(target))
    assert got.dtype == torch.float32 and float(got) == float(want)
