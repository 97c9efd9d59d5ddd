"""The port's FPN detector (simple_sfod_tpu_torch/models/backbones/fpn.py and
the multi-level pipeline of models/faster_rcnn.py) against the JAX
package's, on the CPU in float32, at a 64x128 canvas with FPN OUT_CHANNELS
32 and FC_DIM 64 (configs/synthetic_tiny_fpn.yaml).

Tolerances:
  pyramid levels, pooled features   1e-5 of the tensor's largest entry (the
                                    rtol 1e-5 / atol 1e-5 of the slice,
                                    relative to the largest entry: the
                                    convs sum in another order); in train
                                    mode 1e-4, and the moved running
                                    statistics 1e-4 of each buffer's
                                    largest entry (flax's E[x^2] - E[x]^2
                                    variance, as tests/test_torch_resnet.py)
  assign_boxes_to_levels            exact (tests/test_fpn.py's golden table
                                    and seeded boxes)
  _propose_fpn                      keep set exact: the same proposals
                                    valid in the same slots; boxes 1e-4 px
  pool_rois                         bit-equal to pooling each box from its
                                    own level alone (the mask adds exact
                                    zeros), 1e-5 of the largest entry
                                    against JAX
  FPN losses on the JAX feature     1e-5 relative, counts equal
  the 1-step base lockstep          test_torch_trainer.py's bounds: each
                                    loss 1e-4 relative, counts equal, each
                                    parameter within 1e-4 of its largest
                                    entry plus 25% of what the step moved it

Weights cross by checkpoint/from_jax.py. The JAX package has no Detectron2
naming for an FPN tree: its `export_torch_checkpoint` raises KeyError
'conv0' (a fault of the reference, pinned here); the port writes
Detectron2's FPN names, held by value through the pyramid and heads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.checkpoint.torch_export import export_torch_checkpoint
from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.loader import gt_instances as jax_gt_instances
from simple_sfod_tpu.engine.trainers.base import BaseTrainer as JaxBaseTrainer
from simple_sfod_tpu.models import faster_rcnn as jfr
from simple_sfod_tpu.models.detector import DetectionBatch as JaxBatch
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine import export
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer
from simple_sfod_tpu_torch.models import faster_rcnn as pfr
from simple_sfod_tpu_torch.models.detector import DetectionBatch, Detector
from simple_sfod_tpu_torch.ops.roi_align import roi_align
from simple_sfod_tpu_torch.structures.instances import Instances
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)
from test_torch_trainer import jax_step_draws, rel_err, within_tolerance
from test_torch_train_model import jax_loss_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "synthetic_tiny_fpn.yaml")
CANVAS = (64, 128)
GT_CAP = 8
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg")
# (VGG.BN, MODEL.FPN.NORM, MODEL.FPN.FUSE_TYPE)
VARIANTS = {"bn": ("True", "", "sum"), "nobn_fpn_bn_avg": ("False", "BN", "avg")}


def T(a):
    return torch.from_numpy(np.array(a))


def cfg_pair(*opts, tmp_path=None):
    out = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_file(YAML)
        c.merge_from_list(list(opts))
        if tmp_path is not None:
            c.OUTPUT_DIR = str(tmp_path)
        out.append(c)
    return out


def variant_opts(name):
    bn, norm, fuse = VARIANTS[name]
    return ["VGG.BN", bn, "MODEL.FPN.NORM", norm, "MODEL.FPN.FUSE_TYPE", fuse]


def seeded_variables(jcfg, seed=0):
    """The JAX FasterRCNN's variables at its init's shapes (jax.eval_shape),
    filled with seeded values: kernels normal with std 1/sqrt(fan_in),
    biases normal(0, 0.05), BN scale uniform(0.5, 1.5), mean normal(0, 0.1),
    var uniform(0.5, 2)."""
    shapes = jax.eval_shape(lambda: jfr.FasterRCNN(jax_lower(jcfg)).init(
        jax.random.key(0), jnp.zeros((1, *CANVAS, 3), jnp.float32)))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return rs.normal(0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
        if name == "mean":
            return rs.normal(0, 0.1, leaf.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rs.uniform(0.5, 2.0 if name == "var" else 1.5, leaf.shape).astype(np.float32)
        return rs.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def pair():
    """The JAX detector and its seeded variables; the port's on the same weights."""
    pc, jc = cfg_pair()
    variables = seeded_variables(jc)
    pcfg = detector_config_from_cfg(pc)
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    return JaxDetector(jax_lower(jc)), variables, det


def images_of(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, *CANVAS, 3)).astype(np.uint8),
            np.asarray([[64, 128], [50, 100], [60, 120]][:n], np.int32))


def rel_max(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30)


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# configuration, modules, weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("yaml", ["synthetic_tiny_fpn.yaml", "vgg16_fpn_cityscapes_to_foggy_source.yaml"])
def test_fpn_yamls_lower_as_in_jax(yaml):
    pc, jc = get_cfg(), jax_get_cfg()
    for c in (pc, jc):
        c.merge_from_file(os.path.join(ROOT, "configs", yaml))
    got, want = detector_config_from_cfg(pc), jax_lower(jc)
    for f in ("fpn", "fpn_in_features", "fpn_out_channels", "rpn_in_features", "roi_in_features",
              "anchor_sizes_per_level", "in_feature", "vgg_bn", "rpn_pre_nms_topk_train", "rpn_post_nms_topk_test"):
        assert getattr(got, f) == getattr(want, f), f
    for prop in ("rpn_levels", "roi_levels", "level_anchor_sizes", "num_anchors", "stride", "feature_channels",
                 "dc_in_feature", "dc_stride", "dc_channels"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_config_errors_raised_as_in_jax():
    """tests/test_fpn.py's test_non_pyramid_in_feature_rejected and
    test_size_level_mismatch_rejected: the same conditions raise in both."""
    import dataclasses

    pc, jc = cfg_pair("MODEL.RPN.IN_FEATURES", "('vgg4',)")
    for lower, c in ((detector_config_from_cfg, pc), (jax_lower, jc)):
        with pytest.raises(ValueError, match="pyramid levels"):
            lower(c)
    pc, jc = cfg_pair()
    for c in (detector_config_from_cfg(pc), jax_lower(jc)):
        with pytest.raises(ValueError, match="RPN levels"):
            dataclasses.replace(c, anchor_sizes_per_level=((32,), (64,))).num_anchors
        with pytest.raises(ValueError, match="same number of anchor sizes"):
            dataclasses.replace(c, anchor_sizes_per_level=((32,), (64,), (128,), (256,), (512, 640))).num_anchors


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_and_pyramid_against_jax(variant):
    """state_dict_from_jax loads strictly into the port's FPN detector, and
    the pyramid it computes equals the JAX FPN's (eval mode; train mode
    where a norm is BN: the batch statistics and the moved running ones)."""
    pc, jc = cfg_pair(*variant_opts(variant))
    variables = seeded_variables(jc, seed=1)
    pcfg = detector_config_from_cfg(pc)
    sd = state_dict_from_jax(variables, pcfg)
    keys = [k for k in sd if k.startswith("backbone.fpn_")]
    norm = pcfg.fpn_norm == "BN"
    assert len(keys) == 4 * 2 * (6 if norm else 2)  # 4 levels x (lateral, output) x (weight, bias | weight, norm 5)
    assert all(k.startswith(("backbone.bottom_up.vgg", "backbone.fpn_lateral", "backbone.fpn_output", "proposal",
                             "roi_heads", "pixel")) for k in sd)
    model = pfr.FasterRCNN(pcfg)
    model.load_state_dict(sd, strict=True)
    images, _ = images_of(2, 2)
    jmodel = jfr.FasterRCNN(jax_lower(jc))
    has_bn = pcfg.vgg_bn or norm
    for train in ((False, True) if has_bn else (False,)):
        want, updated = jax.jit(lambda v, x, train=train: jmodel.apply(v, x, train, method="features",
                                                                        mutable=["batch_stats"]))(
            variables, jnp.asarray(images))
        with torch.no_grad():
            got = model.features(torch.from_numpy(images), train=train)
        assert list(got) == ["p2", "p3", "p4", "p5", "p6"] == list(want)
        for k in got:
            assert got[k].shape == nchw(want[k]).shape
            assert rel_max(got[k].numpy(), nchw(want[k])) <= (1e-4 if train else 1e-5), (k, train)
        if train:
            moved = state_dict_from_jax({"params": variables["params"], **updated}, pcfg)
            after = model.state_dict()
            for k in moved:
                if k.endswith(("running_mean", "running_var")):
                    assert rel_max(after[k].numpy(), moved[k].numpy()) <= 1e-4, k


def test_jax_export_raises_on_an_fpn_tree():
    """A fault of the reference, pinned: the JAX exporter has no FPN naming
    and fails on the tree's missing `conv0` (its backbone is bottom_up and
    the fpn_* convs). The port carries the tree (above) under Detectron2's
    FPN names."""
    pc, jc = cfg_pair()
    variables = seeded_variables(jc)
    with pytest.raises(KeyError, match="conv0"):
        export_torch_checkpoint(variables["params"], variables["batch_stats"], jax_lower(jc))
    sd = state_dict_from_jax(variables, detector_config_from_cfg(pc))
    assert "backbone.bottom_up.vgg0.0.weight" in sd and "backbone.fpn_lateral2.weight" in sd


# ---------------------------------------------------------------------------
# the multi-level pipeline
# ---------------------------------------------------------------------------


def test_assign_boxes_to_levels_golden_table_and_jax():
    sides = [28.0, 56.0, 112.0, 223.0, 224.0, 300.0, 448.0, 1792.0, 0.0]
    boxes = np.asarray([[0.0, 0.0, s, s] for s in sides], np.float32)
    assert pfr.assign_boxes_to_levels(T(boxes), 2, 5).tolist() == [2, 2, 3, 3, 4, 4, 5, 5, 2]
    assert pfr.assign_boxes_to_levels(T([[0.0, 0.0, 448.0, 112.0]]), 2, 5).tolist() == [4]
    rs = np.random.RandomState(0)
    xy = rs.uniform(0, 500, (3, 400, 2))
    boxes = np.concatenate([xy, xy + np.exp(rs.uniform(0, 7, (3, 400, 2)))], -1).astype(np.float32)
    want = np.asarray(jfr.assign_boxes_to_levels(jnp.asarray(boxes), 2, 5))
    np.testing.assert_array_equal(pfr.assign_boxes_to_levels(T(boxes), 2, 5).numpy(), want)
    assert len(set(want.ravel().tolist())) == 4


@pytest.mark.parametrize("training", [True, False])
def test_propose_fpn_keep_set_equals_jax(pair, training):
    jdet, _, det = pair
    cfg = det.cfg
    anchors = pfr.anchors_for(cfg, CANVAS, torch.device("cpu"))
    assert isinstance(anchors, tuple) and len(anchors) == 5
    n = sum(a.shape[0] for a in anchors)
    rs = np.random.RandomState(3)
    obj = rs.normal(0, 2, (3, n)).astype(np.float32)
    deltas = rs.normal(0, 0.3, (3, n, 4)).astype(np.float32)
    sizes = np.asarray([[64, 128], [50, 100], [60, 90]], np.int32)
    got = pfr.propose(cfg, anchors, pfr.RPNOutput(T(obj), T(deltas)), T(sizes), training)
    janchors = jfr.anchors_for(jdet.cfg, CANVAS)
    want = jax.jit(lambda o, d, s: jfr.propose(jdet.cfg, janchors, jfr.RPNOutput(o, d), s, training))(
        jnp.asarray(obj), jnp.asarray(deltas), jnp.asarray(sizes))
    wv = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), wv)
    assert wv.sum() > 0
    np.testing.assert_allclose(got.boxes.numpy()[wv], np.asarray(want.boxes)[wv], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.scores.numpy()[wv], np.asarray(want.scores)[wv])
    merged, post = pfr.proposal_counts(cfg, [a.shape[0] for a in anchors], training)
    assert got.boxes.shape[1] == post and merged < n


def test_pool_rois_equals_own_level_pooling_and_jax(pair):
    """The mask formula equals, bit for bit, pooling each box from its own
    level alone; and the JAX pool_rois within 1e-5; the routing of
    tests/test_fpn.py (a level filled with its level number)."""
    jdet, variables, det = pair
    cfg = det.cfg
    images, _ = images_of(2, 4)
    with torch.no_grad():
        feature = det.model.features(torch.from_numpy(images))
    rs = np.random.RandomState(5)
    xy = rs.uniform(0, [100, 50], (2, 24, 2))
    boxes = np.concatenate([xy, xy + np.exp(rs.uniform(2, 7, (2, 24, 2)))], -1).astype(np.float32)
    got = pfr.pool_rois(cfg, feature, T(boxes))
    lvl = pfr.assign_boxes_to_levels(T(boxes), 2, 5)
    assert len(set(lvl.ravel().tolist())) >= 3
    p = cfg.pooler_resolution
    for b in range(2):
        for r in range(24):
            level = int(lvl[b, r])
            alone = roi_align(feature[f"p{level}"][b], T(boxes[b, r:r + 1]), 1.0 / 2 ** level, p, 2)[0]
            assert torch.equal(got[b * 24 + r], alone), (b, r, level)
    jfeat = {k: jnp.asarray(v.numpy().transpose(0, 2, 3, 1)) for k, v in feature.items()}
    want = jax.jit(lambda f, bx: jfr.pool_rois(jdet.cfg, f, bx))(jfeat, jnp.asarray(boxes))
    assert rel_max(got.numpy(), nchw(want)) <= 1e-5
    const = {f"p{l}": torch.full((1, 4, 512 // 2 ** l, 512 // 2 ** l), float(l)) for l in (2, 3, 4, 5)}
    routed = pfr.pool_rois(cfg, const, T([[[16.0, 16.0, 72.0, 72.0], [16.0, 16.0, 128.0, 128.0],
                                           [20.0, 20.0, 244.0, 244.0]]]))
    for i, level in enumerate((2, 3, 4)):
        assert torch.allclose(routed[i, :, 2:5, 2:5], torch.tensor(float(level)))


def test_losses_and_inference_on_the_jax_feature(pair):
    """rpn_losses over the concatenated levels, sampling, pool_rois and the
    ROI losses on the JAX feature and draws; then the heads' inference on
    it (test_torch_detector.py's bounds for whole inference)."""
    jdet, variables, det = pair
    images, sizes = images_of(2, 6)
    rs = np.random.RandomState(7)
    xy = rs.uniform(0, [80, 30], (2, GT_CAP, 2))
    gt_boxes = np.concatenate([xy, xy + rs.uniform([12, 10], [48, 34], (2, GT_CAP, 2))], -1).astype(np.float32)
    classes = rs.randint(0, 4, (2, GT_CAP)).astype(np.int32)
    valid = np.arange(GT_CAP)[None] < np.asarray([[6], [4]])
    scores = np.ones((2, GT_CAP), np.float32)
    jfeat = jax.jit(lambda v, x: jdet._features(v, x, False))(variables, jnp.asarray(images))
    rng = jax.random.key(11)
    jgt = JaxInstances(jnp.asarray(gt_boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid))
    _, jm = jax.jit(lambda v, f, i, s, g, r: jdet.losses_from_feature(v, f, JaxBatch(i, s, g), r))(
        variables, jfeat, jnp.asarray(images), jnp.asarray(sizes), jgt, rng)
    counts = pfr.anchor_counts(det.cfg, CANVAS)
    rpn_p, roi_p = jax_loss_draws(rng, 2, sum(counts), pfr.roi_pool_size(det.cfg, counts, GT_CAP))
    feat = {k: T(nchw(v)) for k, v in jfeat.items()}
    batch = DetectionBatch(T(images), T(sizes), Instances(T(gt_boxes), T(scores), T(classes), T(valid)))
    with torch.no_grad():
        _, pm = det.losses_from_feature(feat, batch, T(rpn_p), T(roi_p))
    for k in LOSSES:
        assert rel_err(float(pm[k]), float(jm[k])) <= 1e-5, (k, float(pm[k]), float(jm[k]))
    assert int(pm["num_fg"]) == int(jm["num_fg"]) > 0 and int(pm["num_sampled"]) == int(jm["num_sampled"])
    want = jax.jit(lambda v, f, s: jdet.infer_from_feature(v, f, s, CANVAS))(variables, jfeat, jnp.asarray(sizes))
    got = det.infer_from_feature(feat, T(sizes), CANVAS)
    wv = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), wv)
    assert wv.sum() > 0
    np.testing.assert_array_equal(got.classes.numpy()[wv], np.asarray(want.classes)[wv])
    np.testing.assert_allclose(got.boxes.numpy()[wv], np.asarray(want.boxes)[wv], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[wv], np.asarray(want.scores)[wv], rtol=0, atol=1e-5)


def test_exported_artifact_equals_eager(pair):
    """The FPN detector exported (torch.export, both NMS kernels as the
    sfod:: custom ops) and called equals eager Detector.infer bit for bit.
    (Writing and reloading the artifact is the export tests' and the card's
    zoo phase's.)"""
    _, _, det = pair
    program = export.export_inference(det, det.model.state_dict(), CANVAS, device="cpu")
    images, sizes = images_of(1, 8)
    with torch.no_grad():
        got = program.module()(T(images), T(sizes))
    want = det.infer(images, sizes)
    assert int(want.valid.sum()) > 0
    for k in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(got[k], getattr(want, k)), k


# ---------------------------------------------------------------------------
# one base step against the JAX BaseTrainer
# ---------------------------------------------------------------------------


def jit_jax_detector_init(monkeypatch):
    """The JAX Detector's init under one jit: flax runs an init op by op, a
    compile an op (28 s for the FPN detector on this CPU). The same
    threefry draws; both packages then start from the state it made."""
    from simple_sfod_tpu.models import detector as jax_detector

    def init(self, rng, canvas_hw, batch=1):
        images = jnp.zeros((batch, canvas_hw[0], canvas_hw[1], 3), jnp.float32)
        return jax.jit(lambda r: self.module.init(r, images, train=False))(rng)

    monkeypatch.setattr(jax_detector.Detector, "init", init)


def test_lockstep_one_base_step_on_the_tiny_fpn_yaml(tmp_path, monkeypatch):
    """configs/synthetic_tiny_fpn.yaml (VGG16-BN + FPN 32, FC_DIM 64, batch
    2, 64x128): one step of the JAX BaseTrainer's _step_fn_raw against the
    port's run_step on the JAX draws, from the same weights."""
    jit_jax_detector_init(monkeypatch)
    pc, jc = cfg_pair("SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0", tmp_path=tmp_path)
    jtr = JaxBaseTrainer(jc)
    pcfg = detector_config_from_cfg(pc)
    init = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    start = state_dict_from_jax(init, pcfg)
    ptr = BaseTrainer(pc, device="cpu", state_dict=start)
    counts = pfr.anchor_counts(pcfg, CANVAS)
    batch = synthetic_batch(make_synthetic_records(2, (60, 120), 4, 6, seed=3), CANVAS, GT_CAP)
    state, jm = jax.jit(jtr._step_fn_raw)(jtr.state, jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"]),
                                          jax_gt_instances(batch), jtr.base_rng)
    pm = ptr.run_step(batch, jax_step_draws(jtr.base_rng, 0, 2, sum(counts), pfr.roi_pool_size(pcfg, counts, GT_CAP)))
    for k in LOSSES + ("total_loss",):
        assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (k, float(pm[k]), float(jm[k]))
    for k in ("num_fg", "num_sampled"):
        assert int(pm[k]) == int(jm[k]), k
    assert int(pm["num_fg"]) > 0
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()), pcfg)
    got = ptr.state.model.state_dict()
    bad = [k for k in want if not k.endswith("num_batches_tracked") and not within_tolerance(got[k], want[k], start[k])]
    assert not bad, bad
    moved = [k for k in want if k.startswith("backbone.fpn_") and not torch.equal(want[k], start[k])]
    assert len(moved) == 16
