"""ResNet-50/101 under FPN in the port (models/faster_rcnn.py:build_backbone,
checkpoint/from_jax.py:_fpn over ResNet) against the JAX package's, on the
CPU in float32.

No backbone name of the YAML schema builds this detector in either package
(the JAX `_BACKBONE_MAP` has no ResNet FPN builder); both build it from a
DetectorConfig. Here that is configs/synthetic_tiny_fpn.yaml (FPN
OUT_CHANNELS 32, FC_DIM 64, a 64x128 canvas) lowered, with backbone
resnet50 or resnet101, fpn_in_features res2..res5 and NORM BN or FrozenBN,
the block plans cut to (1, 1, 2, 1) in both packages
(test_torch_adabn.py:cut_r101). The port's trainer takes the DetectorConfig
as `det_cfg`; the JAX trainer gets it by its lowering patched in the test.

Tolerances (test_torch_fpn.py's): pyramid levels 1e-5 of each level's
largest entry in eval mode, 1e-4 in train mode, the running statistics
moved by `bn_update` 1e-4 of each buffer's largest entry; detections: the
same valid set and classes, boxes 1e-4 relative plus 1e-3 px, scores 1e-5;
the one-step base lockstep test_torch_trainer.py's bounds.

Faults of the reference, pinned: `torch_import._import_resnet` reads the
deepest stage from `in_feature[3]`, which under FPN is "p2" (IndexError);
`export_torch_checkpoint` has no FPN naming (KeyError). Weights cross by
the port's `state_dict_from_jax` only.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.checkpoint.torch_export import export_torch_checkpoint
from simple_sfod_tpu.checkpoint.torch_import import import_torch_checkpoint
from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.loader import gt_instances as jax_gt_instances
from simple_sfod_tpu.engine.trainers import base as jax_base
from simple_sfod_tpu.models import faster_rcnn as jfr
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.solver.build import backbone_freeze_mask as jax_freeze_mask
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine import export
from simple_sfod_tpu_torch.engine.trainers.base import BaseTrainer
from simple_sfod_tpu_torch.models import faster_rcnn as pfr
from simple_sfod_tpu_torch.models.backbones import resnet
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.solver.build import backbone_freeze_mask
from test_torch_adabn import R101_CUT
from test_torch_fpn import jit_jax_detector_init, nchw, rel_max
from test_torch_imagenet_init import seeded_tree
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)
from test_torch_trainer import jax_step_draws, rel_err, within_tolerance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "synthetic_tiny_fpn.yaml")
CANVAS = (64, 128)
GT_CAP = 8
LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "total_loss")
RES = ("res2", "res3", "res4", "res5")
# under the cut plan the depths differ by name only: ResNet-101 is built in
# test_freeze_mask_equals_jax_under_fpn
VARIANTS = [("resnet50", "BN"), ("resnet50", "FrozenBN")]


@pytest.fixture
def cut(monkeypatch):
    """Both packages' ResNet-50 and -101 block plans cut to R101_CUT."""
    from simple_sfod_tpu.checkpoint import torch_import
    from simple_sfod_tpu.models.backbones import resnet as jax_resnet

    for blocks in (jax_resnet.BLOCK_COUNTS, torch_import._RESNET_BLOCKS, resnet.BLOCK_COUNTS):
        for depth in (50, 101):
            monkeypatch.setitem(blocks, depth, R101_CUT)


def cfg_nodes(tmp_path=None, *opts):
    out = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_file(YAML)
        c.merge_from_list(list(opts))
        if tmp_path is not None:
            c.OUTPUT_DIR = str(tmp_path)
        out.append(c)
    return out


def rfpn(det_cfg, backbone, norm):
    return dataclasses.replace(det_cfg, backbone=backbone, resnet_norm=norm, fpn_in_features=RES)


def configs(backbone, norm, tmp_path=None, *opts):
    pc, jc = cfg_nodes(tmp_path, *opts)
    return pc, jc, rfpn(detector_config_from_cfg(pc), backbone, norm), rfpn(jax_lower(jc), backbone, norm)


def images_of(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, *CANVAS, 3)).astype(np.uint8),
            np.asarray([[64, 128], [50, 100], [60, 120]][:n], np.int32))


@pytest.mark.parametrize("backbone,norm", VARIANTS)
def test_pyramid_and_detections_against_jax(cut, backbone, norm):
    """state_dict_from_jax (Detectron2's R-FPN names) loads strictly; the
    pyramid equals the JAX FPN's in eval mode and, under BN, in train mode,
    where `bn_update` moves the running statistics as the JAX train-mode
    forward does (AdaBN); the eval-mode detections equal the JAX ones."""
    _, _, pcfg, jcfg = configs(backbone, norm)
    variables = seeded_tree(jcfg, seed=1)
    # random weights: the stem scaled so that the maps stay O(1) on 0-255
    # pixels, and the class-1 logit raised, so that detections pass the score threshold
    variables["params"]["backbone"]["bottom_up"]["stem_conv"]["kernel"] *= 0.01
    variables["params"]["predictor"]["cls_score"]["bias"][1] += 4.0
    sd = state_dict_from_jax(variables, pcfg)
    assert {k.split(".")[2] for k in sd if k.startswith("backbone.bottom_up.")} == {"stem", *RES}
    assert {k.split(".")[1] for k in sd if k.startswith("backbone.fpn_")} == {
        f"fpn_{kind}{lvl}" for kind in ("lateral", "output") for lvl in (2, 3, 4, 5)}
    det = Detector(pcfg, device="cpu").load_state_dict(sd)
    model = det.model
    images, sizes = images_of(2, 2)
    jmodel = jfr.FasterRCNN(jcfg)
    for train in ((False, True) if norm == "BN" else (False,)):
        want, updated = jax.jit(lambda v, x, train=train: jmodel.apply(v, x, train, method="features",
                                                                        mutable=["batch_stats"]))(
            variables, jnp.asarray(images))
        with torch.no_grad():
            got = model.features(torch.from_numpy(images), train=train, update_bn=False)
        assert list(got) == ["p2", "p3", "p4", "p5", "p6"] == list(want)
        for k in got:
            assert got[k].shape == nchw(want[k]).shape
            assert rel_max(got[k].numpy(), nchw(want[k])) <= (1e-4 if train else 1e-5), (k, train)
        if train:
            before = {k: v.clone() for k, v in model.state_dict().items()}
            det.bn_update(images)
            moved = state_dict_from_jax({"params": variables["params"], **updated}, pcfg)
            after = model.state_dict()
            stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
            assert stats and all(not torch.equal(after[k], before[k]) for k in stats)
            for k in stats:
                assert rel_max(after[k].numpy(), moved[k].numpy()) <= 1e-4, k
            det.load_state_dict(sd)
    jdet = JaxDetector(jcfg)
    want = jax.jit(lambda v, i, s: jdet.infer(v, i, s))(variables, jnp.asarray(images), jnp.asarray(sizes))
    got = det.infer(images, sizes)
    wv = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), wv)
    assert wv.sum() > 0
    np.testing.assert_array_equal(got.classes.numpy()[wv], np.asarray(want.classes)[wv])
    np.testing.assert_allclose(got.boxes.numpy()[wv], np.asarray(want.boxes)[wv], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[wv], np.asarray(want.scores)[wv], rtol=0, atol=1e-5)


def test_lockstep_one_base_step_against_jax(tmp_path, monkeypatch, cut):
    """One step of the JAX BaseTrainer's _step_fn_raw on the ResNet-50 FPN
    detector (NORM BN: train-mode statistics in the step) against the
    port's BaseTrainer (det_cfg) on the JAX draws, from the same weights
    (FREEZE_AT 2: the stem and res2 frozen in both)."""
    jit_jax_detector_init(monkeypatch)
    pc, jc, pcfg, jcfg = configs("resnet50", "BN", tmp_path, "SOLVER.BASE_LR", "0.01", "SOLVER.WARMUP_ITERS", "0")
    monkeypatch.setattr(jax_base, "detector_config_from_cfg", lambda cfg: jcfg)
    jtr = jax_base.BaseTrainer(jc)
    init = jax.tree_util.tree_map(np.asarray, jtr.state.variables())
    start = state_dict_from_jax(init, pcfg)
    ptr = BaseTrainer(pc, device="cpu", state_dict=start, det_cfg=pcfg)
    frozen = [n for n, p in ptr.state.model.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")) for n in frozen)
    counts = pfr.anchor_counts(pcfg, CANVAS)
    batch = synthetic_batch(make_synthetic_records(2, (60, 120), 4, 6, seed=3), CANVAS, GT_CAP)
    state, jm = jax.jit(jtr._step_fn_raw)(jtr.state, jnp.asarray(batch["images"]), jnp.asarray(batch["sizes"]),
                                          jax_gt_instances(batch), jtr.base_rng)
    pm = ptr.run_step(batch, jax_step_draws(jtr.base_rng, 0, 2, sum(counts), pfr.roi_pool_size(pcfg, counts, GT_CAP)))
    for k in LOSSES:
        assert rel_err(float(pm[k]), float(jm[k])) <= 1e-4, (k, float(pm[k]), float(jm[k]))
    for k in ("num_fg", "num_sampled"):
        assert int(pm[k]) == int(jm[k]), k
    assert int(pm["num_fg"]) > 0
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.variables()), pcfg)
    got = ptr.state.model.state_dict()
    bad = [k for k in want if not k.endswith("num_batches_tracked") and not within_tolerance(got[k], want[k], start[k])]
    assert not bad, bad
    assert all(torch.equal(got[k], start[k]) for k in frozen)
    assert sum(not torch.equal(want[k], start[k]) for k in want if k.startswith("backbone.fpn_")) == 16


def test_freeze_mask_equals_jax_under_fpn(cut):
    """MODEL.BACKBONE.FREEZE_AT under FPN: the port's mask of parameter
    names (`backbone.bottom_up.stem.*`, `backbone.bottom_up.res{s}.*`)
    selects what the JAX mask selects in the flax tree."""
    _, _, pcfg, jcfg = configs("resnet101", "BN")
    variables = seeded_tree(jcfg)
    for freeze_at in (0, 1, 2, 3):
        flags = jax_freeze_mask(variables["params"], freeze_at)
        as_ones = jax.tree.map(lambda f, x: np.full(x.shape, float(f), np.float32), flags, variables["params"])
        sd = state_dict_from_jax({"params": as_ones, "batch_stats": variables["batch_stats"]}, pcfg)
        mask = backbone_freeze_mask(pfr.FasterRCNN(pcfg), freeze_at)
        assert mask == {k: bool(np.all(sd[k].numpy() == 1.0)) for k in mask}, freeze_at
        assert sum(mask.values()) == {0: 0, 1: 3, 2: 15, 3: 27}[freeze_at]


def test_exported_program_equals_eager(cut):
    """engine/export.py is generic over the backbone: the R-FPN detector
    exported (both NMS kernels as sfod:: ops) equals eager inference."""
    _, _, pcfg, jcfg = configs("resnet50", "FrozenBN")
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(seeded_tree(jcfg, seed=3), pcfg))
    program = export.export_inference(det, det.model.state_dict(), CANVAS, device="cpu")
    images, sizes = images_of(1, 8)
    with torch.no_grad():
        got = program.module()(torch.from_numpy(images), torch.from_numpy(sizes))
    want = det.infer(images, sizes)
    assert int(want.valid.sum()) > 0
    for k in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(got[k], getattr(want, k)), k


def test_jax_import_and_export_fail_on_an_rfpn_detector(cut):
    """Faults of the reference, pinned: `_import_resnet` reads the C4 names
    (`backbone.stem.*`, no `bottom_up`) and takes the deepest stage from
    in_feature[3], which is "p2" under FPN; `export_torch_checkpoint` has
    no FPN naming. Neither carries R-FPN weights."""
    _, _, pcfg, jcfg = configs("resnet50", "BN")
    variables = seeded_tree(jcfg)
    assert jcfg.in_feature == "p2"
    sd = {k: v.numpy() for k, v in state_dict_from_jax(variables, pcfg).items()}
    with pytest.raises(KeyError, match="backbone.stem.conv1.weight"):
        import_torch_checkpoint(sd, jcfg)
    c4_names = {k.replace("backbone.bottom_up.", "backbone."): v for k, v in sd.items()}
    with pytest.raises(IndexError, match="string index out of range"):
        import_torch_checkpoint(c4_names, jcfg)
    with pytest.raises(KeyError):
        export_torch_checkpoint(variables["params"], variables["batch_stats"], jcfg)
