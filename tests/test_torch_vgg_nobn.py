"""The port's VGG16 without BatchNorm (VGG.BN False: the `_nobn` YAMLs and
vgg16_cityscapes_to_foggy_source.yaml) against the JAX package's, on the
CPU in float32 at a 64x128 canvas, FC_DIM 64.

  - `state_dict_from_jax` key for key and value for value equal to the JAX
    package's `export_torch_checkpoint` (Detectron2's shifted module indices
    of the no-BN layout, `_D2_STAGE_CONVS_NOBN`; stage 4 holds no conv), and
    the port's detector takes it with strict=True.
  - The canonical stage features vgg0..vgg4 (pools after convs 2, 4, 7, 10,
    13) within 1e-5 of each map's largest entry, in eval and train mode
    (train mode changes nothing without BatchNorm).
  - Every BatchNorm assumption of the trainers a tested no-op on the
    BN-free detector: AdaBN's reset and refinement, `Detector.bn_update`,
    `ema_tensors` (parameters only), `precise_bn`, the solver's norm mask,
    the fixed bfloat16 teacher, SPLIT_VIEW_BN, and a checkpoint's strict
    round trip without any num_batches_tracked.
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
from simple_sfod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.data.synthetic import make_synthetic_records, synthetic_batch
from simple_sfod_tpu_torch.engine.hooks import precise_bn
from simple_sfod_tpu_torch.engine.train_state import ema_tensors
from simple_sfod_tpu_torch.engine.trainers import build_trainer
from simple_sfod_tpu_torch.models.backbones.vgg import VGG16Backbone
from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN
from simple_sfod_tpu_torch.solver.build import norm_param_mask
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_YAML = "faster_rcnn_VGG_cityscapes_foggy_source_nobn.yaml"
SFAT_YAML = "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free_nobn.yaml"
CANVAS = (64, 128)
SMALL = ["MODEL.ROI_BOX_HEAD.FC_DIM", "64", "TPU.CANVAS", str(CANVAS), "TPU.GT_CAPACITY", "8",
         "SOLVER.IMS_PER_BATCH", "2", "SOLVER.IMS_PER_BATCH_TARGET", "2", "VIS_PERIOD", "0"]


def cfg_pair(yaml=SOURCE_YAML, *opts, tmp_path=None):
    out = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_file(os.path.join(ROOT, "configs", yaml))
        c.merge_from_list(SMALL + list(opts))
        if tmp_path is not None:
            c.OUTPUT_DIR = str(tmp_path)
        out.append(c)
    return out


def seeded_variables(jcfg, seed=0):
    """The JAX detector's variables at its init's shapes (jax.eval_shape),
    kernels normal with std 1/sqrt(fan_in), biases normal(0, 0.05)."""
    shapes = jax.eval_shape(lambda: JaxFasterRCNN(jax_lower(jcfg)).init(
        jax.random.key(0), jnp.zeros((1, *CANVAS, 3), jnp.float32)))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        if str(getattr(path[-1], "key", path[-1])) == "kernel":
            return rs.normal(0, 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), leaf.shape).astype(np.float32)
        return rs.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.mark.parametrize("yaml", [SOURCE_YAML, SFAT_YAML, "vgg16_cityscapes_to_foggy_source.yaml"])
def test_state_dict_equals_jax_export(yaml):
    pc, jc = cfg_pair(yaml)
    pcfg = detector_config_from_cfg(pc)
    assert not pcfg.vgg_bn and pcfg.vgg_bn == jax_lower(jc).vgg_bn
    variables = seeded_variables(jc)
    assert "batch_stats" not in variables
    got = state_dict_from_jax(variables, pcfg)
    want = export_torch_checkpoint(variables["params"], {}, jax_lower(jc))
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    backbone = [k for k in got if k.startswith("backbone.")]
    assert len(backbone) == 26 and not any(k.startswith("backbone.vgg4.") for k in backbone)
    assert {k.rsplit(".", 1)[0] for k in backbone} == {
        f"backbone.vgg{s}.{i}" for s, idxs in enumerate(((0, 2, 5), (0, 3, 5), (0, 3, 5, 7), (0, 2, 4))) for i in idxs}
    model = FasterRCNN(pcfg)
    model.load_state_dict(got, strict=True)
    assert not any("running" in k or "num_batches" in k for k in model.state_dict())


def test_canonical_features_match_jax():
    pc, jc = cfg_pair()
    variables = seeded_variables(jc, seed=1)
    pcfg = detector_config_from_cfg(pc)
    model = FasterRCNN(pcfg)
    model.load_state_dict(state_dict_from_jax(variables, pcfg), strict=True)
    images = np.random.RandomState(2).randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8)
    x = jnp.asarray(images.astype(np.float32)) - jnp.asarray(pcfg.pixel_mean, jnp.float32)
    bp = {"params": variables["params"]["backbone"]}
    from simple_sfod_tpu.models.backbones.vgg import VGG16Backbone as JaxVGG

    want = jax.jit(lambda v, x: JaxVGG(bn=False).apply(v, x))(bp, x)
    with torch.no_grad():
        xt = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)
        for train in (False, True):
            got = model.backbone(xt, train)
            assert list(got) == [f"vgg{i}" for i in range(5)]
            for k, w in want.items():
                w = np.asarray(w).transpose(0, 3, 1, 2)
                stride = VGG16Backbone.out_strides()[k]
                assert got[k].shape == w.shape == (2, VGG16Backbone.out_channels()[k], CANVAS[0] // stride,
                                                   CANVAS[1] // stride)
                assert np.abs(got[k].numpy() - w).max() <= 1e-5 * np.abs(w).max(), (k, train)


def test_batchnorm_steps_are_noops_without_batchnorm(tmp_path):
    """AdaBN (reset, refinement), bn_update, precise_bn, ema_tensors, the
    solver's norm mask on the bare VGG; the SFAT YAML's fixed bfloat16
    teacher and a step of the `_single` variant under SPLIT_VIEW_BN; a
    checkpoint saved and restored strictly."""
    pc, _ = cfg_pair(tmp_path=tmp_path)
    tr = build_trainer(pc, device="cpu")
    model = tr.state.model
    assert not tr._batchnorms() and not any(norm_param_mask(model).values())
    assert len(ema_tensors(model)) == len(list(model.parameters()))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = synthetic_batch(make_synthetic_records(2, (60, 120), 4, 6, seed=1), CANVAS, 8)
    tr.reset_bn_stats()
    assert tr.refine_bn_stats(loader=[batch] * 3) == 3
    tr.detector.bn_update(torch.from_numpy(batch["images"]))
    assert precise_bn(tr.detector, [batch] * 3, 3) == 3
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    m = tr.run_step(batch)
    assert np.isfinite(float(m["total_loss"]))
    tr.checkpointer.save("x", tr.checkpoint_state())
    tr.checkpointer.wait()
    again = build_trainer(pc, device="cpu")
    again.resume_or_load(resume=True)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in again.state.model.state_dict().items())

    for opts in ((), ("TRAINER", "source_free_adaptive_teacher_single", "SEMISUPNET.SPLIT_VIEW_BN", "True")):
        sc, _ = cfg_pair(SFAT_YAML, "TPU.DTYPE", "bfloat16" if not opts else "float32", *opts, tmp_path=tmp_path)
        sfat = build_trainer(sc, device="cpu")
        if not opts:  # the fixed teacher in bfloat16, nothing else to cast
            assert all(p.dtype == torch.bfloat16 for p in sfat.state.teacher.parameters())
            assert not [n for n, _ in sfat.state.teacher.named_buffers() if "running" in n]
        m = sfat.run_step({"images": batch["images"], "sizes": batch["sizes"]})
        assert np.isfinite(float(m["total_loss"]))
