"""The port's VGG16-BN Faster R-CNN inference against the JAX Detector on
the CPU, in float32, at a 128x256 canvas with FC_DIM 64, on weights
initialised by JAX and carried across by checkpoint/from_jax.py.

Tolerances and why:
  vgg4 feature       rtol 1e-4 of its max: 13 convs sum in another order
  RPN outputs        atol 1e-5, on the JAX feature
  proposals          valid equal, boxes 1e-3 px, on the JAX RPN outputs
  roi_align          1e-5, on the JAX feature and proposals
  heads on the JAX   valid/classes equal, boxes 1e-4 px, scores 1e-6
  feature
  end to end         valid/classes equal, boxes 1e-3 px + 1e-5 relative,
                     scores 1e-5: the feature's summation-order error is
                     scaled by anchors up to 512 px through the deltas
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden
from simple_sfod_tpu.checkpoint.torch_export import export_torch_checkpoint
from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from simple_sfod_tpu.models.faster_rcnn import RPNOutput as JaxRPNOutput
from simple_sfod_tpu.models.faster_rcnn import anchors_for as jax_anchors_for
from simple_sfod_tpu.models.faster_rcnn import propose as jax_propose
from simple_sfod_tpu.ops.roi_align import roi_align as jax_roi_align
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.models.faster_rcnn import RPNOutput, anchors_for, propose
from simple_sfod_tpu_torch.ops.roi_align import roi_align

CANVAS = (128, 256)
OPTS = [
    "MODEL.BACKBONE.NAME", "build_vgg_backbone",
    "MODEL.ROI_HEADS.IN_FEATURES", "('vgg4',)",
    "MODEL.RPN.IN_FEATURES", "('vgg4',)",
    "MODEL.ROI_HEADS.NUM_CLASSES", "8",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "TPU.CANVAS", str(CANVAS),
]


def lowered(get):
    cfg = get()
    cfg.merge_from_list(OPTS)
    return cfg


@pytest.fixture(scope="module")
def pair():
    """JAX detector + its variables, and the port detector with the same weights."""
    jcfg = jax_lower(lowered(jax_get_cfg))
    pcfg = detector_config_from_cfg(lowered(get_cfg))
    jdet = JaxDetector(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jdet.init(jax.random.key(0), CANVAS))
    pdet = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (1,) + CANVAS + (3,)).astype(np.uint8)
    sizes = np.asarray([[120, 250]], np.int32)
    feat = np.array(jdet._features(variables, jnp.asarray(images), False))
    logits, deltas = jdet.module.apply(variables, jnp.asarray(feat), method=JaxFasterRCNN.rpn)
    props = jax_propose(jcfg, jax_anchors_for(jcfg, CANVAS), JaxRPNOutput(logits, deltas), jnp.asarray(sizes), training=False)
    return dict(
        jcfg=jcfg, pcfg=pcfg, jdet=jdet, variables=variables, pdet=pdet, images=images, sizes=sizes,
        feat=feat, logits=np.array(logits), deltas=np.array(deltas),
        prop_boxes=np.array(props.boxes), prop_valid=np.array(props.valid),
    )


def nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def test_state_dict_matches_export_torch_checkpoint(pair):
    """Key for key, equal arrays with the JAX package's own Detectron2 exporter."""
    v = pair["variables"]
    want = export_torch_checkpoint(v["params"], v["batch_stats"], pair["jcfg"])
    got = state_dict_from_jax(v, pair["pcfg"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # and the port's module takes it strictly
    assert set(got) == set(pair["pdet"].model.state_dict())


def test_vgg4_features(pair):
    with torch.no_grad():
        got = pair["pdet"].model.features(torch.from_numpy(pair["images"]))
    got = got.permute(0, 2, 3, 1).numpy()
    want = pair["feat"]
    assert got.shape == want.shape == (1, 4, 8, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_uint8_images_cast_before_mean(pair):
    """uint8 and float images give the same feature: the cast comes before
    the mean subtraction, so nothing wraps around."""
    m = pair["pdet"].model
    with torch.no_grad():
        a = m.features(torch.from_numpy(pair["images"]))
        b = m.features(torch.from_numpy(pair["images"].astype(np.float32)))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_rpn_outputs(pair):
    with torch.no_grad():
        out = pair["pdet"].model.rpn(nchw(pair["feat"]))
    assert out.objectness.dtype == torch.float32 and out.deltas.shape == (1, 4 * 8 * 15, 4)
    np.testing.assert_allclose(out.objectness.numpy(), pair["logits"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.deltas.numpy(), pair["deltas"], rtol=0, atol=1e-5)


def test_proposals(pair):
    cfg = pair["pcfg"]
    got = propose(
        cfg, anchors_for(cfg, CANVAS, torch.device("cpu")),
        RPNOutput(torch.from_numpy(pair["logits"]), torch.from_numpy(pair["deltas"])),
        torch.from_numpy(pair["sizes"]),
    )
    np.testing.assert_array_equal(got.valid.numpy(), pair["prop_valid"])
    assert got.valid.sum() > 10
    np.testing.assert_allclose(got.boxes.numpy(), pair["prop_boxes"], rtol=0, atol=1e-3)


def test_roi_align(pair):
    feat, boxes = pair["feat"][0], pair["prop_boxes"][0]
    got = roi_align(torch.from_numpy(feat).permute(2, 0, 1), torch.from_numpy(boxes), 1 / 32)
    want = np.asarray(jax_roi_align(jnp.asarray(feat), jnp.asarray(boxes), 1 / 32))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw", [(9, 13), (13, 9)])
def test_roi_align_against_golden(hw):
    """Both contraction orders (W >= H and W < H) against the scalar oracle."""
    rng = np.random.RandomState(hw[0])
    feat = rng.normal(0, 1, hw + (5,)).astype(np.float32)
    xy = rng.uniform(-20, 150, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 200, (12, 2))], 1).astype(np.float32)
    got = roi_align(torch.from_numpy(feat).permute(2, 0, 1), torch.from_numpy(boxes), 1 / 16)
    want = golden.roi_align_ref(feat, boxes, 1 / 16, 7, 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def _assert_detections(got, want, box_atol, box_rtol, score_atol):
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() > 0
    np.testing.assert_array_equal(got.classes.numpy()[gv], np.asarray(want.classes)[wv])
    np.testing.assert_allclose(got.boxes.numpy()[gv], np.asarray(want.boxes)[wv], rtol=box_rtol, atol=box_atol)
    np.testing.assert_allclose(got.scores.numpy()[gv], np.asarray(want.scores)[wv], rtol=0, atol=score_atol)


def test_heads_inference_on_shared_feature(pair):
    want = pair["jdet"].infer_from_feature(pair["variables"], jnp.asarray(pair["feat"]), jnp.asarray(pair["sizes"]), CANVAS)
    got = pair["pdet"].infer_from_feature(nchw(pair["feat"]), pair["sizes"], CANVAS)
    assert got.boxes.shape == (1, 100, 4)
    _assert_detections(got, want, 1e-4, 0, 1e-6)


def test_infer_end_to_end(pair):
    want = pair["jdet"].infer(pair["variables"], jnp.asarray(pair["images"]), jnp.asarray(pair["sizes"]))
    got = pair["pdet"].infer(pair["images"], pair["sizes"])
    _assert_detections(got, want, 1e-3, 1e-5, 1e-5)
    # detections stay inside the true image size
    b = got.boxes.numpy()[got.valid.numpy()]
    assert (b[:, [0, 2]] <= 250).all() and (b[:, [1, 3]] <= 120).all() and (b >= 0).all()


def test_seeded_init_is_deterministic():
    from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights

    cfg = detector_config_from_cfg(lowered(get_cfg))
    a = init_weights(FasterRCNN(cfg), 3).state_dict()
    b = init_weights(FasterRCNN(cfg), 3).state_dict()
    c = init_weights(FasterRCNN(cfg), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.vgg0.0.weight"], c["backbone.vgg0.0.weight"])
