"""The raw inference path and the inference overrides of the port against
the JAX package on the CPU, in float32:

  - the raw path (no score filter, no class-wise NMS: the reference's
    fast_rcnn_inference_new, `Detector.infer_raw`, topk 64) and inference
    with each override (score_thresh, nms_thresh, topk), on VGG16-BN
    (128x256, FC_DIM 64) and on the VGG-FPN detector
    (configs/synthetic_tiny_fpn.yaml, 64x128), the weights seeded at the
    JAX init's shapes (test_torch_fpn.py:seeded_variables) and carried by
    checkpoint/from_jax.py: the heads on the JAX feature for both, and
    `infer_raw` and `infer` end to end from the same uint8 images for
    VGG16-BN. On the FPN detector end to end, the pyramid's rounding moves
    near-tied RPN proposals across the pre-NMS cut (one box of 512 moved
    0.037 px at 128 px); there `infer_raw` is held to the port's own head
    path on its own pyramid, bit for bit;
  - `roi_inference` with every combination of apply_nms and
    apply_score_thresh, and with each of score_thresh, nms_thresh, topk and
    candidate_cap, on the same seeded head outputs and proposals.

Bounds: boxes within 1e-4 of the largest coordinate, scores within 1e-5,
classes and valid equal. The two packages sum the features in another
order; seeded weights at std 1/sqrt(fan_in) give class logits in the tens,
where softmax turns that rounding into score errors above 1e-5, so the
predictor's kernels are scaled by HEAD_SCALE, to logits of a few units.
The head-only cases share their inputs exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.models import faster_rcnn as jfr
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.structures.instances import Instances as JaxInstances
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg
from simple_sfod_tpu_torch.models import faster_rcnn as pfr
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.structures.instances import Instances
from test_torch_detector import OPTS as VGG_OPTS
from test_torch_fpn import cfg_pair as fpn_cfg_pair
from test_torch_fpn import seeded_variables
from test_torch_train_loop import free_disk  # noqa: F401  (autouse: 2 threads, removes each test's directory)

BOX_REL, SCORE_TOL = 1e-4, 1e-5
DETECTORS = {"vgg16_bn": (128, 256), "vgg_fpn": (64, 128)}
OVERRIDES = {"score_thresh": 0.2, "nms_thresh": 0.3, "topk": 20}
HEAD_SCALE = 0.1


def cfg_pair(name):
    if name == "vgg_fpn":
        return fpn_cfg_pair()
    from simple_sfod_tpu.config import get_cfg as jax_get_cfg
    from simple_sfod_tpu_torch.config import get_cfg

    out = []
    for get in (get_cfg, jax_get_cfg):
        c = get()
        c.merge_from_list(list(VGG_OPTS))
        out.append(c)
    return out


@functools.lru_cache(maxsize=None)
def make_pair(name):
    """The JAX detector, its seeded variables, the port's detector on the
    same weights, images uint8 [2, H, W, 3], sizes [2, 2], and the JAX
    feature (the port's layout beside it)."""
    pc, jc = cfg_pair(name)
    variables = seeded_variables(jc, seed=3)
    for head in variables["params"]["predictor"].values():
        head["kernel"] = head["kernel"] * np.float32(HEAD_SCALE)
    pcfg = detector_config_from_cfg(pc)
    det = Detector(pcfg, device="cpu").load_state_dict(state_dict_from_jax(variables, pcfg))
    h, w = DETECTORS[name]
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (2, h, w, 3)).astype(np.uint8)
    sizes = np.asarray([[h, w], [h - 8, w - 16]], np.int32)
    jdet = JaxDetector(jax_lower(jc))
    jfeat = jax.jit(lambda v, x: jdet._features(v, x, False))(variables, jnp.asarray(images))
    if isinstance(jfeat, dict):
        pfeat = {k: torch.from_numpy(np.array(v)).permute(0, 3, 1, 2) for k, v in jfeat.items()}
    else:
        pfeat = torch.from_numpy(np.array(jfeat)).permute(0, 3, 1, 2)
    return dict(name=name, jdet=jdet, variables=variables, det=det, images=images, sizes=sizes,
                canvas=(h, w), jfeat=jfeat, pfeat=pfeat)


@pytest.fixture(params=list(DETECTORS))
def pair(request):
    return make_pair(request.param)


def assert_detections(got, want):
    wv = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), wv)
    assert wv.sum() > 0
    np.testing.assert_array_equal(got.classes.numpy()[wv], np.asarray(want.classes)[wv])
    wb = np.asarray(want.boxes)[wv]
    np.testing.assert_allclose(got.boxes.numpy()[wv], wb, rtol=0, atol=BOX_REL * np.abs(wb).max())
    np.testing.assert_allclose(got.scores.numpy()[wv], np.asarray(want.scores)[wv], rtol=0, atol=SCORE_TOL)


RAW = dict(topk=64, apply_nms=False, apply_score_thresh=False)


def jax_heads(p, **kw):
    """The JAX detector's head-side inference on its own feature (jitted:
    one XLA program compiles faster than the ops one by one)."""
    fn = jax.jit(lambda v, f, s: p["jdet"].infer_from_feature(v, f, s, p["canvas"], **kw))
    return fn(p["variables"], p["jfeat"], jnp.asarray(p["sizes"]))


def test_raw_path_on_the_jax_feature(pair):
    """No score filter and no NMS: all 64 slots filled from the capped
    candidates, by score."""
    p = pair
    want = jax_heads(p, **RAW)
    with torch.inference_mode():
        got = p["det"].detect(p["pfeat"], p["sizes"], p["canvas"], **RAW)
    assert got.boxes.shape == (2, 64, 4) and bool(got.valid.all())
    assert_detections(got, want)
    assert bool((got.scores[:, :-1] >= got.scores[:, 1:]).all())


@pytest.mark.parametrize("override", [None, *OVERRIDES])
def test_overrides_on_the_jax_feature(pair, override):
    p = pair
    kw = {} if override is None else {override: OVERRIDES[override]}
    want = jax_heads(p, **kw)
    got = p["det"].infer_from_feature(p["pfeat"], p["sizes"], p["canvas"], **kw)
    assert got.boxes.shape[1] == kw.get("topk", p["det"].cfg.detections_per_image)
    assert_detections(got, want)


def test_infer_raw_end_to_end(pair):
    p = pair
    got = p["det"].infer_raw(p["images"], p["sizes"], topk=64)
    if p["name"] == "vgg_fpn":  # the module docstring: the port's own head path on its own pyramid
        with torch.inference_mode():
            want = p["det"].detect(p["det"].model.features(torch.from_numpy(p["images"])), p["sizes"], p["canvas"], **RAW)
        assert all(torch.equal(getattr(got, k), getattr(want, k)) for k in ("boxes", "scores", "classes", "valid"))
        return
    want = jax.jit(lambda v, x, s: p["jdet"].infer_raw(v, x, s, topk=64))(
        p["variables"], jnp.asarray(p["images"]), jnp.asarray(p["sizes"]))
    assert bool(got.valid.all())
    assert_detections(got, want)


@pytest.mark.parametrize("overrides", [False, True], ids=["config", "overrides"])
def test_infer_end_to_end(overrides):
    """VGG16-BN, with the config's TEST values and with all three overrides
    at once (each alone is held on the JAX feature above; the FPN
    detector's heads are held on the JAX pyramid: the module docstring)."""
    p = make_pair("vgg16_bn")
    kw = dict(OVERRIDES) if overrides else {}
    want = jax.jit(lambda v, x, s: p["jdet"].infer(v, x, s, **kw))(
        p["variables"], jnp.asarray(p["images"]), jnp.asarray(p["sizes"]))
    got = p["det"].infer(p["images"], p["sizes"], **kw)
    assert_detections(got, want)


# roi_inference on seeded head outputs: B 2, R 200 proposals (30 invalid, a
# few empty), C 8 classes
B, R, C = 2, 200, 8
SWITCHES = [dict(apply_nms=n, apply_score_thresh=s) for n in (True, False) for s in (True, False)]
ARGS = [dict(score_thresh=0.3), dict(nms_thresh=0.2), dict(topk=17), dict(candidate_cap=150),
        dict(topk=300, apply_nms=False, apply_score_thresh=False)]


def head_outputs(seed=0):
    rs = np.random.RandomState(seed)
    scores = (rs.normal(0, 2.0, (B, R, C + 1))).astype(np.float32)
    deltas = rs.normal(0, 0.5, (B, R, 4 * C)).astype(np.float32)
    xy = rs.uniform(0, [200, 100], (B, R, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(4, 80, (B, R, 2))], -1).astype(np.float32)
    boxes[:, ::23, 2] = boxes[:, ::23, 0]  # empty proposals
    valid = rs.uniform(size=(B, R)) > 0.15
    sizes = np.asarray([[128, 256], [100, 180]], np.int32)
    return scores, deltas, boxes, valid, sizes


# roi_inference reads only the config's TEST values, which the two detectors
# share: every case on VGG16-BN's config; on FPN's, NMS and the score
# threshold both on (inference) and both off (the raw path)
CASES = [("vgg16_bn", kw) for kw in SWITCHES + ARGS] + [("vgg_fpn", SWITCHES[0]), ("vgg_fpn", SWITCHES[-1])]


@pytest.mark.parametrize("detector,kw", CASES,
                         ids=[f"{d}-" + ",".join(f"{k}={v}" for k, v in kw.items()) for d, kw in CASES])
def test_roi_inference_switches(detector, kw):
    pc, jc = cfg_pair(detector)
    scores, deltas, boxes, valid, sizes = head_outputs()
    props = JaxInstances(jnp.asarray(boxes), jnp.zeros((B, R)), jnp.zeros((B, R), jnp.int32), jnp.asarray(valid))
    want = jax.jit(lambda *a: jfr.roi_inference(jax_lower(jc), *a, **kw))(
        jnp.asarray(scores), jnp.asarray(deltas), props, jnp.asarray(sizes))
    T = torch.from_numpy
    pprops = Instances(T(boxes), torch.zeros(B, R), torch.zeros(B, R, dtype=torch.int32), T(valid))
    got = pfr.roi_inference(detector_config_from_cfg(pc), T(scores), T(deltas), pprops, T(sizes), **kw)
    assert got.boxes.shape[1] == kw.get("topk", jax_lower(jc).detections_per_image)
    assert_detections(got, want)
    if not (kw.get("apply_nms", True) or kw.get("apply_score_thresh", True)):
        assert bool(got.valid.all())


def test_roi_inference_refuses_topk_above_the_candidates(detector="vgg16_bn"):
    """candidate_cap below topk: the JAX package's top_k raises, and so does
    the port (rather than return fewer than topk slots)."""
    pc, jc = cfg_pair(detector)
    scores, deltas, boxes, valid, sizes = head_outputs()
    props = JaxInstances(jnp.asarray(boxes), jnp.zeros((B, R)), jnp.zeros((B, R), jnp.int32), jnp.asarray(valid))
    with pytest.raises(ValueError, match="top_k"):
        jax.jit(lambda *a: jfr.roi_inference(jax_lower(jc), *a, topk=50, candidate_cap=40))(
            jnp.asarray(scores), jnp.asarray(deltas), props, jnp.asarray(sizes))
    T = torch.from_numpy
    pprops = Instances(T(boxes), torch.zeros(B, R), torch.zeros(B, R, dtype=torch.int32), T(valid))
    with pytest.raises(ValueError, match="topk 50 exceeds the 40 candidates"):
        pfr.roi_inference(detector_config_from_cfg(pc), T(scores), T(deltas), pprops, T(sizes), topk=50,
                          candidate_cap=40)
