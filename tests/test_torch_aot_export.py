"""The port's serving artifacts (simple_sfod_tpu_torch/engine/export.py and
tools/export_model.py) on the CPU: each export mode against the JAX
package's artifact of the same mode on the same weights (JAX-initialised,
carried across by checkpoint/from_jax.py), and against the port's eager
Detector.infer; the batched propose / roi_inference against the per-image
loop they replaced; the NMS custom ops; the file format; the metadata of
both tools; loading and serving with the port's model code poisoned.

VGG16-BN at a 64x128 canvas, FC_DIM 64, float32. Bounds:
  port artifact vs JAX artifact   valid/classes equal, boxes 1e-3 px + 1e-5
                                  relative, scores 1e-5 (tests/
                                  test_torch_detector.py's infer bounds:
                                  float32 summation order in the backbone)
  port artifact vs port eager     bit-equal
  batched vs per-image pipeline   bit-equal (torch.equal)
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.engine import export as jax_export
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.engine import export
from simple_sfod_tpu_torch.models import faster_rcnn as frcnn
from simple_sfod_tpu_torch.models.detector import Detector
from simple_sfod_tpu_torch.ops import _kernels, nms
from simple_sfod_tpu_torch.structures.boxes import clip_boxes, nonempty
from simple_sfod_tpu_torch.structures.instances import Instances, topk_indices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN_YAML = os.path.join(ROOT, "configs", "faster_rcnn_VGG_cityscapes_foggy_adaptive_teacher_source_free.yaml")
CANVAS = (64, 128)
OPTS = [
    "MODEL.BACKBONE.NAME", "build_vgg_backbone",
    "MODEL.ROI_HEADS.IN_FEATURES", "('vgg4',)",
    "MODEL.RPN.IN_FEATURES", "('vgg4',)",
    "MODEL.ROI_HEADS.NUM_CLASSES", "8",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "TPU.CANVAS", str(CANVAS),
]
# the JAX package's export modes, three artifacts that cover them all: each
# case's export_inference keywords and the batch sizes it is called at
CASES = {
    "fixed": (dict(batch=1), (1,)),
    "poly_bf16_params": (dict(batch=None, params_dtype="bfloat16"), (1, 3)),
    "weights_as_argument_train_mode_bn": (dict(batch=1, bundle_params=False, train_mode_bn=True), (1,)),
}


@pytest.fixture(autouse=True)
def two_threads():
    """2 torch threads a test: the suite runs several workers on the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def lowered(get):
    cfg = get()
    cfg.merge_from_list(OPTS)
    return cfg


def seeded_variables(seed: int = 0):
    """The JAX detector's {"params", "batch_stats"} at the shapes of its init
    (jax.eval_shape: traced, not run), filled with seeded values at the
    scales of models/faster_rcnn.py:init_weights: kernels normal with std
    1/sqrt(fan_in) (0.01 in the RPN head and for cls_score, 0.001 for
    bbox_pred), zero biases, BN scale 1, mean 0, var 1."""
    shapes = jax.eval_shape(lambda: JaxFasterRCNN(jax_lower(lowered(jax_get_cfg))).init(
        jax.random.key(0), jnp.zeros((1, *CANVAS, 3), jnp.float32)))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[-1] == "kernel":
            std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            if "rpn_head" in keys or "cls_score" in keys:
                std = 0.01
            elif "bbox_pred" in keys:
                std = 0.001
            return rs.normal(0, std, leaf.shape).astype(np.float32)
        return np.full(leaf.shape, 1.0 if keys[-1] in ("scale", "var") else 0.0, np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def pair():
    """The JAX detector and its variables; the port detector on the same weights."""
    jdet = JaxDetector(jax_lower(lowered(jax_get_cfg)))
    variables = seeded_variables()
    pcfg = detector_config_from_cfg(lowered(get_cfg))
    sd = state_dict_from_jax(variables, pcfg)
    return jdet, variables, Detector(pcfg, device="cpu").load_state_dict(sd), sd


def images_of(n, seed):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n,) + CANVAS + (3,)).astype(np.uint8)
    sizes = np.asarray([[64, 128], [50, 100], [64, 90], [40, 128]][:n], np.int32)
    return images, sizes


def assert_detections(got, want, box_atol, box_rtol, score_atol):
    """tests/test_torch_detector.py's _assert_detections on the artifacts' dicts."""
    gv, wv = got["valid"].numpy(), np.asarray(want["valid"])
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() > 0
    np.testing.assert_array_equal(got["classes"].numpy()[gv], np.asarray(want["classes"])[wv])
    np.testing.assert_allclose(got["boxes"].numpy()[gv], np.asarray(want["boxes"])[wv], rtol=box_rtol, atol=box_atol)
    np.testing.assert_allclose(got["scores"].numpy()[gv], np.asarray(want["scores"])[wv], rtol=0, atol=score_atol)


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_jax_artifact_and_eager(pair, tmp_path, case):
    """The port's reloaded artifact against the JAX package's reloaded
    artifact of the same mode (within the infer bounds) and against the
    port's eager Detector.infer on the same weights (bit for bit); the
    file's size as the mode says."""
    jdet, variables, pdet, sd = pair
    kw, batches = CASES[case]
    ppath, jpath = str(tmp_path / "port.sfodx"), str(tmp_path / "jax.sfodx")
    size = export.save_exported(export.export_inference(pdet, sd, CANVAS, device="cpu", **kw), ppath, {"case": case})
    jax_export.save_exported(jax_export.export_inference(jdet, variables, CANVAS, **kw), jpath, {"case": case})
    program, meta = export.load_exported(ppath, device="cpu")
    jprog, jmeta = jax_export.load_exported(jpath)
    assert meta == jmeta == {"case": case}

    weights, jweights = sd, variables
    eager = pdet
    if kw.get("params_dtype"):
        weights, jweights = export.cast_floating(sd, "bfloat16"), jax_export.cast_floating(variables, "bfloat16")
        eager = export.cast_detector(pdet, "bfloat16")
    weight_bytes = sum(v.numel() * v.element_size() for v in weights.values())
    if kw.get("bundle_params", True):
        assert weight_bytes < size < weight_bytes + 4 * 2**20
    else:
        assert size < 0.05 * weight_bytes
    for n in batches:
        images, sizes = images_of(n, seed=n)
        args, jargs = (torch.from_numpy(images), torch.from_numpy(sizes)), (images, sizes)
        if kw.get("bundle_params") is False:
            args, jargs = (export.weights_argument(program, weights),) + args, (jweights,) + jargs
        with torch.inference_mode():
            got = program.module()(*args)
        assert got["boxes"].shape == (n, 100, 4) and got["classes"].dtype == torch.int32
        assert_detections(got, jprog.call(*jargs), 1e-3, 1e-5, 1e-5)
        want = eager.infer(images, sizes, train_mode_bn=kw.get("train_mode_bn", False))
        for key in ("boxes", "scores", "classes", "valid"):
            assert torch.equal(got[key], getattr(want, key)), key
    if kw["batch"] == 1:
        images, sizes = images_of(2, seed=0)
        with pytest.raises(Exception):
            program.module()(*args[:-2], torch.from_numpy(images), torch.from_numpy(sizes))


def stack(items):
    """Per-image sets -> one batched set."""
    return Instances(*(torch.stack([getattr(i, f) for i in items]) for f in ("boxes", "scores", "classes", "valid")))


def per_image_propose(cfg, anchors, rpn_out, image_sizes, training=False):
    """The per-image loop that models/faster_rcnn.py:propose replaced."""
    pre_k, post_k = frcnn.proposal_counts(cfg, anchors.shape[0], training)
    out = []
    for obj, deltas, size in zip(rpn_out.objectness, rpn_out.deltas, image_sizes):
        idx = topk_indices(obj, pre_k)
        vals = obj[idx]
        boxes = clip_boxes(frcnn.RPN_BOX_TRANSFORM.apply_deltas(deltas[idx], anchors[idx]), size)
        valid = nonempty(boxes) & torch.isfinite(vals)
        keep = nms.nms_mask_matrix(boxes, vals, valid, cfg.rpn_nms_thresh)
        inst = Instances(boxes, vals, torch.zeros((pre_k,), dtype=torch.int32), keep)
        out.append(inst.top_k(post_k))
    return stack(out)


def per_image_roi_inference(cfg, scores, deltas, proposals, image_sizes):
    """The per-image loop that models/faster_rcnn.py:roi_inference replaced."""
    topk = cfg.detections_per_image
    c = scores.shape[-1] - 1
    out = []
    for sc, dl, pb, pv, size in zip(scores, deltas, proposals.boxes, proposals.valid, image_sizes):
        probs = torch.softmax(sc, dim=-1)[:, :-1]
        r = probs.shape[0]
        boxes = clip_boxes(frcnn.ROI_BOX_TRANSFORM.apply_deltas(dl, pb).reshape(-1, c, 4), size).reshape(r * c, 4)
        flat = probs.reshape(r * c)
        classes = torch.arange(c, dtype=torch.int32).repeat(r)
        valid = pv[:, None].expand(r, c).reshape(-1) & nonempty(boxes) & (flat > cfg.score_thresh_test)
        key = torch.where(valid, flat, torch.full_like(flat, -float("inf")))
        cand = Instances(boxes, flat, classes, valid).take(topk_indices(key, min(flat.shape[0], max(8 * topk, 1024))))
        keep = nms.batched_class_nms(cand.boxes, cand.scores, cand.classes, cand.valid, cfg.nms_thresh_test)
        out.append(cand.mask(keep).top_k(topk))
    return stack(out)


def assert_instances_equal(a, b):
    for key in ("boxes", "scores", "classes", "valid"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key


@pytest.mark.parametrize("training", [False, True], ids=["test_caps", "train_caps"])
def test_batched_pipeline_equals_per_image_loop(training):
    """propose and roi_inference on B = 1..4 images at once, bit-equal to
    the per-image loop, at a 192x384 canvas (1080 anchors: the test and the
    training post-NMS caps differ, 1000 and 1080)."""
    cfg = detector_config_from_cfg(lowered(get_cfg))
    canvas = (192, 384)
    anchors = frcnn.anchors_for(cfg, canvas, torch.device("cpu"))
    rng = np.random.RandomState(7)
    n = anchors.shape[0]
    sizes = torch.tensor([[192, 384], [150, 300], [192, 250], [100, 384]], dtype=torch.int32)
    obj = torch.from_numpy(rng.normal(0, 2, (4, n)).astype(np.float32))
    obj[:, ::97] = obj[:, 1::97]  # score ties
    deltas = torch.from_numpy(rng.normal(0, 0.3, (4, n, 4)).astype(np.float32))
    for b in (1, 2, 3, 4):
        rpn = frcnn.RPNOutput(obj[:b], deltas[:b])
        got = frcnn.propose(cfg, anchors, rpn, sizes[:b], training=training)
        want = per_image_propose(cfg, anchors, rpn, sizes[:b], training=training)
        assert_instances_equal(got, want)
        assert got.valid.sum() > 100
        r = got.boxes.shape[1]
        logits = torch.from_numpy(rng.normal(0, 2, (b, r, 9)).astype(np.float32))
        box_deltas = torch.from_numpy(rng.normal(0, 0.5, (b, r, 32)).astype(np.float32))
        dets = frcnn.roi_inference(cfg, logits, box_deltas, got, sizes[:b])
        assert_instances_equal(dets, per_image_roi_inference(cfg, logits, box_deltas, got, sizes[:b]))
        assert dets.valid.sum() >= 50 * b


def test_nms_ops_cpu_equal_plain_and_pass_opcheck():
    """The custom ops' CPU implementations are the plain versions image by
    image; their schemas, fakes and dispatch pass torch.library.opcheck; an
    empty batch and a CPU call leave the launch counters alone."""
    rng = np.random.RandomState(3)
    b = torch.from_numpy(rng.uniform(0, 200, (3, 130, 4)).astype(np.float32))
    b[..., 2:] += b[..., :2]
    s = torch.from_numpy(np.round(rng.uniform(0, 1, (3, 130)), 2).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, 1, (3, 130)) > 0.1)
    order = nms.score_order(s, v)
    sb = torch.gather(b, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    sv = torch.gather(v, 1, order).contiguous()
    _kernels.reset_launches()
    bits = torch.ops.sfod.suppress_relation_bits(sb, sv, 0.5)
    keep = torch.ops.sfod.greedy_keep_from_bits(bits, sv)
    assert bits.shape == (3, 130, 3) and bits.dtype == torch.int64 and keep.dtype == torch.bool
    for i in range(3):
        rel = nms.suppress_relation_plain(sb[i], sv[i], 0.5)
        assert torch.equal(bits[i], nms.pack_bits(rel))
        assert torch.equal(keep[i], nms.greedy_keep_plain(rel, sv[i]))
    assert torch.equal(nms.nms_mask_matrix(b, s, v, 0.5), torch.stack([nms.nms_mask_matrix(*t, 0.5) for t in zip(b, s, v)]))
    empty = torch.ops.sfod.suppress_relation_bits(sb[:0], sv[:0], 0.5)
    assert empty.shape == (0, 130, 3) and torch.ops.sfod.greedy_keep_from_bits(empty, sv[:0]).shape == (0, 130)
    assert _kernels.LAUNCHES == {"suppress_relation_bits": 0, "greedy_keep_from_bits": 0}
    torch.library.opcheck(torch.ops.sfod.suppress_relation_bits.default, (sb, sv, 0.5))
    torch.library.opcheck(torch.ops.sfod.greedy_keep_from_bits.default, (bits, sv))


def test_load_refuses_a_non_artifact_and_a_jax_artifact(tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not a simple_sfod_tpu exported model"):
        export.load_exported(str(junk), device="cpu")
    jpath = str(tmp_path / "jax.sfodx")
    jfn = jax.jit(lambda x: x * 2)
    exported = jax.export.export(jfn)(jax.ShapeDtypeStruct((2,), jnp.float32))
    jax_export.save_exported(exported, jpath, {"canvas": [64, 128]})
    with pytest.raises(ValueError, match="artifact of the JAX package .*StableHLO"):
        export.load_exported(jpath, device="cpu")


class _StubJaxTrainer:
    """What the JAX tool reads of its trainer; weights play no part in the
    metadata, and the JAX trainer's init would take most of the test."""

    class state:
        @staticmethod
        def variables():
            return {}

    detector = None

    def resume_or_load(self, resume=False):
        pass


POISONED = r"""
import sys
for name in ("jax", "jaxlib", "flax", "simple_sfod_tpu", "simple_sfod_tpu_torch.models",
             "simple_sfod_tpu_torch.config", "simple_sfod_tpu_torch.engine.trainers"):
    sys.modules[name] = None
import numpy as np, torch
from simple_sfod_tpu_torch.engine.serve import DetectionService
svc = DetectionService(sys.argv[1], device="cpu")
rs = np.random.RandomState(3)
images = torch.from_numpy(rs.randint(0, 256, (3, 64, 128, 3)).astype(np.uint8))
out = svc.infer(images, torch.tensor([[64, 128]] * 3, dtype=torch.int32))
assert out["boxes"].shape == (3, 100, 4) and out["valid"].any(), out
res = svc.predict_array(rs.randint(0, 256, (50, 100, 3)).astype(np.uint8))
svc.close()
assert res["width"] == 100 and res["detections"], res
print("served-without-model-code", svc.info()["config"], len(res["detections"]))
"""


def test_export_tools_write_equal_metadata_and_the_artifact_serves_without_model_code(tmp_path, monkeypatch):
    """tools/export_model.py of both packages on the main YAML (cut to a
    64x128 canvas) with the flags that reach the metadata write the same
    keys and values (the JAX tool on a stand-in trainer and program: the
    metadata reads neither); the port tool's artifact then loads and serves
    in a process where the port's models, config and trainers and every
    JAX module are poisoned in sys.modules."""
    import simple_sfod_tpu.engine.trainers as jax_trainers

    opts = ["TPU.CANVAS", "(64, 128)", "MODEL.ROI_BOX_HEAD.FC_DIM", "16", "TPU.DTYPE", "float32",
            "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "128", "OUTPUT_DIR", str(tmp_path / "out")]
    flags = ["--model", "student", "--batch", "poly", "--params-dtype", "bfloat16", "--train-mode-bn"]
    from simple_sfod_tpu_torch.tools import export_model

    port_path = str(tmp_path / "port.sfodx")
    export_model.main(["--config-file", MAIN_YAML, "--out", port_path, "--device", "cpu", *flags, *opts])
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import export_model as jax_tool
    finally:
        sys.path.pop(0)
    stub_program = jax.export.export(jax.jit(lambda x: x * 2))(jax.ShapeDtypeStruct((2,), jnp.float32))
    monkeypatch.setattr(jax_trainers, "build_trainer", lambda cfg, **kw: _StubJaxTrainer())
    monkeypatch.setattr(jax_export, "export_inference", lambda *a, **kw: stub_program)
    monkeypatch.setattr(sys, "argv", ["export_model.py", "--config-file", MAIN_YAML, "--out",
                                      str(tmp_path / "jax.sfodx"), *flags, *opts])
    jax_tool.main()
    metas = []
    for name in ("port.sfodx", "jax.sfodx"):
        with open(tmp_path / name, "rb") as f:
            blob = f.read(4096)
        n = int.from_bytes(blob[7:15], "little")
        metas.append(json.loads(blob[15:15 + n]))
    assert metas[0] == metas[1]
    assert metas[0]["batch"] is None and metas[0]["model"] == "student" and metas[0]["params_dtype"] == "bfloat16"

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", POISONED, port_path], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"served-without-model-code {os.path.basename(MAIN_YAML)}" in out.stdout
