"""The port's HTTP detection service (simple_sfod_tpu_torch/engine/serve.py)
on the CPU against the JAX Detector.infer plus the JAX service's
post-processing, on the same weights (JAX-initialised, carried across by
checkpoint/from_jax.py), at a 64x128 canvas in float32.

Boxes are compared within 1e-3 px + 1e-5 relative and scores within 1e-5,
as in tests/test_torch_detector.py's end-to-end test (float32 summation
order through the backbone)."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_sfod_tpu.config import detector_config_from_cfg as jax_lower
from simple_sfod_tpu.config import get_cfg as jax_get_cfg
from simple_sfod_tpu.data.loader import _resize_shortest_edge as jax_resize
from simple_sfod_tpu.data.loader import d2_output_shape as jax_d2_output_shape
from simple_sfod_tpu.models.detector import Detector as JaxDetector
from simple_sfod_tpu_torch.checkpoint.from_jax import state_dict_from_jax
from simple_sfod_tpu_torch.config import detector_config_from_cfg, get_cfg
from simple_sfod_tpu_torch.data.loader import _resize_shortest_edge, d2_output_shape
from simple_sfod_tpu_torch.engine.serve import DetectionService, serve_in_thread
from simple_sfod_tpu_torch.models.detector import Detector

CANVAS = (64, 128)
OPTS = [
    "MODEL.BACKBONE.NAME", "build_vgg_backbone",
    "MODEL.ROI_HEADS.IN_FEATURES", "('vgg4',)",
    "MODEL.RPN.IN_FEATURES", "('vgg4',)",
    "MODEL.ROI_HEADS.NUM_CLASSES", "8",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "TPU.CANVAS", str(CANVAS),
    "INPUT.MIN_SIZE_TEST", "64",
    "INPUT.MAX_SIZE_TEST", "128",
]
NAMES = [f"c{i}" for i in range(8)]


def cfg_of(get):
    cfg = get()
    cfg.merge_from_list(OPTS)
    return cfg


@pytest.fixture(scope="module")
def weights():
    jdet = JaxDetector(jax_lower(cfg_of(jax_get_cfg)))
    variables = jax.tree_util.tree_map(np.asarray, jdet.init(jax.random.key(1), CANVAS))
    sd = state_dict_from_jax(variables, detector_config_from_cfg(cfg_of(get_cfg)))
    return jdet, variables, sd


@pytest.fixture(scope="module")
def server(weights):
    svc = DetectionService(cfg_of(get_cfg), weights[2], device="cpu", batch=2, max_wait_ms=5.0, class_names=NAMES)
    srv, url = serve_in_thread(svc)
    yield svc, url
    srv.shutdown()
    srv.server_close()
    svc.close()


def jax_reference(weights, img, min_score=0.0):
    """JAX Detector.infer on the loader-parity canvas, then the JAX service's
    post-processing (engine/serve.py predict_array)."""
    jdet, variables, _ = weights
    oh, ow = img.shape[:2]
    resized, scale = jax_resize(img.astype(np.float32), 64, 128)
    h, w = min(resized.shape[0], CANVAS[0]), min(resized.shape[1], CANVAS[1])
    canvas = np.zeros(CANVAS + (3,), np.uint8)
    canvas[:h, :w] = np.clip(resized[:h, :w], 0, 255).astype(np.uint8)
    dets = jdet.infer(variables, jnp.asarray(canvas[None]), jnp.asarray([[h, w]], np.int32))
    boxes, scores = np.asarray(dets.boxes[0]), np.asarray(dets.scores[0])
    classes, valid = np.asarray(dets.classes[0]), np.asarray(dets.valid[0])
    keep = valid & (scores >= min_score)
    inv = 1.0 / np.maximum(np.concatenate([scale, scale]), 1e-8)
    file_boxes = np.clip(boxes[keep] * inv, 0, [ow, oh, ow, oh])
    order = np.argsort(-scores[keep], kind="stable")
    return file_boxes[order], scores[keep][order], classes[keep][order]


def post(url, body, query=""):
    req = urllib.request.Request(f"{url}/predict{query}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def assert_matches(res, want, shape, names=NAMES):
    boxes, scores, classes = want
    assert res["height"] == shape[0] and res["width"] == shape[1]
    dets = res["detections"]
    assert len(dets) == len(scores) > 0
    np.testing.assert_array_equal([d["class"] for d in dets], classes)
    assert all(d["class_name"] == (names[d["class"]] if names else str(d["class"])) for d in dets)
    np.testing.assert_allclose([d["score"] for d in dets], scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose([d["box"] for d in dets], boxes, rtol=1e-5, atol=1e-3)


def test_http_predict_matches_jax(server, weights):
    svc, url = server
    img = np.random.RandomState(0).randint(0, 256, CANVAS + (3,)).astype(np.uint8)
    assert_matches(post(url, npy(img)), jax_reference(weights, img), CANVAS)


def test_http_predict_resized_image_matches_jax(server, weights):
    """A 40x80 image goes through the PIL resize to 64x128; boxes come back
    in the file's coordinates."""
    svc, url = server
    img = np.random.RandomState(1).randint(0, 256, (40, 80, 3)).astype(np.uint8)
    res = post(url, npy(img), "?min_score=0.1")
    want = jax_reference(weights, img, min_score=0.1)
    assert_matches(res, want, (40, 80))
    for d in res["detections"]:
        x0, y0, x1, y1 = d["box"]
        assert 0 <= x0 <= x1 <= 80 and 0 <= y0 <= y1 <= 40


def test_info_and_errors(server):
    svc, url = server
    info = json.loads(urllib.request.urlopen(f"{url}/", timeout=30).read())
    assert info["canvas"] == list(CANVAS) and info["batch"] == 2 and info["platforms"] == ["cpu"]
    assert info["class_names"] == NAMES and info["min_size"] == 64 and info["max_size"] == 128
    with pytest.raises(urllib.error.HTTPError) as e:
        post(url, npy(np.zeros((8, 8), np.uint8)))
    assert e.value.code == 400 and "HxWx3" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nothing", timeout=30)
    assert e.value.code == 404


def test_microbatch_coalesces_concurrent_requests(server):
    """Concurrent predicts share one device call, and each requester gets
    its own image's detections."""
    svc, _ = server
    rs = np.random.RandomState(2)
    imgs = [rs.randint(0, 256, CANVAS + (3,)).astype(np.uint8) for _ in range(2)]
    singles = [svc.predict_array(im) for im in imgs]
    results = [None, None]
    svc._batcher._gate.clear()
    calls = svc._batcher.calls

    def run(i):
        results[i] = svc.predict_array(imgs[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    try:
        for th in threads:
            th.start()
        # both queued before the worker may drain
        for _ in range(200):
            with svc._batcher._cv:
                if len(svc._batcher._queue) == 2:
                    break
            threading.Event().wait(0.01)
    finally:
        svc._batcher._gate.set()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert svc._batcher.calls == calls + 1
    for got, want in zip(results, singles):
        assert [d["class"] for d in got["detections"]] == [d["class"] for d in want["detections"]]
        np.testing.assert_allclose(
            [d["box"] for d in got["detections"]], [d["box"] for d in want["detections"]], rtol=1e-5, atol=1e-3
        )


def test_service_from_saved_file_and_close(weights, tmp_path):
    path = str(tmp_path / "w.pth")
    torch.save({"model": weights[2]}, path)
    svc = DetectionService(cfg_of(get_cfg), path, device="cpu")
    img = np.random.RandomState(0).randint(0, 256, CANVAS + (3,)).astype(np.uint8)
    assert_matches(svc.predict_array(img), jax_reference(weights, img), CANVAS, names=None)
    svc.close()
    assert not svc._batcher._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.predict_array(img)


@pytest.mark.parametrize("hw", [(1024, 2048), (600, 1200), (375, 1242), (40, 80), (801, 599), (3, 5000)])
def test_d2_output_shape_matches_jax(hw):
    assert d2_output_shape(*hw, 600, 1333) == jax_d2_output_shape(*hw, 600, 1333)


@pytest.mark.parametrize("hw", [(40, 80), (64, 128), (70, 50)])
def test_resize_matches_jax(hw):
    img = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(np.uint8)
    got, gs = _resize_shortest_edge(img, 64, 128)
    want, ws = jax_resize(img.astype(np.float32), 64, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gs, ws)


def test_serve_cli_on_the_r101_adabn_yaml(tmp_path):
    """`python -m simple_sfod_tpu_torch.engine.serve --config-file
    configs/r_101_c4_cs_foggy_adabn.yaml` (ResNet-101 C4, full depth; a
    narrow box head and a 64x128 canvas on the CPU) answers a request."""
    import os
    import subprocess
    import sys

    from simple_sfod_tpu_torch.models.faster_rcnn import FasterRCNN, init_weights

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yaml = os.path.join(root, "configs", "r_101_c4_cs_foggy_adabn.yaml")
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    opts = ["MODEL.ROI_BOX_HEAD.FC_DIM", "64", "TPU.CANVAS", str(CANVAS), "INPUT.MIN_SIZE_TEST", "60"]
    cfg.merge_from_list(opts)
    path = str(tmp_path / "r101.pth")
    torch.save({"model": init_weights(FasterRCNN(detector_config_from_cfg(cfg)), 0).state_dict()}, path)
    cmd = [sys.executable, "-m", "simple_sfod_tpu_torch.engine.serve", "--config-file", yaml, "--weights", path,
           "--device", "cpu", "--port", "0", *opts]
    proc = subprocess.Popen(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "r_101_c4_cs_foggy_adabn.yaml" in line and " on http://" in line, (line, proc.stderr.read()[-2000:])
        url = line.strip().rsplit(" on ", 1)[1].rstrip("/")
        buf = io.BytesIO()
        np.save(buf, np.random.RandomState(0).randint(0, 256, (60, 120, 3)).astype(np.uint8))
        req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(), method="POST")
        got = json.loads(urllib.request.urlopen(req, timeout=120).read())
        assert "detections" in got, got
        assert all(np.isfinite(d["box"]).all() and np.isfinite(d["score"]) for d in got["detections"])
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- the artifact route: DetectionService over engine/export.py's file -------
ARTIFACT_META = {"canvas": list(CANVAS), "min_size": 64, "max_size": 128, "image_format": "BGR",
                 "class_names": NAMES, "model": "teacher", "params_dtype": None, "train_mode_bn": False,
                 "config": "serve-test"}


@pytest.fixture(scope="module")
def artifact_paths(weights, tmp_path_factory):
    """A poly-batch artifact with its weights and a batch-1 one without."""
    from simple_sfod_tpu_torch.engine.export import export_inference, save_exported

    det = Detector(detector_config_from_cfg(cfg_of(get_cfg)), device="cpu").load_state_dict(weights[2])
    out = tmp_path_factory.mktemp("artifacts")
    paths = {}
    for name, batch, bundle in (("poly", None, True), ("argument", 1, False)):
        paths[name] = str(out / f"{name}.sfodx")
        program = export_inference(det, weights[2], CANVAS, batch=batch, bundle_params=bundle, device="cpu")
        save_exported(program, paths[name], dict(ARTIFACT_META, batch=batch, bundle_params=bundle))
    return paths


def test_artifact_http_info_and_predict_match_jax(weights, artifact_paths):
    """GET / gives the artifact's info with the JAX service's keys; POST
    /predict of a canvas-sized and a resized image matches the JAX
    Detector.infer plus the JAX service's post-processing."""
    svc = DetectionService(artifact_paths["poly"], device="cpu")
    srv, url = serve_in_thread(svc)
    try:
        info = json.loads(urllib.request.urlopen(f"{url}/", timeout=30).read())
        assert info == {"canvas": list(CANVAS), "batch": None, "min_size": 64, "max_size": 128, "image_format": "BGR",
                        "class_names": NAMES, "platforms": ["cpu"], "model": "teacher", "config": "serve-test"}
        img = np.random.RandomState(0).randint(0, 256, CANVAS + (3,)).astype(np.uint8)
        assert_matches(post(url, npy(img)), jax_reference(weights, img), CANVAS)
        small = np.random.RandomState(1).randint(0, 256, (40, 80, 3)).astype(np.uint8)
        assert_matches(post(url, npy(small), "?min_score=0.1"), jax_reference(weights, small, min_score=0.1), (40, 80))
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_artifact_poly_batch_pads_to_a_power_of_two(artifact_paths):
    """3 concurrent requests make one call of batch 4 (the pad slot's
    output dropped), each requester getting its own image's detections."""
    svc = DetectionService(artifact_paths["poly"], device="cpu", max_wait_ms=5.0)
    assert [svc.call_batch(k) for k in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    rs = np.random.RandomState(2)
    imgs = [rs.randint(0, 256, CANVAS + (3,)).astype(np.uint8) for _ in range(3)]
    singles = [svc.predict_array(im) for im in imgs]
    batches = []
    infer = svc.infer

    def record(images, sizes):
        batches.append(images.shape[0])
        return infer(images, sizes)

    svc.infer = record
    results = [None] * 3
    svc._batcher._gate.clear()
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, svc.predict_array(imgs[i]))) for i in range(3)]
    try:
        for th in threads:
            th.start()
        for _ in range(200):
            with svc._batcher._cv:
                if len(svc._batcher._queue) == 3:
                    break
            threading.Event().wait(0.01)
    finally:
        svc._batcher._gate.set()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    svc.close()
    assert batches == [4]
    for got, want in zip(results, singles):
        assert [d["class"] for d in got["detections"]] == [d["class"] for d in want["detections"]]
        np.testing.assert_allclose(
            [d["box"] for d in got["detections"]], [d["box"] for d in want["detections"]], rtol=1e-5, atol=1e-3
        )


def test_artifact_without_weights_serves_with_them(weights, artifact_paths):
    """A --no-bundle-params artifact refuses to serve without weights and
    serves with the state dict (in-memory or a .pth) as JAX's does with its
    variables."""
    with pytest.raises(ValueError, match="no-bundle-params"):
        DetectionService(artifact_paths["argument"], device="cpu")
    svc = DetectionService(artifact_paths["argument"], weights[2], device="cpu")
    assert svc.info()["batch"] == 1
    img = np.random.RandomState(3).randint(0, 256, CANVAS + (3,)).astype(np.uint8)
    assert_matches(svc.predict_array(img), jax_reference(weights, img), CANVAS)
    svc.close()
