"""The port's HTML report (evaluation/report.py) and web GUI
(evaluation/gui.py) against the JAX package's, on the CPU: render_report
byte for byte on the runner's results (with and without curves, NaN and
missing classes); every GUI page (form, GT and detection statistics, the
image browser over PNG and JPEG images, a metrics run with its report.html
and results.json) byte for byte on the same state; and the port's server
over HTTP: 200 on each page, an image served with its type, the traversal
guard's 403 and the 404 of an unknown page.
"""

import os
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from simple_sfod_tpu.evaluation import gui as jax_gui
from simple_sfod_tpu.evaluation import report as jax_report
from simple_sfod_tpu.evaluation import runner as jax_runner
from simple_sfod_tpu_torch.evaluation import gui, report, runner
from test_torch_metrics_toolkit import NAMES, write_pair


@pytest.fixture(scope="module")
def coco_scene(tmp_path_factory):
    """The toolkit tests' scene as COCO GT and results, with its images
    (PNG and JPEG, named as the GT's file_names' stems: the browser's keys)."""
    kw = write_pair(tmp_path_factory.mktemp("gui"), "coco", "coco")
    return {"gt": kw["gt"], "gt_format": "coco", "det": kw["det"], "det_format": "coco", "img_dir": kw["images_dir"]}


def test_render_report_byte_equal(coco_scene):
    gts, dets, names = runner.load_inputs(coco_scene["gt"], "coco", coco_scene["det"], "coco")
    results, curves = runner.run_metrics(gts, dets, names, want_curves=True)
    for args in ((results, names), (results, names, curves), ({"coco": {"AP": float("nan"), "AP50": 12.0}}, ["a", "b"],
                 {"a": (np.asarray([0.0, 0.5]), np.asarray([1.0, 0.8]))})):
        for kw in ({}, {"title": "T <&>", "subtitle": "sub · x"}):
            assert report.render_report(*args, **kw) == jax_report.render_report(*args, **kw)
    doc = report.render_report(results, names, curves)
    assert doc.count("<svg") == len(NAMES) and "polyline" in doc


def states(s, out):
    """(name, page function name, args) of every page on the scene `s`."""
    full = dict(s, names="", iou="0.5", voc_method="all_point")
    return [
        ("form-empty", "form_page", ({},)),
        ("form-filled", "form_page", (dict(full, metrics=["coco", "f1"]), "ValueError: boom <x>")),
        ("stats-gt", "stats_page", (full, "gt")),
        ("stats-det", "stats_page", (full, "det")),
        ("stats-no-images", "stats_page", (dict(full, img_dir=os.path.dirname(s["gt"])), "gt")),
        *[(f"view-{which}-{i}", "view_page", (full, which, i)) for which in ("gt", "det") for i in (0, 1, 9)],
        ("run", "run_page", (dict(full, metrics=["coco", "voc", "f1"], out=out),)),
        ("run-voc-11", "run_page", (dict(full, metrics=["voc"], voc_method="11_point", iou="0.6"),)),
    ]


def test_pages_byte_equal(coco_scene, tmp_path):
    out = str(tmp_path / "out")
    for name, fn, args in states(coco_scene, out):
        want = getattr(jax_gui, fn)(*args)
        artifacts = {}
        if name == "run":
            artifacts = {f: open(os.path.join(out, f), "rb").read() for f in ("report.html", "results.json")}
        got = getattr(gui, fn)(*args)
        assert got == want, name
        for f, data in artifacts.items():
            assert open(os.path.join(out, f), "rb").read() == data, f
    assert "<image href='/imgfile?" in gui.view_page(dict(coco_scene), "det", 1)


def test_view_page_image_size_from_the_header(coco_scene):
    """The browser's viewBox is the image's own size, read from the PNG
    (index 0) and the JPEG (index 1) header without an image library."""
    from simple_sfod_tpu_torch.data.native_codec import image_size

    files = sorted(os.listdir(coco_scene["img_dir"]))
    for i in (0, 1):
        h, w = image_size(os.path.join(coco_scene["img_dir"], files[i]))
        assert f"viewBox='0 0 {w} {h}'" in gui.view_page(dict(coco_scene), "gt", i)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_server_pages_images_and_traversal_guard(coco_scene):
    srv, base = gui.serve_in_thread()
    try:
        q = urllib.parse.urlencode(coco_scene)
        for path in ("/", f"/stats?which=gt&{q}", f"/stats?which=det&{q}", f"/view?which=det&idx=0&{q}",
                     f"/run?{q}&metrics=coco&metrics=voc"):
            status, ctype, body = _get(base + path)
            assert status == 200 and ctype == "text/html; charset=utf-8" and body.startswith(b"<!doctype html"), path
        status, _, body = _get(f"{base}/run?{q}&metrics=coco")
        assert b"AP50" in body and b"class='err'" not in body
        for name, ctype in (("a0.png", "image/png"), ("a1.jpg", "image/jpeg")):
            status, got_type, body = _get(f"{base}/imgfile?" + urllib.parse.urlencode({"dir": coco_scene["img_dir"], "name": name}))
            assert status == 200 and got_type == ctype
            with open(os.path.join(coco_scene["img_dir"], name), "rb") as f:
                assert body == f.read()
        for name in ("../gt.json", "../../etc/passwd", "a0.txt"):
            status, _, _ = _get(f"{base}/imgfile?" + urllib.parse.urlencode({"dir": coco_scene["img_dir"], "name": name}))
            assert status == 403, name
        assert _get(f"{base}/nope")[0] == 404
        status, _, body = _get(f"{base}/run?gt=/nonexistent/gt.json&gt_format=coco&det=x")
        assert status == 200 and b"FileNotFoundError" in body
    finally:
        srv.shutdown()
        srv.server_close()
