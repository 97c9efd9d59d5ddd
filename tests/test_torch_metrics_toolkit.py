"""The offline metrics toolkit of the port against the JAX package's, on the
CPU: the readers (evaluation/toolkit.py, through runner.load_inputs) on
every pair of GT and detection formats that tests/test_metrics_tool.py
covers, records equal; runner.run_metrics for COCO, Pascal VOC (all-point
and 11-point) and F1 (reference and greedy) equal to 1e-12; the
metrics_tool CLI printing what the JAX tool prints, and its HTML report
byte for byte; the tube evaluator (evaluation/tube.py) equal on seeded
tubes with both interpolations, from memory and from files.

The scene: 6 images, 3 classes, up to 5 GT boxes and 9 detections an
image, made from a seed, with an empty image and a class no detection has.
YOLO coordinates are relative to each image's size, read by the port from
the PNG or JPEG header (data/native_codec.py:image_size) and by the JAX
package with PIL.
"""

import json
import math
import os
import sys
import warnings

import numpy as np
import pytest

from simple_sfod_tpu.evaluation import runner as jax_runner
from simple_sfod_tpu.evaluation import tube as jax_tube
from simple_sfod_tpu_torch.evaluation import runner, tube
from simple_sfod_tpu_torch.tools import metrics_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["person", "car", "bicycle"]
SIZES = {"a0": (128, 96), "a1": (200, 120), "a2": (64, 64), "a3": (96, 160), "a4": (128, 96), "a5": (100, 75)}
# (GT format, detection format): the pairs tests/test_metrics_tool.py reads
PAIRS = [("coco", "coco"), ("voc", "abs-xyxy"), ("yolo", "yolo"), ("abs-xywh", "abs-xyxy"), ("coco", "yolo"),
         ("abs-xyxy", "abs-xywh")]


def scene(seed=0):
    """{stem: {"boxes", "classes"}} GT and {stem: {"boxes", "classes",
    "scores"}} detections, integer pixel boxes (exact in every format)."""
    rs = np.random.RandomState(seed)
    gts, dets = {}, {}
    for i, (stem, (w, h)) in enumerate(SIZES.items()):
        n = 0 if i == 3 else rs.randint(1, 6)
        xy = rs.randint(0, [w // 2, h // 2], (n, 2))
        wh = rs.randint(4, [w // 2, h // 2], (n, 2))
        gb = np.concatenate([xy, xy + wh], 1)
        gc = rs.randint(0, 2, n)  # "bicycle" has GT only in image 5 below
        if i == 5:
            gc[:] = 2
        gts[stem] = {"boxes": gb.tolist(), "classes": gc.tolist()}
        m = rs.randint(0, 10)
        jitter = rs.randint(-3, 4, (m, 4))
        src = gb[rs.randint(0, n, m)] if n else rs.randint(0, min(w, h) // 2, (m, 4))
        db = np.clip(src + jitter, 0, None)
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 2)
        dc = rs.randint(0, 2, m)
        dets[stem] = {"boxes": db.tolist(), "classes": dc.tolist(), "scores": np.round(rs.uniform(0.05, 1, m), 3).tolist()}
    return gts, dets


def _write_images(d):
    """Each scene image, seeded pixels at its size: PNG, JPEG for odd indices."""
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rs = np.random.RandomState(7)
    for i, (stem, (w, h)) in enumerate(SIZES.items()):
        img = Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        img.save(os.path.join(d, f"{stem}.{'jpg' if i % 2 else 'png'}"))
    return d


def _coco(path, recs, detections, ids=lambda stem: int(stem[1:]) + 1):
    """COCO JSON of the records; image ids by `ids` (integers, or the
    stems where the detections are txt files named by stem)."""
    if detections:
        out = [{"image_id": ids(s), "category_id": c + 1, "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                "score": sc} for s, r in recs.items() for b, c, sc in zip(r["boxes"], r["classes"], r["scores"])]
    else:
        out = {"images": [{"id": ids(s), "file_name": f"{s}.png", "width": SIZES[s][0], "height": SIZES[s][1]}
                          for s in recs],
               "categories": [{"id": i + 1, "name": n} for i, n in enumerate(NAMES)],
               "annotations": [{"id": k, "image_id": ids(s), "category_id": c + 1,
                                "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]], "area": (b[2] - b[0]) * (b[3] - b[1]),
                                "iscrowd": 0}
                               for k, (s, b, c) in enumerate((s, b, c) for s, r in recs.items()
                                                             for b, c in zip(r["boxes"], r["classes"]))]}
    with open(path, "w") as f:
        json.dump(out, f)
    return path


def _voc(d, recs):
    os.makedirs(d)
    for s, r in recs.items():
        objs = "".join(f"<object><name>{NAMES[c]}</name><bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
                       f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>"
                       for b, c in zip(r["boxes"], r["classes"]))
        with open(os.path.join(d, f"{s}.xml"), "w") as f:
            f.write(f"<annotation>{objs}</annotation>")
    return d


def _txt(d, recs, fmt, detections, numeric=False):
    os.makedirs(d)
    for s, r in recs.items():
        w, h = SIZES[s]
        lines = []
        for i, (b, c) in enumerate(zip(r["boxes"], r["classes"])):
            if fmt == "yolo":
                coords = f"{(b[0] + b[2]) / 2 / w} {(b[1] + b[3]) / 2 / h} {(b[2] - b[0]) / w} {(b[3] - b[1]) / h}"
            elif fmt == "abs-xywh":
                coords = f"{b[0]} {b[1]} {b[2] - b[0]} {b[3] - b[1]}"
            else:
                coords = f"{b[0]} {b[1]} {b[2]} {b[3]}"
            conf = f" {r['scores'][i]}" if detections else ""
            lines.append(f"{c if numeric else NAMES[c]}{conf} {coords}")
        with open(os.path.join(d, f"{s}.txt"), "w") as f:
            f.write("\n".join(lines))
    return d


def write_pair(tmp, gt_fmt, det_fmt, seed=0):
    """The scene in these formats -> load_inputs' arguments."""
    gts, dets = scene(seed)
    tmp = str(tmp)
    img_dir = _write_images(os.path.join(tmp, "images"))
    if gt_fmt == "coco":
        gt = _coco(os.path.join(tmp, "gt.json"), gts, False, *([] if det_fmt == "coco" else [lambda stem: stem]))
    elif gt_fmt == "voc":
        gt = _voc(os.path.join(tmp, "gt_voc"), gts)
    else:
        gt = _txt(os.path.join(tmp, "gt_txt"), gts, gt_fmt, False)
    if det_fmt == "coco":
        det = _coco(os.path.join(tmp, "det.json"), dets, True)
    else:
        det = _txt(os.path.join(tmp, "det_txt"), dets, det_fmt, True, numeric=gt_fmt == "coco")
    names = None if gt_fmt == "coco" else NAMES
    return dict(gt=gt, gt_format=gt_fmt, det=det, det_format=det_fmt, names=names, images_dir=img_dir)


def assert_same(got, want, tol=1e-12, where="results"):
    """Nested dicts/lists/arrays/numbers equal, floats within tol, NaN == NaN."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (where, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], tol, f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(np.asarray(got, np.float64), want.astype(np.float64), rtol=0, atol=tol, err_msg=where)
    elif isinstance(want, float):
        assert (math.isnan(got) and math.isnan(want)) or abs(got - want) <= tol, (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("gt_fmt,det_fmt", PAIRS)
def test_load_inputs_and_run_metrics(tmp_path, gt_fmt, det_fmt):
    kw = write_pair(tmp_path, gt_fmt, det_fmt)
    want = jax_runner.load_inputs(**kw)
    got = runner.load_inputs(**kw)
    assert got == want
    gts, dets, names = got
    assert names == NAMES and sum(len(r["classes"]) for r in dets.values()) > 20
    for voc_method, f1_mode in (("all_point", "reference"), ("11_point", "greedy")):
        args = dict(metrics=("coco", "voc", "f1"), voc_method=voc_method, f1_mode=f1_mode, want_curves=True)
        w_res, w_curves = jax_runner.run_metrics(*want, **args)
        g_res, g_curves = runner.run_metrics(gts, dets, names, **args)
        assert_same(g_res, w_res)
        assert_same(g_curves, w_curves, where="curves")
        assert 0 < g_res["coco"]["AP50"] < 100 and 0 < g_res["f1"]["F1"]


def test_unknown_detection_classes_dropped_as_in_jax(tmp_path):
    kw = write_pair(tmp_path, "coco", "abs-xyxy")
    with open(os.path.join(kw["det"], "a0.txt"), "a") as f:
        f.write("\ntruck 0.95 10 10 50 50\n7 0.5 1 1 9 9")
    for mod in (jax_runner, runner):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = mod.load_inputs(**kw)
        assert any("dropped 2 entries" in str(c.message) for c in caught)
        if mod is jax_runner:
            want = out
    assert out == want


def jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import metrics_tool as jax_metrics_tool
    finally:
        sys.path.pop(0)
    return jax_metrics_tool


@pytest.mark.parametrize("argv", [
    ["--metrics", "coco,voc,f1"],
    ["--metrics", "f1", "--f1-mode", "greedy", "--iou", "0.6"],
    ["--metrics", "coco", "--voc-method", "11_point", "--html", "{html}"],
], ids=["all", "f1-greedy", "html"])
def test_metrics_tool_prints_what_the_jax_tool_prints(tmp_path, capsys, monkeypatch, argv):
    kw = write_pair(tmp_path, "coco", "coco")
    base = ["--gt", kw["gt"], "--gt-format", "coco", "--det", kw["det"], "--det-format", "coco"]
    outs = {}
    for which in ("jax", "port"):
        html = str(tmp_path / f"report.html")
        args = base + [a.format(html=html) for a in argv]
        if which == "jax":
            monkeypatch.setattr(sys, "argv", ["metrics_tool", *args])
            res = jax_tool().main()
        else:
            res = metrics_tool.main(args)
        captured = capsys.readouterr()
        outs[which] = (captured.out, captured.err, res)
        if "--html" in argv:
            with open(html, "rb") as f:
                outs[which] += (f.read(),)
            os.remove(html)
    assert outs["port"][0] == outs["jax"][0] and outs["port"][1] == outs["jax"][1]
    assert_same(outs["port"][2], outs["jax"][2])
    if "--html" in argv:
        assert outs["port"][3] == outs["jax"][3] and outs["port"][3].startswith(b"<!doctype html")


def test_metrics_tool_runs_as_a_module_without_torch(tmp_path):
    """`python -m simple_sfod_tpu_torch.tools.metrics_tool` in a fresh process
    imports no torch (a host tool: nothing of it needs the card)."""
    import subprocess

    kw = write_pair(tmp_path, "voc", "abs-xyxy")
    names = tmp_path / "names.txt"
    names.write_text("\n".join(NAMES))
    code = ("import runpy, sys\n"
            "sys.argv = ['metrics_tool'] + sys.argv[1:]\n"
            "runpy.run_module('simple_sfod_tpu_torch.tools.metrics_tool', run_name='__main__')\n"
            "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code, "--gt", kw["gt"], "--gt-format", "voc", "--det", kw["det"],
                          "--det-format", "abs-xyxy", "--names", str(names)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "== voc ==" in out.stdout and "VOC_AP50" in out.stdout


# ---------------------------------------------------------------- tubes
def seeded_tubes(seed=0, videos=3, cats=(1, 2, 3)):
    """GT and predicted tube dicts: per video and class, 0-3 GT tracks and
    0-4 predictions near them (jittered boxes, dropped and extra frames)."""
    rs = np.random.RandomState(seed)
    gts, preds = [], []
    for vid in range(1, videos + 1):
        for cat in cats:
            for _ in range(rs.randint(0, 4)):
                frames = sorted(rs.choice(12, rs.randint(2, 8), replace=False).tolist())
                xywh = rs.randint(0, 50, 2).tolist() + rs.randint(5, 30, 2).tolist()
                gts.append({"category_id": cat, "video_id": vid,
                            "track": [{"frame": f, "bbox": [xywh[0] + f, xywh[1], xywh[2], xywh[3]]} for f in frames]})
                for _ in range(rs.randint(0, 3)):
                    keep = [f for f in frames if rs.uniform() > 0.2] or frames[:1]
                    conf = float(np.round(rs.uniform(0.1, 1), 3))
                    preds.append({"category_id": cat, "video_id": vid, "track": [
                        {"frame": f, "confidence": conf,
                         "bbox": [xywh[0] + f + int(rs.randint(-4, 5)), xywh[1] + int(rs.randint(-4, 5)), xywh[2], xywh[3]]}
                        for f in keep]})
            if rs.uniform() > 0.5:  # a false positive far away
                preds.append({"category_id": cat, "video_id": vid, "track": [
                    {"frame": 0, "bbox": [200, 200, 10, 10], "confidence": float(np.round(rs.uniform(), 3))}]})
    return gts, preds


@pytest.mark.parametrize("method", ["all_point", "11_point"])
@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_tubes_equal_jax(method, thr):
    gts, preds = seeded_tubes()
    videos = [{"id": v} for v in (1, 2, 3, 4)]  # video 4 holds nothing
    cats = [{"id": 1, "name": "car"}, {"id": 2, "name": "person"}, {"id": 3, "name": "bike"}, {"id": 4, "name": "bus"}]
    want = jax_tube.evaluate_tubes([jax_tube.Tube(**g) for g in gts], [jax_tube.Tube(**p) for p in preds], videos,
                                   cats, thr=thr, method=method)
    got = tube.evaluate_tubes([tube.Tube(**g) for g in gts], [tube.Tube(**p) for p in preds], videos, cats, thr=thr,
                              method=method)
    assert_same(got, want, tol=0.0)
    assert 0 < got[1] < 1
    a, b = tube.Tube(**gts[0]), tube.Tube(**preds[0])
    assert tube.stt_iou(a, b) == jax_tube.stt_iou(jax_tube.Tube(**gts[0]), jax_tube.Tube(**preds[0]))


def test_tube_evaluator_files_and_refusals(tmp_path):
    gts, preds = seeded_tubes(seed=1)
    anno = tmp_path / "anno.json"
    anno.write_text(json.dumps({"videos": [{"id": 1}, {"id": 2}, {"id": 3}],
                                "categories": [{"id": 1, "name": "car"}, {"id": 2, "name": "person"},
                                               {"id": 3, "name": "bike"}], "annotations": gts}))
    pred = tmp_path / "preds.json"
    pred.write_text(json.dumps(preds))
    for method in ("all_point", "11_point"):
        assert_same(tube.TubeEvaluator(str(anno), str(pred), method).evaluate(0.5),
                    jax_tube.TubeEvaluator(str(anno), str(pred), method).evaluate(0.5), tol=0.0)
    for bad, match in (((str(anno), "p.txt", "all_point"), "extension"), ((str(anno), str(pred), "x"), "method")):
        with pytest.raises(ValueError, match=match):
            tube.TubeEvaluator(*bad)
    with pytest.raises(ValueError, match="0 < thr"):
        tube.TubeEvaluator(str(anno), str(pred)).evaluate(0.0)
