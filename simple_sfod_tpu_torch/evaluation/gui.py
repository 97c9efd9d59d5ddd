"""Interactive metrics shell, a local web app (the port's copy of
`simple_sfod_tpu/evaluation/gui.py`, the web re-build of the reference's
PyQt5 GUI, daod/src/ui/), over the engines the CLI uses
(evaluation/runner.py and report.render_report), on the standard library's
http.server alone:

  /        the form: GT dir+format, class names, images dir, detections
           dir+format, metric selection, IoU threshold, VOC interpolation,
           output dir                                  (main_ui.py's form)
  /stats   GT or detection statistics: box/image counts, per-class table +
           bar chart, annotated-image browser         (details.py:36-104)
  /view    one image with GT (green) / detection (red) boxes drawn as an
           SVG overlay, prev/next navigation          (details.py:106-130)
  /run     compute the selected metrics, render the report inline and
           write report.html + results.json to the output dir
                                                      (run_ui.py:298-394)
  /imgfile an image of the images dir, refused (403) outside it

The browser's image size comes from the PNG or JPEG header
(`data/native_codec.py:image_size`), not from an image library; another
format is drawn at 640x480, as the JAX GUI draws an image it cannot open.
Given the same state every page is the JAX GUI's, byte for byte.

Launch: python -m simple_sfod_tpu_torch.tools.metrics_gui [--port 8350].
Binds 127.0.0.1.
"""

from __future__ import annotations

import html
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..data.native_codec import image_size
from .report import render_report
from .runner import DET_FORMATS, GT_FORMATS, load_inputs, record_arrays, run_metrics

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif")

FIELDS = (
    "gt",
    "gt_format",
    "names",
    "img_dir",
    "det",
    "det_format",
    "iou",
    "voc_method",
    "out",
)

_CSS = """
body{font-family:system-ui,sans-serif;margin:24px auto;max-width:1100px;color:#1a1a2e}
h1{font-size:22px} h2{font-size:17px;margin-top:28px}
fieldset{border:1px solid #ccd;border-radius:8px;margin:14px 0;padding:10px 14px}
legend{font-weight:600} label{margin-right:14px}
input[type=text]{width:560px;padding:4px 6px;border:1px solid #bbc;border-radius:4px}
table{border-collapse:collapse;margin:10px 0}
td,th{border:1px solid #ccd;padding:4px 10px;text-align:left}
.btn{display:inline-block;padding:6px 16px;margin:4px 8px 4px 0;border:1px solid #667;
border-radius:6px;background:#eef;cursor:pointer;text-decoration:none;color:#1a1a2e}
.err{color:#a22;background:#fee;padding:8px 12px;border-radius:6px}
.muted{color:#667}
"""


def _page(title: str, body: str) -> str:
    return (
        f"<!doctype html><html><head><meta charset='utf-8'><title>{html.escape(title)}"
        f"</title><style>{_CSS}</style></head><body><h1>{html.escape(title)}</h1>"
        f"{body}</body></html>"
    )


def _esc(v) -> str:
    return html.escape(str(v if v is not None else ""), quote=True)


def _radio(name: str, options, chosen: str) -> str:
    return " ".join(
        f"<label><input type='radio' name='{name}' value='{o}'"
        f"{' checked' if o == chosen else ''}> {o}</label>"
        for o in options
    )


def form_page(state: Dict[str, str], message: str = "") -> str:
    s = {k: state.get(k, "") for k in FIELDS}
    # reference GUI defaults every metric checked (main_ui.py); an empty
    # round-tripped selection re-checks all, matching run_page's fallback
    metrics = state.get("metrics") or ["coco", "voc", "f1"]
    checks = " ".join(
        f"<label><input type='checkbox' name='metrics' value='{m}'"
        f"{' checked' if m in metrics else ''}> {m}</label>"
        for m in ("coco", "voc", "f1")
    )
    msg = f"<p class='err'>{html.escape(message)}</p>" if message else ""
    body = f"""{msg}<form method='post'>
<fieldset><legend>Ground truth</legend>
<p><label>Annotations (file or dir): <input type='text' name='gt' value='{_esc(s["gt"])}'></label></p>
<p>Format: {_radio("gt_format", GT_FORMATS, s["gt_format"] or "coco")}</p>
<p><label>Class names file (optional): <input type='text' name='names' value='{_esc(s["names"])}'></label></p>
<p><label>Images dir (optional, for yolo coords + the image browser):
<input type='text' name='img_dir' value='{_esc(s["img_dir"])}'></label></p>
<button class='btn' formaction='/stats?which=gt'>GT statistics</button>
</fieldset>
<fieldset><legend>Detections</legend>
<p><label>Detections (file or dir): <input type='text' name='det' value='{_esc(s["det"])}'></label></p>
<p>Format: {_radio("det_format", DET_FORMATS, s["det_format"] or "coco")}</p>
<button class='btn' formaction='/stats?which=det'>Detection statistics</button>
</fieldset>
<fieldset><legend>Metrics</legend>
<p>{checks}
<label>IoU threshold: <input type='text' name='iou' value='{_esc(s["iou"] or "0.5")}' style='width:60px'></label>
VOC interpolation: {_radio("voc_method", ("all_point", "11_point"), s["voc_method"] or "all_point")}</p>
<p><label>Output dir (optional, writes report.html + results.json):
<input type='text' name='out' value='{_esc(s["out"])}'></label></p>
<button class='btn' formaction='/run'>RUN</button>
</fieldset></form>"""
    return _page("simple_sfod_tpu · detection metrics", body)


def _state_query(state: Dict) -> str:
    pairs = [(k, state.get(k, "")) for k in FIELDS if state.get(k)]
    pairs += [("metrics", m) for m in state.get("metrics", [])]
    return urllib.parse.urlencode(pairs)


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return -1.0


# small parse caches so prev/next in the image browser doesn't re-read the
# whole GT/detection datasets per click (keyed on paths + mtimes; a handful
# of entries is plenty for one user at the browser)
_INPUTS_CACHE: Dict[tuple, tuple] = {}
_STEM_CACHE: Dict[tuple, Dict[str, object]] = {}
# ThreadingHTTPServer handles requests concurrently: the check-then-evict
# sequences below race without a lock (KeyError on double-pop, unbounded
# growth on concurrent insert)
_CACHE_LOCK = threading.Lock()


def _load_state_inputs(state: Dict, need_det: bool):
    names_path = state.get("names", "")
    gt, det = state.get("gt", ""), state.get("det") if need_det else None
    key = (
        gt, state.get("gt_format", "coco"), det, state.get("det_format", "coco"),
        names_path, state.get("img_dir", ""),
        _mtime(gt), _mtime(det or ""), _mtime(names_path),
    )
    with _CACHE_LOCK:
        hit = _INPUTS_CACHE.get(key)
    if hit is not None:
        return hit
    names = None
    if names_path:
        with open(names_path) as f:
            names = [line.strip() for line in f if line.strip()]
    out = load_inputs(
        gt,
        state.get("gt_format", "coco"),
        det,
        state.get("det_format", "coco"),
        names=names,
        images_dir=state.get("img_dir") or None,
    )
    with _CACHE_LOCK:
        while len(_INPUTS_CACHE) >= 4:
            _INPUTS_CACHE.pop(next(iter(_INPUTS_CACHE)), None)
        _INPUTS_CACHE[key] = out
    return out


def _coco_stem_map(gt_path: str) -> Dict[str, object]:
    """stem(file_name) -> coco image id, for the image browser under coco GT."""
    key = (gt_path, _mtime(gt_path))
    with _CACHE_LOCK:
        hit = _STEM_CACHE.get(key)
    if hit is not None:
        return hit
    try:
        with open(gt_path) as f:
            data = json.load(f)
        out = {
            os.path.splitext(os.path.basename(img.get("file_name", "")))[0]: img["id"]
            for img in data.get("images", [])
            if img.get("file_name")
        }
    except (OSError, ValueError):
        out = {}
    with _CACHE_LOCK:
        while len(_STEM_CACHE) >= 4:
            _STEM_CACHE.pop(next(iter(_STEM_CACHE)), None)
        _STEM_CACHE[key] = out
    return out


def _list_images(img_dir: str) -> List[str]:
    try:
        return sorted(
            f for f in os.listdir(img_dir) if f.lower().endswith(IMAGE_EXTS)
        )
    except OSError:
        return []


def _bar_chart(counts: Dict[str, int], width=640, bar_h=22) -> str:
    if not counts:
        return ""
    peak = max(counts.values()) or 1
    rows, y = [], 4
    for name, n in sorted(counts.items(), key=lambda kv: -kv[1]):
        w = int(440 * n / peak)
        rows.append(
            f"<text x='4' y='{y + 15}' font-size='12'>{html.escape(str(name))}</text>"
            f"<rect x='150' y='{y + 3}' width='{max(w, 1)}' height='{bar_h - 8}' fill='#5b7bd5'/>"
            f"<text x='{154 + w}' y='{y + 15}' font-size='12'>{n}</text>"
        )
        y += bar_h
    return (
        f"<svg width='{width}' height='{y + 4}' xmlns='http://www.w3.org/2000/svg'>"
        + "".join(rows)
        + "</svg>"
    )


def stats_page(state: Dict, which: str) -> str:
    gts, dets, class_names = _load_state_inputs(state, need_det=(which == "det"))
    records = dets if which == "det" else gts
    records = records or {}
    total_imgs = len(records)
    per_class: Dict[str, int] = {}
    total_boxes = 0
    for rec in records.values():
        for c in rec.get("classes", []):
            name = class_names[c] if 0 <= c < len(class_names) else f"class_{c}"
            per_class[name] = per_class.get(name, 0) + 1
            total_boxes += 1
    # details.py:25 — "A total of #TOTAL_BB# bounding boxes were found in
    # #TOTAL_IMAGES# images"
    body = (
        f"<p>A total of <b>{total_boxes}</b> bounding boxes were found in "
        f"<b>{total_imgs}</b> images.</p>"
        f"<h2>Boxes per class</h2>{_bar_chart(per_class)}"
        "<table><tr><th>class</th><th>boxes</th></tr>"
        + "".join(
            f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
            for k, v in sorted(per_class.items(), key=lambda kv: -kv[1])
        )
        + "</table>"
    )
    img_dir = state.get("img_dir", "")
    files = _list_images(img_dir) if img_dir else []
    if files:
        q = _state_query(state)
        body += (
            f"<h2>Image browser ({len(files)} images)</h2>"
            f"<p><a class='btn' href='/view?{q}&which={which}&idx=0'>open browser</a></p>"
        )
    elif img_dir:
        body += "<p class='muted'>No images found in the images dir.</p>"
    body += "<p><a class='btn' href='javascript:history.back()'>back</a></p>"
    title = "Detection statistics" if which == "det" else "Ground-truth statistics"
    return _page(title, body)


def _overlay_svg(
    state: Dict, stem: str, fname: str, size: Tuple[int, int], gt_rec: dict, det_rec: dict
) -> str:
    w, h = size
    q = urllib.parse.urlencode({"dir": state.get("img_dir", ""), "name": fname})
    parts = [
        f"<svg width='{min(w, 1000)}' viewBox='0 0 {w} {h}' "
        "xmlns='http://www.w3.org/2000/svg' xmlns:xlink='http://www.w3.org/1999/xlink'>",
        f"<image href='/imgfile?{q}' x='0' y='0' width='{w}' height='{h}'/>",
    ]
    if gt_rec:
        gb, gc = record_arrays(gt_rec, False)
        for (x0, y0, x1, y1), _ in zip(gb, gc):
            parts.append(
                f"<rect x='{x0:.1f}' y='{y0:.1f}' width='{x1 - x0:.1f}' height='{y1 - y0:.1f}'"
                " fill='none' stroke='#19c37d' stroke-width='2'/>"
            )
    if det_rec:
        db, ds, dc = record_arrays(det_rec, True)
        for (x0, y0, x1, y1), s in zip(db, ds):
            parts.append(
                f"<rect x='{x0:.1f}' y='{y0:.1f}' width='{x1 - x0:.1f}' height='{y1 - y0:.1f}'"
                " fill='none' stroke='#e5484d' stroke-width='2'/>"
                f"<text x='{x0:.1f}' y='{max(y0 - 3, 10):.1f}' font-size='12'"
                f" fill='#e5484d'>{s:.2f}</text>"
            )
    parts.append("</svg>")
    return "".join(parts)


def view_page(state: Dict, which: str, idx: int) -> str:
    img_dir = state.get("img_dir", "")
    files = _list_images(img_dir)
    if not files:
        return _page("Image browser", "<p class='err'>no image to show</p>")
    idx = max(0, min(idx, len(files) - 1))
    fname = files[idx]
    stem = os.path.splitext(fname)[0]
    gts, dets, _ = _load_state_inputs(state, need_det=(which == "det"))
    key = stem
    if state.get("gt_format", "coco") == "coco":
        key = _coco_stem_map(state.get("gt", "")).get(stem, stem)
    gt_rec = (gts or {}).get(key) or (gts or {}).get(stem)
    det_rec = (dets or {}).get(key) or (dets or {}).get(stem) if which == "det" else None
    try:
        h, w = image_size(os.path.join(img_dir, fname))
        size = (w, h)
    except (OSError, ValueError):
        size = (640, 480)
    svg = _overlay_svg(state, stem, fname, size, gt_rec, det_rec)
    q = _state_query(state)
    nav = (
        f"<p><a class='btn' href='/view?{q}&which={which}&idx={idx - 1}'>&larr; previous</a>"
        f" <b>{html.escape(fname)}</b> ({idx + 1}/{len(files)}) "
        f"<a class='btn' href='/view?{q}&which={which}&idx={idx + 1}'>next &rarr;</a>"
        "<a class='btn' href='javascript:history.back()'>back</a></p>"
        "<p class='muted'>green = ground truth, red = detections (score above box)</p>"
    )
    return _page("Image browser", nav + svg)


def run_page(state: Dict) -> str:
    metrics = state.get("metrics") or ["coco", "voc", "f1"]
    iou = float(state.get("iou") or 0.5)
    voc_method = state.get("voc_method") or "all_point"
    gts, dets, class_names = _load_state_inputs(state, need_det=True)
    if dets is None:
        raise ValueError("no detections path given")
    # only the selected families run; PR curves render iff voc is among them
    results, curves = run_metrics(
        gts, dets, class_names, metrics=set(metrics), iou=iou,
        voc_method=voc_method, want_curves=True,
    )
    doc = render_report(
        results,
        class_names,
        curves=curves,
        title="Detection metrics",
        subtitle=f"GT: {state.get('gt')} ({state.get('gt_format')}) · "
        f"detections: {state.get('det')} ({state.get('det_format')}) · IoU {iou}",
    )
    out = state.get("out", "")
    saved = ""
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "report.html"), "w") as f:
            f.write(doc)
        jsonable = {
            fam: {k: v for k, v in res.items() if isinstance(v, (int, float, str, dict))}
            for fam, res in results.items()
        }
        with open(os.path.join(out, "results.json"), "w") as f:
            json.dump(jsonable, f, indent=2, default=float)
        saved = (
            f"<p class='muted'>saved {html.escape(os.path.join(out, 'report.html'))}"
            " and results.json</p>"
        )
    nav = (
        "<div style='font-family:system-ui;margin:12px 24px'>"
        "<a href='javascript:history.back()' style='text-decoration:none'>&larr; back to the"
        f" form</a>{saved}</div>"
    )
    # inject a back-link into the self-contained report document
    return doc.replace("<body>", "<body>" + nav, 1)


class MetricsGuiHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, body: str, code: int = 200, ctype: str = "text/html; charset=utf-8"):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _params(self) -> Dict:
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        if self.command == "POST":
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length).decode()
            for k, v in urllib.parse.parse_qs(body).items():
                qs.setdefault(k, []).extend(v)
        state = {k: v[0] for k, v in qs.items() if k != "metrics"}
        if "metrics" in qs:  # absent on a fresh load -> form defaults apply
            state["metrics"] = qs["metrics"]
        return state

    def _route(self):
        path = urllib.parse.urlparse(self.path).path
        state = self._params()
        try:
            if path == "/":
                return self._send(form_page(state))
            if path == "/stats":
                return self._send(stats_page(state, state.get("which", "gt")))
            if path == "/view":
                return self._send(
                    view_page(state, state.get("which", "gt"), int(state.get("idx", 0)))
                )
            if path == "/run":
                return self._send(run_page(state))
            if path == "/imgfile":
                return self._imgfile(state)
            return self._send(_page("Not found", "<p class='err'>unknown page</p>"), 404)
        except Exception as e:  # surface errors like run_ui's popups
            return self._send(form_page(state, message=f"{type(e).__name__}: {e}"), 200)

    def _imgfile(self, state: Dict):
        img_dir = os.path.realpath(state.get("dir", ""))
        name = os.path.basename(state.get("name", ""))
        full = os.path.realpath(os.path.join(img_dir, name))
        if not full.startswith(img_dir + os.sep) or not full.lower().endswith(IMAGE_EXTS):
            return self._send(_page("Forbidden", "<p class='err'>bad image path</p>"), 403)
        try:
            with open(full, "rb") as f:
                data = f.read()
        except OSError:
            return self._send(_page("Not found", "<p class='err'>no such image</p>"), 404)
        ext = os.path.splitext(full)[1].lower().lstrip(".")
        ctype = {
            "jpg": "image/jpeg", "jpeg": "image/jpeg", "png": "image/png",
            "bmp": "image/bmp", "tiff": "image/tiff", "tif": "image/tiff",
        }.get(ext, "application/octet-stream")
        self._send(data, ctype=ctype)

    do_GET = _route
    do_POST = _route


def make_server(host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), MetricsGuiHandler)


def run_server(host: str = "127.0.0.1", port: int = 8350):
    srv = make_server(host, port)
    print(f"metrics GUI listening on http://{host}:{srv.server_address[1]}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


def serve_in_thread(host: str = "127.0.0.1", port: int = 0):
    """Start the server on a daemon thread; returns (server, base_url)."""
    srv = make_server(host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, f"http://{host}:{srv.server_address[1]}"
