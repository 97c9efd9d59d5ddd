"""Static HTML report for detection metrics (the port's copy of
`simple_sfod_tpu/evaluation/report.py`, which stands in for the reference's
PyQt5 metrics GUI): one self-contained file, with no dependency and no
server, of headline stat tiles, a per-class table and per-class
precision-recall curves as inline SVG small multiples. Given the same
results it writes the same bytes as the JAX package's.
"""

from __future__ import annotations

import html
from typing import Dict, Optional, Sequence

import numpy as np

# single data hue (one series per panel -> identity carried by panel titles);
# text/grid stay in ink/neutral tones per standard chart hygiene
_HUE = "#2f6bc4"
_INK = "#1f2430"
_MUTED = "#667085"
_GRID = "#e4e7ec"
_SURFACE = "#ffffff"
_TILE_BG = "#f6f7f9"

_CSS = f"""
body {{ font: 14px/1.45 -apple-system, 'Segoe UI', Roboto, Helvetica, Arial,
        sans-serif; color: {_INK}; background: {_SURFACE};
        margin: 2rem auto; max-width: 980px; padding: 0 1rem; }}
h1 {{ font-size: 1.4rem; margin-bottom: .25rem; }}
.sub {{ color: {_MUTED}; margin-bottom: 1.5rem; }}
.tiles {{ display: flex; flex-wrap: wrap; gap: 12px; margin: 1rem 0 2rem; }}
.tile {{ background: {_TILE_BG}; border-radius: 8px; padding: 12px 18px;
         min-width: 110px; }}
.tile .v {{ font-size: 1.6rem; font-weight: 600; }}
.tile .l {{ color: {_MUTED}; font-size: .8rem; }}
table {{ border-collapse: collapse; margin: .5rem 0 2rem; }}
th, td {{ text-align: right; padding: 4px 14px; border-bottom: 1px solid {_GRID}; }}
th:first-child, td:first-child {{ text-align: left; }}
th {{ color: {_MUTED}; font-weight: 500; }}
.panels {{ display: flex; flex-wrap: wrap; gap: 16px; }}
.panel {{ }}
.panel .t {{ font-size: .85rem; margin-bottom: 2px; }}
.panel .t b {{ font-weight: 600; }}
"""


def _fmt(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return html.escape(str(v))
    if f != f:  # nan
        return "–"
    return f"{f:.2f}"


def _pr_panel(name: str, ap: Optional[float], rec, prec, w=240, h=170) -> str:
    """One PR small-multiple: recall on x, precision on y, single 2px line."""
    ml, mr, mt, mb = 30, 8, 6, 24  # margins
    pw, ph = w - ml - mr, h - mt - mb

    def x(r):
        return ml + r * pw

    def y(p):
        return mt + (1.0 - p) * ph

    grid, labels = [], []
    for g in (0.0, 0.25, 0.5, 0.75, 1.0):
        grid.append(
            f'<line x1="{x(0):.1f}" y1="{y(g):.1f}" x2="{x(1):.1f}" y2="{y(g):.1f}" '
            f'stroke="{_GRID}" stroke-width="1"/>'
        )
        if g in (0.0, 0.5, 1.0):
            labels.append(
                f'<text x="{ml - 5:.1f}" y="{y(g) + 3.5:.1f}" text-anchor="end" '
                f'font-size="9" fill="{_MUTED}">{g:g}</text>'
            )
            labels.append(
                f'<text x="{x(g):.1f}" y="{h - mb + 13:.1f}" text-anchor="middle" '
                f'font-size="9" fill="{_MUTED}">{g:g}</text>'
            )

    if rec is not None and len(rec):
        rec = np.concatenate([[0.0], np.asarray(rec, float)])
        prec = np.concatenate([[prec[0]], np.asarray(prec, float)])
        # downsample long curves for compact SVG
        if len(rec) > 400:
            idx = np.unique(np.linspace(0, len(rec) - 1, 400).astype(int))
            rec, prec = rec[idx], prec[idx]
        pts = " ".join(f"{x(r):.1f},{y(p):.1f}" for r, p in zip(rec, prec))
        line = (
            f'<polyline points="{pts}" fill="none" stroke="{_HUE}" '
            f'stroke-width="2" stroke-linejoin="round"/>'
        )
    else:
        line = (
            f'<text x="{x(0.5):.1f}" y="{y(0.5):.1f}" text-anchor="middle" '
            f'font-size="10" fill="{_MUTED}">no detections</text>'
        )

    title = html.escape(name) + (f" — AP {_fmt(ap)}" if ap is not None else "")
    return (
        '<div class="panel">'
        f'<div class="t"><b>{html.escape(name)}</b>'
        + (f' <span style="color:{_MUTED}">AP {_fmt(ap)}</span>' if ap is not None else "")
        + "</div>"
        f'<svg width="{w}" height="{h}" role="img" aria-label="PR curve {title}">'
        f"<title>{title}</title>"
        + "".join(grid)
        + f'<line x1="{ml}" y1="{mt}" x2="{ml}" y2="{h - mb}" stroke="{_GRID}"/>'
        + line
        + "".join(labels)
        + f'<text x="{x(0.5):.1f}" y="{h - 2:.1f}" text-anchor="middle" font-size="9" '
        f'fill="{_MUTED}">recall</text>'
        "</svg></div>"
    )


def render_report(
    results: Dict[str, dict],
    class_names: Sequence[str],
    curves: Optional[Dict[str, tuple]] = None,
    title: str = "Detection metrics",
    subtitle: str = "",
) -> str:
    """results: {"coco": ..., "voc": ..., "f1": ...} (any subset), as produced
    by the evaluators. curves: {class_name: (recall, precision)} from
    PascalVOCEvaluator.evaluate(return_curves=True)."""
    coco = results.get("coco") or {}
    voc = results.get("voc") or {}
    f1 = results.get("f1") or {}

    tiles = []
    for label, value in (
        ("AP", coco.get("AP")),
        ("AP50", coco.get("AP50")),
        ("AP75", coco.get("AP75")),
        ("VOC AP50", voc.get("VOC_AP50")),
        ("F1", f1.get("F1")),
        ("precision", f1.get("precision")),
        ("recall", f1.get("recall")),
    ):
        if value is not None:
            tiles.append(
                f'<div class="tile"><div class="v">{_fmt(value)}</div>'
                f'<div class="l">{html.escape(label)}</div></div>'
            )

    per_ap = coco.get("per_class_AP") or {}
    per_ap50 = coco.get("per_class_AP50") or {}
    per_voc = voc.get("voc_per_class") or {}
    rows = []
    for i, name in enumerate(class_names):
        def get(d):
            if isinstance(d, dict):
                return d.get(name)
            return d[i] if i < len(d) else None

        cells = [get(per_ap), get(per_ap50), get(per_voc)]
        if all(c is None for c in cells):
            continue
        rows.append(
            f"<tr><td>{html.escape(str(name))}</td>"
            + "".join(f"<td>{_fmt(c) if c is not None else '–'}</td>" for c in cells)
            + "</tr>"
        )
    table = (
        "<h2>Per-class</h2><table><tr><th>class</th><th>AP</th><th>AP50</th>"
        "<th>VOC AP50</th></tr>" + "".join(rows) + "</table>"
        if rows
        else ""
    )

    panels = ""
    if curves is not None:
        parts = []
        for name in class_names:
            rec_prec = curves.get(name)
            ap = per_voc.get(name) if isinstance(per_voc, dict) else None
            if rec_prec is None:
                parts.append(_pr_panel(str(name), ap, None, None))
            else:
                parts.append(_pr_panel(str(name), ap, rec_prec[0], rec_prec[1]))
        panels = (
            "<h2>Precision–recall (IoU 0.5)</h2>"
            '<div class="panels">' + "".join(parts) + "</div>"
        )

    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_CSS}</style></head><body>"
        f"<h1>{html.escape(title)}</h1>"
        f"<div class='sub'>{html.escape(subtitle)}</div>"
        f"<div class='tiles'>{''.join(tiles)}</div>"
        + table
        + panels
        + "</body></html>"
    )
