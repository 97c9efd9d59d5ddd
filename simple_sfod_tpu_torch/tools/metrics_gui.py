"""The interactive detection-metrics GUI, a local web app over the engines
of tools/metrics_tool.py (the port's copy of the repo's
tools/metrics_gui.py; see evaluation/gui.py). Runs on the host; needs
neither a GPU nor torch.

    python -m simple_sfod_tpu_torch.tools.metrics_gui [--host 127.0.0.1] [--port 8350]

then open the printed URL in a browser.
"""

from __future__ import annotations

import argparse

from ..evaluation.gui import run_server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8350)
    args = ap.parse_args(argv)
    run_server(args.host, args.port)


if __name__ == "__main__":
    main()
