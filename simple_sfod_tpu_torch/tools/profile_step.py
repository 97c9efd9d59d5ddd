"""Trace N adaptation steps and print where the device's time goes: the top
kernels by total time (the port of the JAX package's
`tools/profile_step.py`, which reads a jax.profiler xplane).

    python -m simple_sfod_tpu_torch.tools.profile_step [--trainer source_free_adaptive_teacher]
        [--steps 5] [--out ./output/sfat_trace] [--top 40] [--device cpu] [KEY VALUE ...]
    python -m simple_sfod_tpu_torch.tools.profile_step --parse-only --out DIR

Builds --trainer (a source-free adaptation variant: it steps on
`utils/bench.py:synthetic_bench_batch`) on `utils/bench.py:sfat_bench_cfg`,
with KEY VALUE overrides, warms up 3 steps, and traces --steps steps in
`utils/profiling.py:device_trace`, which writes `<out>/trace.json`. Then,
from that Chrome trace (or an existing one, --parse-only): the device's
events (kernels, copies, sets) by name with their total ms and counts, the
window's length, the device's busy ms (the union of its events) and busy
share, and the host's ops the same way (nested ops each count their own
span). The last line is that summary as JSON.

Like every entry point the tool runs on CUDA and raises without it;
--device cpu traces the CPU, and its trace has no device events.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "cpu_op"
WARMUP_STEPS = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Trace adaptation steps and print the top device kernels.")
    p.add_argument("--trainer", default="source_free_adaptive_teacher")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default="./output/sfat_trace", help="the trace's directory")
    p.add_argument("--parse-only", action="store_true", help="summarise <out>/trace.json")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--device", default=None, help="default cuda")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE config overrides")
    return p.parse_args(argv)


def _union_us(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) spans."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _table(events: List[dict], top: int) -> dict:
    per, counts = collections.Counter(), collections.Counter()
    for e in events:
        per[e["name"]] += float(e["dur"])
        counts[e["name"]] += 1
    return {
        "total_ms": sum(per.values()) / 1e3 if events else None,
        "events": sum(counts.values()),
        "top": [[name, us / 1e3, counts[name]] for name, us in per.most_common(top)],
    }


def summarize_trace(path: str, top: int = 40) -> Dict:
    """The summary of a Chrome trace (module docstring): {"trace", "window_ms",
    "device": {total_ms, events, top: [[name, ms, count]], busy_ms,
    busy_share}, "host": {total_ms, events, top}}."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("cat") == "Trace"]
    timed = window or events
    t0 = min((float(e["ts"]) for e in timed), default=0.0)
    t1 = max((float(e["ts"]) + float(e["dur"]) for e in timed), default=0.0)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    device = _table(dev, top)
    window_ms = (t1 - t0) / 1e3
    # a trace without device events (a CPU run) has no device time to report
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]) / 1e3 if dev else None
    device["busy_ms"] = busy
    device["busy_share"] = busy / window_ms if busy is not None and window_ms > 0 else None
    return {"trace": path, "window_ms": window_ms, "device": device,
            "host": _table([e for e in events if e.get("cat") == HOST_CAT], top)}


def print_summary(s: Dict) -> None:
    d = s["device"]
    print(f"=== {s['trace']}: window {s['window_ms']:.3f} ms ===")
    if d["events"]:
        print(f"-- device: {d['total_ms']:.3f} ms over {d['events']} events; busy {d['busy_ms']:.3f} ms "
              f"({100 * d['busy_share']:.1f}% of the window)")
    else:
        print("-- device: no events (a CPU trace)")
    for name, ms, n in d["top"]:
        print(f"  {ms:9.3f} ms  x{n:<5} {name[:110]}")
    h = s["host"]
    if h["events"]:
        print(f"-- host ops: {h['total_ms']:.3f} ms over {h['events']} events (nested ops each count their span)")
    for name, ms, n in h["top"]:
        print(f"  {ms:9.3f} ms  x{n:<5} {name[:110]}")
    print(json.dumps(s), flush=True)


def trace_steps(args) -> str:
    """Build the trainer, warm up, trace --steps steps -> the trace's path."""
    import torch

    from ..device import resolve_device
    from ..engine.trainers import build_trainer
    from ..utils.bench import synthetic_bench_batch
    from ..utils.profiling import device_trace
    from .roofline import bench_cfg, content_sizes

    device = resolve_device(args.device)
    cfg = bench_cfg(os.path.join(args.out, "run"), args.opts, trainer=args.trainer)
    trainer = build_trainer(cfg, device=device, synthetic=True)
    batch = synthetic_bench_batch(cfg)
    batch["sizes"] = content_sizes(cfg.TPU.CANVAS, len(batch["images"]))
    for _ in range(WARMUP_STEPS):
        trainer.run_step(batch)
    if device.type == "cuda":
        torch.cuda.synchronize()
    with device_trace(args.out):  # waits for the device before it stops
        for _ in range(args.steps):
            trainer.run_step(batch)
    path = os.path.join(args.out, "trace.json")
    print(f"trace written to {path}", flush=True)
    return path


def main(argv=None) -> Dict:
    """Run the tool; -> the summary it printed."""
    args = parse_args(argv)
    path = os.path.join(args.out, "trace.json") if args.parse_only else trace_steps(args)
    summary = summarize_trace(path, args.top)
    print_summary(summary)
    return summary


if __name__ == "__main__":
    main()
