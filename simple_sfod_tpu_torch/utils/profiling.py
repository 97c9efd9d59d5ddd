"""Tracing and step timing (the port of `simple_sfod_tpu/utils/profiling.py`,
whose `device_trace` is a jax.profiler trace): `device_trace(log_dir)`
records the host's ops and the device's kernels with torch.profiler and
writes a Chrome trace into log_dir, and `StepTimer` gives the median and
mean of steps after a warm-up, waiting for the device at each stop."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed work (CPU ops, and CUDA kernels where CUDA is
    available) and write it as `<log_dir>/trace.json`, a Chrome trace that
    chrome://tracing and Perfetto open. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _device_of(result) -> Optional[torch.device]:
    """The device of the first tensor in `result` (a tensor, a dataclass, a
    mapping or a sequence of them), or None."""
    if isinstance(result, torch.Tensor):
        return result.device
    if isinstance(result, dict):
        items = result.values()
    elif isinstance(result, (list, tuple)):
        items = result
    elif hasattr(result, "__dict__"):
        items = vars(result).values()
    else:
        return None
    for item in items:
        dev = _device_of(item)
        if dev is not None:
            return dev
    return None


class StepTimer:
    """Median/mean step timing with warm-up exclusion (the IterationTimer
    replacement). Call .start() before and .stop(result) after each step:
    stop() waits for the device that holds `result` (torch.cuda.synchronize
    on it; no copy of the result to the host), so queued kernels are
    counted. The first `warmup` steps are not kept."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        dev = _device_of(result) if result is not None else None
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {"mean_s": float("nan"), "median_s": float("nan"), "steps": 0}
        ts = sorted(self.times)
        return {
            "mean_s": sum(ts) / len(ts),
            "median_s": ts[len(ts) // 2],
            "steps": len(ts),
        }
