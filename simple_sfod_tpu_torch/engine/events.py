"""Metric logging (the port of `simple_sfod_tpu/engine/events.py`):
EventStorage and its writers, to the console, to `metrics.json` (one JSON
line per write) and to TensorBoard.

Values reach the storage as Python numbers: the train loop reads the step's
device metrics back only on the steps it writes.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class EventStorage:
    """Scalars by name with the iteration they were put at; `median` over a
    window of the latest 20, `latest` the newest of each."""

    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._window = window
        self._history = defaultdict(lambda: deque(maxlen=1000))
        self._latest: Dict[str, tuple] = {}

    def put_scalar(self, name: str, value) -> None:
        value = float(value)
        self._history[name].append((self.iter, value))
        self._latest[name] = (self.iter, value)

    def median(self, name: str, window: Optional[int] = None) -> float:
        vals = sorted(v for _, v in list(self._history[name])[-(window or self._window):])
        return vals[len(vals) // 2] if vals else float("nan")

    def names(self):
        return sorted(self._history)

    def latest(self) -> Dict[str, tuple]:
        return dict(self._latest)

    def step(self) -> None:
        self.iter += 1


class JSONWriter:
    """Appends {"iteration": iter, <name>: latest value, ...} as one line of
    `path` per write."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage) -> None:
        rec = {"iteration": storage.iter}
        rec.update({k: v for k, (_, v) in storage.latest().items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class ConsoleWriter:
    """`iter I/MAX  loss_*: median ...  lr: ... (elapsed s)` on stdout."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._t0 = time.time()

    def write(self, storage: EventStorage) -> None:
        losses = {k: storage.median(k) for k in storage.names() if k.startswith("loss") or k.endswith("_val")}
        lr = storage.latest().get("lr", (0, float("nan")))[1]
        loss_str = "  ".join(f"{k}: {v:.4g}" for k, v in losses.items())
        print(f"iter {storage.iter}/{self.max_iter}  {loss_str}  lr: {lr:.2e}  ({time.time() - self._t0:.0f}s)", flush=True)

    def close(self) -> None:
        pass


def tensorboard_summary_writer():
    """The SummaryWriter class of tensorboardX, else of
    torch.utils.tensorboard; ImportError where neither imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter


class TensorboardWriter:
    """The scalars put at the current iteration to TensorBoard. Construction
    raises ImportError where no backend imports."""

    def __init__(self, log_dir: str):
        self._w = tensorboard_summary_writer()(log_dir)

    def write(self, storage: EventStorage) -> None:
        for k, (it, v) in storage.latest().items():
            if it == storage.iter:
                self._w.add_scalar(k, v, it)

    def close(self) -> None:
        self._w.close()
