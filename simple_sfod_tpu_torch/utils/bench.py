"""The adaptation benchmark's synthetic batch (the port's copy of
`simple_sfod_tpu/utils/bench.py:synthetic_bench_batch`; the benchmark's
configuration is `config/defaults.py:get_sfat_bench_cfg`)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_bench_batch(cfg, n: int = None) -> Dict[str, np.ndarray]:
    """The adaptation benchmark's target batch: n (default
    SOLVER.IMS_PER_BATCH_TARGET) uniform-noise uint8 canvases of TPU.CANVAS
    from RandomState(0), each with a 600x1200 content size."""
    n = n or cfg.SOLVER.IMS_PER_BATCH_TARGET
    rs = np.random.RandomState(0)
    return {
        "images": rs.uniform(0, 255, (n, *cfg.TPU.CANVAS, 3)).astype(np.uint8),
        "sizes": np.tile(np.asarray([[600, 1200]], np.int32), (n, 1)),
    }
