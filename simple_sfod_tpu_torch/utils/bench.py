"""The adaptation benchmark's configuration and synthetic batch (the port
of `simple_sfod_tpu/utils/bench.py`), shared by the roofline and profiling
tools so that they measure the same step."""

from __future__ import annotations

from typing import Dict

import numpy as np


def sfat_bench_cfg(
    batch_target: int = 1,
    trainer: str = "source_free_adaptive_teacher",
    output_dir: str = "./output/sfat_bench",
):
    """The benchmark's configuration, frozen: `config/defaults.py:
    SFAT_BENCH_CONFIG` (VGG16-BN Faster R-CNN, 608x1216 canvas, bfloat16,
    8 classes, BBOX_THRESHOLD 0.8, EMA keep rate 0.9996: the main YAML's
    values) with `trainer` as TRAINER and `batch_target` target images a
    step, writing to `output_dir`. Key for key the JAX package's."""
    from ..config.defaults import SFAT_BENCH_CONFIG, config_opts, get_cfg

    cfg = get_cfg()
    cfg.merge_from_list(config_opts(SFAT_BENCH_CONFIG) + config_opts(
        {"TRAINER": trainer, "SOLVER": {"IMS_PER_BATCH_TARGET": int(batch_target)}}))
    cfg.OUTPUT_DIR = output_dir
    cfg.freeze()
    return cfg


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
