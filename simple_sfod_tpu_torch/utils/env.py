"""Process set-up shared by entry points (the port of
`simple_sfod_tpu/utils/env.py`, which points XLA's persistent compilation
cache at a directory). The port's compiled code is its kernel library
(ops/_kernels.py, nvcc) and its host libraries (host_libs.py, g++), each
built once per source hash into a build directory; `setup_cache` points
both build directories at `cache_dir`, so builds are kept there and reused
by every process that calls it first."""

from __future__ import annotations

import os


def setup_cache(cache_dir: str) -> str:
    """Build and load the compiled libraries in `cache_dir` (created);
    returns its absolute path. Libraries already loaded stay loaded."""
    from .. import host_libs
    from ..ops import _kernels

    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    _kernels.BUILD_DIR = cache_dir
    host_libs.BUILD_DIR = cache_dir
    return cache_dir
