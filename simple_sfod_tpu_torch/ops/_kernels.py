"""Build, bind and launch the hand-written Hopper kernels of `csrc/`.

The CUDA sources are compiled at first use by plain `nvcc` for sm_90a into
a shared library with a C interface, in `simple_sfod_tpu_torch/_build/`
(listed in .gitignore), and loaded with ctypes. A build is redone only when
the source's hash changes. Nothing here includes PyTorch's headers or uses
`torch.utils.cpp_extension`.

Each launch wrapper checks its tensors, launches on PyTorch's current
stream, raises if the C entry point reports a CUDA error, and adds one to
its entry of `LAUNCHES`. The wrappers take CUDA tensors only: the CPU path
lives in `ops/nms.py`, in the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# csrc/nms.cu:kMaxWords * 64, the largest N whose three mask slices fit in a
# block's shared memory; above it greedy_keep_from_bits takes its row-walk
# route, up to csrc/nms.cu:kRowWalkMaxWords * 64
GREEDY_MAX_N = 140 * 64
ROWWALK_MAX_N = 224 * 1024 // 8 * 64

# Launch counts of each kernel, by name. A run sets them to 0 before the
# work it wants to account for and reads them after.
LAUNCHES: Dict[str, int] = {"suppress_relation_bits": 0, "greedy_keep_from_bits": 0}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(name: str = "nms", build_dir: Optional[str] = None) -> str:
    """Compile csrc/<name>.cu into <build_dir>/libsfod_<name>-<hash>.so unless
    that file exists; returns its path. Raises with nvcc's output on failure."""
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    build_dir = build_dir or BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"libsfod_{name}-{digest}.so")
    if os.path.exists(out):
        return out
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
        with open(out + ".ptxas.txt", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            if name == "nms":
                lib.sfod_suppress_relation_bits.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.sfod_suppress_relation_bits.restype = ctypes.c_int
                lib.sfod_greedy_keep_from_bits.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.sfod_greedy_keep_from_bits.restype = ctypes.c_int
                lib.sfod_greedy_keep_from_bits_rowwalk.argtypes = lib.sfod_greedy_keep_from_bits.argtypes
                lib.sfod_greedy_keep_from_bits_rowwalk.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def resource_usage(name: str = "nms") -> Dict[str, Dict[str, int]]:
    """Registers, static shared memory and spill bytes of each kernel of
    csrc/<name>.cu, by mangled name, from the `-Xptxas -v` report that
    `build` keeps beside the library."""
    with open(build(name) + ".ptxas.txt") as f:
        text = f.read()
    usage: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            kernel = m.group(1)
            usage.setdefault(kernel, {})
            continue
        if kernel is None:
            continue
        for key, pat in (
            ("registers", r"Used (\d+) registers"),
            ("smem_bytes", r"(\d+) bytes smem"),
            ("spill_store_bytes", r"(\d+) bytes spill stores"),
            ("spill_load_bytes", r"(\d+) bytes spill loads"),
        ):
            m = re.search(pat, line)
            if m:
                usage[kernel][key] = int(m.group(1))
    return {k: v for k, v in usage.items() if "registers" in v}


def load_all() -> None:
    """Build (if needed) and load every kernel library."""
    _load("nms")


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({torch.cuda.get_device_name()})")


def launch_suppress_relation_bits(
    sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Kernel 1. sboxes float32 [N, 4] and svalid bool [N] on CUDA, in score
    order -> int64 [N, ceil(N/64)] row bitmask of the suppression relation
    (the words hold the kernel's uint64 bits)."""
    n = sboxes.shape[0]
    words = (n + 63) // 64
    _check_cuda("sboxes", sboxes, torch.float32, (n, 4))
    _check_cuda("svalid", svalid, torch.bool, (n,))
    up = float(np.nextafter(np.float32(iou_threshold), np.float32(np.inf)))
    if not math.isfinite(up):
        raise ValueError(f"iou_threshold must be a float32 with a finite float above it, got {iou_threshold}")
    if sboxes.data_ptr() % 16:
        sboxes = sboxes.clone()
    # the kernel writes every word, the zeros below the diagonal included
    out = torch.empty((n, words), dtype=torch.int64, device=sboxes.device)
    if n == 0:
        return out
    lib = _load("nms")
    with torch.cuda.device(sboxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sfod_suppress_relation_bits(
            sboxes.data_ptr(), svalid.data_ptr(), float(iou_threshold), n, words,
            out.data_ptr(), stream,
        )
    _raise_on(err, "suppress_relation_bits launch")
    LAUNCHES["suppress_relation_bits"] += 1
    return out


def _launch_greedy(entry: str, max_n: int, bits: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    n = svalid.shape[0]
    words = (n + 63) // 64
    _check_cuda("bits", bits, torch.int64, (n, words))
    _check_cuda("svalid", svalid, torch.bool, (n,))
    if n > max_n:
        raise ValueError(f"{entry} takes N <= {max_n}, got {n}")
    if bits.data_ptr() % 16:
        bits = bits.clone()
    keep = torch.empty((n,), dtype=torch.bool, device=bits.device)
    if n == 0:
        return keep
    lib = _load("nms")
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"sfod_{entry}")(
            bits.data_ptr(), svalid.data_ptr(), n, words, keep.data_ptr(), stream
        )
    _raise_on(err, f"{entry} launch")
    LAUNCHES["greedy_keep_from_bits"] += 1
    return keep


def launch_greedy_keep_from_bits(bits: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Kernel 2. bits int64 [N, ceil(N/64)] from kernel 1 and svalid bool [N]
    on CUDA -> keep bool [N] in the same (score) order. N <= GREEDY_MAX_N."""
    return _launch_greedy("greedy_keep_from_bits", GREEDY_MAX_N, bits, svalid)


def launch_greedy_keep_from_bits_rowwalk(bits: torch.Tensor, svalid: torch.Tensor) -> torch.Tensor:
    """Kernel 2's second route, the row walk, for N above GREEDY_MAX_N (it
    takes any N up to ROWWALK_MAX_N); the same arguments and result, counted
    as a launch of greedy_keep_from_bits."""
    return _launch_greedy("greedy_keep_from_bits_rowwalk", ROWWALK_MAX_N, bits, svalid)
