"""Build and load the port's host (CPU) C++ libraries with plain g++.

  imgcodec  data/csrc/imgcodec.cpp (Pillow-exact bilinear resize, PNG
            scanline reconstruction) and data/csrc/jpeg_decode.cpp (the
            port's baseline JPEG decoder, bit-equal to libjpeg-turbo's with
            PIL's settings); data/native_codec.py binds them
  cocoeval  evaluation/csrc/cocoeval.cpp (the port's copy of the repo's
            native/cocoeval.cpp): the COCO metric in C++ (evaluation/native.py
            binds it)

Each library is compiled from its sources alone, with no system library
beyond the C++ runtime, at first use with `g++ -O3 -fPIC -std=c++17 -shared`
into `simple_sfod_tpu_torch/_build/` (listed in .gitignore), keyed by
a hash of its sources and flags, and loaded with ctypes. A library that does
not build raises with g++'s output; nothing falls back to another decoder
or to a Python evaluator.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
SOURCES = {
    "imgcodec": (os.path.join(_PKG, "data", "csrc", "imgcodec.cpp"), os.path.join(_PKG, "data", "csrc", "jpeg_decode.cpp")),
    "cocoeval": (os.path.join(_PKG, "evaluation", "csrc", "cocoeval.cpp"),),
}

BUILD_SECONDS: Dict[str, float] = {}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's host libraries need a C++17 compiler")
    return cxx


def build(name: str, build_dir: Optional[str] = None) -> str:
    """Compile SOURCES[name] into <build_dir>/libsfod_host_<name>-<hash>.so
    unless that file exists; returns its path. Raises with g++'s output."""
    srcs = SOURCES[name]
    missing = [s for s in srcs if not os.path.exists(s)]
    if missing:
        raise RuntimeError(f"the sources of host library {name!r} are missing: {missing}")
    cxx = _cxx()
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    build_dir = build_dir or BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"libsfod_host_{name}-{digest}.so")
    if os.path.exists(out):
        return out
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {' '.join(srcs)}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The library, built if needed, loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
