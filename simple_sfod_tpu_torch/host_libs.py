"""Build and load the port's host (CPU) C++ libraries with plain g++.

  imgcodec  data/csrc/imgcodec.cpp: Pillow-exact bilinear resize, PNG
            scanline reconstruction, and JPEG decode where libjpeg's header
            is found (data/native_codec.py binds it)
  cocoeval  the repo's native/cocoeval.cpp, built as it is: the COCO metric
            in C++ (evaluation/native.py binds it)

Each library is compiled at first use with `g++ -O3 -fPIC -std=c++17
-shared` into `simple_sfod_tpu_torch/_build/` (listed in .gitignore), keyed by
a hash of its source and flags, and loaded with ctypes. A library that does
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
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
SOURCES = {
    "imgcodec": os.path.join(_PKG, "data", "csrc", "imgcodec.cpp"),
    "cocoeval": os.path.join(os.path.dirname(_PKG), "native", "cocoeval.cpp"),
}

BUILD_SECONDS: Dict[str, float] = {}
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's host libraries need a C++17 compiler")
    return cxx


def _has_header(cxx: str, header: str) -> bool:
    proc = subprocess.run(
        [cxx, "-x", "c++", "-E", "-o", os.devnull, "-"],
        input=f"#include <{header}>\n", capture_output=True, text=True,
    )
    return proc.returncode == 0


def _flags(name: str, cxx: str) -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) of a library: the codec takes libjpeg
    where its header is found."""
    if name == "imgcodec" and _has_header(cxx, "jpeglib.h"):
        return [*CXX_FLAGS, "-DSFOD_WITH_JPEG=1"], ["-ljpeg"]
    return list(CXX_FLAGS), []


def build(name: str, build_dir: Optional[str] = None) -> str:
    """Compile SOURCES[name] into <build_dir>/libsfod_host_<name>-<hash>.so
    unless that file exists; returns its path. Raises with g++'s output."""
    src = SOURCES[name]
    if not os.path.exists(src):
        raise RuntimeError(f"the source of host library {name!r} is missing: {src}")
    cxx = _cxx()
    cflags, lflags = _flags(name, cxx)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(cflags + lflags).encode()).hexdigest()[:16]
    build_dir = build_dir or BUILD_DIR
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"libsfod_host_{name}-{digest}.so")
    if os.path.exists(out):
        return out
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *cflags, "-o", tmp, src, *lflags], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src}:\n{proc.stdout}\n{proc.stderr}")
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
