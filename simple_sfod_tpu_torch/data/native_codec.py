"""ctypes binding of the port's host image codec (data/csrc/imgcodec.cpp,
built by host_libs.py): the loader's per-image work, decode and the
detectron2 shortest-edge resize, without PIL.

  resize_bilinear  Pillow-BILINEAR-bit-exact resample of a uint8 array
  decode           PNG or JPEG file -> RGB uint8 [H, W, 3]. PNG: the chunks
                   are parsed here, the IDAT stream inflated by zlib and the
                   scanlines reconstructed in C++; colour types map to PIL's
                   convert("RGB") (palette and grey expand, alpha dropped).
                   JPEG: libjpeg with PIL's default settings, where the
                   library was built with it

The JAX package's binding (`simple_sfod_tpu/data/native_codec.py`) returns
None on any failure and its loader then decodes with PIL. This one raises:
a file it cannot decode, or a codec library that does not build, is an
error, with the reason (for a JPEG where libjpeg's header was absent at
build time, it says so).
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from .. import host_libs

_lib = None
_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
NO_JPEG = -10  # sfod_jpeg_decode: built without libjpeg


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = host_libs.load("imgcodec")
            lib.sfod_jpeg_decode.restype = ctypes.c_int
            lib.sfod_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.sfod_resize_bilinear.restype = ctypes.c_int
            lib.sfod_resize_bilinear.argtypes = [_U8P] + [ctypes.c_int32] * 3 + [_U8P] + [ctypes.c_int32] * 2
            lib.sfod_png_unfilter.restype = ctypes.c_int
            lib.sfod_png_unfilter.argtypes = [_U8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _U8P]
            lib.sfod_image_free.argtypes = [ctypes.c_void_p]
            lib.sfod_codec_features.restype = ctypes.c_int
            _lib = lib
        return _lib


def has_jpeg() -> bool:
    """Whether the codec was built with libjpeg (its header was found)."""
    return bool(_load().sfod_codec_features() & 1)


def resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Pillow-BILINEAR-bit-exact resize of a uint8 [H, W, C] array."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    dst = np.empty((nh, nw, c), np.uint8)
    rc = lib.sfod_resize_bilinear(img.ctypes.data_as(_U8P), h, w, c, dst.ctypes.data_as(_U8P), nh, nw)
    if rc != 0:
        raise ValueError(f"resize of a {img.shape} image to {(nh, nw)} refused (code {rc})")
    return dst


def decode(path: str) -> np.ndarray:
    """Decode a PNG or JPEG file to RGB uint8 [H, W, 3]. Raises on a file it
    cannot read or decode."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        return decode_bytes(f.read(), path)


def decode_bytes(data: bytes, name: str = "image") -> np.ndarray:
    """Decode the bytes of a PNG or JPEG file (`name` labels errors)."""
    if data.startswith(PNG_MAGIC):
        return _decode_png(data, name)
    if data.startswith(JPEG_MAGIC):
        return _decode_jpeg(data, name)
    raise ValueError(f"{name}: neither PNG nor JPEG")


def _decode_jpeg(data: bytes, path: str) -> np.ndarray:
    lib = _load()
    out = _U8P()
    h, w = ctypes.c_int32(), ctypes.c_int32()
    rc = lib.sfod_jpeg_decode(data, len(data), ctypes.byref(out), ctypes.byref(h), ctypes.byref(w))
    if rc == NO_JPEG:
        raise RuntimeError(
            f"{path}: JPEG decode needs libjpeg, whose header (jpeglib.h) the compiler did not find "
            "when the port's codec was built; PNG files decode without it"
        )
    if rc != 0:
        raise ValueError(f"{path}: JPEG decode failed (code {rc})")
    arr = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    lib.sfod_image_free(out)
    return arr


def _decode_png(data: bytes, path: str) -> np.ndarray:
    pos, ihdr, plte, idat = 8, None, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + n]
        if len(chunk) != n:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"PLTE":
            plte = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"{path}: PNG colour type {ctype} is not valid")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    # 16-bit PNGs are refused as the JAX codec refuses them: PIL opens 16-bit
    # grey as mode "I" and its convert("RGB") clips rather than narrows
    if depth == 16 or (depth != 8 and ctype not in (0, 3)):
        raise ValueError(f"{path}: PNG bit depth {depth} with colour type {ctype} is not supported")
    stride = (w * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is short")
    rows = np.empty((h, stride), np.uint8)
    rc = _load().sfod_png_unfilter(
        raw.ctypes.data_as(_U8P), h, stride, max(1, channels * depth // 8), rows.ctypes.data_as(_U8P)
    )
    if rc != 0:
        raise ValueError(f"{path}: PNG scanline with an unknown filter type")
    if depth < 8:
        # pixels packed high bits first; grey is scaled to 8 bits as libpng's
        # expand_gray_1_2_4_to_8 and PIL's L;1/L;2/L;4 unpackers do
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint16)
        pix = (vals * (255 // ((1 << depth) - 1)) if ctype == 0 else vals).astype(np.uint8)[..., None]
    else:
        pix = rows[:, : w * channels].reshape(h, w, channels)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = pix[..., 0]
        if idx.max(initial=0) >= len(plte):
            raise ValueError(f"{path}: palette index out of range")
        return plte[idx]
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])
