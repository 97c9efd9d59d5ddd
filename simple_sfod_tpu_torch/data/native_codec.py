"""ctypes binding of the port's host image codec (data/csrc/imgcodec.cpp
and data/csrc/jpeg_decode.cpp, built by host_libs.py): the loader's
per-image work, decode and the detectron2 shortest-edge resize, without PIL
and without any system image library.

  resize_bilinear  Pillow-BILINEAR-bit-exact resample of a uint8 array
  decode           PNG or JPEG file -> RGB uint8 [H, W, 3]. PNG: the chunks
                   are parsed here, the IDAT stream inflated by zlib and the
                   scanlines reconstructed in C++; colour types map to PIL's
                   convert("RGB") (palette and grey expand, alpha dropped).
                   JPEG: the port's baseline decoder, bit-equal to what
                   libjpeg-turbo gives with PIL's settings; progressive,
                   lossless, hierarchical, arithmetic-coded, CMYK and
                   non-8-bit files are refused, each by name
  image_size       (height, width) of a PNG or JPEG from its header alone
  encode_png       RGB uint8 [H, W, 3] -> the bytes of a PNG file (zlib)

The JAX package's binding (`simple_sfod_tpu/data/native_codec.py`) returns
None on any failure and its loader then decodes with PIL. This one raises:
a file it cannot decode, or a codec library that does not build, is an
error, with the reason. Where libjpeg only warns and pads (a truncated
file), the JAX package returns an image and this decoder raises.
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
# sfod_jpeg_decode's codes (data/csrc/jpeg_decode.cpp: Code)
JPEG_ERRORS = {
    -1: "not a JPEG stream (no SOI marker)",
    -2: "corrupt JPEG data",
    -3: "the JPEG data ends early (truncated file)",
    -4: "out of memory",
    -5: "progressive JPEG (SOF2) is not supported",
    -6: "lossless JPEG (SOF3) is not supported",
    -7: "hierarchical JPEG (SOF5-7, DHP, EXP) is not supported",
    -8: "arithmetic-coded JPEG (SOF9-15) is not supported",
    -9: "JPEG sample precision other than 8 bits is not supported",
    -10: "JPEG with other than 1 or 3 components (CMYK/YCCK) is not supported",
    -11: "JPEG with fractional sampling factors is not supported (libjpeg refuses them too)",
    -12: "JPEG sampling factors out of range or too many blocks in an MCU",
}
# the JPEG frame markers that carry the image size (all SOFn)
_SOF_MARKERS = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


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
            _lib = lib
        return _lib


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
    if rc != 0:
        raise ValueError(f"{path}: JPEG decode failed: {JPEG_ERRORS.get(rc, 'unknown error')} (code {rc})")
    arr = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    lib.sfod_image_free(out)
    return arr


def image_size(path: str) -> tuple:
    """(height, width) of a PNG (IHDR) or JPEG (its SOFn marker) file, read
    from the header without decoding a pixel. Raises on other files."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(24)
        if head.startswith(PNG_MAGIC):
            if head[12:16] != b"IHDR":
                raise ValueError(f"{path}: PNG without IHDR")
            w, h = struct.unpack(">II", head[16:24])
            return int(h), int(w)
        if not head.startswith(JPEG_MAGIC):
            raise ValueError(f"{path}: neither PNG nor JPEG")
        f.seek(2)
        while True:
            b = f.read(1)
            while b == b"\xff":  # fill bytes before the marker code
                b = f.read(1)
            if not b:
                raise ValueError(f"{path}: JPEG without a frame header")
            marker = b[0]
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                f.read(1)  # the next marker's 0xFF
                continue
            seg = f.read(2)
            if len(seg) < 2 or marker in (0xD9, 0xDA):
                raise ValueError(f"{path}: JPEG without a frame header")
            n = struct.unpack(">H", seg)[0]
            if marker in _SOF_MARKERS:
                sof = f.read(5)
                if len(sof) < 5:
                    raise ValueError(f"{path}: truncated JPEG frame header")
                h, w = struct.unpack(">HH", sof[1:5])
                return int(h), int(w)
            f.seek(n - 2, os.SEEK_CUR)
            if f.read(1) != b"\xff":
                raise ValueError(f"{path}: corrupt JPEG marker segment")


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit RGB PNG of rgb uint8 [H, W, 3]: every scanline unfiltered,
    the stream deflated by zlib at `level`."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes RGB [H, W, 3], not {rgb.shape}")
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return PNG_MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b"")


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
