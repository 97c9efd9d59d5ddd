"""ctypes binding of the port's host image codec (data/csrc/imgcodec.cpp,
data/csrc/jpeg_decode.cpp, data/csrc/containers.cpp, data/csrc/ccitt.cpp,
data/csrc/webp_vp8.cpp, data/csrc/webp_vp8l.cpp, data/csrc/xz.cpp and
data/csrc/zstd.cpp, built by host_libs.py):
the loader's per-image work, decode and the detectron2 shortest-edge resize,
without PIL and without any system image library.

  resize_bilinear  Pillow-BILINEAR-bit-exact resample of a uint8 array
  decode           PNG, JPEG, BMP, GIF, TIFF or WebP file -> RGB uint8 [H, W, 3],
                   the pixels of PIL's convert("RGB"). PNG: the chunks are
                   parsed here, the IDAT stream inflated by zlib and the
                   scanlines of each Adam7 pass (or of the whole image)
                   reconstructed in C++; every colour type and bit depth
                   maps as PIL maps it (palette and grey expand, alpha and
                   tRNS dropped, 16-bit colour keeps its high byte, 16-bit
                   grey opens as "I;16" and clips at 255). JPEG: the port's
                   decoder (sequential and progressive, Huffman- and
                   arithmetic-coded, block smoothing as libjpeg-turbo >= 2.1
                   smooths; lossless SOF3; grey, YCbCr, RGB, CMYK and
                   YCCK), bit-equal to what libjpeg-turbo and Pillow give;
                   hierarchical, arithmetic lossless and non-8-bit files
                   are refused, each by name. BMP (BmpImagePlugin's
                   headers, depths, bitfield layouts and RLE) and GIF (the
                   first frame on the logical screen) parsed here. TIFF: the
                   first page of a classic or BigTIFF file, strips or tiles,
                   chunky or planar, every pixel layout of Pillow's
                   OPEN_INFO (1 to 32 bits, signed, unsigned and float
                   samples, FillOrder 2, CIELab through LittleCMS's table
                   as Pillow converts it); none, PackBits, LZW (old style
                   too), Deflate, LZMA (xz.cpp: LZMA2, Delta and the BCJ
                   filters) and ZSTD (zstd.cpp), with predictors 2 and 3,
                   ThunderScan, CCITT RLE, Group 3 and
                   Group 4 (ccitt.cpp, after libtiff's tif_fax3.c), JPEG
                   (the port's decoder, fed the JPEGTables tag), old-style
                   JPEG (tif_ojpeg.c's stream rebuilt here, decoded by the
                   port's decoder into libjpeg's raw components) and YCbCr
                   at every subsampling (libtiff's RGBA interface); each
                   mapped as Pillow's raw modes convert them, then turned by
                   the Orientation tag as Pillow turns it. WebP (lossy VP8,
                   lossless VP8L, the ALPH plane, VP8X with its metadata
                   skipped, the first frame of an animated file on its
                   canvas): the RIFF chunks parsed here as libwebp's demuxer
                   accepts them, the frame decoded by the port's decoders,
                   bit-equal to libwebp 1.6's RGBA with Pillow's settings,
                   alpha decoded and dropped. JPEG 2000, TIFF's SGILog and
                   WebP compressions (PIL refuses both too) and the other
                   formats PIL opens are refused by name
  image_size       (height, width) of any of those from its header alone
  encode_png       RGB uint8 [H, W, 3] -> the bytes of a PNG file (zlib)

The JAX package's binding (`simple_sfod_tpu/data/native_codec.py`) returns
None on any failure and its loader then decodes with PIL, so it reads every
file that PIL reads. This one raises: a file it cannot decode, or a codec
library that does not build, is an error, with the reason. Where libjpeg
only warns and pads (a truncated file), the JAX package returns an image
and this decoder raises. Where Pillow fails, on an arithmetic-coded JPEG
longer than its 64 KiB read block (libjpeg's arithmetic decoder cannot
suspend), this decoder reads the file, as the JAX package's native codec
does.
"""

from __future__ import annotations

import ctypes
import os
import re
import struct
import threading
import zlib

import numpy as np

from .. import host_libs

_lib = None
_lock = threading.Lock()
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
# sfod_jpeg_decode's codes (data/csrc/jpeg_decode.cpp: Code)
JPEG_ERRORS = {
    -1: "not a JPEG stream (no SOI marker)",
    -2: "corrupt JPEG data",
    -3: "the JPEG data ends early (truncated file)",
    -4: "out of memory",
    -5: "progressive JPEG with an invalid or out-of-order scan progression (libjpeg refuses it or warns)",
    -6: "lossless JPEG with an invalid predictor, point transform or restart interval",
    -7: "hierarchical JPEG (SOF5-7, SOF13-15, DHP, EXP) is not supported",
    -8: "arithmetic-coded lossless JPEG (SOF11) is not supported",
    -9: "JPEG sample precision other than 8 bits is not supported (PIL refuses it too)",
    -10: "JPEG with 2 or more than 4 components is not supported (PIL refuses them too)",
    -11: "JPEG with fractional sampling factors is not supported (libjpeg refuses them too)",
    -12: "JPEG sampling factors out of range or too many blocks in an MCU",
    -14: "lossless JPEG in YCbCr or YCCK is not supported (libjpeg converts no colour losslessly and refuses it too)",
    -15: "JPEG sampling factors other than the TIFF's YCbCrSubsampling, or subsampled planes that are not YCbCr "
         "(libtiff refuses them: PIL too)",
    -16: "bogus JPEGTables field (libtiff refuses it: PIL too)",
}
# sfod_webp_vp8_decode's and sfod_webp_vp8l_decode's codes
# (data/csrc/webp_vp8.cpp, data/csrc/webp_vp8l.cpp)
WEBP_ERRORS = {
    -1: "the VP8 frame's data ends early (frame header, first partition or token partition sizes)",
    -2: "corrupt VP8 frame header (no key-frame start code, an inter frame, a profile above 3, a hidden frame, "
        "a first partition as long as the chunk, or a zero width or height)",
    -3: "the VP8 first partition ends early (libwebp: premature end-of-partition0)",
    -4: "a VP8 token partition ends early (libwebp: premature end-of-file)",
    -5: "out of memory",
    -6: "corrupt ALPH chunk (empty, or a compression method, pre-processing or reserved bits that libwebp refuses)",
    -7: "the ALPH chunk's uncompressed alpha is shorter than the frame",
    -8: "corrupt VP8L header (signature or version)",
    -9: "corrupt VP8L bitstream (a transform, colour cache, prefix code or backward reference that libwebp refuses)",
    -10: "the VP8L bitstream ends early",
    -11: "corrupt lossless ALPH stream (a transform, colour cache, prefix code or backward reference that libwebp "
         "refuses)",
    -12: "the lossless ALPH stream ends early",
}
BMP_MAGIC = b"BM"
GIF_MAGICS = (b"GIF87a", b"GIF89a")
# Pillow's TIFF prefixes: classic (with the two byte-swapped version words it
# accepts) and BigTIFF
TIFF_MAGICS = (b"II*\x00", b"MM\x00*", b"MM*\x00", b"II\x00*", b"II+\x00", b"MM\x00+")
READS = "PNG, JPEG, BMP, GIF, TIFF and WebP"
# formats PIL opens that the port refuses, named in the refusal: (magic
# prefix, its offset, name)
_OTHER_FORMATS = (
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", 0, "JPEG 2000"),
    (b"\xff\x4f\xff\x51", 0, "JPEG 2000 (codestream)"),
)
# the bit depths each PNG colour type allows
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# the Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
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
            i32 = ctypes.c_int32
            lib.sfod_webp_vp8_decode.restype = i32
            lib.sfod_webp_vp8_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                                                 ctypes.c_int64, _U8P, i32, i32, i32]
            lib.sfod_webp_vp8l_decode.restype = i32
            lib.sfod_webp_vp8l_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8P, i32, i32, i32]
            lib.sfod_jpeg_decode_tiff.restype = i32
            lib.sfod_jpeg_decode_tiff.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
                                                  i32, i32, i32, ctypes.POINTER(_U8P)] + [ctypes.POINTER(i32)] * 3
            lib.sfod_ccitt_decode.restype = i32
            lib.sfod_ccitt_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32, i32, i32, i32, _U8P,
                                              ctypes.c_int64]
            lib.sfod_ycbcr_units.restype = None
            lib.sfod_ycbcr_units.argtypes = [ctypes.c_char_p] + [i32] * 5 + [_I32P] * 5 + [_U8P, ctypes.c_int64]
            lib.sfod_ycbcr_planes.restype = None
            lib.sfod_ycbcr_planes.argtypes = [_U8P, ctypes.c_int64, _U8P, _U8P, ctypes.c_int64] + [i32] * 4 + \
                [_I32P] * 5 + [_U8P]
            lib.sfod_lab_rgb.restype = None
            lib.sfod_lab_rgb.argtypes = [_U8P, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint16), _U8P]
            lib.sfod_webp_vp8l_transforms.restype = i32
            lib.sfod_webp_vp8l_transforms.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, i32]
            i64 = ctypes.c_int64
            lib.sfod_jpeg_decode_ojpeg.restype = i32
            lib.sfod_jpeg_decode_ojpeg.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, ctypes.POINTER(_U8P),
                                                   ctypes.POINTER(i32), _I32P, ctypes.POINTER(i32),
                                                   ctypes.POINTER(i32)]
            for fn, args in (("sfod_gif_lzw", [ctypes.c_char_p, i64, ctypes.c_int32, _U8P, i64]),
                             ("sfod_tiff_lzw", [ctypes.c_char_p, i64, _U8P, i64, ctypes.c_int32]),
                             ("sfod_xz_decode", [ctypes.c_char_p, i64, _U8P, i64]),
                             ("sfod_zstd_decode", [ctypes.c_char_p, i64, _U8P, i64]),
                             ("sfod_thunderscan", [ctypes.c_char_p, i64, i32, i32, i64, _U8P]),
                             ("sfod_packbits", [ctypes.c_char_p, i64, _U8P, i64]),
                             ("sfod_bmp_rle", [ctypes.c_char_p, i64, i64, ctypes.c_int32, ctypes.c_int32,
                                               ctypes.c_int32, _U8P])):
                getattr(lib, fn).restype = i64
                getattr(lib, fn).argtypes = args
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
    """Decode a PNG, JPEG, BMP, GIF, TIFF or WebP file to RGB uint8 [H, W, 3].
    Raises on a file it cannot read or decode."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        return decode_bytes(f.read(), path)


def decode_bytes(data: bytes, name: str = "image") -> np.ndarray:
    """Decode the bytes of an image file (`name` labels errors)."""
    if data.startswith(PNG_MAGIC):
        return _decode_png(data, name)
    if data.startswith(JPEG_MAGIC):
        return _decode_jpeg(data, name)
    if data.startswith(BMP_MAGIC):
        return _decode_bmp(data, name)
    if data.startswith(GIF_MAGICS):
        return _decode_gif(data, name)
    if data.startswith(TIFF_MAGICS):
        return _decode_tiff(data, name)
    if _is_webp(data):
        return _decode_webp(data, name)
    raise ValueError(_unknown_format(data, name))


def _unknown_format(head: bytes, name: str) -> str:
    fmt = next((f for magic, at, f in _OTHER_FORMATS if head[at:at + len(magic)] == magic), None)
    if fmt is not None:
        return f"{name}: {fmt} is not supported (the port reads {READS})"
    return f"{name}: not a PNG, JPEG, BMP, GIF, TIFF or WebP file (the formats the port reads)"


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
    """(height, width) of an image file, read from its header without
    decoding a pixel: PNG's IHDR, JPEG's SOFn marker, BMP's info header,
    GIF's logical screen grown to its first frame (as PIL's size is), TIFF's
    first IFD, swapped by an Orientation of 5-8 (the oriented size, Pillow's
    after load), WebP's canvas (VP8X's, else the VP8 or VP8L frame's).
    Raises on other files."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(30)
        if head.startswith(PNG_MAGIC):
            if head[12:16] != b"IHDR":
                raise ValueError(f"{path}: PNG without IHDR")
            w, h = struct.unpack(">II", head[16:24])
            return int(h), int(w)
        if head.startswith(JPEG_MAGIC):
            return _jpeg_size(f, path)
        read = _file_reader(f)
        if head.startswith(BMP_MAGIC):
            hdr = _bmp_header(read, path)
            return hdr["height"], hdr["width"]
        if head.startswith(GIF_MAGICS):
            return _gif_layout(read, path)["size"]
        if head.startswith(TIFF_MAGICS):
            ifd = _tiff_ifd(read, path)
            return ifd["height"], ifd["width"]
        if _is_webp(head):
            return _webp_size(head, path)
        raise ValueError(_unknown_format(head, path))


def _file_reader(f):
    def read(offset: int, n: int) -> bytes:
        f.seek(offset)
        return f.read(n)

    return read


def _bytes_reader(data: bytes):
    return lambda offset, n: data[offset:offset + n]


def _jpeg_size(f, path: str) -> tuple:
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
    if depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG bit depth {depth} with colour type {ctype} is not valid")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: PNG interlace method {interlace} is not valid")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    pix = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:  # a pass without pixels has no scanlines
            samples, off = _png_pass(raw, off, pw, ph, channels, depth, ctype, path)
            pix[y0::dy, x0::dx] = samples
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = pix[..., 0]
        if idx.max(initial=0) >= len(plte):
            raise ValueError(f"{path}: palette index out of range")
        return plte[idx]
    if depth == 16:
        # PIL opens 16-bit grey as "I;16", whose convert("RGB") clips at 255;
        # its other 16-bit rawmodes (RGB;16B, RGBA;16B, LA;16B) keep the high byte
        pix = np.minimum(pix, 255) if ctype == 0 else pix >> 8
        pix = pix.astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])


def _png_pass(raw, off, pw, ph, channels, depth, ctype, path):
    """The samples [ph, pw, channels] of one pass (the whole image when not
    interlaced) whose filtered scanlines start at raw[off]. -> (samples, the
    offset of the next pass)."""
    stride = (pw * channels * depth + 7) // 8
    end = off + ph * (stride + 1)
    if raw.size < end:
        raise ValueError(f"{path}: PNG image data is short")
    rows = np.empty((ph, stride), np.uint8)
    rc = _load().sfod_png_unfilter(
        np.ascontiguousarray(raw[off:end]).ctypes.data_as(_U8P), ph, stride, max(1, channels * depth // 8),
        rows.ctypes.data_as(_U8P)
    )
    if rc != 0:
        raise ValueError(f"{path}: PNG scanline with an unknown filter type")
    if depth == 16:
        return rows.view(">u2").reshape(ph, pw, channels), end
    if depth == 8:
        return rows.reshape(ph, pw, channels), end
    # pixels packed high bits first; grey is scaled to 8 bits as libpng's
    # expand_gray_1_2_4_to_8 and PIL's 1/L;2/L;4 unpackers do
    bits = np.unpackbits(rows, axis=1).reshape(ph, -1, depth)[:, :pw]
    vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(axis=2, dtype=np.uint16)
    return (vals * (255 // ((1 << depth) - 1)) if ctype == 0 else vals).astype(np.uint8)[..., None], end


# ---------------------------------------------------------------------------
# BMP, as Pillow's BmpImagePlugin opens it
# ---------------------------------------------------------------------------

_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# BIT2MODE: bits -> (mode, raw mode) of an uncompressed file
_BMP_MODES = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
              32: ("RGB", "BGRX")}
# the BI_BITFIELDS layouts Pillow reads: (bits, masks) -> raw mode
_BMP_BITFIELDS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX", (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR", (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA", (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR", (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR", (16, (0xF800, 0x7E0, 0x1F)): "BGR;16", (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# bits a pixel of each raw mode
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _bmp_header(read, path: str) -> dict:
    """BmpImageFile._bitmap: size, raw mode, palette and pixel data layout."""
    head = read(0, 18)
    if len(head) < 18:
        raise ValueError(f"{path}: truncated BMP header")
    offset, hsize = struct.unpack_from("<I", head, 10)[0], struct.unpack_from("<I", head, 14)[0]
    if hsize not in _BMP_HEADERS:
        raise ValueError(f"{path}: BMP header size {hsize} is not supported (PIL refuses it too)")
    hd = read(18, hsize - 4)
    if len(hd) < hsize - 4:
        raise ValueError(f"{path}: truncated BMP header")
    pos, masks, colors = 14 + hsize, None, 0
    if hsize == 12:  # BITMAPCOREHEADER (OS/2 1.x): 16-bit size, 3-byte palette entries
        width, height, _, bits = struct.unpack_from("<HHHH", hd)
        comp, pad, direction = 0, 3, -1
    else:
        flip = hd[7] == 0xFF  # a negative height: top-down rows
        width, height = struct.unpack_from("<II", hd)
        height = 2**32 - height if flip else height
        bits, comp = struct.unpack_from("<HI", hd, 10)
        colors, pad, direction = struct.unpack_from("<I", hd, 28)[0], 4, 1 if flip else -1
        if comp == 3:  # BI_BITFIELDS: the masks in the header, or after a 40-byte one
            if len(hd) >= 48:
                alpha = struct.unpack_from("<I", hd, 48) if len(hd) >= 52 else (0,)
                masks = struct.unpack_from("<III", hd, 36) + alpha
            else:
                m = read(pos, 12)
                if len(m) < 12:
                    raise ValueError(f"{path}: truncated BMP bitfield masks")
                masks, pos = struct.unpack("<III", m) + (0,), pos + 12
    colors = colors or 1 << bits
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_MODES:
        raise ValueError(f"{path}: BMP pixel depth {bits} is not supported (PIL refuses it too)")
    mode, raw = _BMP_MODES[bits]
    rle = False
    if comp == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_BITFIELDS:
            raise ValueError(f"{path}: BMP bitfields layout {bits} bits {masks} is not supported (PIL refuses it too)")
        raw = _BMP_BITFIELDS[key]
    elif comp in (1, 2):
        rle = True
    elif comp in (4, 5):
        kind = "JPEG (BI_JPEG)" if comp == 4 else "PNG (BI_PNG)"
        raise ValueError(f"{path}: BMP with {kind} compression is not supported (PIL refuses it too)")
    elif comp != 0:
        raise ValueError(f"{path}: BMP compression {comp} is not supported (PIL refuses it too)")
    palette = None
    if mode == "P":
        if not 0 < colors <= 256:
            raise ValueError(f"{path}: BMP palette of {colors} colours is not supported (PIL refuses it too)")
        pal = read(pos, pad * colors)
        grey = all(pal[i * pad:i * pad + 3] == bytes([v & 255]) * 3
                   for i, v in enumerate((0, 255) if colors == 2 else range(colors)))
        if grey:  # a grey palette is dropped: mode "1" or "L" of the raw indices
            mode = raw = "1" if colors == 2 else "L"
        else:
            n = len(pal) // pad
            palette = np.frombuffer(pal[:n * pad], np.uint8).reshape(n, pad)[:, 2::-1]
    return dict(width=int(width), height=int(height), bits=bits, offset=offset, direction=direction, mode=mode,
                raw=raw, rle=rle, rle4=comp == 2, palette=palette)


def _decode_bmp(data: bytes, path: str) -> np.ndarray:
    hdr = _bmp_header(_bytes_reader(data), path)
    w, h, mode, raw = hdr["width"], hdr["height"], hdr["mode"], hdr["raw"]
    if w == 0 or h == 0:
        raise ValueError(f"{path}: BMP of size {w}x{h}")
    if hdr["rle"]:
        if mode == "1":
            raise ValueError(f"{path}: RLE BMP with a black-and-white palette is not supported (PIL refuses it too)")
        idx = np.zeros(w * h, np.uint8)
        body = data[hdr["offset"]:]
        got = _load().sfod_bmp_rle(body, len(body), hdr["offset"], w, h, int(hdr["rle4"]),
                                   idx.ctypes.data_as(_U8P))
        if got < w * h:
            raise ValueError(f"{path}: BMP RLE data ends before the image does (PIL refuses it too)")
        pix = idx.reshape(h, w)
    else:
        stride = ((w * hdr["bits"] + 31) >> 3) & ~3
        need = (w * _RAW_BITS.get(raw, 32) + 7) // 8
        if stride < need:
            raise ValueError(f"{path}: BMP rows shorter than its {mode} pixels (PIL refuses it too)")
        body = data[hdr["offset"]:hdr["offset"] + stride * h]
        if len(body) < stride * (h - 1) + need:
            raise ValueError(f"{path}: truncated BMP pixel data")
        rows = np.frombuffer(body + bytes(stride * h - len(body)), np.uint8).reshape(h, stride)[:, :need]
        pix = _bmp_unpack(rows, w, raw)
    if hdr["direction"] == -1:
        pix = pix[::-1]
    if mode == "P":
        return _palette_rgb(pix, hdr["palette"])
    if pix.ndim == 2:  # "1" (its pixels 0 or 255) and "L"
        return np.repeat(pix[..., None], 3, axis=2)
    return np.ascontiguousarray(pix)


def _bmp_unpack(rows: np.ndarray, w: int, raw: str) -> np.ndarray:
    """Pillow's unpacker of raw mode `raw` over rows [h, bytes]."""
    if raw in ("1", "P;1", "P;4"):
        bits = np.unpackbits(rows, axis=1)
        if raw == "P;4":
            return (bits.reshape(rows.shape[0], -1, 4) * np.array([8, 4, 2, 1], np.uint8)).sum(2, dtype=np.uint8)[:, :w]
        return bits[:, :w] * np.uint8(255 if raw == "1" else 1)
    if raw in ("P", "L"):
        return rows[:, :w]
    if raw in ("BGR;15", "BGR;16"):
        p = rows[:, :2 * w].view("<u2").astype(np.uint32)
        six = raw == "BGR;16"
        r = ((p >> (11 if six else 10)) & 31) * 255 // 31
        g = ((p >> 5) & (63 if six else 31)) * 255 // (63 if six else 31)
        return np.stack([r, g, (p & 31) * 255 // 31], axis=-1).astype(np.uint8)
    px = rows[:, :w * len(raw.split(";")[0])].reshape(rows.shape[0], w, -1)
    return px[..., [raw.index(c) for c in "RGB"]]


def _palette_rgb(idx: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """P -> RGB as Pillow converts it: indices past the palette are black."""
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(len(palette), 256)] = palette[:256]
    return lut[idx]


# ---------------------------------------------------------------------------
# GIF: the first frame, as Pillow's GifImagePlugin opens it
# ---------------------------------------------------------------------------


def _gif_block(read, pos: int) -> tuple:
    """GifImageFile.data: (one data sub-block, or None at a terminator or
    the end of the file; the offset after it)."""
    n = read(pos, 1)
    if not n or not n[0]:
        return None, pos + len(n)
    return read(pos + 1, n[0]), pos + 1 + n[0]


def _gif_blocks(read, pos: int) -> tuple:
    """The data sub-blocks from pos up to a terminator: (their bytes joined,
    the offset after it)."""
    out = []
    block, pos = _gif_block(read, pos)
    while block:
        out.append(block)
        block, pos = _gif_block(read, pos)
    return b"".join(out), pos


def _gif_palette(p: bytes):
    """A colour table, or None where it is the grey ramp i -> (i, i, i)
    (Pillow drops it and opens the image as "L")."""
    ramp = all(i // 3 == p[i] == p[i + 1] == p[i + 2] for i in range(0, len(p) - 2, 3))
    return None if ramp else np.frombuffer(p[:len(p) // 3 * 3], np.uint8).reshape(-1, 3)


def _gif_layout(read, path: str) -> dict:
    """GifImageFile._open and _seek(0): the size (the logical screen grown to
    the first frame), the frame's box, palette, transparency, interlacing
    and the offset of its LZW data."""
    s = read(0, 13)
    if len(s) < 13:
        raise ValueError(f"{path}: truncated GIF header")
    w, h, flags = struct.unpack_from("<HHB", s, 6)
    pos, palette = 13, None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        palette = _gif_palette(read(pos, n))
        pos += n
    transparency = None
    while True:
        b = read(pos, 1)
        pos += 1
        if not b or b == b";":
            raise ValueError(f"{path}: GIF without an image (PIL refuses it too)")
        if b == b"!":  # an extension, read block by block as Pillow reads it
            label = read(pos, 1)
            pos += 1
            block, pos = _gif_block(read, pos)
            if label == b"\xfe":  # a comment: its blocks up to the terminator
                _, pos = _gif_blocks(read, pos) if block else (None, pos)
                continue
            if label == b"\xf9" and block is not None:  # graphic control: the transparency index
                if len(block) < 4:
                    raise ValueError(f"{path}: truncated GIF graphic control extension (PIL refuses it too)")
                if block[0] & 1:
                    transparency = block[3]
            elif label == b"\xff" and block is not None and block.startswith(b"NETSCAPE2.0"):
                _, pos = _gif_block(read, pos)  # its loop count
            _, pos = _gif_blocks(read, pos)
        elif b == b",":
            d = read(pos, 9)
            if len(d) < 9:
                raise ValueError(f"{path}: truncated GIF image descriptor")
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", d)
            pos += 9
            if fflags & 128:
                n = 3 << ((fflags & 7) + 1)
                local = _gif_palette(read(pos, n))
                pos += n
                if local is not None:  # a grey-ramp local table leaves the global one in force
                    palette = local
            bits = read(pos, 1)
            if not bits:
                raise ValueError(f"{path}: truncated GIF image")
            return dict(size=(max(y0 + fh, h), max(x0 + fw, w)), box=(x0, y0, fw, fh), palette=palette,
                        transparency=transparency, interlace=bool(fflags & 64), min_size=bits[0], data=pos + 1)
        # any other byte: skipped, as Pillow skips it


def _decode_gif(data: bytes, path: str) -> np.ndarray:
    read = _bytes_reader(data)
    lay = _gif_layout(read, path)
    (H, W), (x0, y0, fw, fh) = lay["size"], lay["box"]
    lzw, _ = _gif_blocks(read, lay["data"])
    idx = np.zeros(fw * fh, np.uint8)
    got = _load().sfod_gif_lzw(lzw, len(lzw), lay["min_size"], idx.ctypes.data_as(_U8P), fw * fh)
    if got < 0:
        what = "corrupt LZW data" if got == -1 else f"LZW minimum code size {lay['min_size']}"
        raise ValueError(f"{path}: GIF with {what} (PIL refuses it too)")
    # the frame on a canvas of index 0, or of the transparency index
    fill = lay["transparency"] if lay["transparency"] is not None else 0
    canvas = np.full((H, W), fill, np.uint8)
    if fw and fh:
        rows = np.arange(fh)
        if lay["interlace"]:
            rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])
        frame = canvas[y0:y0 + fh, x0:x0 + fw]
        full, part = divmod(int(got), fw)
        frame[rows[:full]] = idx[:full * fw].reshape(full, fw)
        if part:
            frame[rows[full], :part] = idx[full * fw:got]
    if lay["palette"] is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    return _palette_rgb(canvas, lay["palette"])


# ---------------------------------------------------------------------------
# TIFF: the first page, as Pillow's TiffImagePlugin opens it (its raw decoder
# for uncompressed files, libtiff through TiffDecode.c for every other
# compression), then turned upright as ImageOps.exif_transpose turns it
# ---------------------------------------------------------------------------

BIGTIFF_MAGICS = (b"II+\x00", b"MM\x00+")
# field types -> struct codes (RATIONAL as two LONGs, IFD as LONG, IFD8 as LONG8)
_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d",
               13: "I", 16: "Q", 17: "q", 18: "Q"}
_TIFF_COMPRESSION = {1: "raw", 2: "ccitt_rle", 3: "group3", 4: "group4", 5: "lzw", 6: "ojpeg", 7: "jpeg",
                     8: "deflate", 32771: "ccitt_rlew", 32773: "packbits", 32809: "thunderscan", 32946: "deflate",
                     34925: "lzma", 50000: "zstd"}
# compressions Pillow names and refuses too: SGILog (its LogL and LogLuv
# photometrics have no OPEN_INFO mode, and libtiff decodes SGILog under no
# other) and WebP (the libtiff Pillow 12.1 bundles is built without it)
_TIFF_REFUSED_COMPRESSION = {34676: "SGILog", 34677: "SGILog24", 50001: "WebP"}
# the compressions libtiff runs its predictor (tif_predict.c) after
_TIFF_PREDICTED = ("lzw", "deflate", "lzma", "zstd")
# sfod_xz_decode's and sfod_zstd_decode's codes (data/csrc/xz.cpp,
# data/csrc/zstd.cpp)
XZ_ERRORS = {
    -1: "not an .xz stream (liblzma refuses it: PIL too)",
    -2: "corrupt .xz data or options liblzma refuses (PIL refuses it too)",
    -3: "the .xz stream or the strip's data ends before the strip or tile does (libtiff: not enough data; PIL "
        "refuses it too)",
    -5: "out of memory",
    -6: "an .xz block's integrity check does not match its data (PIL refuses it too)",
}
ZSTD_ERRORS = {
    -1: "not a zstd frame (libzstd refuses it: PIL too)",
    -2: "corrupt zstd data (PIL refuses it too)",
    -3: "the zstd frame or the strip's data ends before the strip or tile does (libtiff: not enough data; PIL "
        "refuses it too)",
    -4: "a zstd frame that needs a dictionary (libtiff loads none: PIL refuses it too)",
    -5: "a zstd window above 2^27 + 1 bytes (libzstd's default limit: PIL refuses it too)",
    -6: "the zstd content checksum does not match (PIL refuses it too)",
    -7: "out of memory",
}
THUNDERSCAN_ERRORS = {-3: "not enough data for a row (libtiff refuses it: PIL too)",
                      -4: "too much data for a row (libtiff refuses it: PIL too)"}
_SGILOG_PHOTOMETRIC = {32844: "LogL", 32845: "LogLuv"}
# the CCITT decoders of data/csrc/ccitt.cpp (sfod_ccitt_decode's kind)
_CCITT_KIND = {"ccitt_rle": 0, "ccitt_rlew": 1, "group3": 2, "group4": 4}
CCITT_ERRORS = {
    -1: "the CCITT data ends before the strip or tile does (libtiff: premature EOF)",
    -2: "CCITT run-length buffer overflow (libtiff refuses the strip)",
    -3: "the Group 4 data ends before the strip or tile does (libtiff leaves the rest of it unwritten)",
}
# Pillow 12.1's TiffImagePlugin.OPEN_INFO: (byte orders, photometric,
# SampleFormat, FillOrder, bits, extra samples) -> (mode, raw mode). Its key
# set is the rule: a file whose key is missing is refused as PIL refuses it
# ("unknown pixel mode")
_OPEN_INFO_ROWS = {
    ("<>", 0, (1,), 1, (1,), ()): ("1", "1;I"), ("<>", 0, (1,), 2, (1,), ()): ("1", "1;IR"),
    ("<>", 1, (1,), 1, (1,), ()): ("1", "1"), ("<>", 1, (1,), 2, (1,), ()): ("1", "1;R"),
    ("<>", 0, (1,), 1, (2,), ()): ("L", "L;2I"), ("<>", 0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    ("<>", 1, (1,), 1, (2,), ()): ("L", "L;2"), ("<>", 1, (1,), 2, (2,), ()): ("L", "L;2R"),
    ("<>", 0, (1,), 1, (4,), ()): ("L", "L;4I"), ("<>", 0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    ("<>", 1, (1,), 1, (4,), ()): ("L", "L;4"), ("<>", 1, (1,), 2, (4,), ()): ("L", "L;4R"),
    ("<>", 0, (1,), 1, (8,), ()): ("L", "L;I"), ("<>", 0, (1,), 2, (8,), ()): ("L", "L;IR"),
    ("<>", 1, (1,), 1, (8,), ()): ("L", "L"), ("<>", 1, (2,), 1, (8,), ()): ("L", "L"),
    ("<>", 1, (1,), 2, (8,), ()): ("L", "L;R"),
    ("<", 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    ("<", 0, (1,), 1, (16,), ()): ("I;16", "I;16"), ("<", 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (">", 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"), ("<", 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    ("<", 1, (2,), 1, (16,), ()): ("I", "I;16S"), (">", 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    ("<", 0, (3,), 1, (32,), ()): ("F", "F;32F"), (">", 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    ("<", 1, (1,), 1, (32,), ()): ("I", "I;32N"), ("<", 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (">", 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    ("<", 1, (3,), 1, (32,), ()): ("F", "F;32F"), (">", 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    ("<>", 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    ("<>", 2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"), ("<>", 2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    ("<>", 2, (1,), 1, (8,) * 4, ()): ("RGBA", "RGBA"), ("<>", 2, (1,), 1, (8,) * 4, (0,)): ("RGB", "RGBX"),
    ("<>", 2, (1,), 1, (8,) * 5, (0, 0)): ("RGB", "RGBXX"), ("<>", 2, (1,), 1, (8,) * 6, (0, 0, 0)): ("RGB", "RGBXXX"),
    ("<>", 2, (1,), 1, (8,) * 4, (1,)): ("RGBA", "RGBa"), ("<>", 2, (1,), 1, (8,) * 5, (1, 0)): ("RGBA", "RGBaX"),
    ("<>", 2, (1,), 1, (8,) * 6, (1, 0, 0)): ("RGBA", "RGBaXX"), ("<>", 2, (1,), 1, (8,) * 4, (2,)): ("RGBA", "RGBA"),
    ("<>", 2, (1,), 1, (8,) * 5, (2, 0)): ("RGBA", "RGBAX"), ("<>", 2, (1,), 1, (8,) * 6, (2, 0, 0)): ("RGBA", "RGBAXX"),
    ("<>", 2, (1,), 1, (8,) * 4, (999,)): ("RGBA", "RGBA"),
    ("<", 2, (1,), 1, (16,) * 3, ()): ("RGB", "RGB;16L"), (">", 2, (1,), 1, (16,) * 3, ()): ("RGB", "RGB;16B"),
    ("<", 2, (1,), 1, (16,) * 4, ()): ("RGBA", "RGBA;16L"), (">", 2, (1,), 1, (16,) * 4, ()): ("RGBA", "RGBA;16B"),
    ("<", 2, (1,), 1, (16,) * 4, (0,)): ("RGB", "RGBX;16L"), (">", 2, (1,), 1, (16,) * 4, (0,)): ("RGB", "RGBX;16B"),
    ("<", 2, (1,), 1, (16,) * 4, (1,)): ("RGBA", "RGBa;16L"), (">", 2, (1,), 1, (16,) * 4, (1,)): ("RGBA", "RGBa;16B"),
    ("<", 2, (1,), 1, (16,) * 4, (2,)): ("RGBA", "RGBA;16L"), (">", 2, (1,), 1, (16,) * 4, (2,)): ("RGBA", "RGBA;16B"),
    ("<>", 3, (1,), 1, (1,), ()): ("P", "P;1"), ("<>", 3, (1,), 2, (1,), ()): ("P", "P;1R"),
    ("<>", 3, (1,), 1, (2,), ()): ("P", "P;2"), ("<>", 3, (1,), 2, (2,), ()): ("P", "P;2R"),
    ("<>", 3, (1,), 1, (4,), ()): ("P", "P;4"), ("<>", 3, (1,), 2, (4,), ()): ("P", "P;4R"),
    ("<>", 3, (1,), 1, (8,), ()): ("P", "P"), ("<>", 3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    ("<>", 3, (1,), 1, (8, 8), (2,)): ("PA", "PA"), ("<>", 3, (1,), 2, (8,), ()): ("P", "P;R"),
    ("<>", 5, (1,), 1, (8,) * 4, ()): ("CMYK", "CMYK"), ("<>", 5, (1,), 1, (8,) * 5, (0,)): ("CMYK", "CMYKX"),
    ("<>", 5, (1,), 1, (8,) * 6, (0, 0)): ("CMYK", "CMYKXX"),
    ("<", 5, (1,), 1, (16,) * 4, ()): ("CMYK", "CMYK;16L"), (">", 5, (1,), 1, (16,) * 4, ()): ("CMYK", "CMYK;16B"),
    ("<>", 6, (1,), 1, (8,), ()): ("L", "L"), ("<>", 6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    ("<>", 8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}
_TIFF_OPEN_INFO = {(o,) + k[1:]: v for k, v in _OPEN_INFO_ROWS.items() for o in k[0]}
# Pillow's convert("RGB") of an "I" or "F" raw mode: the sample type
_TIFF_NUMERIC = {"I;16S": "i2", "I;16BS": "i2", "I;32N": "i4", "I;32S": "i4", "I;32BS": "i4", "F;32F": "f4",
                 "F;32BF": "f4"}
# the raw modes whose byte order Pillow takes from the file while libtiff
# hands it native (little-endian) samples: compressed, they read byte-swapped
_TIFF_SWAPPED_BY_PILLOW = ("I;16BS", "I;32BS", "F;32BF")
# ImageOps.exif_transpose: Orientation -> the transposition of the decoded image
_ORIENT = {
    2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
    6: lambda a: a.transpose(1, 0, 2)[:, ::-1], 7: lambda a: a[::-1, ::-1].transpose(1, 0, 2),
    8: lambda a: a.transpose(1, 0, 2)[::-1],
}
# the FillOrder 2 raw modes Pillow's raw decoder has no unpacker for
_TIFF_RAW_MISSING = ("L;IR", "P;1R", "P;2R", "P;4R")
# the one-band raw modes Pillow's raw decoder reads a plane of a planar file
# with (the raw mode's letter of that plane), and the bands of each mode
# (libtiff's planes are unpacked band by band)
_TIFF_RAW_BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "P": "P", "LAB": "LAB"}
_MODE_BANDS = {"1": 1, "L": 1, "LA": 2, "P": 1, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "I;16": 1, "I;16B": 1, "I": 1,
               "F": 1, "LAB": 3}
_XMP_ORIENTATION = re.compile(rb'tiff:Orientation(="|>)([0-9])')
_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_ifd(read, path: str) -> dict:
    """The first IFD, classic or BigTIFF, as Pillow's ImageFileDirectory_v2
    reads it: {tag: tuple of values}, the byte order, the XMP packet and
    JPEGTables as bytes, the Orientation Pillow applies (the tag, else XMP's
    tiff:Orientation, as Image.getexif finds it) and the image's (width,
    height) once oriented, as Pillow's size is after load."""
    head = read(0, 16)
    order = "<" if head[:2] == b"II" else ">"
    big = head[:4] in BIGTIFF_MAGICS
    if head[:4] == b"MM\x00+":  # Pillow tests byte 2 for 43 and reads this as a classic header
        raise ValueError(f"{path}: big-endian BigTIFF is not supported (PIL refuses it too)")
    if big and len(head) < 16 or len(head) < 8:
        raise ValueError(f"{path}: truncated TIFF header")
    (off,) = struct.unpack_from(order + ("Q" if big else "I"), head, 8 if big else 4)
    count_fmt, entry, inline_size = ("Q", 20, 8) if big else ("H", 12, 4)
    cnt = read(off, struct.calcsize(count_fmt))
    if len(cnt) < struct.calcsize(count_fmt):
        raise ValueError(f"{path}: truncated TIFF directory")
    (n,) = struct.unpack(order + count_fmt, cnt)
    raw = read(off + len(cnt), entry * n)
    if len(raw) < entry * n:
        raise ValueError(f"{path}: truncated TIFF directory")
    tags, blobs = {}, {}
    for i in range(n):
        tag, typ = struct.unpack_from(order + "HH", raw, entry * i)
        (count,) = struct.unpack_from(order + ("Q" if big else "I"), raw, entry * i + 4)
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * count
        inline = raw[entry * i + entry - inline_size:entry * (i + 1)]
        val = inline if size <= inline_size else read(struct.unpack(order + ("Q" if big else "I"), inline)[0], size)
        if len(val) < size:
            raise ValueError(f"{path}: truncated TIFF tag {tag}")
        if tag in (347, 700):
            blobs[tag] = bytes(val[:size])
        tags[tag] = struct.unpack(order + fmt * count, val[:size])
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{path}: TIFF without ImageWidth or ImageLength (PIL refuses it too)")
    width, height = int(tags[256][0]), int(tags[257][0])
    if 274 in tags:  # Pillow reads a one-value tag's first value, whatever its count
        orientation = tags[274][0]
    else:
        m = _XMP_ORIENTATION.search(blobs.get(700, b""))
        orientation = int(m[2]) if m else 1
    if orientation in (5, 6, 7, 8):
        width, height = height, width
    return dict(tags=tags, blobs=blobs, order=order, width=width, height=height, orientation=orientation)


def _tiff_layout(ifd: dict, path: str) -> dict:
    """TiffImageFile._setup: the compression, Pillow's OPEN_INFO key and
    its (mode, raw mode), or the refusal that names what is not read."""
    tags = ifd["tags"]
    ccode = tags.get(259, (1,))[0]
    photo = tags.get(262, (0,))[0]
    if ccode in _TIFF_REFUSED_COMPRESSION:
        name = _TIFF_REFUSED_COMPRESSION[ccode]
        if ccode == 50001:
            why = "PIL refuses it too: the libtiff it bundles is built without WebP"
        elif photo in _SGILOG_PHOTOMETRIC:
            why = f"PIL refuses it too: unknown pixel mode for photometric {photo} ({_SGILOG_PHOTOMETRIC[photo]})"
        else:
            why = (f"PIL refuses it too: libtiff refuses photometric {photo} for SGILog, which it decodes only "
                   "under LogL or LogLuv photometric")
        raise ValueError(f"{path}: TIFF with {name} compression is not supported ({why})")
    if ccode not in _TIFF_COMPRESSION:
        raise ValueError(f"{path}: TIFF compression {ccode} is not supported (PIL refuses it too)")
    if ccode == 6:  # TiffImagePlugin: "old style jpeg compression images most certainly are YCbCr"
        photo = 6
    fill = tags.get(266, (1,))[0]
    fmt = tuple(tags.get(339, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps, extra = tuple(tags.get(258, (1,))), tuple(tags.get(338, ()))
    spp = tags.get(277, (1,))[0]
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    key = (ifd["order"], photo, fmt, fill, bps, extra)
    if len(bps) != spp or key not in _TIFF_OPEN_INFO:
        raise ValueError(f"{path}: TIFF pixel layout (photometric {photo}, SampleFormat {fmt}, FillOrder {fill}, "
                         f"bits {bps}, extra samples {extra}) is not supported (PIL refuses it too: unknown pixel "
                         "mode)")
    mode, raw = _TIFF_OPEN_INFO[key]
    compression = _TIFF_COMPRESSION[ccode]
    planar = tags.get(284, (1,))[0] == 2
    lay = dict(compression=compression, photo=photo, fill=fill, bits=bps[0], spp=spp, mode=mode, raw=raw,
               planar=planar and spp > 1, t4=tags.get(292, (0,))[0])
    if compression != "raw":
        if fill == 2:  # libtiff undoes the fill order itself: Pillow reads the FillOrder 1 raw mode
            lay["raw"] = _TIFF_OPEN_INFO[key[:3] + (1,) + key[4:]][1]
        if compression in _CCITT_KIND and bps != (1,):
            raise ValueError(f"{path}: CCITT TIFF at {bps[0]} bits a sample (libtiff refuses it: PIL too)")
        if compression == "thunderscan" and bps != (4,):
            raise ValueError(f"{path}: ThunderScan TIFF at {bps[0]} bits a sample (libtiff decodes 4 bits only: "
                             "PIL refuses it too)")
        predictor = tags.get(317, (1,))[0] if compression in _TIFF_PREDICTED else 1
        if predictor == 2 and bps[0] not in (8, 16, 32) or predictor == 3 and (fmt != (3,) or bps[0] != 32) or \
                predictor not in (1, 2, 3):
            raise ValueError(f"{path}: TIFF predictor {predictor} at {bps[0]} bits, SampleFormat {fmt} is not "
                             "supported (PIL refuses it too)")
        lay["predictor"] = predictor
        if lay["planar"] and not extra and raw.startswith("RGBA"):
            lay["raw"] = "RGBa" + raw[4:]  # Pillow reads libtiff's planes as associated alpha then
        if lay["planar"] and spp > _MODE_BANDS[mode] and 324 not in tags:  # its tile reader takes the first planes
            raise ValueError(f"{path}: planar TIFF of {spp} planes for the {_MODE_BANDS[mode]} bands of mode {mode} "
                             "is not supported (PIL refuses it too)")
    elif raw in _TIFF_RAW_MISSING or lay["planar"] and any(ch not in _TIFF_RAW_BANDS.get(mode, "") for ch in raw[:spp]):
        raise ValueError(f"{path}: uncompressed TIFF in raw mode {raw!r}{' by planes' if lay['planar'] else ''} is not "
                         "supported (PIL refuses it too: unknown raw mode)")
    return lay


def _decode_tiff(data: bytes, path: str) -> np.ndarray:
    ifd = _tiff_ifd(_bytes_reader(data), path)
    lay = _tiff_layout(ifd, path)
    if lay["compression"] == "ojpeg":
        rgb = _tiff_ojpeg(data, ifd, lay, path)
    elif lay["photo"] == 6 and lay["spp"] == 3 and lay["compression"] != "raw":
        rgb = _tiff_ycbcr(data, ifd, lay, path)  # libjpeg's RGB, or libtiff's RGBA interface
    else:
        rgb = _tiff_rgb(_tiff_samples(data, ifd, lay, path), lay, ifd["tags"], path)
    turn = _ORIENT.get(ifd["orientation"])
    return np.ascontiguousarray(turn(rgb) if turn else rgb)


def _tiff_grid(ifd: dict, lay: dict, path: str) -> dict:
    """The strips or tiles: offsets, byte counts, their size, how many across
    and down, the planes."""
    tags = ifd["tags"]
    W, H = int(tags[256][0]), int(tags[257][0])
    if 273 in tags:
        offsets, counts, tiled = tags[273], tags.get(279), False
        tw, th = W, tags.get(278, (H,))[0]
    elif 324 in tags:
        offsets, counts, tiled = tags[324], tags.get(325), True
        if 322 not in tags or 323 not in tags:
            raise ValueError(f"{path}: tiled TIFF without TileWidth or TileLength (PIL refuses it too)")
        tw, th = tags[322][0], tags[323][0]
    else:
        raise ValueError(f"{path}: TIFF without strips or tiles (PIL refuses it too)")
    if lay["compression"] != "raw" and counts is None:
        raise ValueError(f"{path}: compressed TIFF without byte counts")
    rows_tag = th
    th = max(1, min(th, H)) if not tiled else th
    if tw < 1 or th < 1:
        raise ValueError(f"{path}: TIFF tiles of {tw}x{th} (PIL refuses them too)")
    planes = lay["spp"] if lay["planar"] else 1
    across, down = -(-W // tw), -(-H // th)
    if len(offsets) < across * down * planes:
        raise ValueError(f"{path}: TIFF with {len(offsets)} strips or tiles for {across * down * planes}")
    if lay["compression"] == "raw" and not tiled and rows_tag == H and not lay["planar"]:
        offsets = offsets[-1:]  # Pillow reads one strip from the last offset
    return dict(W=W, H=H, tw=tw, th=th, tiled=tiled, offsets=offsets, counts=counts, planes=planes, across=across,
                down=down)


def _tiff_chunks(data: bytes, g: dict, lay: dict, need_of, path: str):
    """Each strip or tile: (plane, y, x, its rows, its bytes), decompressed
    (libtiff reverses the bits of FillOrder 2 data first, CCITT and JPEG
    aside) unless JPEG, whose streams come as stored. need_of(y, x, rows)
    gives the bytes it must yield."""
    compression, tw = lay["compression"], g["tw"]
    lib = _load()
    k, old_style = 0, None
    for p in range(g["planes"]):
        for ty in range(g["down"]):
            for tx in range(g["across"]):
                y, x = ty * g["th"], tx * tw
                rows = min(g["th"], g["H"] - y) if not g["tiled"] else g["th"]
                need = need_of(y, x, rows)
                off = g["offsets"][k]
                src = data[off:off + (g["counts"][k] if g["counts"] is not None and compression != "raw" else need)]
                k += 1
                if lay["fill"] == 2 and compression not in _CCITT_KIND and compression not in ("jpeg", "ojpeg"):
                    src = _BIT_REVERSE[np.frombuffer(src, np.uint8)].tobytes()
                if compression in ("raw", "jpeg"):
                    buf = src
                elif compression == "deflate":
                    try:
                        buf = zlib.decompress(src)
                    except zlib.error as e:
                        raise ValueError(f"{path}: corrupt TIFF Deflate data ({e})") from e
                elif compression in _CCITT_KIND:
                    buf = np.zeros(need, np.uint8)
                    kind = _CCITT_KIND[compression] + (compression == "group3" and bool(lay["t4"] & 1))
                    rc = lib.sfod_ccitt_decode(src, len(src), kind, int(lay["fill"] == 2), off & 1, tw, rows,
                                               buf.ctypes.data_as(_U8P), need // rows)
                    if rc != 0:
                        raise ValueError(f"{path}: TIFF {compression} decode failed: "
                                         f"{CCITT_ERRORS.get(rc, 'unknown error')} (code {rc})")
                    buf = buf.tobytes()
                elif compression == "thunderscan":
                    buf = np.zeros(need, np.uint8)
                    rc = lib.sfod_thunderscan(src, len(src), tw, rows, need // rows, buf.ctypes.data_as(_U8P))
                    if rc < 0:
                        raise ValueError(f"{path}: TIFF ThunderScan decode failed: {THUNDERSCAN_ERRORS[rc]}")
                    buf = buf.tobytes()
                elif compression in ("lzma", "zstd"):
                    buf = np.empty(need, np.uint8)
                    fn = lib.sfod_xz_decode if compression == "lzma" else lib.sfod_zstd_decode
                    rc = fn(src, len(src), buf.ctypes.data_as(_U8P), need)
                    if rc < 0:
                        raise ValueError(f"{path}: TIFF {compression.upper()} decode failed: "
                                         f"{(XZ_ERRORS if compression == 'lzma' else ZSTD_ERRORS)[rc]} (code {rc})")
                    buf = buf.tobytes()
                elif compression == "lzw":
                    # LZWPreDecode picks the style at the first strip read
                    # and keeps its decoder for the rest of the image
                    if old_style is None:
                        old_style = len(src) >= 2 and src[0] == 0 and src[1] & 1 == 1
                    buf = np.empty(need, np.uint8)
                    if lib.sfod_tiff_lzw(src, len(src), buf.ctypes.data_as(_U8P), need, int(old_style)) < 0:
                        raise ValueError(f"{path}: corrupt or short TIFF {compression} data")
                    buf = buf.tobytes()
                else:
                    buf = np.empty(need, np.uint8)
                    rc = lib.sfod_packbits(src, len(src), buf.ctypes.data_as(_U8P), need)
                    if rc < 0:
                        raise ValueError(f"{path}: corrupt or short TIFF {compression} data")
                    buf = buf.tobytes()
                if compression != "jpeg" and len(buf) < need:
                    if compression == "raw":
                        raise ValueError(f"{path}: truncated TIFF strip or tile (PIL refuses it too: image file is "
                                         "truncated)")
                    raise ValueError(f"{path}: TIFF {compression} data ends before its strip or tile does")
                yield p, y, x, rows, buf


def _unpack_bits(chunk: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Rows of samples of `bits` bits packed high bits first -> [rows, n]."""
    b = np.unpackbits(chunk, axis=1)[:, :n * bits].reshape(chunk.shape[0], n, bits)
    return (b.astype(np.uint16) << np.arange(bits - 1, -1, -1, dtype=np.uint16)).sum(2, dtype=np.uint16)


def _tiff_samples(data: bytes, ifd: dict, lay: dict, path: str) -> np.ndarray:
    """The samples [H, W, spp] of the first page: uint8, or native uint16
    (12 and 16 bits) or uint32 (32 bits) holding the values the file's byte
    order gives. Uncompressed data is read as Pillow's raw decoder reads it:
    each tile's rows inside the image, at the stride Pillow gives a tile at
    the right edge; a plane of a planar file by a one-band 8-bit raw mode (a
    16-bit plane's bytes taken as samples); YCbCr as RGBX (four bytes a
    pixel)."""
    g = _tiff_grid(ifd, lay, path)
    if lay["compression"] == "jpeg":
        return _tiff_jpeg_samples(data, g, lay, ifd, path)
    W, H, tw, bits, spp = g["W"], g["H"], g["tw"], lay["bits"], lay["spp"]
    raw = lay["compression"] == "raw"
    per = 1 if lay["planar"] else spp
    sum_bits = bits * spp
    if raw and (lay["planar"] or lay["photo"] == 6):
        bits, per = 8, 1 if lay["planar"] else 4
    word = 8 if bits <= 8 else 16 if bits <= 16 else 32
    order = np.dtype(ifd["order"] + f"u{word // 8}")
    out = np.zeros((H, W, max(spp, per)), np.dtype(f"u{word // 8}"))
    full = (tw * per * bits + 7) // 8  # a tile row's bytes as libtiff decodes it

    def layout(y, x, rows):
        """(rows, stride, bytes of a row's pixels inside the image)"""
        if not raw:
            return rows, full, full
        cw = min(tw, W - x)
        nbytes = (cw * per * bits + 7) // 8
        stride = int(tw * sum_bits / 8 / (spp if lay["planar"] else 1)) if x + tw > W else nbytes
        if stride < nbytes:
            raise ValueError(f"{path}: TIFF tile rows shorter than their pixels (PIL refuses them too)")
        return min(rows, H - y), stride, nbytes

    def need_of(y, x, rows):
        rows, stride, nbytes = layout(y, x, rows)
        return (rows - 1) * stride + nbytes if raw else rows * stride

    predictor = lay.get("predictor", 1)
    for p, y, x, rows, buf in _tiff_chunks(data, g, lay, need_of, path):
        rows, stride, nbytes = layout(y, x, rows)
        flat = np.frombuffer(buf[:(rows - 1) * stride + nbytes] + bytes(stride - nbytes), np.uint8)
        chunk = flat.reshape(rows, stride)[:, :nbytes]
        n = nbytes * 8 // (bits * per) if raw else tw
        if predictor == 3:
            chunk = _float_predictor(chunk, tw * per).view(np.uint32).reshape(rows, tw, per)
        elif bits in (8, 16, 32):
            chunk = np.ascontiguousarray(chunk[:, :n * per * bits // 8]).view(order).reshape(rows, n, per)
            chunk = chunk.astype(out.dtype)
            if predictor == 2:  # horizontal differencing, modulo the sample size
                chunk = np.cumsum(chunk, axis=1, dtype=chunk.dtype)
        else:  # 1, 2, 4 or 12 bits: one sample a pixel, high bits first
            chunk = _unpack_bits(chunk, bits, n)[..., None]
        hh, ww = min(rows, H - y), min(chunk.shape[1], W - x)
        out[y:y + hh, x:x + ww, p:p + per] = chunk[:hh, :ww]
    return out


def _float_predictor(rows: np.ndarray, n: int) -> np.ndarray:
    """libtiff's fpAcc (predictor 3) over rows of n 32-bit samples: the bytes
    summed along the row, then each sample's bytes gathered from the four
    byte planes (most significant first) -> native float32 [rows, n]."""
    acc = np.cumsum(rows[:, :4 * n], axis=1, dtype=np.uint8)
    return np.ascontiguousarray(acc.reshape(rows.shape[0], 4, n)[:, ::-1].transpose(0, 2, 1)).view(np.float32)[..., 0]


def _tiff_rgb(s: np.ndarray, lay: dict, tags: dict, path: str) -> np.ndarray:
    """The samples as convert("RGB") gives the mode Pillow opens them as."""
    mode, raw, compression = lay["mode"], lay["raw"], lay["compression"]
    grey = None
    if s.shape[2] == 4 and lay["photo"] == 6:  # YCbCr read as RGBX by Pillow's raw decoder
        return np.ascontiguousarray(s[..., :3])
    if mode == "1":
        grey = s[..., 0] * np.uint8(255)
        if raw.startswith("1;I"):
            grey = 255 - grey
    elif mode in ("L", "LA"):
        bits = lay["bits"]
        grey = s[..., 0] * np.uint8(255 // ((1 << bits) - 1)) if bits < 8 else s[..., 0]
        if ";" in raw and "I" in raw.split(";")[1]:
            grey = 255 - grey
    elif mode.startswith("I;16"):
        grey = np.minimum(s[..., 0], 255).astype(np.uint8)
    elif mode in ("I", "F"):
        kind = _TIFF_NUMERIC[raw]
        v = s[..., 0].astype(f"u{kind[1]}")
        if compression != "raw" and raw in _TIFF_SWAPPED_BY_PILLOW:
            v = v.byteswap()
        v = v.view(kind)
        if mode == "I":
            grey = np.clip(v, 0, 255).astype(np.uint8)
        else:  # Convert.c: f2l, NaN landing on 0 as the cast does on x86
            grey = np.clip(np.nan_to_num(v, nan=0.0, posinf=255.0, neginf=0.0), 0, 255).astype(np.uint8)
    if grey is not None:
        return np.repeat(grey[..., None], 3, axis=2)
    if s.dtype != np.uint8:  # the 16-bit colour raw modes keep the high byte
        s = (s >> 8).astype(np.uint8)
    if mode in ("P", "PA"):
        if 320 not in tags:
            raise ValueError(f"{path}: palette TIFF without ColorMap (PIL refuses it too)")
        cmap = np.asarray(tags[320], np.uint16) // 256
        n = len(cmap) // 3
        return _palette_rgb(s[..., 0], cmap[:3 * n].reshape(3, n).T.astype(np.uint8))
    if mode == "LAB":  # LittleCMS converts Pillow's offset a* and b*: the raw mode flips the file's
        lab = np.ascontiguousarray(s[..., :3])  # signed ones, a plane's one-band unpacker does not
        if not lay["planar"]:
            lab = lab ^ np.array([0, 128, 128], np.uint8)
        return _lab_rgb(lab)
    if mode == "CMYK":  # Convert.c:cmyk2rgb
        nk = 255 - s[..., 3:4].astype(np.int32)
        t = s[..., :3].astype(np.int32) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    rgb = s[..., :3]
    if raw.startswith("RGBa"):  # Unpack.c un-premultiplies, clipped
        a = s[..., 3:4].astype(np.int32)
        un = np.clip(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 0, 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un))
    return np.ascontiguousarray(rgb, dtype=np.uint8)


def _lab_rgb(lab: np.ndarray) -> np.ndarray:
    """Pillow's "LAB" [H, W, 3] -> RGB as its convert("RGB") gives it
    (ImageCms: LittleCMS's Lab -> sRGB transform; data/lab_srgb_clut.bin is
    its 33^3 table, read out of LittleCMS 2.17 by
    tests/torch_tiff_coders.py:littlecms_lab_clut; the interpolation is
    csrc/containers.cpp:sfod_lab_rgb)."""
    global _LAB_CLUT
    if _LAB_CLUT is None:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "lab_srgb_clut.bin"), "rb") as f:
            _LAB_CLUT = np.frombuffer(zlib.decompress(f.read()), "<u2").astype(np.uint16)
    out = np.empty(lab.shape, np.uint8)
    _load().sfod_lab_rgb(np.ascontiguousarray(lab, np.uint8).ctypes.data_as(_U8P), lab.size // 3,
                         _LAB_CLUT.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.ctypes.data_as(_U8P))
    return out


_LAB_CLUT = None


def _tiff_jpeg_samples(data: bytes, g: dict, lay: dict, ifd: dict, path: str, rgb: bool = False,
                       sampling=(1, 1)) -> np.ndarray:
    """JPEG compression (7): each strip or tile an abbreviated JPEG stream
    after the JPEGTables tag's tables, as tif_jpeg.c feeds libjpeg. libtiff
    asks libjpeg for RGB only for YCbCr in one plane (Pillow's
    JPEGCOLORMODE_RGB); every other file comes out as stored, no colour
    transform whatever marker the stream carries (JCS_UNKNOWN). -> [H, W, 3]
    RGB when rgb, else the samples [H, W, spp]."""
    if lay["bits"] != 8:
        raise ValueError(f"{path}: JPEG-compressed TIFF at {lay['bits']} bits is not supported (PIL refuses it too)")
    lib = _load()
    tables = ifd["blobs"].get(347, b"")
    W, H = g["W"], g["H"]
    nc = 3 if rgb else 1 if lay["planar"] else lay["spp"]
    out = np.zeros((H, W, 3 if rgb else lay["spp"]), np.uint8)
    hs, vs = sampling
    for p, y, x, rows, src in _tiff_chunks(data, g, lay, lambda y, x, rows: 0, path):
        seg_w, seg_h = g["tw"], rows
        px = _U8P()
        h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
        rc = lib.sfod_jpeg_decode_tiff(tables, len(tables), src, len(src), int(rgb), hs, vs, ctypes.byref(px),
                                       ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
        if rc != 0:
            raise ValueError(f"{path}: TIFF JPEG decode failed: {JPEG_ERRORS.get(rc, 'unknown error')} (code {rc})")
        arr = np.ctypeslib.as_array(px, shape=(h.value, w.value, c.value)).copy()
        lib.sfod_image_free(px)
        if c.value != nc:
            raise ValueError(f"{path}: TIFF JPEG stream with {c.value} components for {nc} (libtiff refuses it: "
                             "PIL too)")
        last_strip = not g["tiled"] and y + rows >= H
        if w.value != seg_w or h.value < seg_h or (h.value > seg_h and not last_strip):
            raise ValueError(f"{path}: TIFF JPEG stream of {w.value}x{h.value} for a {seg_w}x{seg_h} strip or tile "
                             "(libtiff refuses it: PIL too)")
        hh, ww = min(seg_h, H - y), min(seg_w, W - x)
        out[y:y + hh, x:x + ww, p:p + arr.shape[2]] = arr[:hh, :ww]
    return out


def _ycbcr_tables(tags: dict) -> tuple:
    """tif_color.c:TIFFYCbCrToRGBInit's tables from YCbCrCoefficients and
    ReferenceBlackWhite (libtiff's defaults when absent), in its float32
    arithmetic: (Y_tab, Cr_r_tab, Cb_b_tab, Cr_g_tab, Cb_g_tab)."""
    f32 = np.float32

    def rational(tag, default):
        v = tags.get(tag)
        if v is None:
            return [f32(x) for x in default]
        return [f32(0) if v[i + 1] == 0 else f32(v[i]) / f32(v[i + 1]) for i in range(0, len(v), 2)]

    luma = rational(529, (0.299, 0.587, 0.114))
    rbw = rational(532, (0, 255, 128, 255, 128, 255))
    if any(np.isnan(v) for v in luma) or luma[1] == 0 or len(luma) < 3:
        raise ValueError("invalid YCbCrCoefficients (libtiff refuses them: PIL too)")
    if len(rbw) < 6 or not all(f32(-0x7FFFFFFF + 128) < v < f32(0x7FFFFFFF) for v in rbw):
        raise ValueError("invalid ReferenceBlackWhite (libtiff refuses it: PIL too)")

    def fix(v):
        return np.int64(np.int32(np.float64(v) * 65536.0 + 0.5))

    def clamp(v, lo, hi):
        return f32(lo) if not v >= lo else f32(hi) if v > hi else v

    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):  # the sample minus int32(RB), times CR, over RW - RB
        den = rw - rb if rw - rb != 0 else f32(1)
        return (f32(c - int(rb)) * f32(cr)) / den

    def clampw(v):
        lo, hi = f32(-128 * 32), f32(128 * 32)
        return np.int64(np.int32(lo if v < lo else hi if v > hi else v))

    x = np.arange(-128, 128)
    cr = np.array([clampw(code2v(int(i), rbw[4] - f32(128), rbw[5] - f32(128), 127)) for i in x], np.int64)
    cb = np.array([clampw(code2v(int(i), rbw[2] - f32(128), rbw[3] - f32(128), 127)) for i in x], np.int64)
    y_tab = np.array([clampw(code2v(int(i) + 128, rbw[0], rbw[1], 255)) for i in x], np.int64)
    half = np.int64(1 << 15)
    return y_tab, (d1 * cr + half) >> 16, (d3 * cb + half) >> 16, d2 * cr, d4 * cb + half


def _ycbcr_units_rgb(units: bytes, across: int, hs: int, vs: int, rows: int, width: int, tables) -> np.ndarray:
    """rows x width RGB pixels of YCbCr data units (csrc/containers.cpp:
    sfod_ycbcr_units over `tables`, _ycbcr_tables' as int32)."""
    pix = np.empty((rows, width, 3), np.uint8)
    _load().sfod_ycbcr_units(units, across, hs, vs, rows, width, *[t.ctypes.data_as(_I32P) for t in tables],
                             pix.ctypes.data_as(_U8P), width * 3)
    return pix


def _tiff_ycbcr(data: bytes, ifd: dict, lay: dict, path: str) -> np.ndarray:
    """A YCbCr file, compressed: JPEG in one plane through libjpeg's YCbCr
    -> RGB; anything else as Pillow reads it through libtiff's RGBA
    interface (tif_getimage.c): data units of YCbCrSubsampling's h x v luma
    samples and one Cb and Cr (planes only at 1 x 1), chroma replicated over
    the unit, converted by TIFFYCbCrtoRGB."""
    tags = ifd["tags"]
    g = _tiff_grid(ifd, lay, path)
    sub = tags.get(530)
    if lay["compression"] == "jpeg" and not lay["planar"]:
        sampling = (sub[0], sub[1]) if sub else (0, 0)
        return _tiff_jpeg_samples(data, g, lay, ifd, path, rgb=True, sampling=sampling)
    hs, vs = (sub[0], sub[1]) if sub else (2, 2)
    if (hs, vs) not in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)) or lay["planar"] and (hs, vs) != (1, 1):
        raise ValueError(f"{path}: YCbCr TIFF with subsampling {hs}x{vs}{' in planes' if lay['planar'] else ''} "
                         "(libtiff's RGBA interface refuses it: PIL too)")
    W, H, tw = g["W"], g["H"], g["tw"]
    tables = [np.ascontiguousarray(t, np.int32) for t in _ycbcr_tables(tags)]

    def convert(units: bytes, across: int, rows: int, width: int) -> np.ndarray:
        return _ycbcr_units_rgb(units, across, hs, vs, rows, width, tables)

    if lay["planar"]:  # putseparate8bitYCbCr11tile: the planes' samples are 1 x 1 units
        return convert(_tiff_samples(data, ifd, lay, path).tobytes(), W, H, W)
    units_across = -(-tw // hs)
    unit = hs * vs + 2
    row_bytes = units_across * unit  # a row of units: vs rows of pixels
    # the predictor's row: TIFFScanlineSize (a unit row over vs) for strips, TIFFTileRowSize for tiles
    pred_row = tw * 3 if g["tiled"] else row_bytes // vs

    def need_of(y, x, rows):
        return -(-rows // vs) * row_bytes

    out = np.zeros((H, W, 3), np.uint8)
    for _, y, x, rows, buf in _tiff_chunks(data, g, lay, need_of, path):
        if lay["predictor"] == 2:  # horAcc8, stride 3, over rows of pred_row bytes
            n = need_of(y, x, rows)
            if n % pred_row or pred_row % 3:
                raise ValueError(f"{path}: YCbCr TIFF whose predictor rows do not divide its strips or tiles "
                                 "(libtiff refuses it: PIL too)")
            acc = np.frombuffer(buf[:n], np.uint8).reshape(n // pred_row, pred_row // 3, 3)
            buf = np.cumsum(acc, axis=1, dtype=np.uint8).tobytes()
        pix = convert(buf, units_across, rows, tw)
        hh, ww = min(rows, H - y), min(tw, W - x)
        out[y:y + hh, x:x + ww] = pix[:hh, :ww]
    return out


# ---------------------------------------------------------------------------
# Old-style JPEG (compression 6), as libtiff's tif_ojpeg.c has libjpeg read
# it: its header markers read from the JPEGInterchangeFormat stream and on
# into the strips (OJPEGReadHeaderInfoSec), or its tables from the
# JPEGQTables, JPEGDCTables and JPEGACTables tags; a stream rebuilt from them
# (OJPEGWriteStream: SOI, the tables, DRI, SOF, SOS, then the scan's data,
# the strips after it with an RST marker between two, EOI); the components
# read raw (raw_data_out) as YCbCr data units of the frame's sampling,
# which Pillow converts through libtiff's RGBA interface
# ---------------------------------------------------------------------------

OJPEG_ERRORS = {
    "missing": "the JPEG data ends inside its markers (libtiff refuses it: PIL too)",
    "marker": "an unknown marker in the JPEG data (libtiff refuses it: PIL too)",
    "corrupt": "corrupt JPEG markers or tables (libtiff refuses them: PIL too)",
    "tables": "no JPEG tables: neither an SOF marker nor the JPEGQTables tag (libtiff refuses it: PIL too)",
    "size": "a JPEG frame whose size or component count is not the image's (libtiff refuses it: PIL too)",
    "sampling": "JPEG sampling factors other than the YCbCrSubsampling libtiff takes from the frame (libtiff "
                "refuses them: PIL too)",
    "strips": "strips whose rows are not a whole number of JPEG MCU rows (libtiff refuses them: PIL too)",
}


def _ojpeg_parts(data: bytes, tags: dict) -> tuple:
    """OJPEGReadBufferFill's sources: ([the JPEGInterchangeFormat stream,
    if its offset lies in the file, then each strip's bytes (an offset past
    the file: none; a byte count of 0 or past the file: to its end)], the
    index of the first strip)."""
    size = len(data)
    parts = []
    jif = tags.get(513, (0,))[0]
    if 0 < jif < size:
        n = tags.get(514, (0,))[0]
        parts.append(data[jif:jif + (n if 0 < n and jif + n <= size else size - jif)])
    first = len(parts)
    counts = tags.get(279)
    for k, off in enumerate(tags[273]):
        if not 0 < off < size:
            parts.append(b"")
            continue
        c = counts[k] if counts is not None and k < len(counts) else 0
        parts.append(data[off:off + (c if 0 < c and off + c <= size else size - off)])
    return parts, first


def _ojpeg_header(src: bytes, spp: int, sub: tuple, W: int, H: int, path: str) -> dict:
    """OJPEGReadHeaderInfoSec over the joined sources: the DQT, DHT, DRI,
    SOF and SOS markers up to SOS, each checked as libtiff checks it."""
    def refuse(kind):
        raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS[kind]}")

    def word(p):
        if p + 2 > len(src):
            refuse("missing")
        return (src[p] << 8) | src[p + 1]

    h = dict(q={}, dc={}, ac={}, dri=None, sof=None, sos=None, end=0)
    pos = 0
    while pos < len(src) and src[pos] == 0xFF:
        pos += 1
        while pos < len(src) and src[pos] == 0xFF:
            pos += 1
        if pos >= len(src):
            refuse("missing")
        m = src[pos]
        pos += 1
        if m == 0xD8:
            continue
        n = word(pos)
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            if n < 2:
                refuse("corrupt")
        elif m == 0xDD:
            if n != 4:
                refuse("corrupt")
            h["dri"] = word(pos + 2)
        elif m == 0xDB:
            if n <= 2:
                refuse("corrupt")
            p, left = pos + 2, n - 2
            while left > 0:
                if left < 65 or p + 65 > len(src) or src[p] & 15 > 3:
                    refuse("corrupt")
                h["q"][src[p] & 15] = b"\xff\xdb\x00\x43" + src[p:p + 65]
                p, left = p + 65, left - 65
        elif m == 0xC4:
            if n <= 2 or pos + n > len(src):
                refuse("corrupt" if n <= 2 else "missing")
            o = src[pos + 2]
            if o >> 4 not in (0, 1) or o & 15 > 3:
                refuse("corrupt")
            (h["ac"] if o >> 4 else h["dc"])[o & 15] = b"\xff\xc4" + src[pos:pos + n]
        elif m in (0xC0, 0xC1, 0xC3):
            if h["sof"] is not None or n < 11 or (n - 8) % 3:
                refuse("corrupt")
            nc = (n - 8) // 3
            if pos + n > len(src):
                refuse("missing")
            if nc != spp or src[pos + 2] != 8 or src[pos + 7] != nc:
                refuse("size")
            y, x = word(pos + 3), word(pos + 5)
            if (y < H) or (x < W) or x > W:
                refuse("size")
            comps = [tuple(src[pos + 8 + 3 * i:pos + 11 + 3 * i]) for i in range(nc)]
            h["sof"] = dict(marker=m, y=y, x=x, comps=comps)
        elif m == 0xDA:
            if n != 6 + 2 * spp or pos + n > len(src) or src[pos + 2] != spp:
                refuse("corrupt" if pos + n <= len(src) else "missing")
            h["sos"] = [tuple(src[pos + 3 + 2 * i:pos + 5 + 2 * i]) for i in range(spp)]
            h["end"] = pos + n
            return h
        else:
            refuse("marker")
        pos += n
    h["end"] = pos
    return h


def _ojpeg_tag_tables(data: bytes, tags: dict, h: dict, spp: int, path: str) -> None:
    """OJPEGReadHeaderInfoSecTables*: the tables of the JPEGQTables,
    JPEGDCTables and JPEGACTables tags (one offset a component, a component
    sharing the previous one's table where the offsets repeat)."""
    for tag, kind in ((519, "q"), (520, "dc"), (521, "ac")):
        offs = tags.get(tag)
        if not offs or offs[0] == 0:
            raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS['tables']}")
        sel = []
        for m in range(spp):
            off = offs[m] if m < len(offs) else 0
            if off != 0 and (m == 0 or off != offs[m - 1]):
                if any(offs[k] == off for k in range(m - 1)):
                    raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS['corrupt']}")
                if kind == "q":
                    body = data[off:off + 64]
                    if len(body) < 64:
                        raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS['missing']}")
                    h["q"][m] = b"\xff\xdb\x00\x43" + bytes([m]) + body
                else:
                    counts = data[off:off + 16]
                    total = sum(counts)
                    if len(counts) < 16 or total > 255 or off + 16 + total > len(data):
                        raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS['corrupt']}")
                    cls = m if kind == "dc" else 16 | m
                    h[kind][m] = (b"\xff\xc4" + struct.pack(">H", 19 + total) + bytes([cls]) + counts
                                  + data[off + 16:off + 16 + total])
                sel.append(m)
            else:
                sel.append(sel[-1] if sel else 0)
        h[kind + "_sel"] = sel


def _tiff_ojpeg(data: bytes, ifd: dict, lay: dict, path: str) -> np.ndarray:
    tags = ifd["tags"]
    W, H, spp = int(tags[256][0]), int(tags[257][0]), lay["spp"]
    if 273 not in tags:
        raise ValueError(f"{path}: old-style JPEG TIFF in tiles is not supported")
    if lay["planar"]:
        raise ValueError(f"{path}: old-style JPEG TIFF in planes is not supported")
    if lay["bits"] != 8:
        raise ValueError(f"{path}: old-style JPEG TIFF at {lay['bits']} bits (libtiff refuses it: PIL too)")
    # the photometric libtiff keeps (tif_dirread.c's OJPEG hacks: missing or
    # RGB is taken for YCbCr)
    photo = tags.get(262, (6,))[0]
    photo = 6 if photo == 2 else photo
    if spp == 3 and photo != 6:
        raise ValueError(f"{path}: old-style JPEG TIFF of 3 samples under photometric {photo} is not supported")
    if spp == 1 and photo not in (0, 1):
        raise ValueError(f"{path}: old-style JPEG TIFF of 1 sample under photometric {photo} (libtiff's RGBA "
                         "interface refuses YCbCr of one sample: PIL too)")
    parts, first = _ojpeg_parts(data, tags)
    src = b"".join(parts)
    tag_sub = tuple(tags.get(530, (2, 2))[:2]) if spp == 3 else (1, 1)
    h = _ojpeg_header(src, spp, tag_sub, W, H, path)
    # OJPEGSubsamplingCorrect: the frame's sampling stands; sampling a TIFF
    # cannot state is left to libjpeg's upsampling (1 x 1 units)
    hs, vs, forced = tag_sub[0], tag_sub[1], False
    if h["sof"] is not None and spp == 3:
        comps = h["sof"]["comps"]
        hs, vs = comps[0][1] >> 4, comps[0][1] & 15
        if hs not in (1, 2, 4) or vs not in (1, 2, 4) or any(c[1] != 0x11 for c in comps[1:]):
            hs, vs, forced = 1, 1, True
    rps = min(tags.get(278, (H,))[0], H)
    restart = tags.get(515, (0,))[0] & 0xFFFF  # tif_ojpeg.c keeps it in 16 bits
    if rps < H:
        if hs not in (1, 2, 4) or vs not in (1, 2, 4) or rps % (8 * vs):
            raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS['strips']}")
        restart = (-(-W // (8 * hs)) * (rps // (8 * vs))) & 0xFFFF
    if h["dri"] is not None:
        restart = h["dri"]
    if h["sof"] is None:  # the tables and frame from the tags
        _ojpeg_tag_tables(data, tags, h, spp, path)
        hv = [(hs << 4) | vs] + [0x11] * (spp - 1)
        h["sof"] = dict(marker=0xC0, y=H, x=W, comps=[(i, hv[i], h["q_sel"][i]) for i in range(spp)])
        h["sos"] = [(i, (h["dc_sel"][i] << 4) | h["ac_sel"][i]) for i in range(spp)]
    sof = h["sof"]
    if h["sos"] is None:  # libtiff's SOS then names component 0, which libjpeg refuses
        raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS['corrupt']}")
    stream = [b"\xff\xd8"]
    stream += [h["q"][k] for k in sorted(h["q"])] + [h["dc"][k] for k in sorted(h["dc"])]
    stream += [h["ac"][k] for k in sorted(h["ac"])]
    if restart:
        stream.append(b"\xff\xdd\x00\x04" + struct.pack(">H", restart))
    stream.append(bytes([0xFF, sof["marker"], 0, 8 + 3 * spp, 8]) + struct.pack(">HHB", sof["y"] & 0xFFFF,
                                                                                  sof["x"] & 0xFFFF, spp)
                  + b"".join(bytes(c) for c in sof["comps"]))
    stream.append(bytes([0xFF, 0xDA, 0, 6 + 2 * spp, spp]) + b"".join(bytes(c) for c in h["sos"]) + b"\x00\x3f\x00")
    # the scan: the rest of the source the header ended in, then the strips
    # after it, an RST marker after each strip that has a strip after it
    cut, k = h["end"], 0
    while k < len(parts) and cut >= len(parts[k]) and k < len(parts) - 1:
        cut -= len(parts[k])
        k += 1
    rst = 0
    for j in range(k, len(parts)):
        chunk = parts[j][cut:] if j == k else parts[j]
        if not chunk:
            continue
        stream.append(chunk)
        if j >= first and j + 1 < len(parts):
            stream.append(bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) % 8
    stream.append(b"\xff\xd9")
    jpeg = b"".join(stream)
    lib = _load()
    px = _U8P()
    nc, hh, ww = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    dims = np.zeros(16, np.int32)
    interleave = spp == 1 or forced
    rc = lib.sfod_jpeg_decode_ojpeg(jpeg, len(jpeg), int(interleave), ctypes.byref(px), ctypes.byref(nc),
                                    dims.ctypes.data_as(_I32P), ctypes.byref(hh), ctypes.byref(ww))
    if rc != 0:
        raise ValueError(f"{path}: TIFF old-style JPEG decode failed: {JPEG_ERRORS.get(rc, 'unknown error')} "
                         f"(code {rc})")
    try:
        if interleave:
            pix = np.ctypeslib.as_array(px, shape=(hh.value, ww.value, nc.value))[:H, :W].copy()
            if spp == 1:
                return np.repeat(pix, 3, axis=2)
            tables = [np.ascontiguousarray(t, np.int32) for t in _ycbcr_tables(tags)]
            return _ycbcr_units_rgb(pix.reshape(H, W * 3).tobytes(), W, 1, 1, H, W, tables)  # 1 x 1 units
        # the units of OJPEGDecodeRaw, converted from the planes they are cut from
        (yw, yh), (cw, ch) = dims[2:4], dims[6:8]
        if dims[6:8].tolist() != dims[10:12].tolist() or yw < -(-W // hs) * hs or yh < -(-H // vs) * vs or \
                cw < -(-W // hs) or ch < -(-H // vs):
            raise ValueError(f"{path}: old-style JPEG TIFF: {OJPEG_ERRORS['sampling']}")
        base = ctypes.addressof(px.contents)
        tables = [np.ascontiguousarray(t, np.int32) for t in _ycbcr_tables(tags)]
        rgb = np.empty((H, W, 3), np.uint8)
        lib.sfod_ycbcr_planes(px, int(yw), ctypes.cast(base + int(yw * yh), _U8P),
                              ctypes.cast(base + int(yw * yh + cw * ch), _U8P), int(cw), hs, vs, H, W,
                              *[t.ctypes.data_as(_I32P) for t in tables], rgb.ctypes.data_as(_U8P))
        return rgb
    finally:
        lib.sfod_image_free(px)


# ---------------------------------------------------------------------------
# WebP, as Pillow's WebPImagePlugin opens it: libwebp's demuxer, then frame 0
# through WebPAnimDecoder (RGBA, not premultiplied), then convert("RGB")
# ---------------------------------------------------------------------------

_WEBP_IMAGE_TAGS = (b"VP8 ", b"VP8L", b"VP8X")  # the first chunks PIL's _accept identifies
_WEBP_MAX_CHUNK = 0xFFFFFFFF - 8 - 1  # libwebp's MAX_CHUNK_PAYLOAD
_WEBP_MAX_AREA = 1 << 32  # MAX_IMAGE_AREA
_WEBP_ANIMATION, _WEBP_ALPHA, _WEBP_VALID_FLAGS = 0x02, 0x10, 0x3E  # VP8X flags (ICCP, ALPHA, EXIF, XMP, ANIM)


def _is_webp(head: bytes) -> bool:
    return head[:4] == b"RIFF" and head[8:12] == b"WEBP"


def _le(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _vp8_frame_size(payload: bytes, chunk_size: int, path: str) -> tuple:
    """VP8GetInfo: (width, height) of a key frame's header."""
    if len(payload) < 10:
        raise ValueError(f"{path}: truncated VP8 frame header")
    bits = _le(payload[:3])
    if (payload[3:6] != b"\x9d\x01\x2a" or bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk_size):
        raise ValueError(f"{path}: WebP decode failed: {WEBP_ERRORS[-2]}")
    w, h = _le(payload[6:8]) & 0x3FFF, _le(payload[8:10]) & 0x3FFF
    if not (w and h):
        raise ValueError(f"{path}: WebP decode failed: {WEBP_ERRORS[-2]}")
    return w, h


def _vp8l_frame_size(payload: bytes, path: str) -> tuple:
    """VP8LGetInfo: (width, height) from the 14-bit fields after the signature."""
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        raise ValueError(f"{path}: WebP decode failed: {WEBP_ERRORS[-8]}")
    bits = _le(payload[1:5])
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


class _WebPDemux:
    """The chunks of a complete WebP file as libwebp's WebPDemux walks them
    (src/demux/demux.c: ParseSingleImage, StoreFrame, ParseVP8X,
    ParseVP8XChunks, ParseAnimationFrame, IsValid*Format): what it refuses
    raises, naming the reason. ICCP, EXIF, XMP and unknown chunks are
    skipped; Pillow applies none of them to the pixels."""

    def __init__(self, data: bytes, path: str):
        self.path = path
        if len(data) < 20:
            self.refuse("truncated WebP file (shorter than its RIFF header and first chunk header)")
        riff_size = _le(data[4:8])
        if riff_size < 8 or riff_size > _WEBP_MAX_CHUNK:
            self.refuse(f"WebP RIFF size {riff_size} is invalid")
        self.end = riff_size + 8
        if len(data) < self.end:
            self.refuse(f"truncated WebP file ({len(data)} of the {self.end} bytes its RIFF header gives)")
        self.data, self.pos = data[:self.end], 12  # libwebp reads nothing past the RIFF chunk
        first = self.data[12:16]
        if first not in _WEBP_IMAGE_TAGS:
            self.refuse(f"RIFF WEBP file whose first chunk is {first!r}, not VP8, VP8L or VP8X: PIL does not "
                        "identify it either")
        self.frames, self.flags, self.canvas, self.ext, self.anim_chunks = [], 0, None, first == b"VP8X", 0
        if self.ext:
            self.parse_vp8x()
        else:
            self.parse_single_image()
        self.validate()

    def refuse(self, why: str):
        raise ValueError(f"{self.path}: {why}")

    def left(self) -> int:
        return self.end - self.pos

    def need(self, n: int, what: str):
        if n > self.left():
            self.refuse(f"truncated or corrupt WebP file ({what} runs past the RIFF chunk)")

    def store_frame(self, frame: dict, min_size: int) -> None:
        """StoreFrame: an optional ALPH and one VP8 or VP8L chunk from pos."""
        if self.left() < 8 or self.left() < min_size:
            self.refuse("truncated WebP file (a frame's chunks are missing)")
        image = alpha = False
        while True:
            start = self.pos
            tag, size = self.data[start:start + 4], _le(self.data[start + 4:start + 8])
            if size > _WEBP_MAX_CHUNK:
                self.refuse(f"WebP chunk {tag!r} size {size} is invalid")
            padded = size + (size & 1)
            self.pos += 8
            self.need(padded, f"chunk {tag!r}")
            if tag == b"VP8L" and alpha:
                self.refuse("WebP frame with an ALPH chunk before VP8L (lossless carries its own alpha)")
            if tag == b"ALPH" and not alpha:
                alpha = True
                frame["alpha"] = (start, self.data[self.pos:self.pos + size])
            elif tag in (b"VP8 ", b"VP8L") and not image:
                payload = self.data[self.pos:self.pos + padded]
                w, h = (_vp8l_frame_size(payload, self.path) if tag == b"VP8L"
                        else _vp8_frame_size(payload, size, self.path))
                image = True
                frame.update(tag=tag, offset=start, payload=payload, chunk_size=size, width=w, height=h)
            else:
                self.pos = start  # the frame ends before this chunk
                return
            self.pos += padded
            if self.pos == self.end:
                return
            if self.left() < 8:
                self.refuse("truncated or corrupt WebP file (a partial chunk header after a frame)")

    def parse_single_image(self) -> None:
        if self.frames:
            self.refuse("WebP file with a second image outside ANMF chunks")
        if self.left() < 8:
            self.refuse("truncated WebP file (no image chunk)")
        frame = {"x": 0, "y": 0}
        self.store_frame(frame, 0)
        if not self.flags & _WEBP_ALPHA:
            frame.pop("alpha", None)  # an ALPH chunk without VP8X's alpha flag is ignored
        if not self.ext and "tag" in frame:
            self.canvas = (frame["width"], frame["height"])
            if frame["tag"] == b"VP8L" and frame["payload"][4] & 0x10:  # VP8L's alpha_is_used bit
                self.flags |= _WEBP_ALPHA
        self.frames.append(frame)

    def parse_vp8x(self) -> None:
        size = _le(self.data[16:20])
        if size > _WEBP_MAX_CHUNK or size < 10:
            self.refuse(f"WebP VP8X chunk size {size} is invalid")
        self.pos = 20
        padded = size + (size & 1)
        self.need(padded, "the VP8X chunk")
        body = self.data[20:30]
        self.flags = body[0]
        self.canvas = (_le(body[4:7]) + 1, _le(body[7:10]) + 1)
        if self.canvas[0] * self.canvas[1] >= _WEBP_MAX_AREA:
            self.refuse(f"WebP canvas {self.canvas} is too large")
        self.pos += padded
        self.need(8, "the chunk after VP8X")
        animation = bool(self.flags & _WEBP_ANIMATION)
        while True:
            start = self.pos
            tag, size = self.data[start:start + 4], _le(self.data[start + 4:start + 8])
            if size > _WEBP_MAX_CHUNK:
                self.refuse(f"WebP chunk {tag!r} size {size} is invalid")
            padded = size + (size & 1)
            self.need(8 + padded, f"chunk {tag!r}")
            if tag == b"VP8X":
                self.refuse("WebP file with a second VP8X chunk")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if self.anim_chunks or animation:
                    self.refuse(f"animated WebP file with a {tag!r} chunk outside ANMF")
                self.parse_single_image()
            elif tag == b"ANIM":
                if padded < 6:
                    self.refuse("WebP ANIM chunk shorter than 6 bytes")
                self.anim_chunks += 1
                self.pos += 8 + padded
            elif tag == b"ANMF":
                if not self.anim_chunks:
                    self.refuse("WebP ANMF chunk before ANIM")
                self.parse_frame(padded, animation)
            else:  # ICCP, EXIF, XMP and unknown chunks
                self.pos += 8 + padded
            if self.pos == self.end:
                return
            if self.left() < 8:
                self.refuse("truncated or corrupt WebP file (a partial chunk header)")

    def parse_frame(self, chunk_size: int, animation: bool) -> None:
        """ParseAnimationFrame: offsets x2, then the frame's chunks (the
        size comes from the bitstream, as libwebp takes it)."""
        if chunk_size < 16:
            self.refuse("WebP ANMF chunk shorter than its 16-byte header")
        self.need(8 + chunk_size, "an ANMF chunk")
        hdr = self.data[self.pos + 8:self.pos + 24]
        frame = {"x": 2 * _le(hdr[0:3]), "y": 2 * _le(hdr[3:6])}
        if (_le(hdr[6:9]) + 1) * (_le(hdr[9:12]) + 1) >= _WEBP_MAX_AREA:
            self.refuse("WebP ANMF frame is too large")
        self.pos += 24
        start = self.pos
        self.store_frame(frame, chunk_size - 16)
        if self.pos - start > chunk_size - 16:
            self.refuse("WebP ANMF chunk shorter than the frame it holds")
        if animation and ("tag" in frame or "alpha" in frame):
            if self.frames and "tag" not in self.frames[-1]:
                self.refuse("WebP frame without an image chunk before another frame")
            self.frames.append(frame)

    def validate(self) -> None:
        """IsValidSimpleFormat / IsValidExtendedFormat."""
        if not self.frames:
            self.refuse("WebP file without a frame")
        if self.ext and self.flags & ~_WEBP_VALID_FLAGS:
            self.refuse(f"WebP VP8X flags {self.flags:#04x} set reserved bits")
        animation = self.ext and bool(self.flags & _WEBP_ANIMATION)
        cw, ch = self.canvas
        for f in self.frames:
            if "tag" not in f:
                self.refuse("WebP frame without a VP8 or VP8L chunk")
            if "alpha" in f and f["alpha"][0] > f["offset"]:
                self.refuse("WebP frame whose ALPH chunk follows its image")
            if not animation:
                if f["x"] or f["y"] or (f["width"], f["height"]) != (cw, ch):
                    self.refuse(f"WebP frame {f['width']}x{f['height']} differs from the canvas {cw}x{ch}")
            elif f["x"] + f["width"] > cw or f["y"] + f["height"] > ch:
                self.refuse(f"WebP frame {f['width']}x{f['height']} at ({f['x']}, {f['y']}) leaves the canvas "
                            f"{cw}x{ch}")


def _decode_webp(data: bytes, path: str, rgba: bool = False) -> np.ndarray:
    """Frame 0 of a WebP file on its canvas (transparent black elsewhere, as
    WebPAnimDecoder starts each key frame): RGB, or, when rgba, the RGBA of
    Pillow's image (opaque where the file has no alpha flag, as Pillow's
    RGBX mode reads it)."""
    demux = _WebPDemux(data, path)
    f = demux.frames[0]
    lib = _load()
    w, h, payload = f["width"], f["height"], f["payload"]
    frame = np.empty((h, w, 4 if rgba else 3), np.uint8)
    out = frame.ctypes.data_as(_U8P)
    if f["tag"] == b"VP8L":
        rc = lib.sfod_webp_vp8l_decode(payload, len(payload), out, frame.shape[2], h, w)
    else:
        alpha = f["alpha"][1] if "alpha" in f else None
        rc = lib.sfod_webp_vp8_decode(payload, len(payload), f["chunk_size"], alpha, len(alpha or b""), out,
                                      frame.shape[2], h, w)
    if rc != 0:
        raise ValueError(f"{path}: WebP decode failed: {WEBP_ERRORS.get(rc, 'unknown error')} (code {rc})")
    cw, ch = demux.canvas
    if (cw, ch) != (w, h):
        canvas = np.zeros((ch, cw, frame.shape[2]), np.uint8)
        canvas[f["y"]:f["y"] + h, f["x"]:f["x"] + w] = frame
        frame = canvas
    if rgba and not demux.flags & _WEBP_ALPHA:
        frame[..., 3] = 255
    return frame


def _webp_size(head: bytes, path: str) -> tuple:
    """(height, width) of a WebP file's canvas from its first chunk."""
    tag, payload = head[12:16], head[20:30]
    if tag == b"VP8X":
        if len(payload) < 10:
            raise ValueError(f"{path}: truncated WebP file (its VP8X chunk is cut short)")
        return _le(payload[7:10]) + 1, _le(payload[4:7]) + 1
    if tag == b"VP8 ":
        w, h = _vp8_frame_size(payload, _le(head[16:20]), path)
        return h, w
    if tag == b"VP8L":
        w, h = _vp8l_frame_size(payload, path)
        return h, w
    raise ValueError(f"{path}: RIFF WEBP file whose first chunk is {tag!r}, not VP8, VP8L or VP8X: PIL does not "
                     "identify it either")
