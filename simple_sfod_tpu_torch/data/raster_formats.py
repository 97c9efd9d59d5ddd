"""Netpbm, DIB, ICO, CUR, QOI, SGI, PCX, DCX and TGA, as Pillow 12.1 opens
them and converts them with convert("RGB"): the header parsers of its
plugins (PpmImagePlugin, BmpImagePlugin's DibImageFile, IcoImagePlugin,
CurImagePlugin, QoiImagePlugin, SgiImagePlugin, PcxImagePlugin,
DcxImagePlugin, TgaImagePlugin), their raw modes and the conversion of the
mode each opens as. native_codec dispatches to them in the order of
Image.open; the loops that cannot be vectorised are data/csrc/raster.cpp.

A parser raises Reject where the plugin's _open fails in a way Image.open
passes over (SyntaxError, IndexError, TypeError, KeyError, EOFError,
struct.error, or no size): the next plugin in Image.ID order is tried. It
raises a ValueError where Pillow raises."""

from __future__ import annotations

import math
import struct

import numpy as np

from . import native_codec as nc

# Image._decompression_bomb_check: more pixels than this and Image.open raises
BOMB_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)
SAFEBLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK: the plain Netpbm decoder's read size
_WS = b" \t\n\x0b\x0c\r"


Reject = nc.Reject


class Source:
    """A file's bytes for the header parsers: read(offset, n), its length,
    and whether it lies on disk (Pillow's seek before a file's start fails
    on disk and stops at 0 in memory)."""

    def __init__(self, read, length: int, on_disk: bool, data: bytes = None):
        self.read, self.length, self.on_disk, self.data = read, length, on_disk, data

    @classmethod
    def of_bytes(cls, data: bytes, on_disk: bool = False) -> "Source":
        return cls(lambda off, n: data[off:off + n] if off >= 0 else b"", len(data), on_disk, data)

    def all(self) -> bytes:
        if self.data is None:
            self.data = self.read(0, self.length)
        return self.data


def _u16(b: bytes, at: int = 0, order: str = "<") -> int:
    if len(b) < at + 2:
        raise Reject("short header field")  # struct.error in Pillow
    return struct.unpack_from(order + "H", b, at)[0]


def _u32(b: bytes, at: int = 0, order: str = "<") -> int:
    if len(b) < at + 4:
        raise Reject("short header field")
    return struct.unpack_from(order + "I", b, at)[0]


def _byte(b: bytes, at: int) -> int:
    if len(b) <= at:
        raise Reject("short header")  # IndexError in Pillow
    return b[at]


def opened(lay: dict, path: str) -> dict:
    """ImageFile.__init__'s check (a mode and a size above 0, else the next
    plugin) and Image.open's decompression bomb check."""
    w, h = lay["size"][1], lay["size"][0]
    if w <= 0 or h <= 0:
        raise Reject("no size")
    if max(1, w) * max(1, h) > BOMB_PIXELS:
        raise ValueError(f"{path}: {lay['format']} image of {w}x{h} pixels is a decompression bomb (PIL refuses it "
                         "too)")
    return lay


def _truncated(fmt: str, path: str) -> ValueError:
    return ValueError(f"{path}: truncated {fmt} pixel data (PIL refuses it too: image file is truncated)")


def mode_rgb(mode: str, px: np.ndarray, palette=None) -> np.ndarray:
    """convert("RGB") of an image of `mode` whose bands are px [h, w, bands]
    (uint8; int64 or uint16 for "I", float32 for "F"); palette [n, 3] for "P" (indices
    past it, or all of them without one, are black)."""
    if mode in ("1", "L", "LA", "I", "F"):
        g = px[..., 0]
        if mode == "I":
            g = np.minimum(g, 255) if g.dtype.kind == "u" else np.clip(g, 0, 255)
        elif mode == "F":  # Convert.c f2l: truncated, NaN landing on 0 as the cast does on x86
            g = np.clip(np.nan_to_num(g, nan=0.0, posinf=255.0, neginf=0.0), 0, 255)
        return np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)
    if mode == "P":
        return nc._palette_rgb(px[..., 0], np.zeros((0, 3), np.uint8) if palette is None else palette)
    if mode == "CMYK":  # Convert.c:cmyk2rgb
        nk = 255 - px[..., 3:4].astype(np.int32)
        t = px[..., :3].astype(np.int32) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(px[..., :3], dtype=np.uint8)  # RGB, RGBA


def _bits(rows: np.ndarray, w: int) -> np.ndarray:
    """Rows of packed bits, high bit first -> [h, w] of 0 and 1."""
    return np.unpackbits(rows, axis=1)[:, :w]


def _rows(data: bytes, at: int, h: int, line: int, fmt: str, path: str) -> np.ndarray:
    """h rows of `line` bytes from data[at:]: the raw decoder's whole rows."""
    if at < 0 or len(data) - at < h * line:
        raise _truncated(fmt, path)
    return np.frombuffer(data, np.uint8, h * line, at).reshape(h, line)


# ---------------------------------------------------------------------------
# Netpbm: PBM, PGM, PPM (plain P1-P3, raw P4-P6), PFM (Pf) and Pillow's own
# PyP, PyRGBA, PyCMYK and P0CMYK heads
# ---------------------------------------------------------------------------

PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
             b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def ppm_accept(head: bytes) -> bool:
    return len(head) >= 2 and head[:1] == b"P" and head[1] in b"0123456fy"


class _Cursor:
    """fp.read(1) over a Source, a block at a time."""

    def __init__(self, src: Source, pos: int = 0):
        self.src, self.pos, self.buf, self.at = src, pos, b"", pos

    def read1(self) -> bytes:
        if not self.at <= self.pos < self.at + len(self.buf):
            self.at, self.buf = self.pos, self.src.read(self.pos, 4096)
        c = self.buf[self.pos - self.at:self.pos - self.at + 1]
        self.pos += len(c)
        return c


def _number(tok: bytes, kind, path: str):
    try:
        return kind(tok)
    except ValueError:
        raise ValueError(f"{path}: Netpbm header field {tok!r} is not a number (PIL refuses it too)") from None


def ppm_open(src: Source, path: str) -> dict:
    """PpmImageFile._open."""
    cur = _Cursor(src)
    magic = b""
    for _ in range(6):
        c = cur.read1()
        if not c or c in _WS:
            break
        magic += c
    if magic not in PPM_MODES:
        raise Reject("not a PPM file")
    mode = PPM_MODES[magic]

    def token() -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = cur.read1()
            if not c:
                break
            if c in _WS:
                if not tok:
                    continue
                break
            if c == b"#":  # a comment, up to CR, LF or the end
                while cur.read1() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError(f"{path}: Netpbm header ends early (PIL refuses it too: Reached EOF while reading header)")
        if len(tok) > 10:
            raise ValueError(f"{path}: Netpbm header token {tok!r} longer than 10 bytes (PIL refuses it too)")
        return tok

    w, h = _number(token(), int, path), _number(token(), int, path)
    lay = dict(format="Netpbm", size=(h, w), mode=mode, maxval=255, decoder="plain" if magic in (b"P1", b"P2", b"P3")
               else "raw", rawmode=mode)
    if mode == "1":
        lay["rawmode"] = "1;I"
    elif mode == "F":
        scale = _number(token(), float, path)
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{path}: PFM scale {scale} is not finite and non-zero (PIL refuses it too)")
        lay["rawmode"] = "F;32F" if scale < 0 else "F;32BF"
    else:
        maxval = _number(token(), int, path)
        if not 0 < maxval < 65536:
            raise ValueError(f"{path}: Netpbm maxval {maxval} is not in 1..65535 (PIL refuses it too)")
        if maxval > 255 and mode == "L":
            lay["mode"] = "I"
        if lay["decoder"] == "raw":
            if maxval == 65535 and mode == "L":
                lay["rawmode"] = "I;16B"
            elif maxval != 255:
                lay["decoder"] = "scaled"
        lay["maxval"] = maxval
    lay["offset"] = cur.pos
    return opened(lay, path)


def ppm_decode(src: Source, lay: dict, path: str) -> np.ndarray:
    data = src.all()
    (h, w), mode, off = lay["size"], lay["mode"], lay["offset"]
    bands = _BANDS[mode]
    if lay["decoder"] == "plain":
        px = _ppm_plain(data[off:], w, h, mode, lay["maxval"], path)
    elif lay["decoder"] == "scaled":  # PpmDecoder: whole pixels of 1- or 2-byte samples, rescaled
        wide = lay["maxval"] > 255
        n = w * h * bands
        body = data[off:off + n * (2 if wide else 1)]
        if len(body) < n * (2 if wide else 1):
            raise ValueError(f"{path}: truncated Netpbm pixel data (PIL refuses it too: not enough image data)")
        v = np.frombuffer(body, ">u2" if wide else np.uint8).astype(np.float64)
        out_max = 65535 if mode == "I" else 255
        px = np.minimum(out_max, np.rint(v / lay["maxval"] * out_max)).astype(np.int64)
        px = px.reshape(h, w, bands) if mode == "I" else px.astype(np.uint8).reshape(h, w, bands)
    else:
        raw = lay["rawmode"]
        if raw == "1;I":
            rows = _rows(data, off, h, (w + 7) // 8, "Netpbm", path)
            px = ((1 - _bits(rows, w)) * np.uint8(255))[..., None]
        elif raw == "I;16B":
            px = _rows(data, off, h, 2 * w, "Netpbm", path).view(">u2")[..., None]
        elif raw.startswith("F;"):  # bottom-up rows of 32-bit floats, the byte order from the scale's sign
            px = _rows(data, off, h, 4 * w, "PFM", path).view("<f4" if raw == "F;32F" else ">f4")[::-1, :, None]
        else:
            px = _rows(data, off, h, w * bands, "Netpbm", path).reshape(h, w, bands)
    return mode_rgb(mode, px)


def _ppm_comments(block: bytes, spans: bool, read) -> tuple:
    """PpmPlainDecoder._ignore_comments: (the block without its comments,
    whether the last comment runs on into the next block)."""
    def comment_end(b, start=0):
        a, c = b.find(b"\n", start), b.find(b"\r", start)
        return min(a, c) if a * c > 0 else max(a, c)

    if spans:
        while block:
            end = comment_end(block)
            if end != -1:
                block = block[end + 1:]
                break
            block = read()
    spans = False
    while True:
        start = block.find(b"#")
        if start == -1:
            break
        end = comment_end(block, start)
        if end != -1:
            block = block[:start] + block[end + 1:]
        else:
            block = block[:start]
            spans = True
            break
    return block, spans


def _ppm_plain(body: bytes, w: int, h: int, mode: str, maxval: int, path: str) -> np.ndarray:
    """PpmPlainDecoder over body, read in SAFEBLOCK blocks as Pillow reads it."""
    pos = [0]

    def read() -> bytes:
        b = body[pos[0]:pos[0] + SAFEBLOCK]
        pos[0] += len(b)
        return b

    bands = _BANDS[mode]
    total = w * h * bands
    spans = False
    if mode == "1":  # one character a pixel, whitespace optional
        data = b""
        while len(data) != total:
            block = read()
            if not block:
                break
            block, spans = _ppm_comments(block, spans, read)
            tokens = b"".join(block.split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise ValueError(f"{path}: plain PBM token {bad[:1]!r} is not 0 or 1 (PIL refuses it too)")
            data = (data + tokens)[:total]
        if len(data) < total:
            raise ValueError(f"{path}: truncated plain PBM data (PIL refuses it too: not enough image data)")
        return np.frombuffer(data.translate(bytes.maketrans(b"01", b"\xff\x00")), np.uint8).reshape(h, w, 1)
    out_max = 65535 if mode == "I" else 255
    vals, half = [], b""
    while len(vals) != total:
        block = read()
        if not block:
            if not half:
                break
            block = b" "  # flush the last token
        block, spans = _ppm_comments(block, spans, read)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():  # the block may cut a token
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"{path}: plain Netpbm token {half[:11]!r} longer than 10 bytes (PIL refuses it too)")
        for tok in tokens[:total - len(vals)]:
            if len(tok) > 10:
                raise ValueError(f"{path}: plain Netpbm token {tok[:11]!r} longer than 10 bytes (PIL refuses it too)")
            v = _number(tok, int, path)
            if v < 0 or v > maxval:
                raise ValueError(f"{path}: plain Netpbm sample {v} outside 0..{maxval} (PIL refuses it too)")
            vals.append(v)
    if len(vals) < total:
        raise ValueError(f"{path}: truncated plain Netpbm data (PIL refuses it too: not enough image data)")
    px = np.rint(np.asarray(vals, np.float64) / maxval * out_max).astype(np.int64).reshape(h, w, bands)
    return px if mode == "I" else px.astype(np.uint8)


# ---------------------------------------------------------------------------
# DIB: a BMP without its file header (DibImageFile); the bitmaps of ICO and
# CUR files
# ---------------------------------------------------------------------------

def dib_accept(head: bytes) -> bool:
    return len(head) >= 4 and struct.unpack_from("<I", head)[0] in nc._BMP_HEADERS


def dib_open(src: Source, path: str) -> dict:
    hdr = nc._bmp_header(src.read, path, at=0)
    return opened(dict(hdr, format="DIB", size=(hdr["height"], hdr["width"])), path)


def dib_decode(src: Source, lay: dict, path: str) -> np.ndarray:
    """A DIB's pixels; an ICO or CUR bitmap's top half (its layout's height
    halved, as Pillow cuts the tile)."""
    return nc._bmp_pixels(src.all(), lay, path)


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------

def ico_accept(head: bytes) -> bool:
    return head[:4] == b"\x00\x00\x01\x00"


def cur_accept(head: bytes) -> bool:
    return head[:4] == b"\x00\x00\x02\x00"


def _ico_entry(src: Source) -> dict:
    """IcoFile: the directory sorted as Pillow sorts it (colour depth up,
    then area down, both stable); the first entry is the one it loads."""
    n = _u16(src.read(0, 6), 4)
    entries = []
    for i in range(n):
        s = src.read(6 + 16 * i, 16)
        width, height = _byte(s, 0) or 256, _byte(s, 1) or 256
        nb_color, bpp = s[2], _u16(s, 6)
        entries.append(dict(dim=(width, height), bpp=bpp, size=_u32(s, 8), offset=_u32(s, 12), square=width * height,
                            depth=bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    if not entries:
        raise Reject("an ICO file without entries")  # IndexError in Pillow
    return entries[0]


def ico_open(src: Source, path: str) -> dict:
    """IcoImageFile._open, which loads the image: the entry's PNG, or its
    DIB (the top half of its doubled height) with the AND mask or the alpha
    bytes Pillow reads beside it. The size is the entry's own."""
    e = _ico_entry(src)
    if src.read(e["offset"], 8) == nc.PNG_MAGIC:
        w, h = _png_size(src, e["offset"], path)
        return opened(dict(format="ICO", png=True, size=(h, w), entry=e), path)
    hdr = nc._bmp_header(src.read, path, at=e["offset"])
    opened(dict(format="ICO", size=(hdr["height"], hdr["width"])), path)
    h2 = int(hdr["height"] / 2)
    w = hdr["width"]
    if e["bpp"] == 32:  # the alpha bytes of a 32-bit entry: every 4th of w*h*4 from the pixels
        got = len(src.read(hdr["offset"], w * h2 * 4))
        if -(-got // 4) < w * h2:
            raise ValueError(f"{path}: truncated ICO alpha data (PIL refuses it too: buffer is not large enough)")
    else:  # the AND mask, read back from the end of the entry
        wpad = -(-w // 32) * 32
        total = wpad * h2 // 8
        at = e["offset"] + e["size"] - total
        if at < 0:
            raise ValueError(f"{path}: ICO entry whose AND mask starts before the file (PIL refuses it too: negative "
                             "seek)")
        got = len(src.read(at, total))
        if h2 and got < wpad // 8 * (h2 - 1) + -(-w // 8):
            raise ValueError(f"{path}: truncated ICO AND mask (PIL refuses it too: not enough image data)")
    return opened(dict(hdr, format="ICO", png=False, size=(h2, w), height=h2, entry=e), path)


def ico_decode(src: Source, lay: dict, path: str) -> np.ndarray:
    if lay["png"]:
        return nc._decode_png(src.all()[lay["entry"]["offset"]:], path)
    return dib_decode(src, lay, path)


def _png_size(src: Source, at: int, path: str) -> tuple:
    head = src.read(at, 24)
    if head[12:16] != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR")
    return struct.unpack(">II", head[16:24])


def cur_open(src: Source, path: str) -> dict:
    """CurImageFile._open: the entry wider and taller than every one before
    it, its DIB read as a BMP's (no AND mask) at half its height."""
    n = _u16(src.read(0, 6), 4)
    m, pos = b"", 6
    for i in range(n):
        s = src.read(6 + 16 * i, 16)
        pos += len(s)
        if not m:
            m = s
        elif _byte(s, 0) > m[0] and _byte(s, 1) > m[1]:
            m = s
    if not m:
        raise Reject("a CUR file without cursors")  # TypeError in Pillow
    at = _u32(m, 12)
    hdr = nc._bmp_header(src.read, path, at=at or pos)  # _bitmap(header=0) reads where the directory ends
    h2 = hdr["height"] // 2
    return opened(dict(hdr, format="CUR", size=(h2, hdr["width"]), height=h2), path)


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------

def qoi_accept(head: bytes) -> bool:
    return head[:4] == b"qoif"


def qoi_open(src: Source, path: str) -> dict:
    s = src.read(0, 14)
    w, h = _u32(s, 4, ">"), _u32(s, 8, ">")
    channels = _byte(s, 12)
    return opened(dict(format="QOI", size=(h, w), bands=3 if channels == 3 else 4), path)


def qoi_decode(src: Source, lay: dict, path: str) -> np.ndarray:
    body = src.all()[14:]
    (h, w), bands = lay["size"], lay["bands"]
    out = np.empty((h, w, bands), np.uint8)
    if nc._load().sfod_qoi(body, len(body), w * h, bands, out.ctypes.data_as(nc._U8P)) != 0:
        raise ValueError(f"{path}: the QOI data ends before the image does (PIL refuses it too)")
    return np.ascontiguousarray(out[..., :3])


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B", (1, 3, 3): "RGB",
             (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def sgi_accept(head: bytes) -> bool:
    return len(head) >= 2 and head[0] == 1 and head[1] == 0xDA


def sgi_open(src: Source, path: str) -> dict:
    s = src.read(0, 512)
    compression, bpc = _byte(s, 2), _byte(s, 3)
    dimension, w, h, z = (_u16(s, at, ">") for at in (4, 6, 8, 10))
    raw = SGI_MODES.get((bpc, dimension, z))
    if raw is None:
        raise ValueError(f"{path}: SGI image of {bpc} bytes a sample, dimension {dimension}, {z} channels is not "
                         "supported (PIL refuses it too: unsupported SGI image mode)")
    return opened(dict(format="SGI", size=(h, w), mode=raw.split(";")[0], bpc=bpc, compression=compression), path)


def sgi_decode(src: Source, lay: dict, path: str) -> np.ndarray:
    data = src.all()
    (h, w), mode, bpc = lay["size"], lay["mode"], lay["bpc"]
    bands = len(mode)
    if lay["compression"] == 0:  # planes of bottom-up rows; 16-bit samples keep their high byte
        page = w * h * bpc
        planes = []
        for k in range(bands):
            body = data[512 + k * page:512 + (k + 1) * page]
            if len(body) < page:
                raise _truncated("SGI", path)
            planes.append(np.frombuffer(body, np.uint8)[::bpc].reshape(h, w))
        px = np.stack(planes, axis=2)
    elif lay["compression"] == 1:
        body = data[512:]
        rows = np.zeros((h, w * bands * bpc), np.uint8)
        rc = nc._load().sfod_sgi_rle(body, len(body), w, h, bands, bpc, rows.ctypes.data_as(nc._U8P))
        if rc < 0:
            raise ValueError(f"{path}: SGI RLE data runs past its row or the file (PIL refuses it too: buffer overrun)")
        px = rows.reshape(h, w, bands, bpc)[..., 0]
    else:
        raise ValueError(f"{path}: SGI compression {lay['compression']} is not supported (PIL refuses it too: cannot "
                         "load this image)")
    return mode_rgb(mode, px[::-1])


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------

DCX_MAGIC = 987654321


def pcx_accept(head: bytes) -> bool:
    return len(head) >= 2 and head[0] == 10 and head[1] in (0, 2, 3, 5)


def dcx_accept(head: bytes) -> bool:
    return len(head) >= 4 and struct.unpack_from("<I", head)[0] == DCX_MAGIC


def pcx_open(src: Source, path: str, base: int = 0, fmt: str = "PCX") -> dict:
    """PcxImageFile._open at `base`."""
    s = src.read(base, 68)
    if not pcx_accept(s):
        raise Reject("not a PCX file")
    x0, y0, x1, y1 = (_u16(s, at) for at in (4, 6, 8, 10))
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise Reject("bad PCX image size")
    version, bits, planes, given = s[1], _byte(s, 3), _byte(s, 65), _u16(s, 66)
    lay = dict(format=fmt, offset=base + len(s) + 60, bits=bits, planes=planes, palette=None)
    if bits == 1 and planes == 1:
        lay.update(mode="1", raw="1")
    elif bits == 1 and planes in (2, 4):
        lay.update(mode="P", raw=f"P;{planes}L", palette=np.frombuffer(s[16:64], np.uint8).reshape(16, 3))
    elif version == 5 and bits == 8 and planes == 1:
        lay.update(mode="L", raw="L")
        if src.length < 769 and src.on_disk:
            raise ValueError(f"{path}: 8-bit {fmt} file shorter than the 769 bytes of its palette (PIL refuses it "
                             "too: it seeks before the start of the file)")
        p = src.read(max(0, src.length - 769), 769)
        if len(p) == 769 and p[0] == 12:
            table = np.frombuffer(p[1:], np.uint8).reshape(256, 3)
            if not np.array_equal(table, np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)):
                lay.update(mode="P", raw="P", palette=table)
    elif version == 5 and bits == 8 and planes == 3:
        lay.update(mode="RGB", raw="RGB;L")
    else:
        raise ValueError(f"{path}: {fmt} of {bits} bits x {planes} planes (version {version}) is not supported (PIL "
                         "refuses it too: unknown PCX mode)")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if given != stride:  # the header's bytes a line is not trusted: only made even
        stride += stride % 2
    lay.update(size=(h, w), line=planes * stride)
    return opened(lay, path)


def dcx_open(src: Source, path: str) -> dict:
    """DcxImageFile._open: the component directory, then the first page."""
    offsets = []
    for i in range(1024):
        off = _u32(src.read(4 + 4 * i, 4))
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise Reject("a DCX file without pages")  # EOFError in Pillow
    return pcx_open(src, path, offsets[0], "DCX")


def pcx_decode(src: Source, lay: dict, path: str) -> np.ndarray:
    data = src.all()
    (h, w), line, raw = lay["size"], lay["line"], lay["raw"]
    body = data[lay["offset"]:]
    buf = np.zeros((h, line), np.uint8)
    got = nc._load().sfod_pcx_rle(body, len(body), line, h, buf.ctypes.data_as(nc._U8P))
    if got < 0:
        raise ValueError(f"{path}: {lay['format']} run past the end of its line (PIL refuses it too: buffer overrun)")
    if got < h:
        raise _truncated(lay["format"], path)
    # PcxDecode.c moves the planes of a padded line together, `xs` bytes
    # apart: the bit planes (raw modes of 2 or 4 bits) by ceil(w / 8), the
    # rest by w with as many planes as w divides the line into
    if raw.startswith("P;"):
        xs, bands = (w + 7) // 8, lay["planes"]
    else:
        xs, bands = w, line // w
    stride = line // bands if bands else 0
    if stride > xs:
        for i in range(1, bands):
            buf[:, i * xs:(i + 1) * xs] = buf[:, i * stride:i * stride + xs].copy()
    if raw == "1":
        px = (_bits(buf, w) * np.uint8(255))[..., None]
    elif raw.startswith("P;"):  # bit planes ceil(w / 8) bytes apart: plane k gives bit k
        planes, s = int(raw[2]), (w + 7) // 8
        idx = sum(_bits(buf[:, k * s:(k + 1) * s], w) << k for k in range(planes))
        px = idx.astype(np.uint8)[..., None]
    elif raw == "RGB;L":
        px = np.stack([buf[:, :w], buf[:, w:2 * w], buf[:, 2 * w:3 * w]], axis=2)
    else:
        px = buf[:, :w, None]
    return mode_rgb(lay["mode"], px, lay["palette"])


# ---------------------------------------------------------------------------
# TGA (no signature: Image.open reaches it when every plugin before it has
# refused the file)
# ---------------------------------------------------------------------------

TGA_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
                (2, 32): "BGRA"}
_TGA_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}
_TGA_PALETTE = {16: (2, "BGRA;15Z"), 24: (3, "BGR"), 32: (4, "BGRA")}


def tga_open(src: Source, path: str) -> dict:
    s = src.read(0, 18)
    id_len, cmap, itype, depth, flags = _byte(s, 0), _byte(s, 1), _byte(s, 2), _byte(s, 16), _byte(s, 17)
    w, h = _u16(s, 12), _u16(s, 14)
    if cmap not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise Reject("not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise Reject("unknown TGA mode")
    pos = 18 + len(src.read(18, id_len))
    palette, mapdepth = None, 0
    if cmap:
        start, count, mapdepth = _u16(s, 3), _u16(s, 5), s[7]
        if mapdepth not in _TGA_PALETTE:
            raise Reject("unknown TGA map depth")
        k, pal_raw = _TGA_PALETTE[mapdepth]
        entries = src.read(pos, k * count)
        pos += len(entries)
        table = bytes(k * start) + entries
        palette = _tga_unpack(np.frombuffer(table[:len(table) // k * k], np.uint8).reshape(1, -1), pal_raw)[0]
    return opened(dict(format="TGA", size=(h, w), mode=mode, raw=TGA_RAWMODES.get((itype & 7, depth)),
                       rle=bool(itype & 8),
                       depth=depth, top_down=bool(flags & 0x20), mirror=bool(flags & 0x10), offset=pos,
                       palette=palette, map_bits=mapdepth), path)


def _tga_unpack(rows: np.ndarray, raw: str, w: int = None) -> np.ndarray:
    """Pillow's unpacker of a TGA raw mode over rows [h, bytes] -> [h, w, bands]."""
    if raw == "1":
        return (_bits(rows, w) * np.uint8(255))[..., None]
    if raw in ("P", "L"):
        return rows[..., None]
    if raw == "LA":
        return rows.reshape(rows.shape[0], -1, 2)
    if raw == "BGRA;15Z":
        p = rows.view("<u2").astype(np.uint32)
        return np.stack([((p >> 10) & 31) * 255 // 31, ((p >> 5) & 31) * 255 // 31, (p & 31) * 255 // 31],
                        axis=-1).astype(np.uint8)
    k = 3 if raw == "BGR" else 4
    return rows.reshape(rows.shape[0], -1, k)[..., 2::-1]


def tga_decode(src: Source, lay: dict, path: str) -> np.ndarray:
    data = src.all()
    (h, w), raw = lay["size"], lay["raw"]
    if raw is None:
        raise ValueError(f"{path}: TGA of {lay['depth']} bits in mode {lay['mode']} is not supported (PIL refuses it "
                         "too: cannot load this image)")
    if lay["mode"] == "L" and raw == "P":
        raise ValueError(f"{path}: colour-mapped TGA without a colour map is not supported (PIL refuses it too: "
                         "unknown raw mode)")
    if lay["palette"] is not None and lay["mode"] not in ("P", "L", "LA"):
        raise ValueError(f"{path}: TGA colour map beside {lay['mode']} pixels is not supported (PIL refuses it too: "
                         "unrecognized image mode)")
    if lay["map_bits"] == 32:
        raise ValueError(f"{path}: TGA 32-bit colour map is not supported (PIL refuses it too: unrecognized raw mode)")
    if lay["rle"] and lay["depth"] < 8:
        raise ValueError(f"{path}: RLE TGA at 1 bit is not supported (PIL refuses it too: its decoder takes a pixel "
                         "of 1 bit for 0 bytes)")
    if lay["palette"] is not None and len(lay["palette"]) > 256:
        raise ValueError(f"{path}: TGA colour map of {len(lay['palette'])} entries (PIL refuses it too: invalid "
                         "palette size)")
    line = (w * _TGA_BITS[raw] + 7) // 8
    if lay["rle"]:
        body = data[lay["offset"]:]
        rows = np.zeros((h, line), np.uint8)
        got = nc._load().sfod_tga_rle(body, len(body), lay["depth"] // 8, line, h, rows.ctypes.data_as(nc._U8P))
        if got < 0:
            raise ValueError(f"{path}: TGA run past the end of its line (PIL refuses it too: buffer overrun)")
        if got < h:
            raise _truncated("TGA", path)
    else:
        rows = _rows(data, lay["offset"], h, line, "TGA", path)
    px = _tga_unpack(rows, raw, w)
    if not lay["top_down"]:
        px = px[::-1]
    if lay["mirror"]:
        px = px[:, ::-1]
    if lay["palette"] is not None and lay["mode"] in ("L", "LA"):  # Pillow's L image with a palette converts through it
        return nc._palette_rgb(px[..., 0], lay["palette"])
    return mode_rgb(lay["mode"], px, lay["palette"])


# ---------------------------------------------------------------------------
# the plugins of this module in Image.ID order, each (name, accept, open,
# decode); tga has no signature
# ---------------------------------------------------------------------------

PLUGINS = {
    "DIB": (dib_accept, dib_open, dib_decode),
    "PPM": (ppm_accept, ppm_open, ppm_decode),
    "CUR": (cur_accept, cur_open, dib_decode),
    "PCX": (pcx_accept, pcx_open, pcx_decode),
    "DCX": (dcx_accept, dcx_open, pcx_decode),
    "ICO": (ico_accept, ico_open, ico_decode),
    "QOI": (qoi_accept, qoi_open, qoi_decode),
    "SGI": (sgi_accept, sgi_open, sgi_decode),
    "TGA": (None, tga_open, tga_decode),
}
