"""Writers of the raster files that Pillow 12.1 cannot write, or cannot
write in every variant its readers take: Netpbm with comments, plain
samples, maxvals other than 255 and Pillow's own PyP/PyRGBA/PyCMYK/P0CMYK
heads; PFM in both byte orders; DIB bitmaps of ICO and CUR entries with
their AND masks, and the ICO and CUR directories around them; SGI raw and
RLE at 8 and 16 bits; PCX of every depth and plane count with header and
trailing palettes, a window and a bytes-a-line field of its own; DCX; TGA
of every image type, depth, colour map, attribute bits and orientation,
raw or run-length coded. Each writes what the format's specification
lays out; the tests hold the port to Pillow's reading of the bytes."""

from __future__ import annotations

import struct

import numpy as np


# ---------------------------------------------------------------------------
# Netpbm
# ---------------------------------------------------------------------------

def netpbm(samples: np.ndarray, magic: bytes, maxval: int = 255, plain: bool = False, comments=(),
           dense_bits: bool = False) -> bytes:
    """samples [h, w, bands] (for P1/P4 1 is black) under `magic`; plain
    writes decimal tokens, raw writes bytes (2 a sample, big-endian, above
    maxval 255; P4 packs 8 pixels a byte). Each comment goes on a line of
    its own after the magic."""
    h, w = samples.shape[:2]
    head = magic + b"\n" + b"".join(b"#" + c + b"\n" for c in comments) + b"%d %d\n" % (w, h)
    bitmap = magic in (b"P1", b"P4")
    if not bitmap:
        head += b"%d\n" % maxval
    s = np.asarray(samples, np.int64).reshape(h, w, -1)
    if plain:
        if bitmap and dense_bits:
            return head + b"\n".join(b"".join(b"%d" % v for v in row.reshape(-1)) for row in s)
        return head + b"\n".join(b" ".join(b"%d" % v for v in row.reshape(-1)) for row in s) + b"\n"
    if bitmap:
        return head + np.packbits(s[..., 0].astype(np.uint8), axis=1).tobytes()
    return head + s.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm(values: np.ndarray, scale: float) -> bytes:
    """A grey PFM ("Pf") of float32 values [h, w]: rows bottom-up,
    little-endian where the scale is negative."""
    h, w = values.shape
    rows = np.asarray(values, "<f4" if scale < 0 else ">f4")[::-1]
    return b"Pf\n%d %d\n%s\n" % (w, h, repr(float(scale)).encode()) + rows.tobytes()


# ---------------------------------------------------------------------------
# DIB, ICO and CUR
# ---------------------------------------------------------------------------

def dib(img: np.ndarray, bits: int, palette=None, and_mask: np.ndarray = None, doubled: bool = True,
        header: int = 40) -> bytes:
    """A bottom-up BITMAPINFOHEADER bitmap (no file header) of img: indices
    [h, w] for 1, 4 and 8 bits with palette [n, 3] RGB, RGB [h, w, 3] for 24
    bits, RGBA for 32. For an ICO or CUR entry (doubled) the height field is
    twice the image's and the AND mask (1 = transparent) follows the
    pixels, rows padded to 32 bits."""
    h, w = img.shape[:2]
    if bits <= 8:
        idx = np.asarray(img, np.uint8)
        rows = np.packbits(np.unpackbits(idx[..., None], axis=2)[..., 8 - bits:].reshape(h, -1), axis=1)
    elif bits == 24:
        rows = np.asarray(img, np.uint8)[..., ::-1].reshape(h, -1)
    else:
        rows = np.asarray(img, np.uint8)[..., [2, 1, 0, 3]].reshape(h, -1)
    stride = (w * bits + 31) // 32 * 4
    pix = np.zeros((h, stride), np.uint8)
    pix[:, :rows.shape[1]] = rows
    body = pix[::-1].tobytes()
    if doubled:
        mask = np.zeros((h, w), np.uint8) if and_mask is None else np.asarray(and_mask, np.uint8)
        mrows = np.zeros((h, (w + 31) // 32 * 4), np.uint8)
        packed = np.packbits(mask, axis=1)
        mrows[:, :packed.shape[1]] = packed
        body += mrows[::-1].tobytes()
    pal = b""
    if bits <= 8:
        p = np.zeros((1 << bits, 4), np.uint8)
        given = np.asarray(palette, np.uint8)[:1 << bits]
        p[:len(given), :3] = given[:, ::-1]
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h * (2 if doubled else 1), 1, bits)
        pal = b"".join(pal[i:i + 3] for i in range(0, len(pal), 4))
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, h * (2 if doubled else 1), 1, bits, 0, len(body), 0, 0, 0, 0)
    return info + pal + body


def icon_dir(kind: int, entries) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) file of entries (width byte, height
    byte, colours, planes or hotspot x, bpp or hotspot y, payload), the
    payloads after the directory in order; (..., payload, offset) pins an
    entry's offset and (..., payload, offset, size) its size field."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    at = 6 + 16 * len(entries)
    blobs = b""
    for e in entries:
        w, h, colors, a, b, payload = e[:6]
        off = e[6] if len(e) > 6 else at + len(blobs)
        size = e[7] if len(e) > 7 else len(payload)
        out += struct.pack("<BBBBHHII", w & 255, h & 255, colors, 0, a, b, size, off)
        blobs += payload
    return out + blobs


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------

def qoi(w: int, h: int, channels: int, ops: bytes, end: bool = True) -> bytes:
    """A QOI header and raw ops (with the 8-byte end marker when end)."""
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops + (bytes(7) + b"\x01" if end else b"")


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

def _sgi_rle_row(row: np.ndarray, bpc: int, terminate: bool = True) -> bytes:
    """One channel's row: runs of equal samples, literals otherwise (at
    most 127 a chunk), a zero chunk at the end."""
    out, i, n = [], 0, len(row)
    atom = (lambda v: bytes([int(v)])) if bpc == 1 else (lambda v: struct.pack(">H", int(v)))
    while i < n:
        j = i
        while j < n and j - i < 127 and row[j] == row[i]:
            j += 1
        if j - i >= 3 or j == n:
            out.append(atom(j - i) + atom(row[i]))
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        out.append(atom(0x80 | (j - i)) + b"".join(atom(v) for v in row[i:j]))
        i = j
    if terminate:
        out.append(atom(0))
    return b"".join(out)


def sgi(planes: np.ndarray, bpc: int = 1, rle: bool = False, dimension: int = None, terminate: bool = True,
        lengths=None, compression: int = None) -> bytes:
    """An SGI file of planes [h, w, z] (top row first; the file stores rows
    bottom-up), raw or RLE with its offset and length tables."""
    h, w, z = planes.shape
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHH", 474, compression if compression is not None else int(rle), bpc, dim, w, h, z)
    head += struct.pack(">ii", 0, (1 << (8 * bpc)) - 1) + bytes(4) + b"test".ljust(80, b"\x00") + struct.pack(">i", 0)
    head = head.ljust(512, b"\x00")
    up = np.asarray(planes, np.int64)[::-1]
    if not rle:
        dt = np.uint8 if bpc == 1 else ">u2"
        return head + b"".join(up[..., c].astype(dt).tobytes() for c in range(z))
    rows = [[_sgi_rle_row(up[y, :, c], bpc, terminate) for y in range(h)] for c in range(z)]
    tab = 512 + 8 * h * z
    starts, lens, data = [], [], b""
    for c in range(z):
        for y in range(h):
            starts.append(tab + len(data))
            lens.append(len(rows[c][y]))
            data += rows[c][y]
    if lengths is not None:
        lens = [lengths(v) for v in lens]
    return head + struct.pack(">%dI" % (h * z), *starts) + struct.pack(">%dI" % (h * z), *lens) + data


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------

def pcx_rle(line: bytes) -> bytes:
    """PCX run-length coding of one line: runs of up to 63; a lone byte of
    0xC0 or above is written as a run of one."""
    out, i, n = bytearray(), 0, len(line)
    while i < n:
        j = i
        while j < n and j - i < 63 and line[j] == line[i]:
            j += 1
        if j - i > 1 or line[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), line[i]])
        else:
            out.append(line[i])
        i = j
    return bytes(out)


def pcx(lines: np.ndarray, width: int, height: int, bits: int, planes: int, version: int = 5, window=(0, 0),
        bytes_per_line: int = None, palette16=None, palette256=None, rle: bool = True) -> bytes:
    """A PCX of encoded lines [height, planes * bytes_per_line] (the planes
    of a line one after another), its window at `window`, 16 header
    palette entries and a trailing 0x0C + 256-entry palette if given."""
    x0, y0 = window
    bpl = bytes_per_line if bytes_per_line is not None else lines.shape[1] // planes
    head = bytearray(128)
    head[0:4] = bytes([10, version, 1 if rle else 0, bits])
    struct.pack_into("<HHHHHH", head, 4, x0, y0, x0 + width - 1, y0 + height - 1, 72, 72)
    if palette16 is not None:
        head[16:64] = np.asarray(palette16, np.uint8).reshape(-1)[:48].tobytes().ljust(48, b"\x00")
    head[65] = planes
    struct.pack_into("<HH", head, 66, bpl, 1)
    body = b"".join(pcx_rle(row.tobytes()) if rle else row.tobytes() for row in np.asarray(lines, np.uint8))
    tail = b"\x0c" + np.asarray(palette256, np.uint8).tobytes() if palette256 is not None else b""
    return bytes(head) + body + tail


def pcx_lines(img: np.ndarray, bits: int, planes: int, stride: int) -> np.ndarray:
    """The lines of indices [h, w] at 1 bit x planes (bit k in plane k) or
    8 bits x 1 plane, or of RGB [h, w, 3] at 8 bits x 3 planes, each plane
    padded to stride bytes."""
    h = img.shape[0]
    out = np.zeros((h, planes * stride), np.uint8)
    for k in range(planes):
        if bits == 1:
            plane = np.packbits(((np.asarray(img) >> k) & 1).astype(np.uint8), axis=1)
        else:
            plane = np.asarray(img, np.uint8)[..., k] if planes == 3 else np.asarray(img, np.uint8)
        out[:, k * stride:k * stride + plane.shape[1]] = plane
    return out


def dcx(pages) -> bytes:
    """A DCX file of PCX pages: the magic, the page offsets, a zero."""
    at = 4 + 4 * (len(pages) + 1)
    offs = []
    for p in pages:
        offs.append(at)
        at += len(p)
    return struct.pack("<I", 987654321) + struct.pack("<%dI" % (len(pages) + 1), *offs, 0) + b"".join(pages)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

def tga_rle(pixels: bytes, depth: int, line: int = None) -> bytes:
    """TGA run-length packets of depth-byte pixels: runs of 2 to 128 equal
    pixels, literals of up to 128; packets stop at line ends when `line`
    (bytes) is given, else run across them (literals only may)."""
    out = bytearray()
    px = [pixels[i:i + depth] for i in range(0, len(pixels), depth)]
    per_line = line // depth if line else len(px)
    for start in range(0, len(px), per_line):
        seg = px[start:start + per_line]
        i = 0
        while i < len(seg):
            j = i
            while j < len(seg) and j - i < 128 and seg[j] == seg[i]:
                j += 1
            if j - i >= 2:
                out += bytes([0x80 | (j - i - 1)]) + seg[i]
                i = j
                continue
            j = i + 1
            while j < len(seg) and j - i < 128 and not (j + 1 < len(seg) and seg[j] == seg[j + 1]):
                j += 1
            out += bytes([j - i - 1]) + b"".join(seg[i:j])
            i = j
    return bytes(out)


def tga(pixels: bytes, width: int, height: int, itype: int, depth: int, cmap=None, image_id: bytes = b"",
        flags: int = 0, rle_lines: bool = True, body: bytes = None) -> bytes:
    """A TGA of stored pixel bytes (rows in the order the flags say), type
    itype (9-11 coded with tga_rle), cmap (first index, entries bytes,
    entry bits), an image ID, descriptor flags (attribute bits 0-3,
    orientation bits 4-5); `body` replaces the coded pixels."""
    first, entries, bits = cmap if cmap else (0, b"", 0)
    count = len(entries) // max(1, (bits + 7) // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), 1 if cmap else 0, itype, first, count, bits, 0, 0, width,
                       height, depth, flags)
    if body is None:
        k = (depth + 7) // 8
        line = (width * depth + 7) // 8 if rle_lines else None
        body = tga_rle(pixels, k, line) if itype & 8 else pixels
    return head + image_id + entries + body
