"""Writers of the TIFF files that tests/test_torch_tiff.py holds the port's
decoder to Pillow with, for what Pillow's and libtiff's own writers cannot
make: any IFD in either byte order or as BigTIFF (`container`), samples at
1 to 32 bits, signed or float, with predictors 2 and 3 and FillOrder 2
(`tiff`), YCbCr data units at every subsampling with its coefficient and
reference tags (`ycbcr_tiff`), and JPEG-compressed TIFF from Pillow's JPEG
streams split into a shared JPEGTables segment and abbreviated strips or
tiles (`jpeg_tiff`), and the codings of tests/test_torch_tiff_codecs.py
that no writer at hand makes: old-style LSB-first LZW (`lzw_compat`),
ThunderScan (`thunderscan`), old-style JPEG TIFF from Pillow's JPEG
streams (`ojpeg_tiff`) and zstd frames of raw and RLE blocks, skippable
frames and XXH64 checksums (`zstd_frame`). `littlecms_lab_clut` reads the table of Pillow's
Lab -> sRGB transform out of the LittleCMS library Pillow bundles; it
writes simple_sfod_tpu_torch/data/lab_srgb_clut.bin:

    python -c "import sys; sys.path.insert(0, 'tests'); import torch_tiff_coders as t; t.write_lab_clut()"
"""

import ctypes
import glob
import io
import lzma
import os
import struct
import zlib

import numpy as np
from PIL import Image

# struct codes of the field types written (RATIONAL as two LONGs)
_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q"}
BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def container(chunks, tags: dict, order="<", big=False, tiled=False) -> bytes:
    """A TIFF (BigTIFF when big) holding the strip or tile payloads
    `chunks` in order, with the IFD `tags` {tag: (type, values)} (RATIONAL
    values as flat numerator, denominator pairs); the offsets and byte
    counts are filled in. Layout: header, payloads, IFD, out-of-line
    values."""
    head = 16 if big else 8
    body = bytearray(head)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + bytes(len(c) % 2)
    entries = dict(tags)
    offs_tag, counts_tag = (324, 325) if tiled else (273, 279)
    wide = 16 if big else 4
    entries[offs_tag] = (wide, offsets)
    entries[counts_tag] = (wide, [len(c) for c in chunks])
    ifd_at = len(body)
    n = len(entries)
    entry, inline = (20, 8) if big else (12, 4)
    value_at = ifd_at + (8 if big else 2) + entry * n + (8 if big else 4)
    ifd, values = bytearray(struct.pack(order + ("Q" if big else "H"), n)), bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        code = _CODES[typ]
        blob = struct.pack(order + code * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        ifd += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, count)
        if len(blob) <= inline:
            ifd += blob + bytes(inline - len(blob))
        else:
            ifd += struct.pack(order + ("Q" if big else "I"), value_at + len(values))
            values += blob + bytes(len(blob) % 2)
    if big:
        body[:16] = (b"II+\x00" if order == "<" else b"MM\x00+") + struct.pack(order + "HHQ", 8, 0, ifd_at)
    else:
        body[:8] = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd_at)
    return bytes(body + ifd + struct.pack(order + ("Q" if big else "I"), 0) + values)


def pack_rows(c: np.ndarray, bits: int, order: str, sample_format: int = 1) -> bytes:
    """Samples [rows, w, per] as the file stores them: packed high bits first
    below 8 bits and at 12, else whole words in `order`."""
    rows = c.shape[0]
    if sample_format == 3:
        return c.astype(order + "f4").tobytes()
    if bits in (8, 16, 32):
        return (c.astype(np.int64) % (1 << bits)).astype(order + f"u{bits // 8}").tobytes()  # two's complement
    b = ((c[..., 0, None].astype(np.int64) >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8).reshape(rows, -1)
    return np.packbits(b, axis=1).tobytes()


def float_predict(row_bytes: np.ndarray, n: int) -> np.ndarray:
    """libtiff's fpDiff over rows of n float32 samples (native bytes): the
    bytes regrouped into planes, most significant first, then differenced
    along the row."""
    v = row_bytes.reshape(row_bytes.shape[0], n, 4)[..., ::-1]  # big-endian byte order of each sample
    planes = v.transpose(0, 2, 1).reshape(row_bytes.shape[0], 4 * n).astype(np.int64)
    planes[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return (planes % 256).astype(np.uint8)


def tiff(samples: np.ndarray, photometric: int, bits: int, compress=lambda b: b, compression=1, order="<",
         predictor=1, planar=1, tile=None, rows_per_strip=None, extra=(), sample_format=None, fill_order=1,
         colormap=None, big=False, more_tags=()) -> bytes:
    """A TIFF of samples [h, w, spp] (ints, or float32 with sample_format
    3): strips of rows_per_strip rows or tiles (tw, th) padded at the edges,
    one plane or a plane a sample, differenced by the predictor, compressed
    by `compress` (stored as `compression`), bit-reversed for FillOrder 2."""
    h, w, spp = samples.shape
    tw, th = tile or (w, rows_per_strip or max(1, min(h, 5)))
    fmt = sample_format or 1
    planes = [samples[..., p:p + 1] for p in range(spp)] if planar == 2 else [samples]
    chunks = []
    for plane in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw if tile else w):
                rows = th if tile else min(th, h - y)
                c = np.zeros((rows, tw, plane.shape[2]), plane.dtype)
                part = plane[y:y + rows, x:x + tw]
                c[:part.shape[0], :part.shape[1]] = part
                if predictor == 2:
                    c = c.astype(np.int64)
                    c[:, 1:] = (c[:, 1:] - c[:, :-1]) % (1 << bits)
                raw = pack_rows(c, bits, order, fmt)
                if predictor == 3:
                    native = np.frombuffer(c.astype("<f4").tobytes(), np.uint8).reshape(rows, -1)
                    raw = float_predict(native, tw * plane.shape[2]).tobytes()
                raw = compress(raw)
                if fill_order == 2:
                    raw = BIT_REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th])})
    else:
        tags[278] = (4, [th])
    for tag, typ, vals in more_tags:
        tags[tag] = (typ, list(vals))
    return container(chunks, tags, order, big, bool(tile))


def ycbcr_units(yy: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> bytes:
    """A strip's or tile's YCbCr data units: for each block of hs x vs luma
    samples (rows vs-padded, width hs-padded, by the caller) the luma in
    row order, then one Cb and one Cr."""
    rows, w = yy.shape
    blocks = yy.reshape(rows // vs, vs, w // hs, hs).transpose(0, 2, 1, 3).reshape(rows // vs, w // hs, hs * vs)
    return np.concatenate([blocks, cb[..., None], cr[..., None]], axis=2).astype(np.uint8).tobytes()


def ycbcr_tiff(hw, hs: int, vs: int, seed=0, compress=lambda b: b, compression=1, rows_per_strip=None, tile=None,
               order="<", big=False, more_tags=()) -> bytes:
    """A YCbCr TIFF (photometric 6) of seeded smooth planes, subsampled
    hs x vs, in strips (rows_per_strip a multiple of vs) or tiles."""
    h, w = hw
    rng = np.random.default_rng(seed)
    tw, th = tile or (w, rows_per_strip or 2 * vs)
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w, tw if tile else w):
            rows = th if tile else min(th, h - y)
            cw = tw if tile else w
            pr, pc = -(-rows // vs) * vs, -(-cw // hs) * hs
            yy = np.clip((y + np.arange(pr))[:, None] * 3 + (x + np.arange(pc))[None, :] * 2
                         + rng.integers(0, 40, (pr, pc)), 0, 255)
            cb = rng.integers(0, 256, (pr // vs, pc // hs))
            cr = np.clip(128 + (np.arange(pc // hs)[None, :] * 9) % 120 - rng.integers(0, 60, (pr // vs, pc // hs)),
                         0, 255)
            chunks.append(compress(ycbcr_units(yy, cb, cr, hs, vs)))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [1]), 530: (3, [hs, vs])}
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th])})
    else:
        tags[278] = (4, [th])
    for tag, typ, vals in more_tags:
        tags[tag] = (typ, list(vals))
    return container(chunks, tags, order, big, bool(tile))


def jpeg_segments(data: bytes) -> list:
    """A JPEG file's marker segments up to SOS: [(marker, its bytes)], then
    ("scan", the rest)."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            out.append(("scan", data[pos:]))
            return out
        out.append((marker, data[pos:pos + 2 + n]))
        pos += 2 + n


def split_jpeg(data: bytes, drop_app=True) -> tuple:
    """(a tables-only stream of the file's DQT and DHT segments, the file
    without them: an abbreviated stream)."""
    segs = jpeg_segments(data)
    tables = b"\xff\xd8" + b"".join(s for m, s in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
    rest = b"\xff\xd8" + b"".join(s for m, s in segs if m not in (0xDB, 0xC4) and not (drop_app and m == 0xE0))
    return tables, rest


def pillow_jpeg(img: np.ndarray, mode: str, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).convert(mode).save(b, "JPEG", **kw)
    return b.getvalue()


def jpeg_tiff(rgb: np.ndarray, photometric=6, mode="RGB", rows_per_strip=16, tile=None, tables=True, order="<",
              big=False, subsampling_tag=True, more_tags=(), **jpeg_kw) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of rgb [h, w, 3]: each strip
    or tile (padded by edge replication) a Pillow JPEG of mode `mode`; with
    `tables`, the DQT and DHT segments moved into the JPEGTables tag and the
    strips left abbreviated, as libtiff writes them."""
    h, w, _ = rgb.shape
    tw, th = tile or (w, rows_per_strip)
    chunks = []
    for y in range(0, h, th):
        for x in range(0, w, tw if tile else w):
            part = rgb[y:y + th, x:x + tw]
            if tile:
                part = np.pad(part, ((0, th - part.shape[0]), (0, tw - part.shape[1]), (0, 0)), mode="edge")
            chunks.append(pillow_jpeg(part, mode, **jpeg_kw))
    spp = {"L": 1, "CMYK": 4}.get(mode, 3)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [1])}
    if tables:
        shared = split_jpeg(chunks[0])[0]
        chunks = [split_jpeg(c)[1] for c in chunks]
        tags[347] = (7, list(shared))
    if photometric == 6 and subsampling_tag:
        sof = next(s for m, s in jpeg_segments(pillow_jpeg(rgb[:8, :8], mode, **jpeg_kw)) if m in (0xC0, 0xC1, 0xC2))
        tags[530] = (3, [sof[11] >> 4, sof[11] & 15])
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th])})
    else:
        tags[278] = (4, [th])
    for tag, typ, vals in more_tags:
        tags[tag] = (typ, list(vals))
    return container(chunks, tags, order, big, bool(tile))


def deflate(b: bytes) -> bytes:
    return zlib.compress(b, 6)


LAB_CLUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "simple_sfod_tpu_torch", "data",
                        "lab_srgb_clut.bin")


def littlecms_lab_clut() -> np.ndarray:
    """The 33 x 33 x 33 x 3 uint16 table of the transform Pillow's
    convert("RGB") builds for a "LAB" image (ImageCms: cmsCreateLab2Profile
    to cmsCreate_sRGBProfile, perceptual, 8-bit Lab with a pad byte in,
    RGBA out), read from the optimised pipeline of the LittleCMS 2.17 that
    Pillow bundles: _cmsTRANSFORM's Lut at byte 112, its first stage's
    _cmsStageCLutData table."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs", "liblcms2-*"))
    lib = ctypes.CDLL(libs[0])
    vp = ctypes.c_void_p
    lib.cmsCreateLab2Profile.restype, lib.cmsCreateLab2Profile.argtypes = vp, [vp]
    lib.cmsCreate_sRGBProfile.restype = vp
    lib.cmsCreateTransform.restype = vp
    lib.cmsCreateTransform.argtypes = [vp, ctypes.c_uint32, vp, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lab_v2_8_pad = (30 << 16) | (3 << 3) | 1 | (1 << 7)  # COLORSPACE PT_LabV2, 3 channels, 1 byte, 1 extra
    rgba_8 = (4 << 16) | (3 << 3) | 1 | (1 << 7)
    xform = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), lab_v2_8_pad, lib.cmsCreate_sRGBProfile(), rgba_8,
                                   0, 0)

    def word(addr, fmt="Q"):
        return struct.unpack(fmt, ctypes.string_at(addr, struct.calcsize(fmt)))

    lut = word(xform + 112)[0]
    stage = word(lut)[0]
    kind, data, next_stage = word(stage + 8, "I")[0], word(stage + 48)[0], word(stage + 56)[0]
    assert kind.to_bytes(4, "big") == b"clut" and next_stage == 0, "not a one-stage CLUT pipeline"
    table, params, entries = word(data, "QQI")
    assert entries == 33 ** 3 * 3 and word(params + 20, "3I") == (33, 33, 33) and word(params + 8, "I")[0] == 0
    return np.frombuffer(ctypes.string_at(table, entries * 2), np.uint16).reshape(33, 33, 33, 3).copy()


def write_lab_clut() -> None:
    with open(LAB_CLUT, "wb") as f:
        f.write(zlib.compress(littlecms_lab_clut().astype("<u2").tobytes(), 9))


# ---------------------------------------------------------------------------
# old-style LZW, ThunderScan, old-style JPEG and zstd frames
# ---------------------------------------------------------------------------


def lzw_compat(data: bytes, clear_at: int = 4093, widths: set = None) -> bytes:
    """Old-style TIFF LZW (libtiff's LZWDecodeCompat): codes LSB first, 256
    clears (so a strip starts 00 and an odd byte), 257 ends; the width
    grows when the decoder's table reaches 2^n entries, one code later than
    the new style; a clear code once the table holds clear_at entries. The
    code widths used are added to `widths`."""
    out, acc, nbits = bytearray(), 0, 0

    def put(code, size):
        nonlocal acc, nbits
        if widths is not None:
            widths.add(size)
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table, nxt, size, fresh = {}, 258, 9, True
    put(256, size)
    w = None

    def emit(code):
        nonlocal nxt, size, fresh
        put(code, size)
        if not fresh:
            nxt += 1
            if nxt > (1 << size) - 1 and size < 12:
                size += 1
        fresh = False

    for k in data:
        if w is None:
            w = k
            continue
        if (w, k) in table:
            w = table[(w, k)]
            continue
        emit(w)
        table[(w, k)] = len(table) + 258
        if len(table) + 258 >= clear_at:
            put(256, size)
            table, nxt, size, fresh = {}, 258, 9, True
        w = k
    if w is not None:
        emit(w)
    put(257, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


_T2 = {0: 0, 1: 1, -1: 3}
_T3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}


def thunderscan(rows: np.ndarray, run_to_end: bool = False) -> bytes:
    """ThunderScan coding (tif_thunder.c) of 4-bit rows [h, w]: each row from
    pixel 0 (last pixel 0): runs of the last pixel, three 2-bit deltas, two
    3-bit deltas, or a raw nibble; the skip codes pad a delta code at a row's
    end. A run never reaches a row's end exactly (libtiff writes nothing for
    such a run) unless run_to_end."""
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        w, i, last = len(row), 0, 0
        while i < w:
            run = 0
            while i + run < w and row[i + run] == last and run < 63:
                run += 1
            if run >= 2 and (run_to_end or i + run < w):
                out.append(run)
                i += run
                continue
            if i + run == w and run >= 2 and not run_to_end:
                run -= 1
                if run >= 2:
                    out.append(run)
                    i += run
                    continue
            d = [int(row[j]) - prev for j, prev in zip(range(i, min(i + 3, w)), [last] + list(row[i:i + 2]))]
            if len(d) and all(x in _T2 for x in d[:3]) and (len(d) == 3 or i + len(d) == w):
                codes = [_T2[x] for x in d] + [2] * (3 - len(d))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                i += len(d)
                last = int(row[i - 1])
                continue
            d = d[:2]
            if all(x in _T3 for x in d) and (len(d) == 2 or i + len(d) == w):
                codes = [_T3[x] for x in d] + [4] * (2 - len(d))
                out.append(0x80 | codes[0] << 3 | codes[1])
                i += len(d)
                last = int(row[i - 1])
                continue
            out.append(0xC0 | int(row[i]))
            last = int(row[i])
            i += 1
    return bytes(out)


def jpeg_scan_segments(jpeg: bytes) -> tuple:
    """(the stream up to and with its SOS segment, [the entropy-coded data of
    each restart interval, its RST markers taken out], the EOI)."""
    segs = jpeg_segments(jpeg)
    scan = segs[-1][1]
    n = struct.unpack(">H", scan[2:4])[0]
    head = jpeg[:len(jpeg) - len(scan)] + scan[:2 + n]
    body = scan[2 + n:]
    assert body.endswith(b"\xff\xd9")
    body = body[:-2]
    parts, start, i = [], 0, 0
    while i < len(body) - 1:
        if body[i] == 0xFF and 0xD0 <= body[i + 1] <= 0xD7:
            parts.append(body[start:i])
            start = i = i + 2
            continue
        i += 1
    parts.append(body[start:])
    return head, parts


def jpeg_tables(jpeg: bytes) -> tuple:
    """The baseline tables of a JPEG stream: ({id: 64 zigzag bytes},
    {(class, id): 16 counts + symbols})."""
    q, huff = {}, {}
    for m, seg in jpeg_segments(jpeg):
        if m == 0xDB:
            p = 4
            while p < len(seg):
                q[seg[p] & 15] = seg[p + 1:p + 65]
                p += 65
        elif m == 0xC4:
            p = 4
            while p < len(seg):
                total = sum(seg[p + 1:p + 17])
                huff[(seg[p] >> 4, seg[p] & 15)] = seg[p + 1:p + 17 + total]
                p += 17 + total
    return q, huff


def ojpeg_tiff(rgb: np.ndarray, layout: str = "jif-scan", subsampling: int = 2, rows_per_strip=None, grey=False,
               photometric=None, subsampling_tag=None, quality=85, more_tags=(), order="<") -> bytes:
    """An old-style JPEG TIFF (compression 6) of rgb [h, w, 3] from Pillow's
    JPEG of it (subsampling 0, 1, 2: 4:4:4, 4:2:2, 4:2:0; grey: mode "L"),
    with a restart marker every rows_per_strip rows, each strip one restart
    interval with its marker taken out, as tif_ojpeg.c expects. layout:
      jif-scan   the JPEG whole at JPEGInterchangeFormat, the strips in its scan
      jif-start  the same, the one strip at the stream's start
      strips     no JPEGInterchangeFormat: the first strip carries the markers
      tables     no markers at all: JPEGQTables, JPEGDCTables, JPEGACTables
                 (and JPEGRestartInterval, JPEGProc 1) give the tables"""
    h, w, _ = rgb.shape
    rps = rows_per_strip or h
    vs = 1 if grey or subsampling in (0, 1) else 2
    kw = dict(quality=quality)
    if not grey:
        kw["subsampling"] = subsampling
    if rps < h:
        kw["restart_marker_rows"] = rps // (8 * vs)
    jpeg = pillow_jpeg(rgb, "L" if grey else "RGB", **kw)
    head, parts = jpeg_scan_segments(jpeg)
    assert len(parts) == -(-h // rps), (len(parts), h, rps)
    spp = 1 if grey else 3
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]), 277: (3, [spp]), 278: (4, [rps]),
            284: (3, [1])}
    tags[262] = (3, [photometric if photometric is not None else (1 if grey else 6)])
    if not grey:
        sof = next(s for m, s in jpeg_segments(jpeg) if m == 0xC0)
        tags[530] = (3, list(subsampling_tag or (sof[11] >> 4, sof[11] & 15)))
    blob = bytearray()  # what the IFD's offsets point into, placed after the header

    def put(b: bytes) -> int:
        at = 8 + len(blob)
        blob.extend(b)
        if len(blob) % 2:
            blob.append(0)
        return at

    if layout in ("jif-scan", "jif-start"):
        jif = put(jpeg)
        tags[513], tags[514] = (4, [jif]), (4, [len(jpeg)])
        scan = jif + len(head)
        offs, counts, pos = [], [], scan
        for k, part in enumerate(parts):
            offs.append(pos)
            counts.append(len(part))
            pos += len(part) + 2
        if layout == "jif-start":
            assert len(parts) == 1
            offs, counts = [jif], [len(jpeg)]
    elif layout == "strips":
        offs = [put(head + parts[0])] + [put(p) for p in parts[1:]]
        counts = [len(head) + len(parts[0])] + [len(p) for p in parts[1:]]
    else:
        q, huff = jpeg_tables(jpeg)
        qo = [put(q[0])] + ([put(q[1])] * 2 if not grey else [])
        dco = [put(huff[(0, 0)])] + ([put(huff[(0, 1)])] * 2 if not grey else [])
        aco = [put(huff[(1, 0)])] + ([put(huff[(1, 1)])] * 2 if not grey else [])
        tags.update({512: (3, [1]), 519: (4, qo), 520: (4, dco), 521: (4, aco)})
        dri = next((s for m, s in jpeg_segments(jpeg) if m == 0xDD), None)
        if dri is not None:
            tags[515] = (3, [struct.unpack(">H", dri[4:6])[0]])
        offs = [put(p) for p in parts]
        counts = [len(p) for p in parts]
    tags[273], tags[279] = (4, offs), (4, counts)
    for tag, typ, vals in more_tags:
        tags[tag] = (typ, list(vals))
    return _ifd_after(bytes(blob), tags, order)


def _ifd_after(blob: bytes, tags: dict, order: str) -> bytes:
    """A classic TIFF: the header, `blob` (at offset 8, holding whatever
    the tags' offsets point at), then the IFD and its out-of-line values."""
    body = bytearray(8) + blob
    if len(body) % 2:
        body.append(0)
    ifd_at = len(body)
    n = len(tags)
    value_at = ifd_at + 2 + 12 * n + 4
    ifd, values = bytearray(struct.pack(order + "H", n)), bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        blob_v = struct.pack(order + _CODES[typ] * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        ifd += struct.pack(order + "HHI", tag, typ, count)
        if len(blob_v) <= 4:
            ifd += blob_v + bytes(4 - len(blob_v))
        else:
            ifd += struct.pack(order + "I", value_at + len(values))
            values += blob_v + bytes(len(blob_v) % 2)
    body[:8] = (b"II*\x00" if order == "<" else b"MM\x00*") + struct.pack(order + "I", ifd_at)
    return bytes(body + ifd + struct.pack(order + "I", 0) + values)


_P1, _P2, _P3, _P4, _P5 = (11400714785074694791, 14029467366897019727, 1609587929392839161, 9650029242287828579,
                           2870177450012600261)
_M64 = (1 << 64) - 1


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64, the hash whose low 32 bits end a zstd frame with a checksum."""
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & _M64

    def rnd(acc, lane):
        return rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64

    def lane(i, k=8):
        return int.from_bytes(data[i:i + k], "little")

    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        while i + 32 <= n:
            v = [rnd(v[k], lane(i + 8 * k)) for k in range(4)]
            i += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ rnd(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h = (rotl(h ^ rnd(0, lane(i)), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h = (rotl(h ^ (lane(i, 4) * _P1 & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = rotl(h ^ (data[i] * _P5 & _M64), 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


def zstd_frame(blocks, checksum=False, content_size=None, window_log=17, single=False, dict_id=None) -> bytes:
    """A zstd frame (RFC 8878) of hand-made blocks: ("raw", bytes), ("rle",
    byte, count), or ("compressed", block body) as another encoder made it;
    the last block marked last. With checksum, the low 32 bits of the
    content's XXH64 follow; content_size and single give the frame content
    size field and the single-segment flag."""
    content = bytearray()
    fcs_code = 0 if content_size is None else (1 if content_size < 65536 + 256 and content_size >= 256 else
                                               0 if single and content_size < 256 else 2)
    fhd = (fcs_code << 6) | (0x20 if single else 0) | (0x04 if checksum else 0)
    if dict_id is not None:
        fhd |= 3
    out = bytearray(b"\x28\xb5\x2f\xfd") + bytes([fhd])
    if not single:
        out.append((window_log - 10) << 3)
    if dict_id is not None:
        out += struct.pack("<I", dict_id)
    if content_size is not None:
        out += (struct.pack("<B", content_size) if fcs_code == 0 else
                struct.pack("<H", content_size - 256) if fcs_code == 1 else struct.pack("<I", content_size))
    for k, b in enumerate(blocks):
        last = k == len(blocks) - 1
        if b[0] == "raw":
            out += struct.pack("<I", (len(b[1]) << 3) | last)[:3] + b[1]
            content += b[1]
        elif b[0] == "rle":
            out += struct.pack("<I", (b[2] << 3) | 2 | last)[:3] + bytes([b[1]])
            content += bytes([b[1]]) * b[2]
        else:
            out += struct.pack("<I", (len(b[1]) << 3) | 4 | last)[:3] + b[1]
            content += b[2]
    if checksum:
        out += struct.pack("<I", xxh64(bytes(content)) & 0xFFFFFFFF)
    return bytes(out)


def skippable_frame(payload: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", 0x184D2A50 | nibble, len(payload)) + payload


_LIT = {0: "raw", 1: "rle", 2: "huffman", 3: "treeless"}
_SEQ = {0: "predefined", 1: "rle", 2: "fse", 3: "repeat"}


def zstd_modes(data: bytes) -> set:
    """What the zstd frames of a strip use, from their headers alone:
    "block-raw", "block-rle", "block-compressed", "literals-<type>[-1|-4]"
    (streams), "huffman-<fse|direct>", "<ll|of|ml>-<mode>" of each compressed
    block's sequences section, "sequences-none", "checksum", "content-size",
    "single-segment"; skippable frames are stepped over, and anything that
    is not a frame ends the walk."""
    seen, pos = set(), 0
    while pos + 5 <= len(data):
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            continue
        if magic != 0xFD2FB528:
            break
        fhd, fcs = data[pos + 4], data[pos + 4] >> 6
        pos += 5 + (not fhd & 0x20) + (0, 1, 2, 4)[fhd & 3]
        pos += (1 if fhd & 0x20 else 0) if fcs == 0 else 1 << fcs
        seen |= {m for m, on in (("checksum", fhd & 4), ("content-size", fcs or fhd & 0x20),
                                 ("single-segment", fhd & 0x20)) if on}
        while pos + 3 <= len(data):
            bh = int.from_bytes(data[pos:pos + 3], "little")
            kind, size = (bh >> 1) & 3, bh >> 3
            body = data[pos + 3:pos + 3 + (1 if kind == 1 else size)]
            pos += 3 + (1 if kind == 1 else size)
            if kind == 3:
                return seen
            seen.add("block-" + ("raw", "rle", "compressed")[kind])
            if kind == 2:
                seen |= _zstd_block_modes(body)
            if bh & 1:
                pos += 4 if fhd & 4 else 0
                break
    return seen


def _zstd_block_modes(body: bytes) -> set:
    seen = set()
    lt, fmt = body[0] & 3, (body[0] >> 2) & 3
    if lt < 2:
        hs = (1, 2, 1, 3)[fmt]
        used = hs + ((body[0] >> 3 if hs == 1 else int.from_bytes(body[:hs], "little") >> 4) if lt == 0 else 1)
        seen.add("literals-" + _LIT[lt])
    else:
        hs = (3, 3, 4, 5)[fmt]
        lhc = int.from_bytes(body[:5], "little")
        used = hs + ((lhc >> 14) & 0x3FF, (lhc >> 14) & 0x3FF, (lhc >> 18) & 0x3FFF, (lhc >> 22) & 0x3FFFF)[fmt]
        seen.add(f"literals-{_LIT[lt]}-{1 if fmt == 0 else 4}")
        if lt == 2:
            seen.add("huffman-" + ("direct" if body[hs] >= 128 else "fse"))
    nseq = body[used]
    if nseq == 0:
        seen.add("sequences-none")
    else:
        m = body[used + (1 if nseq < 128 else 2 if nseq < 255 else 3)]
        seen |= {f"ll-{_SEQ[m >> 6]}", f"of-{_SEQ[(m >> 4) & 3]}", f"ml-{_SEQ[(m >> 2) & 3]}"}
    return seen


def _vli(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    return bytes(out + bytes([v]))


def _read_vli(b: bytes, p: int) -> tuple:
    v, k = 0, 0
    while True:
        v |= (b[p] & 0x7F) << (7 * k)
        k += 1
        p += 1
        if not b[p - 1] & 0x80:
            return v, p


def liblzma_xz(data: bytes, filters, check: int = lzma.CHECK_CRC64) -> bytes:
    """An .xz stream of data from the liblzma Pillow bundles (5.8), through
    lzma_stream_buffer_encode: filters [(id, value)] before LZMA2 preset 6,
    value a Delta's distance or a BCJ filter's start offset (None: no
    options). For the BCJ filters Python's lzma module does not name (ARM64,
    RISC-V)."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs", "liblzma-*"))
    lib = ctypes.CDLL(libs[0])

    class Filter(ctypes.Structure):
        _fields_ = [("id", ctypes.c_uint64), ("options", ctypes.c_void_p)]

    lzma2 = ctypes.create_string_buffer(256)  # lzma_options_lzma, filled by the preset
    assert lib.lzma_lzma_preset(lzma2, 6) == 0
    keep = [lzma2]
    chain = (Filter * (len(filters) + 2))()
    for i, (fid, value) in enumerate(filters):
        opt = None
        if value is not None:  # lzma_options_bcj {start_offset}; lzma_options_delta {type BYTE, dist}
            keep.append(ctypes.create_string_buffer(struct.pack("<II", 0, value) if fid == 3 else
                                                    struct.pack("<I", value), 64))
            opt = ctypes.cast(keep[-1], ctypes.c_void_p)
        chain[i] = Filter(fid, opt)
    chain[len(filters)] = Filter(lzma.FILTER_LZMA2, ctypes.cast(lzma2, ctypes.c_void_p))
    chain[len(filters) + 1] = Filter(2 ** 64 - 1, None)
    out = ctypes.create_string_buffer(len(data) * 2 + 4096)
    pos = ctypes.c_size_t(0)
    lib.lzma_stream_buffer_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                                              ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
                                              ctypes.c_size_t]
    assert lib.lzma_stream_buffer_encode(chain, check, None, data, len(data), out, ctypes.byref(pos), len(out)) == 0
    return out.raw[:pos.value]


def xz_blocks(parts, check=lzma.CHECK_CRC64, filters=None) -> bytes:
    """One .xz stream ("The .xz File Format" 1.2.1) of a block a part, each
    block as Python's lzma writes it, under one index and footer."""
    blocks, records = b"", []
    for part in parts:
        s = lzma.compress(part, check=check, filters=filters)
        backward = (struct.unpack("<I", s[-8:-4])[0] + 1) * 4
        at = len(s) - 12 - backward
        blocks += s[12:at]
        n, p = _read_vli(s, at + 1)
        for _ in range(n):
            unpadded, p = _read_vli(s, p)
            size, p = _read_vli(s, p)
            records.append((unpadded, size))
    index = b"\x00" + _vli(len(records)) + b"".join(_vli(u) + _vli(c) for u, c in records)
    index += bytes(-len(index) % 4)
    index += struct.pack("<I", zlib.crc32(index))
    flags = bytes([0, check])
    footer = struct.pack("<I", len(index) // 4 - 1) + flags
    return (b"\xfd7zXZ\x00" + flags + struct.pack("<I", zlib.crc32(flags)) + blocks + index
            + struct.pack("<I", zlib.crc32(footer)) + footer + b"YZ")
