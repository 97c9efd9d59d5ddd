"""Writers of the TIFF files that tests/test_torch_tiff.py holds the port's
decoder to Pillow with, for what Pillow's and libtiff's own writers cannot
make: any IFD in either byte order or as BigTIFF (`container`), samples at
1 to 32 bits, signed or float, with predictors 2 and 3 and FillOrder 2
(`tiff`), YCbCr data units at every subsampling with its coefficient and
reference tags (`ycbcr_tiff`), and JPEG-compressed TIFF from Pillow's JPEG
streams split into a shared JPEGTables segment and abbreviated strips or
tiles (`jpeg_tiff`). `littlecms_lab_clut` reads the table of Pillow's
Lab -> sRGB transform out of the LittleCMS library Pillow bundles; it
writes simple_sfod_tpu_torch/data/lab_srgb_clut.bin:

    python -c "import sys; sys.path.insert(0, 'tests'); import torch_tiff_coders as t; t.write_lab_clut()"
"""

import ctypes
import glob
import io
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
