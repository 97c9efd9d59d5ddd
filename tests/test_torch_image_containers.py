"""The image files that the JAX package reads through PIL and the port now
reads itself: arithmetic-coded, block-smoothed and lossless JPEG, BMP, GIF
and TIFF, each with tolerance 0.

Every case holds the port's `native_codec.decode` and `decode_bytes` to
Pillow's convert("RGB") (12.1, libjpeg-turbo 3.1, libtiff for compressed
TIFF), its `image_size` to Pillow's `size`, and its loader's `_prep_image`
(decode and shortest-edge resize, RGB and BGR) to the JAX package's, which
opens these files with PIL. Files come from Pillow where it writes the
variant and otherwise from the writers kept here and in
tests/torch_jpeg_coders.py: the arithmetic encoder (after jcarith.c) and
the lossless SOF3 writer, `bmp_file` (every header, depth, bitfield layout,
RLE4 and RLE8 with their escapes, both row orders, short palettes),
`gif_file` (LZW with growing codes, clear codes or a full table, global and
local palettes, interlacing, a frame smaller than the screen or offset in
it, transparency) and `tiff_file` (both byte orders, strips and tiles,
chunky and planar, none, PackBits, LZW and Deflate, predictor 2, every
photometric the port reads, 1 to 16 bits, extra samples).

What stays refused raises a ValueError that names it, beside a check that
Pillow refuses the same bytes where it does. The metrics toolkit and GUI
read BMP sizes from the header as the JAX package's read them with PIL.

The committed fixtures (tests/torch_containers/) are rebuilt by
`python tests/test_torch_image_containers.py --write-fixtures`;
fixtures.json records the SHA-256 of Pillow's RGB of each.
"""

import hashlib
import io
import json
import lzma
import math
import os
import struct
import sys
import warnings
import zlib

if __name__ == "__main__":  # run as a script: the packages sit at the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from PIL import Image, features  # noqa: E402

from simple_sfod_tpu.data import native_codec as jnc  # noqa: E402
from simple_sfod_tpu.data.loader import DetectionLoader as JaxLoader  # noqa: E402
from simple_sfod_tpu_torch.data import native_codec as pnc  # noqa: E402
from simple_sfod_tpu_torch.data.loader import DetectionLoader  # noqa: E402
from test_torch_jpeg import drop_scans, encode, jpeg_parts, pillow_jpeg, smooth_image  # noqa: E402
import torch_tiff_coders as tc  # noqa: E402
from torch_jpeg_coders import lossless_jpeg  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_containers")
LOADER_KW = dict(batch_size=1, canvas_hw=(64, 128), min_size=20, max_size=128, gt_capacity=4, training=False,
                 prefetch=0)
DECODER = f"Pillow {Image.__version__}, libjpeg-turbo {features.version('libjpeg_turbo')}, libtiff " \
          f"{features.version('libtiff')}"


@pytest.fixture(autouse=True)
def jax_loader_through_pil(monkeypatch):
    """The JAX loader decodes these files through PIL: its native codec
    reads no BMP, GIF or TIFF, and on a block-smoothed JPEG its libjpeg
    (not libjpeg-turbo >= 2.1) smooths otherwise than PIL's, which its own
    one-shot check against PIL catches only when that file comes first in
    the process. The codec is switched off for each case, so that the
    reference is PIL's decode whatever ran before."""
    monkeypatch.setattr(jnc, "_DISABLED", True)
    monkeypatch.setattr(jnc, "_CHECKED", dict(jnc._CHECKED))


def pillow_rgb(data: bytes):
    """(Pillow's convert("RGB"), its (height, width))."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB")), im.size[::-1]


def assert_reads_like_pillow(data: bytes, tmp_path, name="case") -> np.ndarray:
    """decode, decode_bytes and image_size equal to Pillow's; _prep_image
    equal to the JAX loader's in RGB and BGR. -> the RGB."""
    ref, size = pillow_rgb(data)
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    got = pnc.decode(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(pnc.decode_bytes(data, name), ref)
    assert pnc.image_size(path) == size
    rec = {"file_name": path}
    for fmt in ("RGB", "BGR"):
        img, scale = DetectionLoader([rec], input_format=fmt, **LOADER_KW)._prep_image(rec)
        want_img, want_scale = JaxLoader([rec], input_format=fmt, **LOADER_KW)._prep_image(rec)
        assert img.dtype == want_img.dtype == np.uint8
        np.testing.assert_array_equal(img, want_img)
        np.testing.assert_array_equal(scale, want_scale)
    return got


def pillow_file(img, fmt, **kw) -> bytes:
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def rand(shape, seed, high=256, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, high, shape).astype(dtype)


# ---------------------------------------------------------------------------
# JPEG: arithmetic coding, block smoothing, lossless
# ---------------------------------------------------------------------------

F420, F422, F440 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)), ((1, 2), (1, 1), (1, 1))
ARITH = {
    "seq-444": dict(sof=0xC9),
    "seq-420": dict(sof=0xC9, factors=F420),
    "seq-422-restart-3": dict(sof=0xC9, factors=F422, restart=3),
    "seq-non-interleaved-440": dict(sof=0xC9, factors=F440, interleaved=False),
    "seq-dac": dict(sof=0xC9, factors=F420, dac=bytes([0, 0x52, 1, 0x31, 16, 2, 17, 40])),
    "seq-grey": dict(sof=0xC9, grey=True),
    "seq-q100-noise": dict(sof=0xC9, quality=100, noise=True),
    "prog-420": dict(sof=0xCA, factors=F420),
    "prog-444-restart-2": dict(sof=0xCA, restart=2),
    "prog-grey": dict(sof=0xCA, grey=True),
    "prog-dac-restart-1": dict(sof=0xCA, factors=F420, restart=1, dac=bytes([0, 0x10, 16, 63, 17, 1])),
    "prog-q100-noise": dict(sof=0xCA, quality=100, noise=True),
    "ycck": dict(sof=0xC9, cmyk=True, adobe=2, jfif=False),
}


def arith_file(case: str, hw=(37, 61), seed=3) -> bytes:
    kw = dict(ARITH[case])
    grey, noise, cmyk = kw.pop("grey", False), kw.pop("noise", False), kw.pop("cmyk", False)
    img = rand((*hw, 3), seed) if noise else smooth_image(*hw, seed=seed, noise=20)
    if cmyk:
        img = np.asarray(Image.fromarray(img).convert("CMYK"))
    return encode(img[..., 0] if grey else img, quality=kw.pop("quality", 80), **kw)


@pytest.mark.parametrize("case", sorted(ARITH))
def test_arithmetic_coded(tmp_path, case):
    data = arith_file(case)
    assert (b"\xff\xc9" in data) != (b"\xff\xca" in data)
    assert_reads_like_pillow(data, tmp_path)


SMOOTHED = {
    "dc-only-420": (2, 1, (45, 63)), "two-scans-444": (0, 2, (45, 63)), "five-scans-420": (2, 5, (45, 63)),
    "nine-scans-422": (1, 9, (33, 47)), "grey-dc-only": (None, 1, (40, 50)), "grey-three-scans": (None, 3, (40, 50)),
    "two-blocks-wide": (2, 6, (12, 16)), "partial-imcu-row": (2, 5, (23, 70)), "one-row": (0, 3, (1, 30)),
}


@pytest.mark.parametrize("case", sorted(SMOOTHED))
def test_block_smoothing(tmp_path, case):
    """Progressive files cut after their first scans: libjpeg-turbo's 5x5
    smoothing (and DC interpolation where no AC scan came), on narrow
    images (the two-block edge), a partial last iMCU row and one row."""
    sub, keep, hw = SMOOTHED[case]
    img = smooth_image(*hw, seed=keep, noise=25)
    data = pillow_jpeg(img[..., 0], progressive=True) if sub is None else pillow_jpeg(
        img, quality=70, progressive=True, subsampling=sub)
    assert keep < len(jpeg_parts(data)[1])
    assert_reads_like_pillow(drop_scans(data, keep), tmp_path)


def lossless_planes(hw, factors, seed, smooth=True):
    H, W = hw
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    out = []
    for i, (h, v) in enumerate(factors):
        shape = (math.ceil(H * v / vmax), math.ceil(W * h / hmax))
        out.append(smooth_image(*shape, seed=seed + i)[..., i % 3] if smooth else rand(shape, seed + i))
    return out


LOSSLESS = {
    **{f"grey-psv{p}": dict(factors=[(1, 1)], psv=p) for p in range(1, 8)},
    "grey-pt3": dict(factors=[(1, 1)], psv=4, pt=3),
    "grey-pt7": dict(factors=[(1, 1)], psv=1, pt=7),
    "rgb-no-markers": dict(factors=[(1, 1)] * 3, psv=7),
    "rgb-adobe-0": dict(factors=[(1, 1)] * 3, psv=6, adobe=0),
    "rgb-ids": dict(factors=[(1, 1)] * 3, psv=5, ids=[82, 71, 66]),
    "cmyk": dict(factors=[(1, 1)] * 4, psv=4),
    "rgb-restart-rows": dict(factors=[(1, 1)] * 3, psv=2, restart=2 * 31),
    "h2v2-first": dict(factors=[(2, 2), (1, 1), (1, 1)], psv=3, restart=16),
    "non-interleaved-restart": dict(factors=[(1, 2), (1, 1), (1, 1)], psv=6, interleaved=False, restart=31 * 16),
    "noise": dict(factors=[(1, 1)] * 3, psv=4, smooth=False),
}


@pytest.mark.parametrize("case", sorted(LOSSLESS))
def test_lossless(tmp_path, case):
    kw = dict(LOSSLESS[case])
    planes = lossless_planes((23, 31), kw.pop("factors"), seed=len(case), smooth=kw.pop("smooth", True))
    factors = LOSSLESS[case]["factors"]
    assert_reads_like_pillow(lossless_jpeg(planes, factors, size=(23, 31), **kw), tmp_path)


def test_lossless_hand_made_8x8():
    """The smallest file: 8x8 grey at 128, Pillow's "L"."""
    data = lossless_jpeg([np.full((8, 8), 128, np.uint8)], [(1, 1)])
    ref, _ = pillow_rgb(data)
    assert (ref == 128).all()
    np.testing.assert_array_equal(pnc.decode_bytes(data), ref)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def _pack(idx: np.ndarray, bits: int) -> np.ndarray:
    """Rows of indices packed high bits first."""
    h, w = idx.shape
    if bits == 8:
        return idx.astype(np.uint8)
    b = ((idx[..., None].astype(np.uint8) >> np.arange(bits - 1, -1, -1, dtype=np.uint8)) & 1).reshape(h, -1)
    return np.packbits(b, axis=1)


def bmp_file(rows, bits: int, width: int, height: int, header=40, palette=None, colors=0, top_down=False,
             compression=0, masks=None, masks_after=False) -> bytes:
    """A width x height BMP of `rows` (uint8 [height, bytes] of packed
    pixels, or the bytes of an RLE stream), `palette` ([n, 3] RGB, written
    BGR(X)) and the given header fields; `masks` go in the header (52+
    bytes) or after a 40-byte one (`masks_after`)."""
    h, w = height, width
    pad = 3 if header == 12 else 4
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        pal = (p if pad == 3 else np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hf = (2**32 - h) if top_down else h
        info = struct.pack("<IiIHHIIiiII", header, w, hf, 1, bits, compression, 0, 2835, 2835, colors, 0)
        if masks is not None and not masks_after:
            info += struct.pack("<IIII", *(list(masks) + [0] * (4 - len(masks))))
        info = info + bytes(header - len(info))
    extra = struct.pack("<III", *masks[:3]) if masks is not None and masks_after else b""
    if isinstance(rows, bytes):
        body = rows
    else:
        stride = (rows.shape[1] + 3) & ~3
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :rows.shape[1]] = rows
        body = (padded if top_down else padded[::-1]).tobytes()
    off = 14 + len(info) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info + extra + pal + body


def rle_stream(idx: np.ndarray, rle4: bool, delta_rows=(), odd_absolute=False) -> bytes:
    """An RLE8/RLE4 stream of indices [h, w] (bottom-up): encoded runs and
    absolute runs a row, an end-of-line escape after each, end of bitmap
    after the last; the rows in `delta_rows` end with a delta escape and
    the two bytes Pillow reads as its steps."""
    out = bytearray()
    for r, row in enumerate(idx[::-1]):
        row = [int(v) for v in row]
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or len(row) - x < 3:
                out += bytes([run, (row[x] << 4) | row[x] if rle4 else row[x]])
                x += run
                continue
            n = min(len(row) - x, 40 if not odd_absolute else 5)
            vals = row[x:x + n]
            out += bytes([0, n])
            data = bytes((vals[i] << 4) | (vals[i + 1] if i + 1 < n else 0) for i in range(0, n, 2)) if rle4 \
                else bytes(vals)
            out += data + bytes(len(data) % 2)
            x += n
        if r in delta_rows:
            out += bytes([0, 2, 1, 0, 2, 0])
        out += bytes([0, 1] if r == idx.shape[0] - 1 else [0, 0])
    return bytes(out)


PAL16 = rand((16, 3), 5)
PAL256 = rand((256, 3), 6)
BMP = {
    **{f"info{hdr}-8bit": dict(bits=8, header=hdr) for hdr in (40, 52, 56, 64, 108, 124)},
    "core12-1bit": dict(bits=1, header=12), "core12-4bit": dict(bits=4, header=12),
    "core12-8bit": dict(bits=8, header=12), "core12-24bit": dict(bits=24, header=12),
    "1bit": dict(bits=1), "4bit": dict(bits=4), "4bit-short-palette": dict(bits=4, colors=5),
    "8bit-short-palette": dict(bits=8, colors=20), "8bit-top-down": dict(bits=8, top_down=True),
    "8bit-grey-palette": dict(bits=8, grey=True), "4bit-grey-palette-narrow": dict(bits=4, grey=True, hw=(9, 4)),
    "1bit-black-white": dict(bits=1, grey=True), "16bit-raw-555": dict(bits=16),
    "16bit-bitfields-565": dict(bits=16, masks=(0xF800, 0x7E0, 0x1F)),
    "16bit-bitfields-555-v4": dict(bits=16, masks=(0x7C00, 0x3E0, 0x1F), header=108),
    "24bit": dict(bits=24), "24bit-top-down": dict(bits=24, top_down=True),
    "24bit-bitfields": dict(bits=24, masks=(0xFF0000, 0xFF00, 0xFF)),
    "32bit-raw": dict(bits=32), "32bit-bitfields-bgrx": dict(bits=32, masks=(0xFF0000, 0xFF00, 0xFF, 0)),
    "32bit-bitfields-xbgr-v5": dict(bits=32, masks=(0xFF000000, 0xFF0000, 0xFF00, 0), header=124),
    "32bit-alpha-rgba-v5": dict(bits=32, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), header=124),
    "32bit-alpha-bgra-v4": dict(bits=32, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=108),
    "32bit-alpha-abgr-v3": dict(bits=32, masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF), header=56),
    "rle8": dict(bits=8, rle=True), "rle8-delta": dict(bits=8, rle=True, delta=True),
    "rle4": dict(bits=4, rle=True), "rle4-odd-absolute": dict(bits=4, rle=True, odd=True),
    "rle4-delta": dict(bits=4, rle=True, delta=True), "rle8-grey-palette": dict(bits=8, rle=True, grey=True),
}


def bmp_case(case: str, hw=(13, 21), seed=0) -> bytes:
    kw = dict(BMP[case])
    hw = kw.pop("hw", hw)
    bits, h, w = kw.pop("bits"), *hw
    grey, masks, colors = kw.pop("grey", False), kw.pop("masks", None), kw.pop("colors", 0)
    rng = np.random.default_rng(seed)
    if bits <= 8:
        n = colors or (1 << bits)
        if grey:
            palette = np.repeat(np.array([0, 255] if n == 2 else np.arange(n), np.uint8)[:, None], 3, axis=1)
        else:
            palette = (PAL16 if bits == 4 else PAL256 if bits == 8 else rand((2, 3), 7))[:n]
        # runs of equal indices, some past a short palette
        idx = np.repeat(rng.integers(0, min(1 << bits, n + 3), (h, (w + 2) // 3)), 3, axis=1)[:, :w]
        if kw.pop("rle", False):
            rle4 = bits == 4
            stream = rle_stream(idx, rle4, delta_rows=(2, 7) if kw.pop("delta", False) else (),
                                odd_absolute=kw.pop("odd", False))
            return bmp_file(stream, bits, w, h, palette=palette, colors=colors, compression=2 if rle4 else 1, **kw)
        return bmp_file(_pack(idx, bits), bits, w, h, palette=palette, colors=colors, **kw)
    if bits == 16:
        rows = rng.integers(0, 65536, (h, w)).astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        rows = rng.integers(0, 256, (h, w * bits // 8)).astype(np.uint8)
    if masks is not None:
        return bmp_file(rows, bits, w, h, masks=masks, compression=3, masks_after=kw.get("header", 40) == 40, **kw)
    return bmp_file(rows, bits, w, h, **kw)


@pytest.mark.parametrize("case", sorted(BMP))
def test_bmp(tmp_path, case):
    assert_reads_like_pillow(bmp_case(case), tmp_path, "a.bmp")


def test_bmp_16bit_widening_every_value(tmp_path):
    """All 65536 pixel values of 5-5-5 and 5-6-5: Pillow widens a field f of
    n bits to f * 255 // (2**n - 1)."""
    p = np.arange(65536, dtype="<u2").reshape(256, 256)
    for masks in (None, (0xF800, 0x7E0, 0x1F)):
        data = bmp_file(p.view(np.uint8), 16, 256, 256, masks=masks, compression=3 if masks else 0, masks_after=True)
        got = assert_reads_like_pillow(data, tmp_path, "w.bmp").reshape(-1, 3).astype(np.int64)
        v = p.reshape(-1).astype(np.int64)
        r = ((v >> 11) & 31) if masks else ((v >> 10) & 31)
        np.testing.assert_array_equal(got[:, 0], r * 255 // 31)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def gif_lzw(idx: np.ndarray, min_size: int, clear_every=None, full_table="clear") -> bytes:
    """LZW codes of the indices, LSB first: a clear code first, the width
    growing as the decoder's table does, a clear every `clear_every` codes,
    and at a full table a clear ("clear") or none ("defer")."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def put(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def reset():
        return {}, end + 1, min_size + 1, True

    table, nxt, size, fresh = reset()
    put(clear, size)
    emitted = 0
    w = None
    for k in (int(v) for v in idx.reshape(-1)):
        if w is None:
            w = k
            continue
        if (w, k) in table:
            w = table[(w, k)]
            continue
        put(w, size)
        emitted += 1
        if not fresh and nxt < 4096:  # the decoder's entry for this code
            nxt += 1
            if nxt == 1 << size and size < 12:
                size += 1
        fresh = False
        if len(table) + end + 1 < 4096:
            table[(w, k)] = len(table) + end + 1
        elif full_table == "clear":
            put(clear, size)
            table, nxt, size, fresh = reset()
        if clear_every and emitted % clear_every == 0 and table:
            put(clear, size)
            table, nxt, size, fresh = reset()
        w = k
    if w is not None:
        put(w, size)
        if not fresh and nxt < 4096:
            nxt += 1
            if nxt == 1 << size and size < 12:
                size += 1
    put(end, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\x00"


def gif_file(idx, palette=None, local=None, screen=None, offset=(0, 0), interlace=False, transparency=None,
             min_size=None, lzw=None, comment=True) -> bytes:
    """A GIF89a of one frame of indices idx [fh, fw] at `offset` on a screen
    of `screen` (w, h), with a global and/or local colour table (RGB
    [2**n, 3]), a graphic control extension with `transparency`, a comment
    and an application extension before it."""
    fh, fw = idx.shape
    sw, sh = screen or (fw + offset[0], fh + offset[1])

    def table_bits(p):
        return int(math.log2(len(p))) - 1

    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    out += bytes([(0x80 | table_bits(palette)) if palette is not None else 0, 0, 0])
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()
    if comment:
        out += b"\x21\xfe" + _sub_blocks(b"a comment") + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    flags = (0x40 if interlace else 0) | ((0x80 | table_bits(local)) if local is not None else 0)
    out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], fw, fh, flags)
    if local is not None:
        out += np.asarray(local, np.uint8).tobytes()
    rows = idx
    if interlace:
        order = np.concatenate([np.arange(fh)[0::8], np.arange(fh)[4::8], np.arange(fh)[2::4], np.arange(fh)[1::2]])
        rows = idx[order]
    ms = min_size or max(2, int(idx.max()).bit_length())
    out += bytes([ms]) + _sub_blocks(lzw if lzw is not None else gif_lzw(rows, ms))
    return bytes(out + b";")


GREY_RAMP = np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, axis=1)
GIF = {
    "global": dict(palette=PAL16), "local": dict(local=PAL16), "both": dict(palette=PAL256, local=PAL16),
    "no-palette-grey": dict(), "grey-ramp-global": dict(palette=GREY_RAMP),
    "grey-ramp-local-over-global": dict(palette=PAL16, local=GREY_RAMP),
    "interlaced": dict(palette=PAL16, interlace=True, hw=(19, 13)),
    "interlaced-tiny": dict(palette=PAL16, interlace=True, hw=(3, 5)),
    "offset-frame": dict(palette=PAL16, offset=(5, 3), screen=(30, 25)),
    "offset-frame-transparency": dict(palette=PAL16, offset=(4, 6), screen=(28, 29), transparency=7),
    "frame-past-screen": dict(palette=PAL16, offset=(6, 2), screen=(10, 8)),
    "transparency": dict(palette=PAL16, transparency=3), "index-past-palette": dict(palette=PAL16[:4], high=16),
    "min-code-8": dict(palette=PAL256, high=256, min_size=8), "clear-codes": dict(palette=PAL16, clear_every=7),
    "full-table-clear": dict(palette=PAL256, high=256, hw=(64, 96), noise=True),
    "full-table-deferred": dict(palette=PAL256, high=256, hw=(64, 96), noise=True, full="defer"),
}


def gif_case(case: str, seed=0) -> bytes:
    kw = dict(GIF[case])
    h, w = kw.pop("hw", (15, 22))
    high, noise = kw.pop("high", 16), kw.pop("noise", False)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, high, (h, w)) if noise else np.repeat(rng.integers(0, high, (h, (w + 3) // 4)), 4, 1)[:, :w]
    clear_every, full = kw.pop("clear_every", None), kw.pop("full", "clear")
    ms = kw.pop("min_size", None) or max(2, int(high - 1).bit_length())
    rows = idx
    if kw.get("interlace"):
        rows = idx[np.concatenate([np.arange(h)[0::8], np.arange(h)[4::8], np.arange(h)[2::4], np.arange(h)[1::2]])]
    return gif_file(idx, lzw=gif_lzw(rows, ms, clear_every, full), min_size=ms, **kw)


@pytest.mark.parametrize("case", sorted(GIF))
def test_gif(tmp_path, case):
    assert_reads_like_pillow(gif_case(case), tmp_path, "a.gif")


@pytest.mark.parametrize("mode", ["P", "L", "RGB", "P-transparency"])
def test_pillow_gif(tmp_path, mode):
    """Pillow's own GIFs (interlaced, its LZW)."""
    img = Image.fromarray(smooth_image(27, 33, seed=4, noise=30))
    im = img.quantize(60) if mode.startswith("P") else img.convert(mode)
    kw = {"transparency": 5} if mode == "P-transparency" else {}
    assert_reads_like_pillow(pillow_file(im, "GIF", **kw), tmp_path, "p.gif")


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW, MSB first: the width grows one code early (as libtiff
    decodes), a clear code before the table is full."""
    out, acc, nbits = bytearray(), 0, 0

    def put(code, size):
        nonlocal acc, nbits
        acc, nbits = (acc << size) | code, nbits + size
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1

    table, nxt, size, fresh = {}, 258, 9, True
    put(256, size)
    w = None
    for k in data:
        if w is None:
            w = k
            continue
        if (w, k) in table:
            w = table[(w, k)]
            continue
        put(w, size)
        if not fresh:
            nxt += 1
            if nxt > (1 << size) - 2 and size < 12:
                size += 1
        fresh = False
        table[(w, k)] = len(table) + 258
        if len(table) + 258 >= 4093:
            put(256, size)
            table, nxt, size, fresh = {}, 258, 9, True
        w = k
    if w is not None:
        put(w, size)
        if not fresh:
            nxt += 1
            if nxt > (1 << size) - 2 and size < 12:
                size += 1
    put(257, size)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


COMPRESS = {1: lambda b: b, 32773: packbits, 5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress}


def tiff_file(samples: np.ndarray, photometric: int, bits: int, order="<", compression=1, predictor=1, planar=1,
              tile=None, rows_per_strip=None, extra=(), colormap=None, more_tags=()) -> bytes:
    """A TIFF of samples [h, w, spp] (values below 2**bits): strips of
    `rows_per_strip` rows or tiles (tw, th) padded at the edges, one plane
    or a plane a sample, differenced (predictor 2) and compressed each."""
    h, w, spp = samples.shape
    dt = np.dtype(order + "u2") if bits == 16 else np.uint8
    tw, th = tile or (w, rows_per_strip or max(1, min(h, 5)))
    planes = [samples[..., p:p + 1] for p in range(spp)] if planar == 2 else [samples]
    chunks = []
    for plane in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw if tile else w):
                rows = th if tile else min(th, h - y)
                c = np.zeros((rows, tw, plane.shape[2]), np.int64)
                part = plane[y:y + rows, x:x + tw]
                c[:part.shape[0], :part.shape[1]] = part
                if predictor == 2:
                    c[:, 1:] = (c[:, 1:] - c[:, :-1]) % (1 << bits)
                if bits >= 8:
                    raw = c.astype(dt).tobytes()
                else:
                    b = ((c[..., 0, None] >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8).reshape(rows, -1)
                    raw = np.packbits(b, axis=1).tobytes()
                chunks.append(COMPRESS[compression](raw))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [th])})
    else:
        entries[278] = (4, [th])
    for tag, typ, vals in more_tags:
        entries[tag] = (typ, vals)
    offs_tag, counts_tag = (324, 325) if tile else (273, 279)
    entries[offs_tag], entries[counts_tag] = (4, [0] * len(chunks)), (4, [len(c) for c in chunks])
    # layout: header, pixel data, then the IFD and its out-of-line values
    body = bytearray(struct.pack(order + "2sHI", b"II" if order == "<" else b"MM", 42, 0))
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + bytes(len(c) % 2)
    entries[offs_tag] = (4, offsets)
    ifd_at = len(body)
    n = len(entries)
    value_at = ifd_at + 2 + 12 * n + 4
    ifd, values = bytearray(struct.pack(order + "H", n)), bytearray()
    for tag in sorted(entries):
        typ, vals = entries[tag]
        code = {3: "H", 4: "I"}[typ]
        blob = struct.pack(order + code * len(vals), *[int(v) for v in vals])
        if len(blob) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + blob + bytes(4 - len(blob))
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals), value_at + len(values))
            values += blob + bytes(len(blob) % 2)
    body[4:8] = struct.pack(order + "I", ifd_at)
    return bytes(body + ifd + struct.pack(order + "I", 0) + values)


def tiff_case(case: str, compression=1, hw=(13, 22), seed=0, **more) -> bytes:
    """The samples and tags of TIFF[case], written by tiff_file (with the
    keywords `more`)."""
    spec = dict(TIFF[case], **more)
    photo, bits, spp = spec.pop("photo"), spec.pop("bits"), spec.pop("spp", 1)
    h, w = hw
    rng = np.random.default_rng(seed)
    if photo == 3:
        s = np.repeat(rng.integers(0, 1 << bits, (h, (w + 1) // 2, 1)), 2, axis=1)[:, :w]
        spec["colormap"] = rng.integers(0, 65536, (1 << bits, 3))
        if spp == 2:
            s = np.concatenate([s, rng.integers(0, 256, (h, w, 1))], axis=2)
    else:
        base = smooth_image(h, w, seed=seed, noise=30).astype(np.int64)
        s = np.concatenate([base] * 2, axis=2)[..., :spp] if spp <= 6 else None
        if bits == 16:
            s = s * 257 + rng.integers(0, 257, s.shape)
            s[::2] %= 600  # both sides of the grey clip at 255
        elif bits < 8:
            s = s >> (8 - bits)
        if spec.get("extra") and spec["extra"][0] == 1:  # associated alpha: premultiplied colour
            a = rng.integers(0, 256, (h, w))
            a[0, :3] = (0, 255, 1)
            s[..., 3] = a if bits == 8 else a * 257
            s[..., :3] = s[..., :3] * s[..., 3:4] // ((1 << bits) - 1)
    return tiff_file(s, photo, bits, compression=compression, **spec)


TIFF = {
    "bilevel-min-is-black": dict(photo=1, bits=1), "bilevel-min-is-white": dict(photo=0, bits=1),
    "grey2": dict(photo=1, bits=2), "grey4-min-is-white": dict(photo=0, bits=4),
    "grey8": dict(photo=1, bits=8), "grey8-min-is-white": dict(photo=0, bits=8),
    "grey8-big-endian": dict(photo=1, bits=8, order=">"), "grey16": dict(photo=1, bits=16),
    "grey16-big-endian": dict(photo=1, bits=16, order=">"), "grey16-min-is-white": dict(photo=0, bits=16),
    "grey-alpha": dict(photo=1, bits=8, spp=2, extra=(2,)),
    "rgb8": dict(photo=2, bits=8, spp=3), "rgb8-big-endian": dict(photo=2, bits=8, spp=3, order=">"),
    "rgb8-one-strip": dict(photo=2, bits=8, spp=3, rows_per_strip=2**32 - 1),
    "rgb8-tiles": dict(photo=2, bits=8, spp=3, tile=(16, 16)), "rgb8-planar": dict(photo=2, bits=8, spp=3, planar=2),
    "rgb8-planar-tiles": dict(photo=2, bits=8, spp=3, planar=2, tile=(16, 16)),
    "rgb8-predictor": dict(photo=2, bits=8, spp=3, predictor=2),
    "rgb8-predictor-tiles": dict(photo=2, bits=8, spp=3, predictor=2, tile=(16, 16)),
    "rgb16": dict(photo=2, bits=16, spp=3), "rgb16-big-endian-predictor": dict(photo=2, bits=16, spp=3, order=">",
                                                                             predictor=2),
    "grey16-predictor": dict(photo=1, bits=16, predictor=2),
    "rgba-unassociated": dict(photo=2, bits=8, spp=4, extra=(2,)),
    "rgba-unassociated-planar": dict(photo=2, bits=8, spp=4, extra=(2,), planar=2),
    "rgba-associated": dict(photo=2, bits=8, spp=4, extra=(1,)),
    "rgba16-associated": dict(photo=2, bits=16, spp=4, extra=(1,)),
    "rgbx-unspecified": dict(photo=2, bits=8, spp=4, extra=(0,)), "rgba-no-extrasamples": dict(photo=2, bits=8, spp=4),
    "palette1": dict(photo=3, bits=1), "palette4": dict(photo=3, bits=4), "palette8": dict(photo=3, bits=8),
    "palette8-tiles": dict(photo=3, bits=8, tile=(16, 16)), "palette-alpha": dict(photo=3, bits=8, spp=2, extra=(2,)),
    "cmyk8": dict(photo=5, bits=8, spp=4), "cmyk8-planar": dict(photo=5, bits=8, spp=4, planar=2),
    "cmyk16": dict(photo=5, bits=16, spp=4),
}
COMPRESSIONS = {"none": 1, "packbits": 32773, "lzw": 5, "deflate": 8, "adobe-deflate": 32946}
# predictor 2 is a matter of LZW and Deflate only (libtiff ignores it otherwise)
TIFF_CASES = [(c, comp) for c in sorted(TIFF) for comp in COMPRESSIONS
              if ("predictor" not in c or comp in ("lzw", "deflate", "none")) and (comp in ("none", "lzw")
                                                                                    or c in ("rgb8", "grey16",
                                                                                             "palette4",
                                                                                             "rgba-associated",
                                                                                             "rgb8-tiles"))]


@pytest.mark.parametrize("case,comp", TIFF_CASES, ids=[f"{c}-{k}" for c, k in TIFF_CASES])
def test_tiff(tmp_path, case, comp):
    assert_reads_like_pillow(tiff_case(case, COMPRESSIONS[comp]), tmp_path, "a.tif")


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "I;16", "RGB", "RGBA", "CMYK"])
@pytest.mark.parametrize("compression", ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"])
def test_pillow_tiff(tmp_path, mode, compression):
    """Pillow's own TIFFs (libtiff writes the compressed ones)."""
    img = Image.fromarray(smooth_image(21, 34, seed=6, noise=30))
    im = {"P": lambda: img.quantize(50), "I;16": lambda: Image.fromarray(
        np.asarray(img)[..., 0].astype(np.uint16) * 300)}.get(mode, lambda: img.convert(mode))()
    assert_reads_like_pillow(pillow_file(im, "TIFF", compression=compression), tmp_path, "p.tif")


# ---------------------------------------------------------------------------
# one property test over sizes and variants
# ---------------------------------------------------------------------------


@settings(max_examples=16, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16),
       kind=st.sampled_from(["arith", "smoothed", "lossless", "bmp", "gif", "tiff"]),
       pick=st.integers(0, 10**6))
def test_hypothesis_containers(tmp_path_factory, h, w, seed, kind, pick):
    tmp = tmp_path_factory.mktemp("cont")
    if kind == "arith":
        case = sorted(ARITH)[pick % len(ARITH)]
        data = arith_file(case, hw=(h, w), seed=seed)
    elif kind == "smoothed":
        full = pillow_jpeg(smooth_image(h, w, seed=seed, noise=30), progressive=True, subsampling=pick % 3)
        data = drop_scans(full, 1 + pick % (len(jpeg_parts(full)[1]) - 1))
    elif kind == "lossless":
        factors = [[(1, 1)], [(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(1, 1)] * 4][pick % 4]
        data = lossless_jpeg(lossless_planes((h, w), factors, seed), factors, psv=1 + pick % 7, pt=pick % 3,
                             size=(h, w))
    elif kind == "bmp":
        data = bmp_case(sorted(BMP)[pick % len(BMP)], hw=(h, w), seed=seed)
    elif kind == "gif":
        case = sorted(c for c in GIF if not GIF[c].get("noise"))[pick % (len(GIF) - 2)]
        data = gif_case(case, seed=seed)
    else:
        case, comp = TIFF_CASES[pick % len(TIFF_CASES)]
        data = tiff_case(case, COMPRESSIONS[comp], hw=(h, w), seed=seed)
    assert_reads_like_pillow(data, tmp)


# ---------------------------------------------------------------------------
# what stays refused: by name, and by Pillow where it refuses too
# ---------------------------------------------------------------------------

SMALL = smooth_image(16, 16, seed=1)


def _sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def _bmp_header_size(n: int) -> bytes:
    data = bytearray(bmp_case("24bit"))
    data[14:18] = struct.pack("<I", n)
    return bytes(data)


def _bmp_compression(comp: int, bits=24) -> bytes:
    data = bytearray(bmp_case("24bit"))
    data[28:30], data[30:34] = struct.pack("<H", bits), struct.pack("<I", comp)
    return bytes(data)


def _tiff_tags(case: str, tags: dict) -> bytes:
    """TIFF[case] with `tags` (SHORT values) set over the writer's."""
    return tiff_case(case, more_tags=[(t, 3, [v]) for t, v in tags.items()])


def _webp() -> bytes:
    return pillow_file(Image.fromarray(SMALL), "WEBP")


REFUSED = {
    # (bytes, message, Pillow refuses it too)
    "jpeg-12-bit": (lambda: encode(SMALL, sof=0xC1, precision=12), "sample precision", True),
    "jpeg-hierarchical-sof5": (lambda: _sof(encode(SMALL), 0xC5), "hierarchical JPEG", True),
    "jpeg-hierarchical-sof13": (lambda: _sof(encode(SMALL), 0xCD), "hierarchical JPEG", True),
    "jpeg-arithmetic-lossless": (lambda: _sof(encode(SMALL), 0xCB), "arithmetic-coded lossless JPEG", True),
    "jpeg-lossless-12-bit": (lambda: lossless_jpeg([SMALL[..., 0]], [(1, 1)], precision=12), "sample precision",
                             True),
    "jpeg-lossless-ycbcr": (lambda: lossless_jpeg([SMALL[..., i] for i in range(3)], [(1, 1)] * 3, jfif=True),
                            "lossless JPEG in YCbCr", True),
    "jpeg-lossless-ycck": (lambda: lossless_jpeg([SMALL[..., i % 3] for i in range(4)], [(1, 1)] * 4, adobe=2),
                           "lossless JPEG in YCbCr or YCCK", True),
    "jpeg-arithmetic-truncated": (lambda: encode(SMALL, sof=0xC9)[:-30], "ends early|corrupt", False),
    "bmp-header-size": (lambda: _bmp_header_size(20), "BMP header size 20", True),
    "bmp-depth-2": (lambda: _bmp_compression(0, bits=2), "BMP pixel depth 2", True),
    "bmp-jpeg": (lambda: _bmp_compression(4), "BI_JPEG", True),
    "bmp-png": (lambda: _bmp_compression(5), "BI_PNG", True),
    "bmp-bitfields-layout": (lambda: bmp_file(rand((4, 8), 1), 16, 4, 4, masks=(0xF00, 0xF0, 0xF), compression=3,
                                              masks_after=True), "bitfields layout", True),
    "bmp-truncated": (lambda: bmp_case("24bit")[:-100], "truncated BMP", True),
    "bmp-4bit-grey-palette": (lambda: bmp_file(_pack(rand((13, 21), 3, 16), 4), 4, 21, 13, palette=GREY_RAMP),
                              "BMP rows shorter", True),
    "gif-no-image": (lambda: b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0) + b";", "GIF without an image", True),
    "gif-corrupt-lzw": (lambda: gif_file(np.zeros((4, 4), int), palette=PAL16[:4], min_size=2,
                                         lzw=bytes([0x04, 0xFF, 0xFF, 0xFF])), "corrupt LZW", True),
    "tiff-jpeg": (lambda: _tiff_tags("rgb8", {259: 7}), "TIFF JPEG decode failed: not a JPEG stream", True),
    "tiff-float": (lambda: _tiff_tags("grey8", {339: 3}), r"SampleFormat \(3,\), FillOrder 1, bits \(8,\)", True),
    "tiff-sgilog": (lambda: _tiff_tags("rgb8", {259: 34676}),
                    r"TIFF with SGILog compression is not supported \(PIL refuses it too", True),
    "tiff-webp": (lambda: _tiff_tags("rgb8", {259: 50001}), "TIFF with WebP compression", True),
    "tiff-rgb16-fill-order-2": (lambda: tiff_case("rgb16", more_tags=[(266, 3, [2])]), "unknown pixel mode", True),
    "bigtiff-big-endian": (lambda: b"MM\x00+\x00\x08\x00\x00" + bytes(32), "big-endian BigTIFF", True),
    "tiff-grey16-min-is-white-mm": (lambda: tiff_file(rand((5, 6, 1), 2, 4000, np.int64), 0, 16, order=">"),
                                    "pixel layout", True),
    "tiff-predictor-3": (lambda: tiff_file(rand((5, 6, 3), 2), 2, 8, compression=5, predictor=3), "predictor 3",
                         True),
    "webp-first-chunk-alph": (lambda: _webp()[:12] + b"ALPH" + _webp()[16:], "first chunk is b'ALPH'", True),
    "webp-truncated": (lambda: _webp()[:40], "truncated WebP file", True),
    "jpeg2000": (lambda: b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40), "JPEG 2000 is not supported", False),
    "jpeg2000-codestream": (lambda: b"\xff\x4f\xff\x51" + bytes(40), r"JPEG 2000 \(codestream\) is not supported",
                            False),
    "unknown": (lambda: b"P6\n2 2\n255\n" + bytes(12), "not a PNG, JPEG, BMP, GIF, TIFF or WebP file", False),
}


def _tiff_coded(case: str, compression: int, coder) -> bytes:
    """TIFF[case]'s samples (as tiff_case writes them) with their strips
    coded by `coder` and stored as `compression`."""
    COMPRESS[compression] = coder
    try:
        return tiff_case(case, compression)
    finally:
        del COMPRESS[compression]


def _grey4_rows(raw: bytes, w: int = 22) -> np.ndarray:
    """The 4-bit pixels [rows, w] of a strip packed two a byte."""
    b = np.frombuffer(raw, np.uint8).reshape(-1, (w + 1) // 2)
    return np.stack([b >> 4, b & 15], axis=2).reshape(b.shape[0], -1)[:, :w]


# refused before the port read TIFF's LZMA, ZSTD, old-style JPEG and
# ThunderScan compressions, decoded now: the same files as their refusals
# checked (TIFF["rgb8"] and TIFF["grey4-min-is-white"]), their strips coded
# as the compression tag says, equal to Pillow and to the JAX loader
DECODED_NOW = {
    "tiff-lzma": lambda: _tiff_coded("rgb8", 34925, lzma.compress),
    "tiff-zstd": lambda: _tiff_coded("rgb8", 50000, lambda b: tc.zstd_frame([("raw", b)])),
    "tiff-old-style-jpeg": lambda: tc.ojpeg_tiff(smooth_image(13, 22, seed=0, noise=30), layout="strips"),
    "tiff-thunderscan": lambda: _tiff_coded("grey4-min-is-white", 32809, lambda b: tc.thunderscan(_grey4_rows(b))),
}


@pytest.mark.parametrize("case", sorted(REFUSED) + sorted(DECODED_NOW))
def test_refusals_name_the_feature(tmp_path, case):
    """The port's decode and loader raise a ValueError naming what is not
    read, and the message says what the port reads; Pillow raises on the
    same bytes where the port's refusal is PIL's own. The cases of
    DECODED_NOW decode as Pillow decodes them."""
    if case in DECODED_NOW:
        assert_reads_like_pillow(DECODED_NOW[case](), tmp_path, "now.tif")
        return
    make, message, pillow_refuses = REFUSED[case]
    data = make()
    path = str(tmp_path / "refused")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=message):
        pnc.decode(path)
    rec = {"file_name": path}
    with pytest.raises(ValueError, match=message):
        DetectionLoader([rec], **LOADER_KW)._prep_image(rec)
    if pillow_refuses:
        with pytest.raises(Exception):
            pillow_rgb(data)


def test_refusals_say_what_the_port_reads(tmp_path):
    for case in ("jpeg2000-codestream", "jpeg2000"):
        with pytest.raises(ValueError, match="the port reads PNG, JPEG, BMP, GIF, TIFF and WebP"):
            pnc.decode_bytes(REFUSED[case][0]())
        (tmp_path / case).write_bytes(REFUSED[case][0]())
        with pytest.raises(ValueError, match="is not supported"):
            pnc.image_size(str(tmp_path / case))


# ---------------------------------------------------------------------------
# the metrics toolkit and GUI on BMP images (the port's sizes came from
# image_size, which read only PNG and JPEG)
# ---------------------------------------------------------------------------


def _bmp_images(img_dir: str, sizes: dict) -> None:
    """The toolkit scene's images as 24-bit BMP files."""
    for stem, (w, h) in sizes.items():
        for ext in (".png", ".jpg"):
            p = os.path.join(img_dir, stem + ext)
            if os.path.exists(p):
                os.remove(p)
        rows = rand((h, w * 3), len(stem) + w)
        with open(os.path.join(img_dir, stem + ".bmp"), "wb") as f:
            f.write(bmp_file(rows, 24, w, h))


@pytest.mark.parametrize("gt_fmt,det_fmt", [("yolo", "yolo"), ("abs-xywh", "yolo")])
def test_toolkit_scores_txt_dirs_with_bmp_images(tmp_path, gt_fmt, det_fmt):
    """YOLO coordinates relative to BMP images' sizes: the port's toolkit
    reads what the JAX toolkit reads and scores it the same."""
    from simple_sfod_tpu.evaluation import runner as jax_runner
    from simple_sfod_tpu_torch.evaluation import runner
    from test_torch_metrics_toolkit import SIZES, assert_same, write_pair

    kw = write_pair(tmp_path, gt_fmt, det_fmt)
    _bmp_images(kw["images_dir"], SIZES)
    want = jax_runner.load_inputs(**kw)
    got = runner.load_inputs(**kw)
    assert got == want
    args = dict(metrics=("coco", "voc", "f1"), want_curves=True)
    w_res, w_curves = jax_runner.run_metrics(*want, **args)
    g_res, g_curves = runner.run_metrics(*got, **args)
    assert_same(g_res, w_res)
    assert_same(g_curves, w_curves, where="curves")
    assert 0 < g_res["coco"]["AP50"] < 100


def test_gui_overlay_at_a_bmp_images_size(tmp_path):
    """The image browser's overlay on a BMP image: the true size (the JAX
    GUI's, from PIL), not a stand-in 640x480; the pages byte-equal."""
    from simple_sfod_tpu.evaluation import gui as jax_gui
    from simple_sfod_tpu_torch.evaluation import gui
    from test_torch_metrics_toolkit import SIZES, write_pair

    kw = write_pair(tmp_path, "coco", "coco")
    _bmp_images(kw["images_dir"], SIZES)
    state = {"gt": kw["gt"], "gt_format": "coco", "det": kw["det"], "det_format": "coco",
             "img_dir": kw["images_dir"], "names": "", "iou": "0.5", "voc_method": "all_point"}
    files = sorted(os.listdir(kw["images_dir"]))
    assert all(f.endswith(".bmp") for f in files)
    for i, f in enumerate(files):
        w, h = SIZES[os.path.splitext(f)[0]]
        for which in ("gt", "det"):
            page = gui.view_page(dict(state), which, i)
            assert page == jax_gui.view_page(dict(state), which, i)
            assert f"viewBox='0 0 {w} {h}'" in page


# ---------------------------------------------------------------------------
# the committed fixtures (decoded on the card's host by chip_smoke.py)
# ---------------------------------------------------------------------------


def fixture_files() -> dict:
    """name -> (a function giving the bytes, a label) of every committed
    container fixture."""
    return {
        "bmp_rle8_delta.bmp": (lambda: bmp_case("rle8-delta", hw=(24, 40)), "BMP RLE8"),
        "bmp_rle4_odd.bmp": (lambda: bmp_case("rle4-odd-absolute", hw=(24, 40)), "BMP RLE4"),
        "bmp_core12_4bit.bmp": (lambda: bmp_case("core12-4bit", hw=(24, 40)), "BMP OS/2 4-bit"),
        "bmp_565_v4.bmp": (lambda: bmp_case("16bit-bitfields-565", hw=(24, 40)), "BMP 5-6-5"),
        "bmp_rgba_v5_top_down.bmp": (lambda: bmp_file(rand((24, 160), 3), 32, 40, 24, header=124, top_down=True,
                                                       masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), compression=3),
                                     "BMP 32-bit alpha"),
        "gif_interlaced_offset.gif": (lambda: gif_file(np.repeat(rand((21, 9), 4, 16), 4, 1)[:, :33], palette=PAL16,
                                                        offset=(3, 5), screen=(40, 30), interlace=True,
                                                        transparency=2), "GIF"),
        "gif_grey_ramp.gif": (lambda: gif_case("grey-ramp-global"), "GIF L"),
        "tiff_rgb_lzw_predictor.tif": (lambda: tiff_case("rgb8-predictor", 5, hw=(24, 40)), "TIFF LZW"),
        "tiff_planar_tiles_deflate.tif": (lambda: tiff_case("rgb8-planar-tiles", 8, hw=(24, 40)), "TIFF Deflate"),
        "tiff_palette_packbits_mm.tif": (lambda: tiff_file(np.repeat(rand((24, 20, 1), 5, 16), 2, 1), 3, 4,
                                                           order=">", compression=32773,
                                                           colormap=rand((16, 3), 6, 65536, np.int64)),
                                         "TIFF PackBits"),
        "tiff_rgba_associated.tif": (lambda: tiff_case("rgba-associated", 1, hw=(24, 40)), "TIFF RGBa"),
        "tiff_grey16_mm.tif": (lambda: tiff_case("grey16-big-endian", 32946, hw=(24, 40)), "TIFF I;16B"),
        "tiff_cmyk.tif": (lambda: tiff_case("cmyk8", 1, hw=(24, 40)), "TIFF CMYK"),
    }


def write_fixtures(directory: str) -> dict:
    """Write the fixtures and fixtures.json: each file's shape, label and
    the SHA-256 of Pillow's RGB."""
    os.makedirs(directory, exist_ok=True)
    record = {}
    for name, (make, label) in sorted(fixture_files().items()):
        data = make()
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        ref, _ = pillow_rgb(data)
        record[name] = {"shape": list(ref.shape), "kind": label, "bytes": len(data), "decoder": DECODER,
                        "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}
    with open(os.path.join(directory, "fixtures.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    return record


def test_committed_fixtures_match_their_digests():
    """Each committed container fixture: the port's RGB and Pillow's hash to
    the recorded SHA-256, and the writers here still write the same bytes."""
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        record = json.load(f)
    files = fixture_files()
    assert sorted(record) == sorted(files)
    for name, rec in record.items():
        path = os.path.join(FIXTURES, name)
        data = open(path, "rb").read()
        assert data == files[name][0](), name
        got = pnc.decode(path)
        assert list(got.shape) == rec["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"], name
        assert hashlib.sha256(pillow_rgb(data)[0].tobytes()).hexdigest() == rec["sha256"], name


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        print(json.dumps(write_fixtures(FIXTURES), indent=1))
