"""TIFF's last compressions as Pillow 12.1 reads them, against the port's
decoder, tolerance 0: old-style (LSB-first) LZW, LZMA (an .xz stream a
strip, data/csrc/xz.cpp), ZSTD (a zstd frame a strip, data/csrc/zstd.cpp),
old-style JPEG (compression 6, tif_ojpeg.c's stream rebuilt and decoded by
the port's JPEG decoder into libjpeg's raw components) and ThunderScan;
SGILog refused as Pillow refuses it.

Each parity case holds `native_codec.decode`, `decode_bytes` and
`image_size` to Pillow and the loader's `_prep_image` to the JAX loader's
(which opens TIFF with PIL). Files come from Pillow's writer where it writes
the variant (LZMA and ZSTD, predictors 1-3), from Python's lzma for the .xz
options libtiff never writes (presets, checks, Delta, lc/lp/pb, several
blocks, concatenated streams), and from tests/torch_tiff_coders.py for the
rest (old-style LZW, ThunderScan, old-style JPEG, hand-made zstd frames).
Damaged files (seeded bit flips and short strips) are held to Pillow's
outcome case by case: the same pixels where Pillow gives pixels, a
ValueError where it raises; the old-style JPEG deviations the port's JPEG
decoder brings (it refuses where libjpeg warns, and its C-exact IDCT gives
other pixels on some corrupt coefficients, as on bare JPEG files) are
pinned case by case in OJPEG_DAMAGE.
"""

import io
import lzma
import os
import struct
import sys
import types

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

import torch_tiff_coders as tc  # noqa: E402
from simple_sfod_tpu_torch.data import native_codec as pnc  # noqa: E402
from test_torch_image_containers import (  # noqa: E402,F401  (jax_loader_through_pil: autouse)
    assert_reads_like_pillow, jax_loader_through_pil, pillow_file, tiff_lzw)
from test_torch_jpeg import smooth_image  # noqa: E402
from test_torch_tiff import assert_agrees, outcome, strip_of  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = smooth_image(24, 40, seed=7, noise=25)
NOISE = np.random.default_rng(3).integers(0, 256, (64, 80, 3)).astype(np.uint8)


def _frame_crop(h=48, w=160) -> np.ndarray:
    with Image.open(os.path.join(ROOT, "tests", "torch_jpeg", "sim10k_frame_0.jpg")) as im:
        return np.asarray(im.convert("RGB"))[300:300 + h, 600:600 + w]


def with_strip_bytes(data: bytes, n: int) -> bytes:
    """A little-endian classic TIFF of one strip with its StripByteCounts
    set to n (the strip cut short as a writer that stopped early leaves it)."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (count,) = struct.unpack_from("<H", data, ifd)
    out = bytearray(data)
    for i in range(count):
        at = ifd + 2 + 12 * i
        tag, typ = struct.unpack_from("<HH", data, at)
        if tag == 279:
            struct.pack_into("<H" if typ == 3 else "<I", out, at + 8, n)
            return bytes(out)
    raise AssertionError("no StripByteCounts")


# ---------------------------------------------------------------------------
# old-style LZW (libtiff's LZWDecodeCompat): refused by name before
# ---------------------------------------------------------------------------

def _mixed_lzw(old_first: bool) -> bytes:
    """Strips coded old and new style in turn."""
    k = [0]

    def code(b):
        k[0] += 1
        return tc.lzw_compat(b) if k[0] % 2 == old_first else tiff_lzw(b)

    return tc.tiff(IMG, 2, 8, code, 5, rows_per_strip=5)


LZW_OLD = {
    "rgb8": lambda: tc.tiff(IMG, 2, 8, tc.lzw_compat, 5),
    "rgb8-predictor-2": lambda: tc.tiff(IMG, 2, 8, tc.lzw_compat, 5, predictor=2),
    "grey16-predictor-2": lambda: tc.tiff(IMG[..., :1].astype(np.int64) * 257, 1, 16, tc.lzw_compat, 5, predictor=2),
    "palette4": lambda: tc.tiff(IMG[..., :1] >> 4, 3, 4, tc.lzw_compat, 5,
                                colormap=np.arange(48).reshape(16, 3) * 1300),
    "tiles": lambda: tc.tiff(IMG, 2, 8, tc.lzw_compat, 5, tile=(16, 16)),
    "fill-order-2": lambda: tc.tiff(IMG, 2, 8, tc.lzw_compat, 5, fill_order=2),
    "clear-every-600": lambda: tc.tiff(NOISE, 2, 8, lambda b: tc.lzw_compat(b, clear_at=600), 5, rows_per_strip=64),
    "no-eoi": lambda: tc.tiff(IMG, 2, 8, lambda b: tc.lzw_compat(b)[:-1], 5),
}


@pytest.mark.parametrize("case", sorted(LZW_OLD))
def test_lzw_old_style(tmp_path, case):
    assert_reads_like_pillow(LZW_OLD[case](), tmp_path, "lzw.tif")


@pytest.mark.parametrize("old_first", [True, False])
def test_lzw_style_is_the_first_strips(tmp_path, old_first):
    """libtiff's LZWPreDecode picks the style at the first strip and decodes
    every later strip in it, so strips of the other style come out wrong:
    the port agrees with Pillow's outcome."""
    data = _mixed_lzw(old_first)
    assert outcome(data) is None
    assert_agrees(data, tmp_path, "mixed.tif")


def test_lzw_old_style_past_every_width():
    """One strip whose table grows through 512, 1024 and 2048 entries to the
    clear at 4093: old style widens a code later than new style, so a
    decoder that widens early misreads it from the 511th entry on."""
    widths = set()
    data = tc.tiff(NOISE, 2, 8, lambda b: tc.lzw_compat(b, widths=widths), 5, rows_per_strip=64)
    assert widths == {9, 10, 11, 12}
    np.testing.assert_array_equal(pnc.decode_bytes(data), NOISE)
    np.testing.assert_array_equal(outcome(data), NOISE)


def test_lzw_old_style_short_strip(tmp_path):
    """Codes that end before the strip's bytes: libtiff's "Not enough
    data", refused by both."""
    data = tc.tiff(IMG, 2, 8, lambda b: tc.lzw_compat(b[:len(b) // 2]), 5)
    assert outcome(data) is None
    with pytest.raises(ValueError, match="corrupt or short TIFF lzw"):
        pnc.decode_bytes(data)


# ---------------------------------------------------------------------------
# LZMA: Pillow's writer (an .xz stream a strip, check None) and Python's
# xz writer for the options libtiff does not use
# ---------------------------------------------------------------------------

def _pillow_image(mode: str) -> Image.Image:
    img = Image.fromarray(IMG)
    if mode == "P":
        return img.quantize(40)
    if mode == "I;16":
        return Image.fromarray(IMG[..., 0].astype(np.uint16) * 251)
    if mode == "F":
        return Image.fromarray(IMG[..., 0].astype(np.float32) * 1.7 - 90.25, "F")
    return img.convert(mode)


PILLOW_MODES = [(m, p) for m in ("1", "L", "P", "I;16", "RGB", "RGBA", "CMYK", "F") for p in (1, 2, 3)
                if (p == 1 or m not in ("1", "P", "F")) and (p != 3 or m == "F") and (p != 2 or m != "F")]


@pytest.mark.parametrize("compression", ["lzma", "zstd"])
@pytest.mark.parametrize("mode,predictor", PILLOW_MODES)
def test_pillow_writer(tmp_path, compression, mode, predictor):
    """Pillow's own LZMA and ZSTD TIFFs (libtiff writes them), predictors 2
    and 3 included: libtiff predicts after LZMA and ZSTD as after LZW."""
    kw = {"tiffinfo": {317: predictor}} if predictor != 1 else {}
    data = pillow_file(_pillow_image(mode), "TIFF", compression=compression, **kw)
    assert assert_reads_like_pillow(data, tmp_path, "p.tif") is not None


@pytest.mark.parametrize("compression", ["lzma", "zstd"])
@pytest.mark.parametrize("rows", [1, 5, 64])
def test_pillow_writer_strips(tmp_path, compression, rows):
    data = pillow_file(Image.fromarray(_frame_crop()), "TIFF", compression=compression, tiffinfo={278: rows, 317: 2})
    assert_reads_like_pillow(data, tmp_path, "s.tif")


XZ_CHECKS = {"none": lzma.CHECK_NONE, "crc32": lzma.CHECK_CRC32, "crc64": lzma.CHECK_CRC64,
             "sha256": lzma.CHECK_SHA256}
XZ_PRESETS = {"0": 0, "6": 6, "9e": 9 | lzma.PRESET_EXTREME}


def _xz(compress, img=IMG, **kw) -> bytes:
    return tc.tiff(img, 2, 8, compress, 34925, **kw)


def _lzma2(**opts):
    return lambda b: lzma.compress(b, filters=[{"id": lzma.FILTER_LZMA2, **opts}])


XZ = {
    **{f"preset-{p}-check-{c}": (lambda p=p, c=c: _xz(lambda b: lzma.compress(b, preset=XZ_PRESETS[p],
                                                                             check=XZ_CHECKS[c]), rows_per_strip=7))
       for p in XZ_PRESETS for c in XZ_CHECKS},
    "delta-3": lambda: _xz(lambda b: lzma.compress(b, filters=[{"id": lzma.FILTER_DELTA, "dist": 3},
                                                               {"id": lzma.FILTER_LZMA2}])),
    "delta-256": lambda: _xz(lambda b: lzma.compress(b, filters=[{"id": lzma.FILTER_DELTA, "dist": 256},
                                                                 {"id": lzma.FILTER_LZMA2}])),
    **{f"lc{lc}-lp{lp}-pb{pb}": (lambda lc=lc, lp=lp, pb=pb: _xz(_lzma2(lc=lc, lp=lp, pb=pb)))
       for lc, lp, pb in ((0, 0, 0), (4, 0, 4), (1, 3, 1), (0, 4, 2), (2, 2, 0))},
    "dictionary-4k": lambda: _xz(_lzma2(dict_size=4096), img=NOISE),
    "uncompressed-chunks": lambda: _xz(lambda b: lzma.compress(b, preset=0), img=NOISE, rows_per_strip=64),
    "tiles": lambda: _xz(lambda b: lzma.compress(b, check=lzma.CHECK_CRC64), tile=(16, 16)),
    "three-blocks-crc64": lambda: _xz(lambda b: tc.xz_blocks([b[:100], b[100:1000], b[1000:]]), rows_per_strip=24),
    "three-blocks-sha256": lambda: _xz(lambda b: tc.xz_blocks([b[:7], b[7:], b"tail"], check=lzma.CHECK_SHA256),
                                       rows_per_strip=24),
    "three-blocks-none": lambda: _xz(lambda b: tc.xz_blocks([b[:1], b[1:2], b[2:]], check=lzma.CHECK_NONE)),
    # concatenated streams: libtiff sets no LZMA_CONCATENATED, so a strip
    # is read from its first stream alone
    "two-streams-first-whole": lambda: _xz(lambda b: lzma.compress(b) + bytes(8) + lzma.compress(b"more")),
    "two-streams-split": lambda: _xz(lambda b: lzma.compress(b[:50]) + bytes(4) + lzma.compress(b[50:])),
    "more-data-than-the-strip": lambda: _xz(lambda b: lzma.compress(b + bytes(range(256)) * 4)),
    "lzma-alone": lambda: _xz(lambda b: lzma.compress(b, format=lzma.FORMAT_ALONE)),
    "raw-lzma2": lambda: _xz(lambda b: lzma.compress(b, format=lzma.FORMAT_RAW, filters=[{"id": lzma.FILTER_LZMA2}])),
}


@pytest.mark.parametrize("case", sorted(XZ))
def test_xz_stream(tmp_path, case):
    """Each .xz variant: the same pixels as Pillow, or a ValueError naming
    LZMA where Pillow raises (a second stream, a foreign format)."""
    data = XZ[case]()
    if assert_agrees(data, tmp_path, "x.tif") is None:
        with pytest.raises(ValueError, match="TIFF LZMA decode failed"):
            pnc.decode_bytes(data)
    assert (outcome(data) is None) == (case in ("two-streams-split", "lzma-alone", "raw-lzma2"))


# the BCJ filters by their .xz IDs; Python's lzma names the first six,
# the liblzma Pillow bundles writes all eight (torch_tiff_coders.liblzma_xz)
BCJ = {"x86": 4, "PowerPC": 5, "IA-64": 6, "ARM": 7, "ARM-Thumb": 8, "SPARC": 9, "ARM64": 10, "RISC-V": 11}


@pytest.mark.parametrize("start", [None, 4096])
@pytest.mark.parametrize("name", sorted(BCJ))
def test_xz_bcj_filters(tmp_path, name, start):
    """Each BCJ filter, with and without a start offset, over noise (which
    holds each filter's instruction patterns) in strips that end inside a
    block: the port reads what Pillow reads."""
    data = _xz(lambda b: tc.liblzma_xz(b, [(BCJ[name], start)]), img=NOISE, rows_per_strip=21)
    assert_reads_like_pillow(data, tmp_path, "bcj.tif")


# chains of up to three filters before LZMA2 ([(id, Delta's distance or a
# BCJ filter's start offset)]), undone in reverse
XZ_CHAINS = {
    "x86-delta": [(4, None), (3, 3)],
    "delta-delta": [(3, 1), (3, 3)],
    "delta-arm64-riscv": [(3, 2), (10, None), (11, 64)],
}


@pytest.mark.parametrize("case", sorted(XZ_CHAINS))
def test_xz_filter_chains(tmp_path, case):
    data = _xz(lambda b: tc.liblzma_xz(b, XZ_CHAINS[case]), img=NOISE, rows_per_strip=21)
    assert_reads_like_pillow(data, tmp_path, "chain.tif")


# ---------------------------------------------------------------------------
# ZSTD: Pillow's writer over contents that reach each literals and
# sequences mode, and hand-made frames
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(5)
ZSTD_CONTENT = {
    "flat": np.full((24, 40, 3), 90, np.uint8),
    "gradient": np.stack([*np.mgrid[:24, :40] * (3, 5)[0], np.full((24, 40), 7)], -1).astype(np.uint8),
    "noise": NOISE,
    "crop": _frame_crop(),
    "few-values": _rng.choice([0, 1, 2, 3], (128, 128, 1), p=[.7, .1, .1, .1]).astype(np.uint8),
    "rows-of-runs": np.repeat(_rng.integers(0, 256, (128, 1, 1)), 200, axis=1).astype(np.uint8),
}
ZSTD_PILLOW = [(c, p, one) for c in sorted(ZSTD_CONTENT) for p in (1, 2) for one in (False, True)]


def _zstd_pillow(content: str, predictor: int, one_strip: bool) -> bytes:
    img = ZSTD_CONTENT[content]
    info = {317: predictor} if predictor != 1 else {}
    if one_strip:
        info[278] = img.shape[0]
    return pillow_file(Image.fromarray(img[..., 0] if img.shape[2] == 1 else img), "TIFF", compression="zstd",
                       tiffinfo=info)


@pytest.mark.parametrize("content,predictor,one_strip", ZSTD_PILLOW)
def test_zstd_pillow(tmp_path, content, predictor, one_strip):
    assert_reads_like_pillow(_zstd_pillow(content, predictor, one_strip), tmp_path, "z.tif")


def _strips(data: bytes) -> list:
    with Image.open(io.BytesIO(data)) as im:
        return [data[o:o + c] for o, c in zip(im.tag_v2[273], im.tag_v2[279])]


# what the hand-made frames below reach beside Pillow's writer
ZSTD_MODES = {"block-raw", "block-rle", "block-compressed", "literals-raw", "literals-rle", "literals-huffman-1",
              "literals-huffman-4", "literals-treeless-1", "literals-treeless-4", "huffman-fse", "huffman-direct",
              "sequences-none",
              "ll-predefined", "ll-rle", "ll-fse", "ll-repeat", "of-predefined", "of-rle", "of-fse", "of-repeat",
              "ml-predefined", "ml-rle", "ml-fse", "ml-repeat", "checksum", "content-size", "single-segment"}


def test_zstd_cases_reach_every_mode():
    """The frames of this file's ZSTD cases, read from their block and
    section headers (torch_tiff_coders.zstd_modes), reach every mode of
    ZSTD_MODES."""
    seen = set()
    for case in ZSTD_PILLOW:
        for s in _strips(_zstd_pillow(*case)):
            seen |= tc.zstd_modes(s)
    for case in ZSTD_FRAMES:
        for s in _strips(ZSTD_FRAMES[case]()):
            seen |= tc.zstd_modes(s)
    assert ZSTD_MODES <= seen, sorted(ZSTD_MODES - seen)


# a compressed block of raw literals "abcd" and one sequence (literal
# length 4, offset 4, match length 124) with RLE tables for all three codes
RLE_SEQUENCES = bytes([4 << 3, *b"abcd", 1, 0x54, 4, 2, 42, 0xF9])
RLE_LITERALS = bytes([0x05, 0x08, 201, 0])  # 128 literals of 201, no sequences


def _grey(raw: bytes, w: int = 16) -> np.ndarray:
    return np.frombuffer(raw, np.uint8).reshape(-1, w, 1)


def _zstd_tiff(frame_of, img=IMG, **kw) -> bytes:
    return tc.tiff(img, 2 if img.shape[2] == 3 else 1, 8, frame_of, 50000, **kw)


def _raw_blocks(b: bytes, n: int = 3) -> list:
    cut = [len(b) * k // n for k in range(n + 1)]
    return [("raw", b[cut[k]:cut[k + 1]]) for k in range(n)]


def _runs(b: bytes) -> list:
    """b as RLE blocks of its runs (raw blocks for runs of one)."""
    out, i = [], 0
    while i < len(b):
        j = i
        while j < len(b) and b[j] == b[i]:
            j += 1
        out.append(("rle", b[i], j - i) if j - i > 1 else ("raw", b[i:j]))
        i = j
    return out


def _zstandard(level: int):
    import zstandard  # the tests' own writer, for frames of several blocks

    return lambda b: zstandard.ZstdCompressor(level=level).compress(b)


def _words(h: int = 625, w: int = 640) -> np.ndarray:
    words = np.random.default_rng(1).choice([b"abc", b"defg", b"hij", b"klmnop", b"q"], h * w // 2)
    return _grey(b"".join(words)[:h * w], w)


ZSTD_FRAMES = {
    # frames of several compressed blocks from libzstd at level 9: treeless
    # literals and the repeat modes of the sequences' codes
    "zstandard-9-frame-rows": lambda: tc.tiff(_frame_crop(200, 1914), 2, 8, _zstandard(9), 50000, rows_per_strip=200),
    "zstandard-9-quantised": lambda: tc.tiff(_frame_crop(300, 800) // 16 * 16, 2, 8, _zstandard(9), 50000,
                                             rows_per_strip=300),
    "zstandard-9-words": lambda: tc.tiff(_words(), 1, 8, _zstandard(9), 50000, rows_per_strip=625),
    "raw-blocks": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b))),
    "rle-blocks": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_runs(b)), img=ZSTD_CONTENT["rows-of-runs"][:8, :40]),
    "checksum": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), checksum=True)),
    "content-size": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), content_size=len(b))),
    "single-segment": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b, 1), content_size=len(b), single=True),
                                         rows_per_strip=2),
    "window-2^27": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), window_log=27)),
    "rle-sequences": lambda: tc.tiff(_grey(b"abcd" * 32), 1, 8, lambda b: tc.zstd_frame([
        ("compressed", RLE_SEQUENCES, b"abcd" * 32)]), 50000, rows_per_strip=8),
    "rle-literals": lambda: tc.tiff(_grey(bytes([201]) * 128), 1, 8, lambda b: tc.zstd_frame([
        ("compressed", RLE_LITERALS, bytes([201]) * 128)]), 50000, rows_per_strip=8),
    "two-frames-first-whole": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b)) + tc.zstd_frame(
        [("raw", b"junk")])),
    "more-data-than-the-strip": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b + bytes(300)))),
    # refused by libzstd or libtiff: Pillow raises, the port raises
    "checksum-wrong": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), checksum=True)[:-4] + b"\0\0\0\0"),
    "content-size-wrong": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), content_size=len(b) + 1)),
    "skippable-first": lambda: _zstd_tiff(lambda b: tc.skippable_frame(b"meta") + tc.zstd_frame(_raw_blocks(b))),
    "two-frames-split": lambda: _zstd_tiff(lambda b: tc.zstd_frame([("raw", b[:9])]) + tc.zstd_frame(
        [("raw", b[9:])])),
    "dictionary-id": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), dict_id=7)),
    "window-2^28": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), window_log=28)),
    "reserved-block": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b))[:6] + bytes([6]) + tc.zstd_frame(
        _raw_blocks(b))[7:]),
    "block-over-the-window": lambda: _zstd_tiff(lambda b: tc.zstd_frame([("raw", b)], window_log=10),
                                                img=NOISE[:16], rows_per_strip=16),
    "not-a-frame": lambda: _zstd_tiff(lambda b: b"\x00" * 8 + b),
}
ZSTD_REFUSED = {"checksum-wrong": "checksum", "content-size-wrong": "corrupt", "skippable-first": "ends before",
                "two-frames-split": "ends before", "dictionary-id": "dictionary", "window-2^28": "window",
                "reserved-block": "corrupt", "block-over-the-window": "corrupt", "not-a-frame": "not a zstd frame"}


@pytest.mark.parametrize("case", sorted(ZSTD_FRAMES))
def test_zstd_frame(tmp_path, case):
    """Hand-made frames: parity where Pillow reads them; where libzstd or
    libtiff refuse them, Pillow raises and the port raises, naming why.
    libtiff stops after a strip's first frame (a skippable one included)."""
    data = ZSTD_FRAMES[case]()
    if case in ZSTD_REFUSED:
        assert outcome(data) is None
        with pytest.raises(ValueError, match=f"TIFF ZSTD decode failed: .*{ZSTD_REFUSED[case]}"):
            pnc.decode_bytes(data)
    else:
        assert_reads_like_pillow(data, tmp_path, "f.tif")


# ---------------------------------------------------------------------------
# old-style JPEG (compression 6): tif_ojpeg.c's stream and raw components,
# Pillow's conversion through libtiff's RGBA interface (chroma replicated)
# ---------------------------------------------------------------------------

OJPEG = [(lay, sub, rps) for lay in ("jif-scan", "jif-start", "strips", "tables") for sub in (0, 1, 2)
         for rps in (None, 16) if not (lay == "jif-start" and rps)]


@pytest.mark.parametrize("layout,sub,rows", OJPEG)
def test_ojpeg(tmp_path, layout, sub, rows):
    """Each layout (the JPEG stream at JPEGInterchangeFormat with the strips
    in its scan or at its start, the markers in the first strip, or the
    tables in tags) at 4:4:4, 4:2:2 and 4:2:0, in one strip or in strips of
    one restart interval each."""
    assert_reads_like_pillow(tc.ojpeg_tiff(_frame_crop(), layout=layout, subsampling=sub, rows_per_strip=rows),
                             tmp_path, "o.tif")


@pytest.mark.parametrize("layout", ["jif-scan", "strips", "tables"])
@pytest.mark.parametrize("rows", [None, 8])
@pytest.mark.parametrize("photometric", [0, 1])
def test_ojpeg_grey(tmp_path, layout, rows, photometric):
    """One component, read as scanlines: Pillow forces photometric 6 for
    compression 6, so MinIsWhite is not inverted."""
    data = tc.ojpeg_tiff(_frame_crop(), layout=layout, grey=True, rows_per_strip=rows, photometric=photometric)
    assert_reads_like_pillow(data, tmp_path, "g.tif")


OJPEG_MORE = {
    "photometric-2": dict(photometric=2),  # libtiff takes RGB for YCbCr under compression 6
    "subsampling-tag-1x1-frame-2x2": dict(subsampling=2, subsampling_tag=(1, 1)),  # the frame's sampling stands
    "subsampling-tag-2x2-frame-1x1": dict(subsampling=0, subsampling_tag=(2, 2)),
    "subsampling-tag-2x1-frame-2x2-strips": dict(subsampling=2, subsampling_tag=(2, 1), rows_per_strip=16,
                                                 layout="strips"),
    "jpegproc-14": dict(layout="tables", more_tags=[(512, 3, [14])]),  # libtiff builds SOF0 whatever JPEGProc says
    "restart-interval-tag-one-strip": dict(layout="tables", more_tags=[(515, 3, [5])]),
    "predictor-tag": dict(more_tags=[(317, 3, [2])]),  # OJPEG runs no predictor
    "quality-30": dict(quality=30),
    "big-endian": dict(order=">"),
}


@pytest.mark.parametrize("case", sorted(OJPEG_MORE))
def test_ojpeg_tags(tmp_path, case):
    data = tc.ojpeg_tiff(_frame_crop(), **OJPEG_MORE[case])
    if case == "restart-interval-tag-one-strip":
        # a deliberate deviation: the tag's interval puts a DRI in the
        # stream, libjpeg fails on the missing RST markers, and Pillow's
        # libtiff RGBA reader (stoponerr 0) hands back the strip as zero
        # YCbCr, one colour; the port refuses the strip
        np.testing.assert_array_equal(np.unique(outcome(data).reshape(-1, 3), axis=0), [[0, 135, 0]])
        with pytest.raises(ValueError, match="old-style JPEG decode failed: corrupt JPEG data"):
            pnc.decode_bytes(data)
        return
    assert assert_agrees(data, tmp_path, "t.tif") is not None


@pytest.mark.parametrize("hw", [(37, 29), (17, 33), (8, 8)])
@pytest.mark.parametrize("sub", [0, 2])
def test_ojpeg_odd_sizes(tmp_path, hw, sub):
    rgb = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,)).astype(np.uint8)
    assert_reads_like_pillow(tc.ojpeg_tiff(rgb, subsampling=sub), tmp_path, "odd.tif")


OJPEG_REFUSED = {
    "grey-photometric-6": (dict(grey=True, photometric=6), "RGBA interface refuses YCbCr of one sample"),
    "strips-not-mcu-rows": (dict(subsampling=2, more_tags=[(278, 4, [8])]), "whole number of JPEG MCU rows"),
    "no-tables": (dict(layout="tables", more_tags=[(519, 4, [0])]), "no JPEG tables"),
    "bits-12": (dict(more_tags=[(258, 3, [12, 12, 12])]), "pixel layout|12 bits"),
}


@pytest.mark.parametrize("case", sorted(OJPEG_REFUSED))
def test_ojpeg_refused_as_pillow_refuses_it(case):
    kw, message = OJPEG_REFUSED[case]
    data = tc.ojpeg_tiff(_frame_crop(), **kw)
    assert outcome(data) is None
    with pytest.raises(ValueError, match=message):
        pnc.decode_bytes(data)


def test_ojpeg_444_is_the_bare_jpeg_and_420_replicates_chroma():
    """At 4:4:4 the file reads as Pillow reads the bare JPEG; at 4:2:0 the
    chroma is replicated over each 2x2 unit (libtiff's RGBA interface), not
    interpolated as libjpeg upsamples it, so the two differ."""
    crop = _frame_crop()
    for sub, equal in ((0, True), (2, False)):
        bare = outcome(tc.pillow_jpeg(crop, "RGB", quality=85, subsampling=sub))
        got = pnc.decode_bytes(tc.ojpeg_tiff(crop, subsampling=sub))
        assert np.array_equal(got, bare) == equal


# ---------------------------------------------------------------------------
# ThunderScan (4-bit, tif_thunder.c)
# ---------------------------------------------------------------------------

def _grey4(h, w, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.clip(np.cumsum(rng.integers(-2, 3, (h, w)), axis=1) // 2 + 8, 0, 15)
    g[h // 3] = 5
    g[1] = 0
    g[1, -1] = 2  # a run, then a lone 3-bit delta: the coder pads it with a skip
    g[h // 2, w // 3:] = 9
    g[-1, ::3] = rng.integers(0, 16, len(g[-1, ::3]))
    return g


def _thunder(g: np.ndarray, photometric: int, run_to_end=False, **kw) -> bytes:
    def code(raw):
        b = np.frombuffer(raw, np.uint8).reshape(-1, (g.shape[1] + 1) // 2)
        rows = np.stack([b >> 4, b & 15], axis=2).reshape(b.shape[0], -1)[:, :g.shape[1]]
        return tc.thunderscan(rows, run_to_end=run_to_end)

    return tc.tiff(g[..., None], photometric, 4, code, 32809, **kw)


THUNDER = [(w, p, rps, end) for w in (21, 20, 1) for p in (0, 1) for rps in (None, 3) for end in (False, True)
           if w != 1 or not end]


@pytest.mark.parametrize("width,photometric,rows,run_to_end", THUNDER)
def test_thunderscan(tmp_path, width, photometric, rows, run_to_end):
    """Every code (runs, 2- and 3-bit deltas with their skips, raw nibbles),
    odd widths, MinIsWhite and MinIsBlack, runs that end at a row's end."""
    data = _thunder(_grey4(13, width, width), photometric, rows_per_strip=rows, run_to_end=run_to_end)
    assert_reads_like_pillow(data, tmp_path, "t.tif")


@pytest.mark.parametrize("predictor", [2, 3])
def test_thunderscan_ignores_the_predictor_tag(tmp_path, predictor):
    """tif_thunder.c sets up no predictor, so Pillow reads the samples as
    coded whatever tag 317 says; so does the port."""
    data = _thunder(_grey4(13, 21, 4), 1, more_tags=[(317, 3, [predictor])])
    assert_reads_like_pillow(data, tmp_path, "p.tif")


def test_thunderscan_coder_uses_every_code():
    g = _grey4(13, 21, 21)
    codes = tc.thunderscan(g)
    kinds = {b >> 6 for b in codes}
    assert kinds == {0, 1, 2, 3}
    assert any(b >> 6 == 1 and 2 in ((b >> 4) & 3, (b >> 2) & 3, b & 3) for b in codes)  # a 2-bit skip
    assert any(b >> 6 == 2 and 4 in ((b >> 3) & 7, b & 7) for b in codes)  # a 3-bit skip


THUNDER_REFUSED = {
    "8-bit": (lambda: tc.tiff(IMG[..., :1], 1, 8, lambda b: bytes([0xC3, 5]) * 24, 32809), "at 8 bits"),
    "too-much": (lambda: tc.tiff(_grey4(4, 9, 1)[..., None], 1, 4, lambda b: bytes([0xC3, 20]) * 4, 32809),
                 "too much data"),
    "not-enough": (lambda: tc.tiff(_grey4(4, 9, 1)[..., None], 1, 4, lambda b: bytes([0xC3, 3]), 32809),
                   "not enough data"),
}


@pytest.mark.parametrize("case", sorted(THUNDER_REFUSED))
def test_thunderscan_refused_as_pillow_refuses_it(case):
    make, message = THUNDER_REFUSED[case]
    data = make()
    assert outcome(data) is None
    with pytest.raises(ValueError, match=message):
        pnc.decode_bytes(data)


# ---------------------------------------------------------------------------
# SGILog: refused, as Pillow refuses it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", [34676, 34677])
@pytest.mark.parametrize("photometric,why", [(32844, "unknown pixel mode for photometric 32844 \\(LogL\\)"),
                                             (32845, "unknown pixel mode for photometric 32845 \\(LogLuv\\)"),
                                             (1, "libtiff refuses photometric 1 for SGILog"),
                                             (2, "libtiff refuses photometric 2 for SGILog")])
def test_sgilog_refused_as_pillow_refuses_it(compression, photometric, why):
    spp = 3 if photometric in (2, 32845) else 1
    data = tc.tiff(IMG[..., :spp], photometric, 8, compression=compression)
    assert outcome(data) is None
    name = "SGILog24" if compression == 34677 else "SGILog"
    with pytest.raises(ValueError, match=f"TIFF with {name} compression is not supported \\(PIL refuses it too: "
                                         f"{why}"):
        pnc.decode_bytes(data)


# ---------------------------------------------------------------------------
# damaged files: seeded bit flips and short strips, case by case against
# Pillow
# ---------------------------------------------------------------------------

def _damage_sources() -> dict:
    crop = _frame_crop(40, 64)
    return {
        "lzma-pillow": lambda: pillow_file(Image.fromarray(crop), "TIFF", compression="lzma", tiffinfo={278: 40}),
        "xz-crc64": lambda: _xz(lambda b: lzma.compress(b, check=lzma.CHECK_CRC64), img=crop, rows_per_strip=40),
        "xz-sha256-blocks": lambda: _xz(lambda b: tc.xz_blocks([b[:3000], b[3000:]], check=lzma.CHECK_SHA256),
                                        img=crop, rows_per_strip=40),
        "zstd-pillow": lambda: pillow_file(Image.fromarray(crop), "TIFF", compression="zstd", tiffinfo={278: 40}),
        "zstd-pillow-predictor": lambda: pillow_file(Image.fromarray(np.tile(crop, (2, 2, 1))), "TIFF",
                                                     compression="zstd", tiffinfo={278: 80, 317: 2}),
        "zstd-checksum": lambda: _zstd_tiff(lambda b: tc.zstd_frame(_raw_blocks(b), checksum=True), img=crop,
                                            rows_per_strip=40),
        "ojpeg-jif-scan": lambda: tc.ojpeg_tiff(crop, layout="jif-scan", subsampling=2),
        "ojpeg-strips": lambda: tc.ojpeg_tiff(crop, layout="strips", subsampling=0, rows_per_strip=16),
        "ojpeg-tables": lambda: tc.ojpeg_tiff(crop, layout="tables", subsampling=2, rows_per_strip=16),
    }


DAMAGE_FLIPS = 24
# the old-style JPEG flips where the port and Pillow part (the port's JPEG
# decoder refuses where libjpeg warns and pads; its C-exact IDCT gives other
# pixels than Pillow's libjpeg-turbo on some corrupt coefficients, as on
# bare JPEG files): (case, seed, flip) -> "raises" (Pillow gives pixels) or
# "differs"
OJPEG_DAMAGE = {("ojpeg-jif-scan", 1, 5): "differs", ("ojpeg-jif-scan", 1, 10): "differs",
                ("ojpeg-strips", 1, 16): "raises", ("ojpeg-strips", 1, 22): "raises",
                ("ojpeg-tables", 0, 0): "raises", ("ojpeg-tables", 0, 2): "raises",
                ("ojpeg-tables", 1, 10): "raises", ("ojpeg-tables", 1, 11): "raises",
                ("ojpeg-tables", 1, 16): "raises"}


def _flips(data: bytes, lo: int, hi: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(DAMAGE_FLIPS):
        d = bytearray(data)
        d[int(rng.integers(lo, hi))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(d))
    return out


def _port(data: bytes):
    try:
        return pnc.decode_bytes(data, "damaged")
    except ValueError as e:
        return str(e)


def _compare(case: str, seed: int, k: int, data: bytes) -> None:
    want, got = outcome(data), _port(data)
    if isinstance(got, str):
        kind = "agree" if want is None else "raises"
    else:
        kind = "agree" if want is not None and np.array_equal(want, got) else "differs"
        if want is None:
            kind = "port-reads-what-pillow-refuses"
    assert kind == OJPEG_DAMAGE.get((case, seed, k), "agree"), (case, seed, k, kind, got if kind != "differs" else "")
    if kind == "raises":
        assert "JPEG decode failed" in got and ("ends early" in got or "corrupt JPEG data" in got), got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(_damage_sources()))
def test_damaged_strip_bit_flips(case, seed):
    """Seeded bit flips in the strip (and, for old-style JPEG, in its
    markers and tables): Pillow's outcome, case by case; old-style JPEG
    parts only where OJPEG_DAMAGE pins it."""
    data = _damage_sources()[case]()
    if case.startswith("ojpeg"):
        lo, hi = 8, min(o + c for o, c in zip(*_strip_table(data)))
    else:
        lo, n = strip_of(data)
        hi = lo + n
    for k, d in enumerate(_flips(data, lo, hi, seed)):
        _compare(case, seed, k, d)


def _strip_table(data: bytes) -> tuple:
    with Image.open(io.BytesIO(data)) as im:
        return im.tag_v2[273], im.tag_v2[279]


@pytest.mark.parametrize("case", sorted(c for c in _damage_sources() if not c.startswith("ojpeg")))
def test_damaged_strip_cut_short(case):
    """The strip cut at seeded points (its byte count lowered): libtiff's
    "Not enough data" unless the strip's bytes were out already; the port
    agrees case by case."""
    data = _damage_sources()[case]()
    _, n = strip_of(data)
    rng = np.random.default_rng(11)
    for cut in sorted({int(c) for c in rng.integers(0, n, 8)} | {n - 1, n - 4, 12}):
        d = with_strip_bytes(data, cut)
        want, got = outcome(d), _port(d)
        if want is None:
            assert isinstance(got, str) and "decode failed" in got, (case, cut)
        else:
            assert not isinstance(got, str) and np.array_equal(got, want), (case, cut, got)


# ---------------------------------------------------------------------------
# the entry points: the server reads the new compressions as the JAX server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lzma", "zstd", "ojpeg", "thunderscan", "lzw-old-style"])
def test_server_decodes_as_the_jax_server(kind):
    from simple_sfod_tpu.engine.serve import DetectionService as JaxService
    from simple_sfod_tpu_torch.engine.serve import DetectionService

    data = {"lzma": lambda: pillow_file(Image.fromarray(IMG), "TIFF", compression="lzma"),
            "zstd": lambda: pillow_file(Image.fromarray(IMG), "TIFF", compression="zstd"),
            "ojpeg": lambda: tc.ojpeg_tiff(_frame_crop()),
            "thunderscan": lambda: _thunder(_grey4(13, 21, 2), 0),
            "lzw-old-style": LZW_OLD["rgb8-predictor-2"]}[kind]()
    svc = types.SimpleNamespace(image_format="BGR", predict_array=lambda arr, min_score=0.0: arr)
    np.testing.assert_array_equal(DetectionService.predict_bytes(svc, data), JaxService.predict_bytes(svc, data))
