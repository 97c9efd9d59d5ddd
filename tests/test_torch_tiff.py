"""TIFF as Pillow 12.1 reads it, against the port's decoder, tolerance 0.

Every case holds the port's `native_codec.decode` and `decode_bytes` to
Pillow's convert("RGB") (libtiff 4.7 for every compression but none), its
`image_size` to Pillow's size, and the loader's `_prep_image` to the JAX
loader's, which opens TIFF with PIL. The cases cover the Orientation tag
(2-8, applied after decoding as ImageOps.exif_transpose applies it, over
every route), BigTIFF, JPEG compression (YCbCr with subsampling and shared
JPEGTables, RGB, grey and CMYK, strips and tiles), CCITT RLE, Group 3 1-D
and 2-D and Group 4 (FillOrder 2 and damaged lines included), YCbCr without
JPEG at every subsampling (libtiff's RGBA interface), signed, 32-bit and
float samples with predictors 2 and 3, FillOrder 2 over each compression,
planar files at 16 bits and with alpha, and the quirks of Pillow's raw
decoder (YCbCr read as RGBX, a planar 16-bit plane read a byte a sample,
big-endian signed and float samples byte-swapped when libtiff decodes
them). Files come from Pillow and libtiff where they write the variant and
from tests/torch_tiff_coders.py where they cannot. What the port leaves
queued raises a ValueError that names it.

The committed fixtures (tests/torch_tiff/) are rebuilt by
`python tests/test_torch_tiff.py --write-fixtures`; fixtures.json records
the SHA-256 of Pillow's RGB of each, and of the frames chip_smoke.py writes.
"""

import hashlib
import io
import json
import os
import sys
import types

if __name__ == "__main__":  # run as a script: the packages sit at the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image, TiffImagePlugin  # noqa: E402

import torch_tiff_coders as tc  # noqa: E402
from simple_sfod_tpu_torch.data import native_codec as pnc  # noqa: E402
from test_torch_image_containers import (  # noqa: E402,F401  (jax_loader_through_pil: autouse)
    DECODER, assert_reads_like_pillow, jax_loader_through_pil, packbits, pillow_file, pillow_rgb, tiff_lzw)
from test_torch_jpeg import smooth_image  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tiff")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODERS = {1: lambda b: b, 32773: packbits, 5: tiff_lzw, 8: tc.deflate}
IMG = smooth_image(21, 34, seed=5, noise=25)


def outcome(data: bytes):
    """Pillow's RGB, or None where Pillow raises."""
    try:
        return pillow_rgb(data)[0]
    except Exception:
        return None


def assert_agrees(data: bytes, tmp_path, name="case.tif"):
    """Where Pillow reads the file, the port reads the same pixels (and
    everything assert_reads_like_pillow checks); where Pillow raises, the
    port raises a ValueError."""
    if outcome(data) is None:
        with pytest.raises(ValueError):
            pnc.decode_bytes(data, name)
        return None
    return assert_reads_like_pillow(data, tmp_path, name)


def info(**tags) -> TiffImagePlugin.ImageFileDirectory_v2:
    d = TiffImagePlugin.ImageFileDirectory_v2()
    for k, v in tags.items():
        d[int(k[1:])] = v
    return d


def bilevel(h=37, w=45, seed=1) -> Image.Image:
    return Image.fromarray(smooth_image(h, w, seed=seed, noise=40)).convert("1")


def strip_of(data: bytes) -> tuple:
    """(offset, byte count) of a one-strip file's strip."""
    with Image.open(io.BytesIO(data)) as im:
        return im.tag_v2[273][0], im.tag_v2[279][0]


# ---------------------------------------------------------------------------
# Orientation: the fault repaired (the port ignored 2-4 and refused 5-8)
# ---------------------------------------------------------------------------

ORIENT_CASES = [(o, c) for o in range(2, 9) for c in (1, 5, 32773)]


@pytest.mark.parametrize("orientation,compression", ORIENT_CASES,
                         ids=[f"{o}-{c}" for o, c in ORIENT_CASES])
def test_orientation(tmp_path, orientation, compression):
    """Orientation 2-8 on an RGB file, raw, LZW and PackBits: turned as
    Pillow turns it, its size swapped for 5-8, the loader's batch the JAX
    loader's."""
    data = tc.tiff(IMG.astype(np.int64), 2, 8, CODERS[compression], compression, rows_per_strip=8,
                   more_tags=[(274, 3, [orientation])])
    got = assert_reads_like_pillow(data, tmp_path, "o.tif")
    assert got.shape[:2] == (IMG.shape[:2] if orientation < 5 else IMG.shape[1::-1])
    if orientation != 1:
        assert not np.array_equal(got, IMG) if got.shape == IMG.shape else True


def _route(route: str, orientation: int) -> bytes:
    o = [(274, 3, [orientation])]
    if route == "ycbcr-lzw-22":
        return tc.ycbcr_tiff((18, 30), 2, 2, seed=2, compress=tiff_lzw, compression=5, more_tags=o)
    if route == "jpeg-ycbcr-420":
        return tc.jpeg_tiff(IMG, rows_per_strip=16, more_tags=o, quality=80)
    if route == "group4":
        return pillow_file(bilevel(), "TIFF", compression="group4", tiffinfo=info(t274=orientation))
    if route == "planar16-lzw":
        return tc.tiff(np.repeat(IMG.astype(np.int64) * 257, 1, 2), 2, 16, tiff_lzw, 5, planar=2, more_tags=o)
    if route == "tiles-raw":
        return tc.tiff(IMG.astype(np.int64), 2, 8, tile=(16, 16), more_tags=o)
    if route == "bigtiff-deflate":
        return tc.tiff(IMG.astype(np.int64), 2, 8, tc.deflate, 8, big=True, more_tags=o)
    return tc.tiff(IMG[..., :1].astype(np.float32) * 1.7 - 20, 1, 32, sample_format=3, more_tags=o)


ROUTES = ["ycbcr-lzw-22", "jpeg-ycbcr-420", "group4", "planar16-lzw", "tiles-raw", "bigtiff-deflate", "float32"]


@pytest.mark.parametrize("route", ROUTES)
def test_orientation_over_every_route(tmp_path, route):
    """Each orientation applied after each decoding route, libtiff's RGBA
    interface (YCbCr) included: it leaves the raster as stored for Pillow's
    request, and Pillow turns it once."""
    for orientation in range(1, 9):
        assert_reads_like_pillow(_route(route, orientation), tmp_path, "r.tif")


def test_orientation_from_xmp_and_ignored_values(tmp_path):
    """No Orientation tag: XMP's tiff:Orientation (Image.getexif's); a tag
    of count 2 or a value outside 1-8 turns nothing."""
    base = IMG.astype(np.int64)
    xmp = b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>'
    for tags in ([(700, 1, list(xmp))], [(274, 3, [3, 1])], [(274, 3, [9])], [(274, 3, [0])],
                 [(700, 7, list(b"<tiff:Orientation>3</tiff:Orientation>"))]):
        data = tc.tiff(base, 2, 8, more_tags=tags)
        ref = pillow_rgb(data)[0]
        np.testing.assert_array_equal(pnc.decode_bytes(data), ref)


# ---------------------------------------------------------------------------
# a tag stored with count 0: the fault repaired (the port raised IndexError
# on its first value; Pillow's ImageFileDirectory_v2 skips a tag without
# data, so it reads as absent)
# ---------------------------------------------------------------------------

GREY4 = smooth_image(4, 4, seed=3, noise=40)[..., :1].astype(np.int64)
COUNT0 = {"compression": 259, "orientation": 274, "photometric": 262, "planar-configuration": 284, "fill-order": 266}


@pytest.mark.parametrize("name", sorted(COUNT0))
def test_count_0_tag_reads_as_absent(tmp_path, name):
    """A 4x4 grey strip with Compression, Orientation, Photometric (then
    MinIsWhite: the image comes back inverted), PlanarConfiguration or
    FillOrder stored with count 0 decodes as Pillow decodes it; image_size
    is Pillow's size."""
    data = tc.tiff(GREY4, 1, 8, more_tags=[(COUNT0[name], 3, [])])
    got = assert_reads_like_pillow(data, tmp_path, "count0.tif")
    if name == "photometric":
        np.testing.assert_array_equal(got[..., 0], 255 - GREY4[..., 0])


@pytest.mark.parametrize("tag", [256, 257])
def test_count_0_image_width_or_length_is_refused(tmp_path, tag):
    """Without its ImageWidth or ImageLength Pillow identifies no image;
    the port raises a ValueError naming the tags, from decode and
    image_size, not an IndexError."""
    data = tc.tiff(GREY4, 1, 8, more_tags=[(tag, 4, [])])
    with pytest.raises(Exception):
        pillow_rgb(data)
    (tmp_path / "w.tif").write_bytes(data)
    for call in (lambda: pnc.decode_bytes(data), lambda: pnc.image_size(str(tmp_path / "w.tif"))):
        with pytest.raises(ValueError, match="TIFF without ImageWidth or ImageLength"):
            call()


LIBTIFF_COUNTED = (258, 277, 278, 280, 281, 284, 317, 322, 323, 324, 325, 339, 340, 341)
COUNT0_SWEEP = [("grey8", t) for t in (258, 273, 277, 278, 279, 339, 700)] + \
    [(k, t) for k in ("grey8-lzw", "grey8-deflate-tiles") for t in LIBTIFF_COUNTED] + \
    [("rgb8-lzw-predictor", t) for t in (258, 277, 317, 338, 339)] + [("palette4", t) for t in (258, 320)] + \
    [("ycbcr-lzw", t) for t in (530, 529, 532)] + [("grey8", t) for t in (266, 292, 347)]


def _count0_base(kind: str, tag: int) -> bytes:
    img = smooth_image(6, 10, seed=4, noise=30)
    empty = [(tag, 1 if tag in (347, 700) else 5 if tag in (529, 532) else 3, [])]
    if kind == "grey8":
        return tc.tiff(img[..., :1].astype(np.int64), 1, 8, rows_per_strip=3, more_tags=empty)
    if kind == "grey8-lzw":
        return tc.tiff(img[..., :1].astype(np.int64), 1, 8, tiff_lzw, 5, rows_per_strip=3, more_tags=empty)
    if kind == "grey8-deflate-tiles":
        return tc.tiff(img[..., :1].astype(np.int64), 1, 8, tc.deflate, 8, tile=(16, 16), more_tags=empty)
    if kind == "rgb8-lzw-predictor":
        return tc.tiff(img.astype(np.int64), 2, 8, tiff_lzw, 5, predictor=2, extra=(), more_tags=empty)
    if kind == "palette4":
        cmap = np.stack([np.arange(16) * 4000, np.arange(16)[::-1] * 4000, np.full(16, 30000)], 1)
        return tc.tiff((img[..., :1] // 16).astype(np.int64), 3, 4, colormap=cmap, more_tags=empty)
    return tc.ycbcr_tiff((6, 10), 2, 2, seed=4, compress=tiff_lzw, compression=5, more_tags=empty)


@pytest.mark.parametrize("kind,tag", COUNT0_SWEEP, ids=[f"{k}-{t}" for k, t in COUNT0_SWEEP])
def test_count_0_sweep_agrees_with_pillow(tmp_path, kind, tag):
    """Every other tag the port reads, stored with count 0: the pixels
    Pillow gives where it reads the file, a ValueError where it raises
    (libtiff, which decodes every compressed file, refuses a directory with
    a per-sample or layout tag of count 0)."""
    assert_agrees(_count0_base(kind, tag), tmp_path, "sweep.tif")


# ---------------------------------------------------------------------------
# BigTIFF
# ---------------------------------------------------------------------------

BIG = {
    "pillow-raw": lambda: pillow_file(Image.fromarray(IMG), "TIFF", big_tiff=True),
    "lzw-predictor": lambda: tc.tiff(IMG.astype(np.int64), 2, 8, tiff_lzw, 5, predictor=2, big=True),
    "tiles-deflate": lambda: tc.tiff(IMG.astype(np.int64), 2, 8, tc.deflate, 8, tile=(16, 16), big=True),
    "grey16-mm-packbits": lambda: tc.tiff(IMG[..., :1].astype(np.int64) * 3, 1, 16, packbits, 32773, order=">",
                                          big=True),
    "jpeg": lambda: tc.jpeg_tiff(IMG, big=True, quality=70),
    "group4": lambda: _big_group4(),
    "big-endian": lambda: tc.tiff(IMG.astype(np.int64), 2, 8, order=">", big=True),
}


def _big_group4() -> bytes:
    im = bilevel()
    data = pillow_file(im, "TIFF", compression="group4")
    off, n = strip_of(data)
    tags = {256: (4, [im.width]), 257: (4, [im.height]), 258: (3, [1]), 259: (3, [4]), 262: (3, [1]),
            277: (3, [1]), 278: (4, [im.height])}
    return tc.container([data[off:off + n]], tags, big=True)


@pytest.mark.parametrize("case", sorted(BIG))
def test_bigtiff(tmp_path, case):
    """BigTIFF: 8-byte offsets and counts, 20-byte entries, LONG8; Pillow
    12.1 opens little-endian BigTIFF only (it tests byte 2 for 43), and the
    port refuses the big-endian kind with it."""
    data = BIG[case]()
    assert data[:4] in pnc.BIGTIFF_MAGICS
    got = assert_agrees(data, tmp_path, "big.tif")
    assert (got is None) == (data[:2] == b"MM")


# ---------------------------------------------------------------------------
# JPEG compression (7)
# ---------------------------------------------------------------------------

JPEG = {
    "pillow-rgb": lambda: pillow_file(Image.fromarray(IMG), "TIFF", compression="jpeg"),
    "pillow-grey": lambda: pillow_file(Image.fromarray(IMG).convert("L"), "TIFF", compression="jpeg"),
    "pillow-cmyk": lambda: pillow_file(Image.fromarray(IMG).convert("CMYK"), "TIFF", compression="jpeg"),
    "pillow-ycbcr": lambda: pillow_file(Image.fromarray(IMG).convert("YCbCr"), "TIFF", compression="jpeg",
                                        quality=60),
    "ycbcr-420-strips-16": lambda: tc.jpeg_tiff(IMG, quality=75),
    "ycbcr-420-strips-8-odd": lambda: tc.jpeg_tiff(smooth_image(37, 45, seed=3, noise=30), rows_per_strip=8),
    "ycbcr-422-strips": lambda: tc.jpeg_tiff(IMG, subsampling="4:2:2", quality=90),
    "ycbcr-444-tables-in-strips": lambda: tc.jpeg_tiff(IMG, subsampling="4:4:4", tables=False),
    "ycbcr-420-tiles-16": lambda: tc.jpeg_tiff(smooth_image(37, 45, seed=4, noise=30), tile=(16, 16), quality=85),
    "ycbcr-420-tiles-32-mm": lambda: tc.jpeg_tiff(IMG, tile=(32, 32), order=">"),
    "ycbcr-420-no-subsampling-tag": lambda: tc.jpeg_tiff(IMG, subsampling_tag=False),
    "ycbcr-420-progressive": lambda: tc.jpeg_tiff(IMG, progressive=True, quality=70, tables=False),
    "ycbcr-420-restarts": lambda: tc.jpeg_tiff(IMG, quality=70, restart_marker_blocks=2),
    "ycbcr-wrong-subsampling-tag": lambda: tc.jpeg_tiff(IMG, subsampling="4:2:2", more_tags=[(530, 3, [2, 2])]),
    "rgb-keep-rgb": lambda: tc.jpeg_tiff(IMG, photometric=2, subsampling="4:4:4", keep_rgb=True),
    "rgb-of-jfif-ycbcr-data": lambda: tc.jpeg_tiff(IMG, photometric=2, subsampling="4:4:4"),
    "rgb-subsampled-refused": lambda: tc.jpeg_tiff(IMG, photometric=2, subsampling="4:2:0"),
    "grey-strips": lambda: tc.jpeg_tiff(IMG, photometric=1, mode="L", rows_per_strip=8),
    "grey-min-is-white-tiles": lambda: tc.jpeg_tiff(IMG, photometric=0, mode="L", tile=(16, 16)),
    "grey-fill-order-2": lambda: tc.jpeg_tiff(IMG, photometric=1, mode="L", more_tags=[(266, 3, [2])]),
    "cmyk-adobe-strips": lambda: tc.jpeg_tiff(IMG, photometric=5, mode="CMYK", rows_per_strip=8),
    "cmyk-tiles": lambda: tc.jpeg_tiff(IMG, photometric=5, mode="CMYK", tile=(16, 16), quality=95),
}


@pytest.mark.parametrize("case", sorted(JPEG))
def test_jpeg_compression(tmp_path, case):
    """Each strip or tile an abbreviated JPEG stream after JPEGTables; YCbCr
    converted by libjpeg (JPEGCOLORMODE_RGB), every other photometric's
    components as stored, whatever JFIF or Adobe marker the stream carries;
    the last strip shorter, tiles cropped; what libtiff refuses (subsampled
    RGB, sampling factors other than YCbCrSubsampling's) refused."""
    got = assert_agrees(JPEG[case](), tmp_path, "j.tif")
    assert (got is None) == case.endswith(("refused", "wrong-subsampling-tag"))


# ---------------------------------------------------------------------------
# CCITT: RLE, Group 3 and Group 4
# ---------------------------------------------------------------------------

CCITT = [(c, t) for c in ("tiff_ccitt", "tiff_raw_16", "group3", "group4") for t in
         ("plain", "2d", "2d-fill-bits", "fill-order-2", "min-is-white", "narrow", "one-pixel", "tall-strips")
         if c == "group3" or t in ("plain", "fill-order-2", "min-is-white", "narrow")
         or t == "one-pixel" and c != "tiff_raw_16"]


@pytest.mark.parametrize("comp,variant", CCITT, ids=[f"{c}-{v}" for c, v in CCITT])
def test_ccitt(tmp_path, comp, variant):
    """libtiff's own CCITT files through Pillow: T4Options 2-D and fill
    bits, FillOrder 2 (bits read LSB first), white/black photometric, widths
    of 1 and not a multiple of 8, several strips."""
    hw = {"narrow": (29, 13), "one-pixel": (9, 1), "tall-strips": (61, 70)}.get(variant, (37, 45))
    tags = {"2d": dict(t292=1), "2d-fill-bits": dict(t292=5), "fill-order-2": dict(t266=2, t292=1),
            "min-is-white": dict(t262=0), "tall-strips": dict(t278=8, t292=1)}.get(variant, {})
    data = pillow_file(bilevel(*hw, seed=len(variant)), "TIFF", compression=comp, tiffinfo=info(**tags))
    assert_reads_like_pillow(data, tmp_path, "f.tif")


DAMAGE = {"group3-1d": ("group3", {}), "group3-2d": ("group3", dict(t292=1)),
          "group3-2d-fill-bits": ("group3", dict(t292=5))}


@pytest.mark.parametrize("case", sorted(DAMAGE))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ccitt_damaged_lines(tmp_path, case, seed):
    """Bytes in the middle of a Group 3 strip overwritten: libtiff reports
    the bad code words, fills the damaged lines from what it decoded and
    resynchronises at the next EOL; the port decodes the same pixels. Where
    the damage leaves the data short of the last row, libtiff stops early
    and Pillow's later rows are its buffer's old memory: the port refuses
    such a strip, naming it."""
    comp, tags = DAMAGE[case]
    data = bytearray(pillow_file(bilevel(61, 70, seed=seed), "TIFF", compression=comp, tiffinfo=info(**tags)))
    off, n = strip_of(bytes(data))
    rng = np.random.default_rng(seed)
    for at in rng.integers(n // 5, 3 * n // 5, 3):
        data[off + at:off + at + 2] = rng.integers(0, 256, 2).astype(np.uint8).tobytes()
    try:
        pnc.decode_bytes(bytes(data))
    except ValueError as e:
        assert "data ends before the strip" in str(e)
        DAMAGE_REFUSED.add((case, seed))
        return
    assert_reads_like_pillow(bytes(data), tmp_path, "d.tif")


DAMAGE_REFUSED = set()


def test_ccitt_data_ending_early_is_refused():
    """A strip whose data ends early: libtiff stops decoding and leaves the
    rest of Pillow's strip buffer as it was (memory the port cannot
    reproduce); the port raises, naming it."""
    for comp in ("group3", "group4"):
        data = pillow_file(bilevel(), "TIFF", compression=comp)
        off, n = strip_of(data)
        cut = data[:off + n // 2] + bytes(n - n // 2) + data[off + n:]
        with pytest.raises(ValueError, match="data ends before the strip"):
            pnc.decode_bytes(cut)


# ---------------------------------------------------------------------------
# YCbCr without JPEG: libtiff's RGBA interface
# ---------------------------------------------------------------------------

SUBSAMPLING = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)]
YCBCR = [(s, c) for s in SUBSAMPLING for c in (5, 32773, 8)]


@pytest.mark.parametrize("sub,compression", YCBCR, ids=[f"{s[0]}x{s[1]}-{c}" for s, c in YCBCR])
def test_ycbcr_without_jpeg(tmp_path, sub, compression):
    """Data units of hs x vs luma and one Cb, Cr; chroma replicated over the
    unit; TIFFYCbCrtoRGB with the default coefficients and reference;
    widths and heights not multiples of the unit. (A 4x4 file's width is
    kept to an even number of units: libtiff reads its scanlines in units
    of a quarter of a unit row, and leaves the last Cb, Cr of an odd row
    unread.)"""
    hs, vs = sub
    hw = (4 * vs + 3, 8 * hs - 3) if sub != (4, 4) else (19, 29)
    data = tc.ycbcr_tiff(hw, hs, vs, seed=hs * 10 + vs, compress=CODERS[compression], compression=compression)
    assert_reads_like_pillow(data, tmp_path, "y.tif")


YCBCR_TAGS = {
    "reference-black-white": [(532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])],
    "reference-fractional": [(532, 5, [31, 2, 471, 2, 255, 2, 481, 2, 257, 2, 479, 2])],
    "coefficients-bt709": [(529, 5, [2126, 10000, 7152, 10000, 722, 10000])],
    "positioning-cosited": [(531, 3, [2])],
    "tiles": None,
    "big-endian": None,
}


@pytest.mark.parametrize("case", sorted(YCBCR_TAGS))
def test_ycbcr_tags(tmp_path, case):
    """ReferenceBlackWhite and YCbCrCoefficients through tif_color.c's
    float tables; YCbCrPositioning changes nothing in the RGBA interface;
    tiles and the big-endian byte order."""
    kw = dict(more_tags=YCBCR_TAGS[case] or ())
    if case == "tiles":
        kw["tile"] = (16, 16)
    if case == "big-endian":
        kw["order"] = ">"
    data = tc.ycbcr_tiff((21, 35), 2, 2, seed=7, compress=tiff_lzw, compression=5, **kw)
    assert_reads_like_pillow(data, tmp_path, "t.tif")


YCBCR_PREDICTOR = [(s, c, t) for s in ((1, 1), (2, 2), (2, 1), (4, 2)) for c in ("lzw", "deflate") for t in (False, True)]


@pytest.mark.parametrize("sub,comp,tiled", YCBCR_PREDICTOR,
                         ids=[f"{s[0]}x{s[1]}-{c}{'-tiles' if t else ''}" for s, c, t in YCBCR_PREDICTOR])
def test_ycbcr_with_predictor(tmp_path, sub, comp, tiled):
    """Predictor 2 over YCbCr units: libtiff accumulates bytes with stride
    3 over rows of TIFFScanlineSize (a unit row over vs) or TIFFTileRowSize.
    Where those rows do not divide the data (2x1, 4x2 here) libtiff fails
    the strip and Pillow keeps whatever its buffer held: the port refuses."""
    data = tc.ycbcr_tiff((19, 37), *sub, seed=1, compress=_CODER[comp], compression=_C[comp],
                         tile=(16, 16) if tiled else None, more_tags=[(317, 3, [2])])
    if sub in ((2, 1), (4, 2)):
        with pytest.raises(ValueError, match="predictor rows"):
            pnc.decode_bytes(data)
        return
    assert_reads_like_pillow(data, tmp_path, "yp.tif")


def _planar_ycbcr_jpeg(sub) -> bytes:
    s = _ints(3, 0, 256, (21, 34, 3)).astype(np.uint8)
    chunks = [tc.pillow_jpeg(np.repeat(s[y:y + 16, :, p:p + 1], 3, 2), "L", quality=90)
              for p in range(3) for y in range(0, 21, 16)]
    tags = {256: (4, [34]), 257: (4, [21]), 258: (3, [8, 8, 8]), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            284: (3, [2]), 278: (4, [16]), 530: (3, list(sub))}
    return tc.container(chunks, tags)


PLANAR_YCBCR = [(s, c) for s in ((1, 1), (2, 2)) for c in ("raw", "lzw", "jpeg")]


@pytest.mark.parametrize("sub,comp", PLANAR_YCBCR, ids=[f"{s[0]}x{s[1]}-{c}" for s, c in PLANAR_YCBCR])
def test_planar_ycbcr(tmp_path, sub, comp):
    """YCbCr in planes: uncompressed, Pillow's raw decoder reads the planes
    as R, G and B; compressed (JPEG's planes as stored), libtiff's RGBA
    interface converts them at 1 x 1 and refuses other subsampling."""
    if comp == "jpeg":
        data = _planar_ycbcr_jpeg(sub)
    else:
        data = tc.tiff(_ints(3, 0, 256, (16, 24, 3)), 6, 8, _CODER[comp], _C[comp], planar=2,
                       more_tags=[(530, 3, list(sub))])
    got = assert_agrees(data, tmp_path, "py.tif")
    assert (got is None) == (sub != (1, 1) and comp != "raw")


def test_uncompressed_ycbcr_is_read_as_pillow_reads_it(tmp_path):
    """Uncompressed YCbCr never reaches libtiff in Pillow: its raw decoder
    reads the OPEN_INFO raw mode, RGBX, four bytes a pixel from each strip's
    offset (no colour conversion), and refuses a file that runs out."""
    rgb = np.concatenate([IMG, IMG[:, :, :1]], axis=2).astype(np.int64)[..., :3]
    data = tc.tiff(rgb, 6, 8, rows_per_strip=4, more_tags=[(530, 3, [1, 1]), (700, 1, list(bytes(2000)))])
    assert_reads_like_pillow(data, tmp_path, "u.tif")
    short = tc.ycbcr_tiff((16, 24), 2, 2, rows_per_strip=16)
    assert outcome(short) is None
    with pytest.raises(ValueError, match="truncated"):
        pnc.decode_bytes(short)


# ---------------------------------------------------------------------------
# sample formats, FillOrder 2, planar files
# ---------------------------------------------------------------------------

def _ints(seed, lo, hi, shape=(13, 22, 1)):
    return np.random.default_rng(seed).integers(lo, hi, shape)


def _floats(seed):
    v = np.random.default_rng(seed).normal(120, 140, (13, 22, 1)).astype(np.float32)
    v[0, :8, 0] = [np.nan, np.inf, -np.inf, -5.5, 0.6, 254.6, 300, 255.5]
    return v


SAMPLES = {
    "signed8": lambda o, c: tc.tiff(_ints(1, -128, 128), 1, 8, _CODER[c], _C[c], order=o, sample_format=2),
    "signed16": lambda o, c: tc.tiff(_ints(2, -600, 600), 1, 16, _CODER[c], _C[c], order=o, sample_format=2),
    "signed16-predictor": lambda o, c: tc.tiff(_ints(3, -600, 600), 1, 16, _CODER[c], _C[c], order=o, sample_format=2,
                                               predictor=2 if _C[c] in (5, 8) else 1),
    "signed32": lambda o, c: tc.tiff(_ints(4, -2**31, 2**31), 1, 32, _CODER[c], _C[c], order=o, sample_format=2),
    "unsigned32": lambda o, c: tc.tiff(_ints(5, 0, 600), 1, 32, _CODER[c], _C[c], order=o),
    "unsigned32-predictor": lambda o, c: tc.tiff(_ints(6, 0, 2**32), 1, 32, _CODER[c], _C[c], order=o,
                                                 predictor=2 if _C[c] in (5, 8) else 1),
    "float32": lambda o, c: tc.tiff(_floats(7), 1, 32, _CODER[c], _C[c], order=o, sample_format=3),
    "float32-min-is-white": lambda o, c: tc.tiff(_floats(8), 0, 32, _CODER[c], _C[c], order=o, sample_format=3),
    "float32-predictor-3": lambda o, c: tc.tiff(_floats(9), 1, 32, _CODER[c], _C[c], order=o, sample_format=3,
                                                predictor=3 if _C[c] in (5, 8) else 1),
    "grey12": lambda o, c: tc.tiff(_ints(10, 0, 4096), 1, 12, _CODER[c], _C[c], order=o),
}
_C = {"raw": 1, "lzw": 5, "deflate": 8, "packbits": 32773}
_CODER = {"raw": CODERS[1], "lzw": tiff_lzw, "deflate": tc.deflate, "packbits": packbits}
SAMPLE_CASES = [(k, o, c) for k in sorted(SAMPLES) for o in "<>" for c in ("raw", "lzw", "deflate")
                if c != "deflate" or "predictor" in k]


@pytest.mark.parametrize("kind,order,comp", SAMPLE_CASES, ids=[f"{k}-{'II' if o == '<' else 'MM'}-{c}"
                                                               for k, o, c in SAMPLE_CASES])
def test_sample_formats(tmp_path, kind, order, comp):
    """Signed 8 (raw bytes as "L"), 16 and 32-bit, unsigned 32-bit ("I"),
    float ("F", NaN and the infinities included) and 12-bit samples: clipped
    or truncated to 0-255 by convert("RGB"); predictors 2 and 3. Where
    OPEN_INFO has no big-endian key both refuse; a big-endian signed or
    float file that libtiff decodes is read byte-swapped, as Pillow reads
    libtiff's native samples with the big-endian raw mode."""
    data = SAMPLES[kind](order, comp)
    assert_agrees(data, tmp_path, "s.tif")


FILL = {
    "bilevel": dict(photometric=1, bits=1), "bilevel-min-is-white": dict(photometric=0, bits=1),
    "grey2": dict(photometric=1, bits=2), "grey4-min-is-white": dict(photometric=0, bits=4),
    "grey8": dict(photometric=1, bits=8), "grey8-min-is-white": dict(photometric=0, bits=8),
    "palette1": dict(photometric=3, bits=1), "palette4": dict(photometric=3, bits=4),
    "palette8": dict(photometric=3, bits=8), "rgb8": dict(photometric=2, bits=8, spp=3),
    "grey16": dict(photometric=1, bits=16), "rgb16-not-in-open-info": dict(photometric=2, bits=16, spp=3),
}
FILL_CASES = [(k, c) for k in sorted(FILL) for c in ("raw", "packbits", "lzw", "deflate")]


@pytest.mark.parametrize("kind,comp", FILL_CASES, ids=[f"{k}-{c}" for k, c in FILL_CASES])
def test_fill_order_2(tmp_path, kind, comp):
    """FillOrder 2: Pillow's ";R" raw modes uncompressed, libtiff's bit
    reversal before decompressing otherwise; a layout without a FillOrder 2
    key in OPEN_INFO refused by both."""
    spec = dict(FILL[kind])
    spp, bits = spec.pop("spp", 1), spec["bits"]
    s = _ints(len(kind), 0, 1 << bits, (13, 22, spp))
    if spec["photometric"] == 3:
        spec["colormap"] = _ints(3, 0, 65536, (1 << bits, 3))
    data = tc.tiff(s, spec.pop("photometric"), spec.pop("bits"), _CODER[comp], _C[comp], fill_order=2, **spec)
    got = assert_agrees(data, tmp_path, "fo.tif")
    # Pillow's raw decoder has no unpacker for L;IR and P;nR: both refuse those uncompressed
    unpacked = comp != "raw" or kind not in ("grey8-min-is-white", "palette1", "palette4")
    assert (got is None) == (kind.endswith("not-in-open-info") or not unpacked)


PLANAR = {
    "rgb16": dict(photometric=2, bits=16, spp=3), "rgba16": dict(photometric=2, bits=16, spp=4, extra=(2,)),
    "rgbx8": dict(photometric=2, bits=8, spp=4, extra=(0,)), "rgba-associated": dict(photometric=2, bits=8, spp=4,
                                                                                      extra=(1,)),
    "cmyk16": dict(photometric=5, bits=16, spp=4), "grey-alpha": dict(photometric=1, bits=8, spp=2, extra=(2,)),
}
PLANAR_CASES = [(k, o, c, t) for k in sorted(PLANAR) for o in "<>" for c in ("raw", "lzw") for t in (False, True)
                if not (t and o == ">")]


@pytest.mark.parametrize("kind,order,comp,tiled", PLANAR_CASES,
                         ids=[f"{k}-{'II' if o == '<' else 'MM'}-{c}{'-tiles' if t else ''}"
                              for k, o, c, t in PLANAR_CASES])
def test_planar(tmp_path, kind, order, comp, tiled):
    """A plane a sample: libtiff's planes at their own bits; Pillow's raw
    decoder reads each plane by a one-band 8-bit raw mode (a 16-bit plane's
    bytes as samples, at the stride Pillow gives a tile at the right edge)
    and has no band raw mode for associated alpha (both refuse)."""
    spec = dict(PLANAR[kind])
    spp, bits = spec.pop("spp"), spec["bits"]
    s = _ints(spp + bits, 0, 1 << bits, (21, 34, spp))
    if spec.get("extra") == (1,):
        s[..., :3] = s[..., :3] * s[..., 3:] // 255
    data = tc.tiff(s, spec.pop("photometric"), spec.pop("bits"), _CODER[comp], _C[comp], order=order, planar=2,
                   tile=(16, 16) if tiled else None, **spec)
    assert_agrees(data, tmp_path, "p.tif")


PLANAR_KEYS = sorted({k[1:] for k in TiffImagePlugin.OPEN_INFO if len(k[4]) > 1 and k[1] != 6})


@pytest.mark.parametrize("key", PLANAR_KEYS, ids=["-".join(map(str, [k[0], k[2], len(k[3]), k[3][0], *k[4]]))
                                                 for k in PLANAR_KEYS])
def test_planar_every_open_info_key(tmp_path, key):
    """Each OPEN_INFO layout of more than one sample as planes, raw and LZW:
    read where Pillow reads it (a one-band raw mode a plane uncompressed,
    no more planes than the mode's bands through libtiff), refused where
    it refuses."""
    photo, _, _, bps, extra = key
    s = _ints(len(bps) + bps[0], 0, 1 << bps[0], (13, 22, len(bps)))
    kw = dict(extra=extra) if extra else {}
    if photo == 3:
        kw["colormap"] = _ints(3, 0, 65536, (256, 3))
    for comp in ("raw", "lzw"):
        data = tc.tiff(s, photo, bps[0], _CODER[comp], _C[comp], planar=2, **kw)
        assert_agrees(data, tmp_path, "k.tif")


# ---------------------------------------------------------------------------
# what stays refused, and the cases the containers slice refused
# ---------------------------------------------------------------------------

CIELAB = [(c, p, o, t) for c in ("raw", "lzw") for p in (1, 2) for o in "<>" for t in (False, True)]


@pytest.mark.parametrize("comp,planar,order,tiled", CIELAB,
                         ids=[f"{c}-{'planar' if p == 2 else 'chunky'}-{'II' if o == '<' else 'MM'}"
                              f"{'-tiles' if t else ''}" for c, p, o, t in CIELAB])
def test_cielab(tmp_path, comp, planar, order, tiled):
    """CIELab (photometric 8, 8 bits): the "LAB" raw mode flips the file's
    signed a* and b* (a plane's one-band unpacker does not), then
    LittleCMS's Lab -> sRGB table and tetrahedral interpolation."""
    s = _ints(8 + planar, 0, 256, (21, 34, 3))
    data = tc.tiff(s, 8, 8, _CODER[comp], _C[comp], order=order, planar=planar, tile=(16, 16) if tiled else None)
    assert_reads_like_pillow(data, tmp_path, "lab.tif")


def test_lab_table_is_littlecms_and_every_value_is_pillows():
    """data/lab_srgb_clut.bin is the table of the LittleCMS that Pillow
    bundles, and the port's conversion gives Pillow's convert("RGB") of a
    "LAB" image for all 2^24 values, L = 0, a = 128, b = 128 (the file's
    bytes) -> (0, 59, 195) among them."""
    import zlib

    with open(tc.LAB_CLUT, "rb") as f:
        committed = np.frombuffer(zlib.decompress(f.read()), "<u2").reshape(33, 33, 33, 3)
    np.testing.assert_array_equal(committed, tc.littlecms_lab_clut())
    v = np.arange(1 << 24, dtype=np.uint32)
    lab = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), lab.tobytes()).convert("RGB")).reshape(-1, 3)
    got = pnc._lab_rgb(lab ^ np.array([0, 128, 128], np.uint8))
    np.testing.assert_array_equal(got, want)
    one = tc.tiff(np.array([[[0, 128, 128]]]), 8, 8)
    assert pnc.decode_bytes(one).tolist() == [[[0, 59, 195]]]


FORMERLY_REFUSED = ["tiff-ccitt", "tiff-ycbcr", "tiff-signed", "tiff-fill-order-2", "tiff-orientation-6",
                    "tiff-planar-16-bit", "bigtiff", "tiff-lab"]


@pytest.mark.parametrize("case", FORMERLY_REFUSED)
def test_formerly_refused(tmp_path, case):
    """The bytes of the refusal cases this slice retired from
    test_torch_image_containers.py: read as Pillow reads them, or refused
    where Pillow raises (and, for tiff-ccitt, where Pillow's rows past the
    end of the data are its strip buffer's old memory)."""
    from test_torch_image_containers import _tiff_tags, rand, tiff_file

    make = {"tiff-ccitt": lambda: _tiff_tags("bilevel-min-is-black", {259: 3}),
            "tiff-ycbcr": lambda: _tiff_tags("rgb8", {262: 6}),
            "tiff-signed": lambda: _tiff_tags("grey8", {339: 2}),
            "tiff-fill-order-2": lambda: _tiff_tags("grey8", {266: 2}),
            "tiff-orientation-6": lambda: _tiff_tags("grey8", {274: 6}),
            "tiff-planar-16-bit": lambda: tiff_file(rand((5, 6, 3), 2, 4000, np.int64), 2, 16, planar=2),
            "bigtiff": lambda: b"II+\x00\x08\x00\x00\x00" + bytes(32),
            "tiff-lab": lambda: _tiff_tags("rgb8", {262: 8})}[case]
    data = make()
    if case == "tiff-ccitt":
        with pytest.raises(ValueError, match="data ends before the strip"):
            pnc.decode_bytes(data)
    else:
        assert_agrees(data, tmp_path, "f.tif")


def test_every_open_info_key_is_the_ports():
    """The port's copy of Pillow's OPEN_INFO: the same keys and modes."""
    want = {("<" if k[0] == TiffImagePlugin.II else ">",) + k[1:]: v for k, v in TiffImagePlugin.OPEN_INFO.items()}
    assert pnc._TIFF_OPEN_INFO == want


# ---------------------------------------------------------------------------
# the entry points beside the loader
# ---------------------------------------------------------------------------

def _entry_files() -> dict:
    return {"jpeg": tc.jpeg_tiff(smooth_image(30, 50, seed=8, noise=20), quality=80),
            "orient6": tc.tiff(smooth_image(30, 50, seed=9, noise=20).astype(np.int64), 2, 8, tiff_lzw, 5,
                               more_tags=[(274, 3, [6])])}


@pytest.mark.parametrize("image_format", ["RGB", "BGR"])
def test_server_decodes_tiff_as_the_jax_server(image_format):
    from simple_sfod_tpu.engine.serve import DetectionService as JaxService
    from simple_sfod_tpu_torch.engine.serve import DetectionService

    svc = types.SimpleNamespace(image_format=image_format, predict_array=lambda arr, min_score=0.0: arr)
    for data in _entry_files().values():
        got = DetectionService.predict_bytes(svc, data)
        want = JaxService.predict_bytes(svc, data)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["jpeg", "orient6"])
def test_style_image_from_tiff(tmp_path, kind):
    import torch

    from simple_sfod_tpu_torch.config import get_cfg
    from simple_sfod_tpu_torch.engine.trainers.source_free_adaptive_teacher import SourceFreeAdaptiveTeacherTrainer

    path = str(tmp_path / "style.tif")
    with open(path, "wb") as f:
        f.write(_entry_files()[kind])
    cfg = get_cfg()
    cfg.STYLE.STYLE_IMAGE = path
    cfg.STYLE.VGG_MODEL = cfg.STYLE.DECODER = ""
    stub = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    module = SourceFreeAdaptiveTeacherTrainer._build_style_transfer(stub)
    with Image.open(path) as im:  # the JAX trainer's reading
        want = np.asarray(im.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(module.style_image.permute(1, 2, 0).numpy(), want)


def test_toolkit_and_gui_on_tiff_images(tmp_path):
    """YOLO boxes relative to TIFF images' sizes (JPEG-compressed, and
    turned by Orientation 6) scored as the JAX toolkit scores them; the
    GUI's pages byte-equal to the JAX GUI's."""
    from simple_sfod_tpu.evaluation import gui as jax_gui
    from simple_sfod_tpu.evaluation import runner as jax_runner
    from simple_sfod_tpu_torch.evaluation import gui, runner
    from test_torch_metrics_toolkit import SIZES, assert_same, write_pair

    def rewrite(img_dir):
        for i, (stem, (w, h)) in enumerate(sorted(SIZES.items())):
            for ext in (".png", ".jpg"):
                p = os.path.join(img_dir, stem + ext)
                if os.path.exists(p):
                    rgb = smooth_image(h, w, seed=w, noise=10)
                    data = tc.jpeg_tiff(rgb, quality=50) if i % 2 else tc.tiff(
                        rgb.transpose(1, 0, 2)[::-1].astype(np.int64), 2, 8, packbits, 32773, rows_per_strip=64,
                        more_tags=[(274, 3, [6])])
                    with open(p, "wb") as f:
                        f.write(data)

    kw = write_pair(tmp_path / "yolo", "yolo", "yolo")
    rewrite(kw["images_dir"])
    want = jax_runner.load_inputs(**kw)
    got = runner.load_inputs(**kw)
    assert got == want
    args = dict(metrics=("coco", "voc", "f1"), want_curves=False)
    assert_same(runner.run_metrics(*got, **args)[0], jax_runner.run_metrics(*want, **args)[0])
    kw = write_pair(tmp_path / "coco", "coco", "coco")
    rewrite(kw["images_dir"])
    state = {"gt": kw["gt"], "gt_format": "coco", "det": kw["det"], "det_format": "coco",
             "img_dir": kw["images_dir"], "names": "", "iou": "0.5", "voc_method": "all_point"}
    files = sorted(os.listdir(kw["images_dir"]))
    assert files and all(open(os.path.join(kw["images_dir"], f), "rb").read(4) == b"II*\x00" for f in files)
    for i, f in enumerate(files):
        w, h = SIZES[os.path.splitext(f)[0]]
        assert pnc.image_size(os.path.join(kw["images_dir"], f)) == (h, w)
        page = gui.view_page(dict(state), "det", i)
        assert page == jax_gui.view_page(dict(state), "det", i)
        assert f"viewBox='0 0 {w} {h}'" in page


# ---------------------------------------------------------------------------
# the committed fixtures (decoded on the card's host by chip_smoke.py)
# ---------------------------------------------------------------------------

def _frame() -> np.ndarray:
    with Image.open(os.path.join(ROOT, "tests", "torch_jpeg", "sim10k_frame_0.jpg")) as im:
        return np.asarray(im.convert("RGB"))


def fixture_files() -> dict:
    """name -> (a function giving the bytes, a label) of every committed
    TIFF fixture: two Sim10k frames timed on the card, and one small file a
    route."""
    small = smooth_image(24, 40, seed=11, noise=25)
    return {
        "sim10k_frame_0_jpeg.tif": (lambda: tc.jpeg_tiff(_frame(), quality=75), "TIFF JPEG YCbCr 4:2:0, 16-row strips"),
        "sim10k_frame_0_g4.tif": (lambda: pillow_file(Image.fromarray(_frame()).convert("L").point(
            lambda v: 255 if v >= 96 else 0).convert("1"), "TIFF", compression="group4"), "TIFF Group 4"),
        "jpeg_cmyk_tiles.tif": (lambda: tc.jpeg_tiff(small, photometric=5, mode="CMYK", tile=(16, 16)),
                                "TIFF JPEG CMYK tiles"),
        "group3_2d_fill_order_2.tif": (lambda: pillow_file(bilevel(24, 40, seed=5), "TIFF", compression="group3",
                                                           tiffinfo=info(t292=5, t266=2)), "TIFF Group 3 2-D"),
        "ccitt_rlew.tif": (lambda: pillow_file(bilevel(24, 40, seed=6), "TIFF", compression="tiff_raw_16"),
                           "TIFF CCITT RLEW"),
        "ycbcr_42_lzw.tif": (lambda: tc.ycbcr_tiff((24, 40), 4, 2, seed=3, compress=tiff_lzw, compression=5),
                             "TIFF YCbCr 4x2"),
        "float32_predictor_3_mm.tif": (lambda: tc.tiff(_floats(4), 1, 32, tc.deflate, 8, order=">", sample_format=3,
                                                       predictor=3), "TIFF float"),
        "signed16_mm_lzw.tif": (lambda: SAMPLES["signed16"](">", "lzw"), "TIFF I;16BS"),
        "bigtiff_orientation_6_planar16.tif": (lambda: tc.tiff(_ints(1, 0, 65536, (24, 40, 3)), 2, 16, planar=2,
                                                               big=True, more_tags=[(274, 3, [6])]),
                                               "BigTIFF planar, Orientation 6"),
        "cielab_lzw_mm.tif": (lambda: tc.tiff(_ints(9, 0, 256, (24, 40, 3)), 8, 8, tiff_lzw, 5, order=">"),
                              "TIFF CIELab"),
        "palette4_fill_order_2_packbits.tif": (lambda: tc.tiff(_ints(2, 0, 16, (24, 40, 1)), 3, 4, packbits, 32773,
                                                               fill_order=2, colormap=_ints(3, 0, 65536, (16, 3))),
                                               "TIFF P;4R"),
        "sim10k_crop_lzma_pred2.tif": (lambda: pillow_file(Image.fromarray(sim10k_crop()), "TIFF", compression="lzma",
                                                           tiffinfo={317: 2}), "TIFF LZMA, predictor 2"),
        "sim10k_crop_zstd_pred2.tif": (lambda: pillow_file(Image.fromarray(sim10k_crop()), "TIFF", compression="zstd",
                                                           tiffinfo={317: 2}), "TIFF ZSTD, predictor 2"),
    }


def sim10k_crop() -> np.ndarray:
    """The Sim10k frame's central 960x528 crop."""
    return _frame()[262:790, 477:1437]


def generated_files() -> dict:
    """name -> (the bytes, a label) of the files chip_smoke.py writes
    itself, whose Pillow digests fixtures.json records too."""
    import chip_smoke

    with open(os.path.join(ROOT, "tests", "torch_jpeg", "sim10k_frame_0.jpg"), "rb") as f:
        jpeg = f.read()
    return {"sim10k_frame_0_ycbcr22_packbits.tif": (lambda: chip_smoke.ycbcr_tiff_bytes(_frame()),
                                                    "TIFF YCbCr 2x2 PackBits, written by chip_smoke.py"),
            "sim10k_frame_0_ojpeg.tif": (lambda: chip_smoke.ojpeg_tiff_bytes(jpeg),
                                         "TIFF old-style JPEG, written by chip_smoke.py")}


def write_fixtures(directory: str) -> dict:
    os.makedirs(directory, exist_ok=True)
    record = {}
    for name, (make, label) in sorted({**fixture_files(), **generated_files()}.items()):
        data = make()
        if name in fixture_files():
            with open(os.path.join(directory, name), "wb") as f:
                f.write(data)
        ref = pillow_rgb(data)[0]
        record[name] = {"shape": list(ref.shape), "kind": label, "bytes": len(data), "decoder": DECODER,
                        "sha256": hashlib.sha256(ref.tobytes()).hexdigest(), "committed": name in fixture_files()}
    with open(os.path.join(directory, "fixtures.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    return record


def fixture_record() -> dict:
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(fixture_record()))
def test_committed_fixture(name):
    """Each fixture (and each frame chip_smoke.py writes): the writer here
    still writes its bytes, and the port's RGB and Pillow's hash to the
    recorded SHA-256."""
    rec = fixture_record()[name]
    make = {**fixture_files(), **generated_files()}[name][0]
    data = make()
    if rec["committed"]:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data
    got = pnc.decode_bytes(data, name)
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"]
    assert hashlib.sha256(pillow_rgb(data)[0].tobytes()).hexdigest() == rec["sha256"]


def test_fixtures_fit_the_budget():
    """Two Sim10k crops (LZMA and ZSTD, about 0.7 MiB each) and the rest."""
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 2 << 20


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        print(json.dumps(write_fixtures(FIXTURES), indent=1))
