"""Netpbm, DIB, ICO and CUR, QOI, SGI, PCX and DCX, and TGA as Pillow 12.1
reads them, against the port's decoder, tolerance 0.

Every case holds the port's `native_codec.decode` and `decode_bytes` to
Pillow's convert("RGB") and its `image_size` to Pillow's size; the cases
through `assert_reads_like_pillow` also hold the loader's `_prep_image` to
the JAX loader's, which opens these files with PIL. Files come from Pillow
where it writes the variant and from tests/torch_raster_coders.py where it
cannot (CUR, DCX, the Py heads, plain Netpbm with comments, PFM in both
byte orders, SGI RLE and 16-bit, PCX bit planes and palettes, TGA colour
maps, types 1/3/11 and both orientation bits). Damaged files are held to
Pillow case by case: the same pixels where it gives pixels, a ValueError
naming the format where it raises. The dispatch follows Image.open's
order: a file that PCX accepts and rejects is read as TGA.

The committed fixtures (tests/torch_raster/) are rebuilt by
`python tests/test_torch_raster_formats.py --write-fixtures`;
fixtures.json records the SHA-256 of Pillow's RGB of each.
"""

import hashlib
import io
import json
import os
import struct
import sys
import types
import warnings

if __name__ == "__main__":  # run as a script: the packages sit at the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

import torch_raster_coders as rc  # noqa: E402
from simple_sfod_tpu_torch.data import native_codec as pnc  # noqa: E402
from test_torch_image_containers import (  # noqa: E402,F401  (jax_loader_through_pil: autouse)
    DECODER, assert_reads_like_pillow, bmp_file, jax_loader_through_pil, pillow_file, pillow_rgb)
from test_torch_jpeg import smooth_image  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_raster")
IMG = smooth_image(37, 53, seed=11, noise=20)
GREY = IMG[..., 1]
RNG = np.random.default_rng(26)
PAL16 = RNG.integers(0, 256, (16, 3), dtype=np.uint8)
PAL256 = RNG.integers(0, 256, (256, 3), dtype=np.uint8)


def outcome(data: bytes):
    """Pillow's RGB, or None where Pillow raises."""
    try:
        return pillow_rgb(data)[0]
    except Exception:
        return None


def agrees(data: bytes, tmp_path, message=None, name="case"):
    """Where Pillow reads the file, the port reads the same pixels and size
    (decode, decode_bytes, image_size); where Pillow raises, the port raises
    a ValueError (matching `message` when given) from decode_bytes and
    decode. -> Pillow's RGB or None."""
    ref = outcome(data)
    path = tmp_path / name
    path.write_bytes(data)
    if ref is None:
        for call in (lambda: pnc.decode_bytes(data, name), lambda: pnc.decode(str(path))):
            with pytest.raises(ValueError, match=message):
                call()
        return None
    np.testing.assert_array_equal(pnc.decode_bytes(data, name), ref)
    np.testing.assert_array_equal(pnc.decode(str(path)), ref)
    assert pnc.image_size(str(path)) == pillow_rgb(data)[1]
    return ref


def pillow_saved(mode: str, fmt: str, img=IMG, **kw) -> bytes:
    im = Image.fromarray(img)
    if mode == "P":
        im = im.convert("P", palette=Image.Palette.ADAPTIVE, colors=50)
    elif mode != im.mode:
        im = im.convert(mode)
    return pillow_file(im, fmt, **kw)


# ---------------------------------------------------------------------------
# Netpbm
# ---------------------------------------------------------------------------

def _scaled(img, maxval):
    return (np.asarray(img, np.int64) * maxval + 127) // 255


NETPBM = {
    "p4-raw": lambda: rc.netpbm(GREY[..., None] < 128, b"P4"),
    "p1-plain": lambda: rc.netpbm(GREY[..., None] < 128, b"P1", plain=True),
    "p1-plain-dense": lambda: rc.netpbm(GREY[..., None] < 100, b"P1", plain=True, dense_bits=True),
    "p5-255": lambda: rc.netpbm(GREY[..., None], b"P5"),
    "p5-100": lambda: rc.netpbm(_scaled(GREY, 100)[..., None], b"P5", 100),
    "p5-1000": lambda: rc.netpbm(_scaled(GREY, 1000)[..., None], b"P5", 1000),
    "p5-65535": lambda: rc.netpbm(GREY[..., None].astype(np.int64) * 3, b"P5", 65535),
    "p5-256-values-over": lambda: rc.netpbm(GREY[..., None].astype(np.int64) + 100, b"P5", 256),
    "p2-255": lambda: rc.netpbm(GREY[..., None], b"P2", plain=True),
    "p2-31": lambda: rc.netpbm(_scaled(GREY, 31)[..., None], b"P2", 31, plain=True),
    "p2-1000": lambda: rc.netpbm(_scaled(GREY, 1000)[..., None], b"P2", 1000, plain=True),
    "p2-65535": lambda: rc.netpbm(_scaled(GREY, 65535)[..., None], b"P2", 65535, plain=True),
    "p6-255": lambda: rc.netpbm(IMG, b"P6"),
    "p6-100": lambda: rc.netpbm(_scaled(IMG, 100), b"P6", 100),
    "p6-4000": lambda: rc.netpbm(_scaled(IMG, 4000), b"P6", 4000),
    "p6-65535": lambda: rc.netpbm(_scaled(IMG, 65535), b"P6", 65535),
    "p3-255": lambda: rc.netpbm(IMG, b"P3", plain=True),
    "p3-7": lambda: rc.netpbm(_scaled(IMG, 7), b"P3", 7, plain=True),
    "p3-40000": lambda: rc.netpbm(_scaled(IMG, 40000), b"P3", 40000, plain=True),
    "comments-p6": lambda: rc.netpbm(IMG, b"P6", comments=[b" made by hand", b"", b"#twice"]),
    "comments-p2-in-header": lambda: b"P2 #magic\n5#w\n 3 # h\n#m\n255\n" + b" ".join(b"%d" % v for v in range(15)),
    "comments-p3-in-data": lambda: b"P3\n2 2\n255\n1 2 3 # c\n4 5 6\n#\n7 8 9 10 11 12",
    "comment-cr": lambda: b"P5\n# cr line\r2 1\n255\n\x10\x20",
    "tabs-and-crlf": lambda: b"P6\t2\r\n1\x0b255\x0c" + bytes(range(6)),
    "plain-tokens-split-oddly": lambda: b"P2\n4 2\n10\n0\n1\n\n2 3\t4 5 6 7\n\n",
    "plain-extra-tokens": lambda: b"P2\n2 1\n255\n1 2 3 x y",
    "pfm-little-endian": lambda: rc.pfm(np.linspace(-20, 300.5, 37 * 53, dtype=np.float32).reshape(37, 53), -1.0),
    "pfm-big-endian": lambda: rc.pfm(np.linspace(0.6, 254.5, 12 * 9, dtype=np.float32).reshape(12, 9), 2.5),
    "pfm-special-values": lambda: rc.pfm(np.array([[np.nan, np.inf, -np.inf, 254.99], [0.99, 255.0, -0.5, 1e9]],
                                                  np.float32), -0.5),
    "pyp": lambda: rc.netpbm(GREY[..., None], b"PyP"),
    "pyp-maxval-9": lambda: rc.netpbm(_scaled(GREY, 9)[..., None], b"PyP", 9),
    "pyrgba": lambda: rc.netpbm(np.concatenate([IMG, GREY[..., None]], 2), b"PyRGBA"),
    "pyrgba-1000": lambda: rc.netpbm(_scaled(np.concatenate([IMG, GREY[..., None]], 2), 1000), b"PyRGBA", 1000),
    "pycmyk": lambda: rc.netpbm(np.concatenate([IMG, GREY[..., None] // 3], 2), b"PyCMYK"),
    "p0cmyk": lambda: rc.netpbm(np.concatenate([IMG, GREY[..., None] // 2], 2), b"P0CMYK"),
    "p0cmyk-300": lambda: rc.netpbm(_scaled(np.concatenate([IMG, GREY[..., None] // 2], 2), 300), b"P0CMYK", 300),
    "pillow-ppm": lambda: pillow_saved("RGB", "PPM"),
    "pillow-pgm": lambda: pillow_saved("L", "PPM"),
    "pillow-pbm": lambda: pillow_saved("1", "PPM"),
    "pillow-pgm-16bit": lambda: pillow_file(Image.fromarray(GREY.astype(np.uint16) * 200), "PPM"),
    "pillow-pfm": lambda: pillow_file(Image.fromarray(GREY.astype(np.float32) * 1.3 - 7), "PPM"),
}


@pytest.mark.parametrize("case", sorted(NETPBM))
def test_netpbm(tmp_path, case):
    assert_reads_like_pillow(NETPBM[case](), tmp_path, "case.ppm")


NETPBM_DAMAGED = {
    "maxval-0": (b"P5\n2 1\n0\n\x00\x00", "maxval 0"),
    "maxval-65536": (b"P6\n1 1\n65536\n" + bytes(6), "maxval 65536"),
    "pfm-scale-0": (b"Pf\n1 1\n0.0\n" + bytes(4), "PFM scale"),
    "pfm-scale-nan": (b"Pf\n1 1\nnan\n" + bytes(4), "PFM scale"),
    "pfm-scale-word": (b"Pf\n1 1\nbig\n" + bytes(4), "Netpbm header field"),
    "token-too-long": (b"P5\n12345678901 1\n255\n", "longer than 10"),
    "header-ends": (b"P6\n3 2\n", "header ends early"),
    "width-not-a-number": (b"P5\nx3 2\n255\n" + bytes(6), "not a number"),
    "plain-bad-bit": (b"P1\n3 1\n0 1 2", "not 0 or 1"),
    "plain-bit-after-data": (b"P1\n2 1\n0 1 1 0 5", "not 0 or 1"),
    "plain-over-maxval": (b"P2\n2 1\n100\n5 101", "outside"),
    "plain-negative": (b"P2\n2 1\n100\n5 -1", "outside"),
    "plain-word": (b"P3\n1 1\n255\n1 2 three", "not a number"),
    "plain-long-token": (b"P2\n2 1\n255\n1 000000000002", "longer than 10"),
    "plain-long-last-token": (b"P2\n1 1\n255\n1 000000000002", "longer than 10"),
    "plain-truncated": (b"P2\n3 2\n255\n1 2 3", "truncated"),
    "plain-bits-truncated": (b"P1\n3 2\n1 0 1 0", "truncated"),
    "raw-truncated": (b"P6\n3 2\n255\n" + bytes(17), "truncated"),
    "raw-scaled-truncated": (b"P5\n3 2\n1000\n" + bytes(11), "truncated"),
    "pbm-truncated": (b"P4\n9 2\n" + bytes(3), "truncated"),
    "pfm-truncated": (b"Pf\n2 2\n-1\n" + bytes(15), "truncated"),
    "width-0": (b"P5\n0 2\n255\n", "not a PNG"),
    "height-negative": (b"P5\n2 -2\n255\n" + bytes(4), "not a PNG"),
    "magic-p7": (b"P7\n2 2\n255\n" + bytes(4), "not a PNG"),
    "magic-glued-comment": (b"P6#c\n2 2\n255\n" + bytes(12), "not a PNG"),
}


@pytest.mark.parametrize("case", sorted(NETPBM_DAMAGED))
def test_netpbm_damaged(tmp_path, case):
    data, message = NETPBM_DAMAGED[case]
    assert agrees(data, tmp_path, message) is None


def test_plain_netpbm_read_in_blocks(tmp_path):
    """A plain PGM longer than Pillow's 1 MiB read block: tokens and a
    comment cut by the block boundary, as PpmPlainDecoder stitches them."""
    vals = RNG.integers(0, 65536, 200000)
    body = b" ".join(b"%d" % v for v in vals)
    cut = 1 << 20
    body = body[:cut - 5] + b"#comment spanning the block\n" + body[cut - 5:]
    data = b"P2\n500 400\n65535\n" + body
    assert agrees(data, tmp_path) is not None


# ---------------------------------------------------------------------------
# DIB
# ---------------------------------------------------------------------------

DIB = {
    "pillow-rgb": lambda: pillow_saved("RGB", "DIB"),
    "pillow-l": lambda: pillow_saved("L", "DIB"),
    "pillow-p": lambda: pillow_saved("P", "DIB"),
    "pillow-1": lambda: pillow_saved("1", "DIB"),
    "core-header-4bit": lambda: rc.dib(GREY // 16, 4, PAL16, doubled=False, header=12),
    "bitfields-565": lambda: bmp_file(np.frombuffer(((GREY.astype(np.uint16) >> 3) * 0x0841).astype("<u2").tobytes(),
                                                    np.uint8).reshape(37, -1), 16, 53, 37,
                                      masks=(0xF800, 0x7E0, 0x1F), compression=3, masks_after=True)[14:],
    "rle8": lambda: _rle8_dib(),
}


def _rle8_dib() -> bytes:
    from test_torch_image_containers import rle_stream

    idx = (GREY // 5).astype(np.uint8)
    return bmp_file(rle_stream(idx[::-1], False), 8, 53, 37, palette=PAL256, compression=1)[14:]


@pytest.mark.parametrize("case", sorted(DIB))
def test_dib(tmp_path, case):
    assert_reads_like_pillow(DIB[case](), tmp_path, "case.dib")


def _dib_palette(colors: int, grey: bool) -> bytes:
    pal = np.zeros((colors, 4), np.uint8)
    pal[:, :3] = (np.arange(colors) % 256)[:, None] if grey else RNG.integers(0, 256, (colors, 3))
    info = struct.pack("<IiiHHIIiiII", 40, 53, 37, 1, 8, 0, 0, 0, 0, colors, 0)
    return info + pal.tobytes() + np.pad(GREY[::-1], ((0, 0), (0, 3))).tobytes()


@pytest.mark.parametrize("colors,grey", [(256, False), (300, True), (300, False), (65536, True), (65537, True)])
def test_dib_palette_sizes(tmp_path, colors, grey):
    """Pillow 12.1 takes up to 65536 palette entries: a grey ramp of any
    length is dropped (mode L); more than 256 colours fail its palette."""
    agrees(_dib_palette(colors, grey), tmp_path, "palette of")


def test_dib_damaged(tmp_path):
    """A DIB whose masks are cut off falls through Pillow's plugins (and the
    port's) to nothing; a cut header, an unknown depth and pixels cut short
    are refused as Pillow refuses them."""
    masks = DIB["bitfields-565"]()
    cases = [(masks[:44], "not a PNG"), (pillow_saved("RGB", "DIB")[:30], "truncated BMP header"),
             (pillow_saved("RGB", "DIB")[:-200], "truncated BMP"),
             (struct.pack("<IiiHHI", 40, 4, 4, 1, 7, 0) + bytes(100), "pixel depth 7")]
    for data, message in cases:
        assert agrees(data, tmp_path, message) is None


# ---------------------------------------------------------------------------
# ICO and CUR
# ---------------------------------------------------------------------------

SQ = smooth_image(48, 48, seed=12, noise=25)
SQA = np.concatenate([SQ, (SQ[..., :1] // 2 + 100)], 2)
ICON_SIZES = [(16, 16), (32, 32), (48, 48)]


def _bmp_icon(bits: int, size: int = 32, mask=None, bpp=None, **kw) -> bytes:
    img = SQ[:size, :size]
    if bits <= 8:
        px = (img[..., 0] >> (8 - bits)).astype(np.uint8)
        payload = rc.dib(px, bits, PAL256[:1 << bits], and_mask=mask, **kw)
    elif bits == 24:
        payload = rc.dib(img, 24, and_mask=mask, **kw)
    else:
        payload = rc.dib(SQA[:size, :size], 32, and_mask=mask, **kw)
    return rc.icon_dir(1, [(size, size, 0 if bits >= 8 else 1 << bits, 1, bpp or bits, payload)])


ICO = {
    "pillow-png-rgba": lambda: pillow_file(Image.fromarray(SQA), "ICO", sizes=ICON_SIZES),
    "pillow-png-p": lambda: pillow_saved("P", "ICO", SQ, sizes=ICON_SIZES),
    "pillow-bmp-rgba": lambda: pillow_file(Image.fromarray(SQA), "ICO", sizes=ICON_SIZES, bitmap_format="bmp"),
    "pillow-bmp-rgb": lambda: pillow_saved("RGB", "ICO", SQ, sizes=ICON_SIZES, bitmap_format="bmp"),
    "pillow-bmp-p": lambda: pillow_saved("P", "ICO", SQ, sizes=ICON_SIZES, bitmap_format="bmp"),
    "pillow-bmp-l": lambda: pillow_saved("L", "ICO", SQ, sizes=ICON_SIZES, bitmap_format="bmp"),
    "bmp-1bit-mask": lambda: _bmp_icon(1, mask=SQ[:32, :32, 0] > 128),
    "bmp-4bit": lambda: _bmp_icon(4, 16),
    "bmp-8bit-odd-width": lambda: rc.icon_dir(1, [(13, 13, 0, 1, 8, rc.dib((SQ[:13, :13, 1]), 8, PAL256))]),
    "bmp-24bit": lambda: _bmp_icon(24, 48),
    "bmp-32bit": lambda: _bmp_icon(32, 32),
    "bmp-32bit-dir-says-24": lambda: _bmp_icon(32, 32, bpp=24),
    "entry-256": lambda: rc.icon_dir(1, [(0, 0, 0, 1, 32, pillow_file(Image.fromarray(
        np.repeat(np.repeat(SQA, 6, 0), 6, 1)[:256, :256]), "PNG"))]),
    "sorted-depth-first": lambda: rc.icon_dir(1, [
        (32, 32, 0, 1, 32, rc.dib(SQA[:32, :32], 32)), (32, 32, 0, 1, 8, rc.dib(SQ[:32, :32, 2], 8, PAL256)),
        (16, 16, 0, 1, 24, rc.dib(SQ[:16, :16], 24))]),
    "png-and-bmp-entries": lambda: rc.icon_dir(1, [
        (16, 16, 0, 1, 32, pillow_file(Image.fromarray(SQA[:16, :16]), "PNG")),
        (48, 48, 0, 1, 24, rc.dib(SQ, 24))]),
    "size-differs-from-directory": lambda: rc.icon_dir(1, [(16, 16, 0, 1, 24, rc.dib(SQ[:40, :24], 24))]),
    "png-size-differs": lambda: rc.icon_dir(1, [(16, 16, 0, 1, 32, pillow_file(Image.fromarray(SQA[:20, :30]),
                                                                                    "PNG"))]),
}


@pytest.mark.parametrize("case", sorted(ICO))
def test_ico(tmp_path, case):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "Image was not the expected size"
        assert_reads_like_pillow(ICO[case](), tmp_path, "case.ico")


def test_ico_size_is_the_entrys_own(tmp_path):
    """A directory that says 16x16 over a 24x40 bitmap: Pillow's open loads
    the entry and reports its own size; decode, image_size, the loader and
    the toolkit all see 24 wide and 40 high, as the JAX entry points do."""
    from simple_sfod_tpu.evaluation import toolkit as jax_toolkit
    from simple_sfod_tpu_torch.evaluation import toolkit

    data = ICO["size-differs-from-directory"]()
    (tmp_path / "a.ico").write_bytes(data)
    assert pnc.image_size(str(tmp_path / "a.ico")) == (40, 24) == pillow_rgb(data)[1]
    assert pnc.decode_bytes(data).shape == (40, 24, 3)
    (tmp_path / "a.bmp").write_bytes(data)  # the toolkit reads .bmp names; Image.open goes by the bytes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert toolkit._image_size(str(tmp_path), "a") == jax_toolkit._image_size(str(tmp_path), "a") == (24, 40)


CUR_ENTRIES = {
    "cur-24bit": lambda: rc.icon_dir(2, [(32, 32, 0, 3, 5, rc.dib(SQ[:32, :32], 24))]),
    "cur-32bit-single": lambda: rc.icon_dir(2, [(32, 32, 0, 0, 0, rc.dib(SQA[:32, :32], 32))]),
    "cur-8bit": lambda: rc.icon_dir(2, [(24, 24, 0, 1, 1, rc.dib(SQ[:24, :24, 0], 8, PAL256))]),
    "cur-1bit": lambda: rc.icon_dir(2, [(40, 40, 2, 0, 0, rc.dib(SQ[:40, :40, 1] > 120, 1,
                                                                 [(0, 0, 0), (255, 255, 255)]))]),
    "cur-largest-wins": lambda: rc.icon_dir(2, [
        (16, 16, 0, 0, 0, rc.dib(SQ[:16, :16], 24)), (32, 32, 0, 0, 0, rc.dib(SQ[:32, :32, 0], 8, PAL256)),
        (48, 32, 0, 0, 0, rc.dib(SQ[:32, :48], 24)), (24, 24, 0, 0, 0, rc.dib(SQ[:24, :24], 24))]),
    "cur-offset-0": lambda: _cur_offset_0(),
}


def _cur_offset_0() -> bytes:
    """An entry whose offset field is 0: Pillow's _bitmap(header=0) reads
    the bitmap where the directory ends."""
    d = rc.icon_dir(2, [(16, 16, 0, 0, 0, rc.dib(SQ[:16, :16], 24))])
    return d[:18] + bytes(4) + d[22:]


@pytest.mark.parametrize("case", sorted(CUR_ENTRIES))
def test_cur(tmp_path, case):
    assert_reads_like_pillow(CUR_ENTRIES[case](), tmp_path, "case.cur")


ICON_DAMAGED = {
    "ico-entry-past-end": lambda: rc.icon_dir(1, [(16, 16, 0, 1, 24, b"", 5000)]),
    "ico-no-entries": lambda: rc.icon_dir(1, []),
    "ico-directory-cut": lambda: _bmp_icon(24, 16)[:14],
    "ico-and-mask-cut": lambda: _bmp_icon(8, 32)[:-60],
    "ico-and-mask-before-file": lambda: rc.icon_dir(1, [(32, 32, 0, 1, 8, rc.dib(SQ[:32, :32, 0], 8, PAL256), 22,
                                                          10)]),
    "ico-32bit-alpha-cut": lambda: _bmp_icon(32, 32)[:-900],
    "ico-pixels-cut": lambda: _bmp_icon(24, 48, bpp=32)[:3000],
    "ico-png-cut": lambda: pillow_file(Image.fromarray(SQA), "ICO", sizes=[(48, 48)])[:200],
    "ico-dib-header-size": lambda: rc.icon_dir(1, [(16, 16, 0, 1, 24, struct.pack("<I", 20) + bytes(60))]),
    "ico-height-1": lambda: rc.icon_dir(1, [(4, 1, 0, 1, 24, struct.pack("<IiiHHIIiiII", 40, 4, 1, 1, 24, 0, 0, 0, 0,
                                                                         0, 0) + bytes(60))]),
    "ico-png-bad-ihdr-crc": lambda: _png_entry_patched(29),
    "ico-png-bad-adler32": lambda: _png_entry_patched(-13),
    "ico-png-junk-after-idat": lambda: _png_entry_patched(-9, b"\xff" * 9),
    "cur-no-entries": lambda: rc.icon_dir(2, []),
    "cur-entry-cut": lambda: CUR_ENTRIES["cur-24bit"]()[:12],
    "cur-pixels-cut": lambda: CUR_ENTRIES["cur-24bit"]()[:400],
    "cur-height-1": lambda: rc.icon_dir(2, [(4, 1, 0, 0, 0, struct.pack("<IiiHHIIiiII", 40, 4, 1, 1, 24, 0, 0, 0, 0,
                                                                        0, 0) + bytes(60))]),
}


def _png_entry_patched(at: int, new: bytes = None) -> bytes:
    """An ICO of one PNG entry with the PNG's byte `at` flipped (29: in
    IHDR's CRC; -13: in the zlib stream's Adler-32, which Pillow's decoder
    never reaches) or its bytes from `at` replaced by `new` (the IEND chunk
    after the image data)."""
    png = bytearray(pillow_file(Image.fromarray(SQA[:16, :16]), "PNG"))
    if new is None:
        png[at] ^= 0x5A
    else:
        png[at:] = new
    return rc.icon_dir(1, [(16, 16, 0, 1, 32, bytes(png))])


@pytest.mark.parametrize("case", sorted(ICON_DAMAGED))
def test_icon_damaged(tmp_path, case):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        agrees(ICON_DAMAGED[case](), tmp_path)


# ---------------------------------------------------------------------------
# QOI
# ---------------------------------------------------------------------------

QOI = {
    "pillow-rgb": lambda: pillow_saved("RGB", "QOI"),
    "pillow-rgba": lambda: pillow_file(Image.fromarray(np.concatenate([IMG, GREY[..., None]], 2)), "QOI"),
    "pillow-flat-runs": lambda: pillow_saved("RGB", "QOI", np.repeat(IMG[::8, ::8], 8, 0).repeat(8, 1)),
    "index-never-written": lambda: rc.qoi(4, 1, 4, bytes([0x05, 0x00, 0xFE, 1, 2, 3, 0x35])),
    "run-past-the-end": lambda: rc.qoi(3, 2, 3, bytes([0xFE, 9, 8, 7, 0xC8])),
    "diff-and-luma-wrap": lambda: rc.qoi(4, 1, 3, bytes([0x40, 0x7F, 0x80, 0x00, 0xBF, 0xFF])),
    "rgba-then-rgb-keeps-alpha": lambda: rc.qoi(2, 1, 4, bytes([0xFF, 1, 2, 3, 4, 0xFE, 5, 6, 7])),
    "channels-5-is-rgba": lambda: rc.qoi(2, 1, 5, bytes([0xFE, 5, 6, 7, 0xC0])),
    "no-end-marker": lambda: rc.qoi(2, 2, 3, bytes([0xFE, 50, 60, 70, 0xC2]), end=False),
}


@pytest.mark.parametrize("case", sorted(QOI))
def test_qoi(tmp_path, case):
    assert_reads_like_pillow(QOI[case](), tmp_path, "case.qoi")


@pytest.mark.parametrize("cut", range(5))
def test_qoi_damaged(tmp_path, cut):
    """Ops cut inside an RGB, RGBA or LUMA op or between ops, and a header
    cut before its channels: refused as Pillow refuses them."""
    ops = bytes([0xFE, 1, 2, 3, 0xFF, 4, 5, 6, 7, 0x80, 0x88])
    data = [rc.qoi(8, 1, 3, ops[:2], end=False), rc.qoi(8, 1, 3, ops[:7], end=False),
            rc.qoi(8, 1, 3, ops[:10], end=False), rc.qoi(8, 1, 3, ops, end=False), b"qoif" + bytes(8)][cut]
    assert agrees(data, tmp_path, "QOI|not a PNG") is None


# ---------------------------------------------------------------------------
# SGI
# ---------------------------------------------------------------------------

SGI_IMG = smooth_image(21, 34, seed=13, noise=6)
SGI_16 = SGI_IMG.astype(np.int64) * 257 + np.arange(34)[None, :, None]


def _sgi_planes(z):
    return np.concatenate([SGI_IMG, SGI_IMG[..., :1]], 2)[..., :z] if z != 1 else SGI_IMG[..., 1:2]


SGI = {f"{'rle' if r else 'raw'}-{b * 8}bit-{z}ch": (lambda r=r, b=b, z=z: rc.sgi(
    _sgi_planes(z) if b == 1 else np.concatenate([SGI_16, SGI_16[..., :1]], 2)[..., :z] if z != 1 else SGI_16[..., 1:2],
    b, r)) for r in (False, True) for b in (1, 2) for z in (1, 3, 4)}
SGI.update({
    "pillow-rgb": lambda: pillow_saved("RGB", "SGI"),
    "pillow-l": lambda: pillow_saved("L", "SGI"),
    "pillow-rgba": lambda: pillow_file(Image.fromarray(np.concatenate([IMG, GREY[..., None]], 2)), "SGI"),
    "dimension-1": lambda: rc.sgi(SGI_IMG[:1, :, :1], 1, True, dimension=1),
    "dimension-1-raw-rows": lambda: rc.sgi(SGI_IMG[:3, :, :1], 1, False, dimension=1),
    "rle-lengths-one-short": lambda: rc.sgi(SGI_IMG, 1, True, lengths=lambda n: n - 1),
    "rle-lengths-long": lambda: rc.sgi(SGI_IMG, 2, True, lengths=lambda n: n + 3),
    "rle-shared-rows": lambda: _sgi_shared_rows(),
})


def _sgi_shared_rows() -> bytes:
    """Every row of every channel pointing at the first row's data: the
    tables need not be in order or disjoint."""
    data = bytearray(rc.sgi(SGI_IMG, 1, True))
    n = 21 * 3
    first = struct.unpack_from(">I", data, 512)[0]
    flen = struct.unpack_from(">I", data, 512 + 4 * n)[0]
    struct.pack_into(">%dI" % n, data, 512, *([first] * n))
    struct.pack_into(">%dI" % n, data, 512 + 4 * n, *([flen] * n))
    return bytes(data)


@pytest.mark.parametrize("case", sorted(SGI))
def test_sgi(tmp_path, case):
    assert_reads_like_pillow(SGI[case](), tmp_path, "case.sgi")


def _sgi_patch(data: bytes, at: int, value: int) -> bytes:
    d = bytearray(data)
    struct.pack_into(">I", d, at, value)
    return bytes(d)


SGI_DAMAGED = {
    "two-channels": lambda: rc.sgi(SGI_IMG[..., :2], 1, False),
    "bpc-3": lambda: rc.sgi(SGI_IMG, 1, False)[:3] + b"\x03" + rc.sgi(SGI_IMG, 1, False)[4:],
    "compression-2": lambda: rc.sgi(SGI_IMG, 1, False, compression=2),
    "raw-truncated": lambda: rc.sgi(SGI_IMG, 1, False)[:-10],
    "raw16-truncated": lambda: rc.sgi(SGI_16, 2, False)[:-10],
    "rle-tables-cut": lambda: rc.sgi(SGI_IMG, 1, True)[:600],
    "rle-offset-below-512": lambda: _sgi_patch(rc.sgi(SGI_IMG, 1, True), 512 + 8, 100),
    "rle-length-past-file": lambda: _sgi_patch(rc.sgi(SGI_IMG, 1, True), 512 + 4 * 63 + 8, 1 << 20),
    "rle-data-cut": lambda: rc.sgi(SGI_IMG, 1, True)[:-40],
    "rle-unterminated-rows": lambda: rc.sgi(SGI_IMG, 1, True, terminate=False),
    "rle-run-past-row": lambda: rc.sgi(np.zeros((2, 4, 1), np.int64), 1, True)[:-8] + bytes([9, 1, 0, 0, 0, 0, 0, 0]),
    "header-cut": lambda: rc.sgi(SGI_IMG, 1, False)[:9],
}


@pytest.mark.parametrize("case", sorted(SGI_DAMAGED))
def test_sgi_damaged(tmp_path, case):
    agrees(SGI_DAMAGED[case](), tmp_path, "SGI|not a PNG")


@pytest.mark.parametrize("seed", range(6))
def test_sgi_rle_flips(tmp_path, seed):
    """Seeded byte flips in the tables and rows of a 16-bit RLE file: the
    port and Pillow agree flip by flip (pixels, or both refuse)."""
    data = bytearray(rc.sgi(np.concatenate([SGI_16, SGI_16[..., :1]], 2)[:8, :12], 2, True))
    r = np.random.default_rng(seed)
    for at in r.integers(512, len(data), 3):
        data[at] = int(r.integers(0, 256))
    agrees(bytes(data), tmp_path)


# ---------------------------------------------------------------------------
# PCX and DCX
# ---------------------------------------------------------------------------

def _pcx_bits(w, planes, stride=None, window=(0, 0), bits=1, palette=True):
    idx = (smooth_image(19, w, seed=w, noise=10)[..., 0] >> (8 - planes)).astype(np.uint8)
    s = stride or ((w + 7) // 8 + ((w + 7) // 8) % 2)
    return rc.pcx(rc.pcx_lines(idx, 1, planes, s), w, 19, bits, planes, window=window, bytes_per_line=s,
                  palette16=PAL16 if palette else None)


def _pcx8(w, planes=1, version=5, stride=None, palette=PAL256, window=(0, 0)):
    img = smooth_image(17, w, seed=w + 1, noise=10)
    s = stride or (w + w % 2)
    src = img if planes == 3 else img[..., 0]
    return rc.pcx(rc.pcx_lines(src, 8, planes, s), w, 17, 8, planes, version, window=window, bytes_per_line=s,
                  palette256=palette if planes == 1 else None)


PCX = {
    "pillow-rgb": lambda: pillow_saved("RGB", "PCX"),
    "pillow-l": lambda: pillow_saved("L", "PCX"),
    "pillow-p": lambda: pillow_saved("P", "PCX"),
    "pillow-1": lambda: pillow_saved("1", "PCX"),
    "1bit-1plane": lambda: _pcx_bits(29, 1),
    "1bit-2planes": lambda: _pcx_bits(29, 2),
    "1bit-4planes": lambda: _pcx_bits(40, 4),
    "1bit-4planes-odd-stride-given": lambda: _pcx_bits(21, 4, stride=3),
    "1bit-4planes-narrow": lambda: _pcx_bits(3, 4),
    "1bit-4planes-header-says-raw": lambda: _pcx_bits(16, 4)[:2] + b"\x00" + _pcx_bits(16, 4)[3:],
    "8bit-palette": lambda: _pcx8(30),
    "8bit-grey-palette": lambda: _pcx8(30, palette=np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)),
    "8bit-no-palette": lambda: _pcx8(30, palette=None) + bytes(800),
    "8bit-odd-width": lambda: _pcx8(31),
    "8bit-odd-width-odd-stride": lambda: _pcx8(31, stride=31),
    "8bit-window": lambda: _pcx8(30, window=(100, 7)),
    "rgb-odd-width": lambda: _pcx8(31, planes=3),
    "rgb-width-1": lambda: _pcx8(1, planes=3),
    "rgb-width-3": lambda: _pcx8(3, planes=3),
    "rgb-window": lambda: _pcx8(24, planes=3, window=(5, 9)),
    "version-0-1bit": lambda: rc.pcx(rc.pcx_lines(GREY[:9, :16] > 128, 1, 1, 2), 16, 9, 1, 1, version=0),
}


@pytest.mark.parametrize("case", sorted(PCX))
def test_pcx(tmp_path, case):
    assert_reads_like_pillow(PCX[case](), tmp_path, "case.pcx")


def test_pcx_short_file_from_disk_and_from_bytes(tmp_path):
    """An 8-bit PCX shorter than 769 bytes: Pillow seeks 769 bytes before
    its end for the palette, which fails on a file (the loader's Image.open
    of a path) and stops at 0 in memory (the server's BytesIO). The port's
    decode and decode_bytes do each."""
    data = rc.pcx(rc.pcx_lines(GREY[:6, :10], 8, 1, 10), 10, 6, 8, 1)
    (tmp_path / "s.pcx").write_bytes(data)
    with pytest.raises(OSError):
        with Image.open(str(tmp_path / "s.pcx")) as im:
            im.convert("RGB")
    with pytest.raises(ValueError, match="shorter than the 769 bytes"):
        pnc.decode(str(tmp_path / "s.pcx"))
    with pytest.raises(ValueError, match="shorter than the 769 bytes"):
        pnc.image_size(str(tmp_path / "s.pcx"))
    np.testing.assert_array_equal(pnc.decode_bytes(data), pillow_rgb(data)[0])


DCX = {
    "two-pages": lambda: rc.dcx([_pcx8(24, planes=3), pillow_saved("L", "PCX")]),
    "one-page": lambda: rc.dcx([_pcx_bits(29, 4)]),
    "grey-page-palette-from-file-end": lambda: rc.dcx([_pcx8(24), pillow_saved("RGB", "PCX")]),
}


@pytest.mark.parametrize("case", sorted(DCX))
def test_dcx(tmp_path, case):
    assert_reads_like_pillow(DCX[case](), tmp_path, "case.dcx")


PCX_DAMAGED = {
    "2bit": (lambda: _pcx_bits(16, 1, bits=2), "unknown PCX mode|2 bits"),
    "4bit": (lambda: _pcx_bits(16, 1, bits=4), "4 bits"),
    "1bit-3planes": (lambda: _pcx_bits(16, 3), "3 planes"),
    "8bit-version-2": (lambda: _pcx8(16, version=2), "version 2"),
    "8bit-2planes": (lambda: _pcx8(16)[:65] + b"\x02" + _pcx8(16)[66:], "2 planes"),
    "run-past-line": (lambda: rc.pcx(np.zeros((2, 4), np.uint8), 4, 2, 8, 1)[:128] + bytes([0xC6, 9, 1, 2, 3, 4])
                      + bytes(800), "run past"),
    "rgb-given-stride-wider": (lambda: _pcx8(20, planes=3, stride=24), "run past"),
    "truncated": (lambda: _pcx8(30, planes=3)[:-100], "truncated PCX"),
    "window-backwards": (lambda: _pcx8(16)[:4] + struct.pack("<HH", 50, 0) + _pcx8(16)[8:], "not a PNG"),
    "header-cut": (lambda: _pcx8(16)[:40], "not a PNG"),
    "dcx-no-pages": (lambda: struct.pack("<II", 987654321, 0), "not a PNG"),
    "dcx-table-unterminated": (lambda: struct.pack("<II", 987654321, 8), "not a PNG"),
    "dcx-page-past-end": (lambda: struct.pack("<III", 987654321, 5000, 0), "not a PNG"),
}


@pytest.mark.parametrize("case", sorted(PCX_DAMAGED))
def test_pcx_damaged(tmp_path, case):
    make, message = PCX_DAMAGED[case]
    assert agrees(make(), tmp_path, message) is None


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

TGA_IMG = smooth_image(23, 37, seed=14, noise=15)


def _tga_px(itype: int, depth: int) -> bytes:
    """Stored pixel bytes for the image type and depth (rows top first)."""
    base = itype & 7
    if base == 1:
        return (TGA_IMG[..., 0] // 8).astype(np.uint8).tobytes()
    if base == 3:
        if depth == 1:
            return np.packbits(TGA_IMG[..., 1] > 128, axis=1).tobytes()
        if depth == 16:
            return np.stack([TGA_IMG[..., 1], TGA_IMG[..., 2]], 2).tobytes()
        return TGA_IMG[..., 1].tobytes()
    if depth == 16:
        v = ((TGA_IMG[..., 0].astype(np.uint16) >> 3) << 10) | ((TGA_IMG[..., 1].astype(np.uint16) >> 3) << 5) | \
            (TGA_IMG[..., 2] >> 3) | ((TGA_IMG[..., 0] > 100).astype(np.uint16) << 15)
        return v.astype("<u2").tobytes()
    if depth == 24:
        return TGA_IMG[..., ::-1].tobytes()
    return np.concatenate([TGA_IMG[..., ::-1], TGA_IMG[..., :1]], 2).tobytes()


def _tga_cmap(bits: int, first: int = 0, n: int = 32) -> tuple:
    pal = PAL256[first:first + n]
    if bits == 16:
        v = ((pal[:, 0].astype(np.uint16) >> 3) << 10) | ((pal[:, 1].astype(np.uint16) >> 3) << 5) | (pal[:, 2] >> 3)
        return first, v.astype("<u2").tobytes(), 16
    if bits == 24:
        return first, pal[:, ::-1].tobytes(), 24
    return first, np.concatenate([pal[:, ::-1], pal[:, :1]], 1).tobytes(), 32


def _tga(itype, depth, cmap=None, flags=0x20, **kw) -> bytes:
    px = _tga_px(itype, depth)
    if not flags & 0x20:  # bottom-up storage
        line = len(px) // 23
        px = b"".join(px[i * line:(i + 1) * line] for i in range(22, -1, -1))
    return rc.tga(px, 37, 23, itype, depth, cmap=cmap, flags=flags, **kw)


TGA = {f"type{t}-{d}bit": (lambda t=t, d=d: _tga(t, d)) for t, d in
       ((2, 16), (2, 24), (2, 32), (3, 1), (3, 8), (3, 16), (10, 16), (10, 24), (10, 32), (11, 8), (11, 16))}
TGA.update({f"type{t}-cmap{b}": (lambda t=t, b=b: _tga(t, 8, _tga_cmap(b))) for t in (1, 9) for b in (16, 24)})
TGA.update({f"orientation-{f:#04x}": (lambda f=f: _tga(10, 24, flags=f)) for f in (0x00, 0x10, 0x20, 0x30)})
TGA.update({
    "cmap-first-index": lambda: _tga(1, 8, _tga_cmap(24, first=5, n=20)),
    "grey-with-colour-map": lambda: _tga(11, 8, _tga_cmap(16, n=200)),
    "grey-alpha-with-colour-map": lambda: _tga(3, 16, _tga_cmap(24, n=256)),
    "cmap-short-indices-past-it": lambda: _tga(9, 8, _tga_cmap(24, n=10)),
    "attribute-bits": lambda: _tga(10, 32, flags=0x28),
    "image-id": lambda: _tga(2, 24, image_id=b"a TGA image id"),
    "rle-literals-across-rows": lambda: _tga_across_rows(),
    "pillow-rgb": lambda: pillow_saved("RGB", "TGA"),
    "pillow-rgba-rle": lambda: pillow_file(Image.fromarray(np.concatenate([IMG, GREY[..., None]], 2)), "TGA",
                                           compression="tga_rle"),
    "pillow-l-rle-bottom-up": lambda: pillow_saved("L", "TGA", compression="tga_rle", orientation=-1),
    "pillow-la": lambda: pillow_saved("LA", "TGA"),
    "pillow-p": lambda: pillow_saved("P", "TGA"),
    "pillow-1": lambda: pillow_saved("1", "TGA"),
})


def _tga_across_rows() -> bytes:
    """A literal packet of 30 pixels from the middle of one row into the
    next, and a run that ends a row, as TgaRleDecode.c reads them."""
    px = TGA_IMG[:2, :20, ::-1].reshape(-1, 3)
    body = bytes([0x89]) + px[0].tobytes() + bytes([29]) + px[10:40].tobytes()
    return rc.tga(b"", 20, 2, 10, 24, flags=0x20, body=body)


@pytest.mark.parametrize("case", sorted(TGA))
def test_tga(tmp_path, case):
    assert_reads_like_pillow(TGA[case](), tmp_path, "case.tga")


TGA_DAMAGED = {
    "type-5": (lambda: _tga(2, 24)[:2] + b"\x05" + _tga(2, 24)[3:], "not a PNG"),
    "depth-15": (lambda: _tga(2, 16)[:16] + b"\x0f" + _tga(2, 16)[17:], "not a PNG"),
    "cmap-depth-15": (lambda: _tga(1, 8, _tga_cmap(16))[:7] + b"\x0f" + _tga(1, 8, _tga_cmap(16))[8:], "not a PNG"),
    "colour-map-type-2": (lambda: _tga(2, 24)[:1] + b"\x02" + _tga(2, 24)[2:], "not a PNG"),
    "width-0": (lambda: _tga(2, 24)[:12] + b"\x00\x00" + _tga(2, 24)[14:], "not a PNG"),
    "type2-depth8": (lambda: rc.tga(bytes(8), 4, 2, 2, 8), "TGA of 8 bits"),
    "type3-depth24": (lambda: rc.tga(bytes(24), 4, 2, 3, 24), "TGA of 24 bits"),
    "type1-without-map": (lambda: rc.tga(bytes(8), 4, 2, 1, 8), "without a colour map"),
    "type1-cmap32": (lambda: _tga(1, 8, _tga_cmap(32)), "32-bit colour map"),
    "type9-cmap32": (lambda: _tga(9, 8, _tga_cmap(32)), "32-bit colour map"),
    "truecolour-with-colour-map": (lambda: _tga(2, 24, _tga_cmap(24)), "colour map beside"),
    "grey-with-32-bit-map": (lambda: _tga(3, 8, _tga_cmap(32)), "32-bit colour map"),
    "1bit-with-colour-map": (lambda: _tga(3, 1, _tga_cmap(24)), "colour map beside"),
    "type11-1bit": (lambda: _tga(11, 1), "RLE TGA at 1 bit"),
    "cmap-300-entries": (lambda: _tga(1, 8, (0, bytes(900), 24)), "colour map of 300"),
    "run-across-rows": (lambda: rc.tga(b"", 4, 2, 10, 24, body=bytes([0x85, 1, 2, 3, 0x81, 4, 5, 6])), "run past"),
    "rle-truncated": (lambda: _tga(10, 24)[:-30], "truncated TGA"),
    "raw-truncated": (lambda: _tga(2, 32)[:-1], "truncated TGA"),
    "header-cut": (lambda: _tga(2, 24)[:15], "not a PNG"),
}


@pytest.mark.parametrize("case", sorted(TGA_DAMAGED))
def test_tga_damaged(tmp_path, case):
    make, message = TGA_DAMAGED[case]
    assert agrees(make(), tmp_path, message) is None


# ---------------------------------------------------------------------------
# seeded damage: flips in the header, flips anywhere, cuts
# ---------------------------------------------------------------------------

DAMAGE_BASES = {"ppm": NETPBM["p6-100"], "plain-pgm": NETPBM["p2-1000"], "pfm": NETPBM["pfm-big-endian"],
                "dib": DIB["pillow-p"], "ico": ICO["bmp-1bit-mask"], "ico-png": ICO["png-and-bmp-entries"],
                "cur": CUR_ENTRIES["cur-largest-wins"], "qoi": QOI["pillow-rgba"], "sgi": SGI["rle-8bit-4ch"],
                "pcx": PCX["1bit-4planes"], "dcx": DCX["two-pages"], "tga": TGA["type9-cmap16"]}
DAMAGE = [(k, seed) for k in sorted(DAMAGE_BASES) for seed in range(4)]


@pytest.mark.parametrize("kind,seed", DAMAGE, ids=[f"{k}-{s}" for k, s in DAMAGE])
def test_seeded_damage_agrees_with_pillow(tmp_path, kind, seed):
    """Each base file with 1-2 bytes of its first 64 replaced, 3 bytes
    anywhere replaced, and cut at a seeded length: the port reads the
    pixels Pillow reads, or raises a ValueError where Pillow raises."""
    base = DAMAGE_BASES[kind]()
    r = np.random.default_rng(seed)
    head, anywhere = bytearray(base), bytearray(base)
    for at in r.integers(0, min(64, len(base)), 1 + seed % 2):
        head[at] = int(r.integers(0, 256))
    for at in r.integers(0, len(base), 3):
        anywhere[at] = int(r.integers(0, 256))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, data in enumerate((bytes(head), bytes(anywhere), base[:int(r.integers(0, len(base)))])):
            agrees(data, tmp_path, name=f"d{i}")


# ---------------------------------------------------------------------------
# the dispatch: Image.open's order
# ---------------------------------------------------------------------------

def test_a_file_pcx_rejects_is_read_as_tga(tmp_path):
    """A TGA whose first bytes PCX's test accepts (an image ID of 10 bytes,
    no colour map) and whose unused colour map fields give PCX a window
    with its right edge before its left: PcxImageFile._open raises
    SyntaxError, Image.open goes on through the plugins to TGA, and so does
    the port."""
    tga = bytearray(_tga(2, 24, image_id=b"0123456789"))
    assert tga[0] == 10 and tga[1] == 0
    tga[3:8] = bytes([0, 0xFF, 0xFF, 0, 0])  # colour map fields, unused without a map: PCX's xmin 0xFFFF
    data = bytes(tga)
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "TGA"
    got = assert_reads_like_pillow(data, tmp_path, "pcx_then_tga")
    assert got.shape == (23, 37, 3)


def _tga_iptc(first: int) -> bytes:
    """A colour-mapped TGA with a 28-byte image ID: its first bytes read as
    an IPTC field (0x1C, record 1) whose length byte is the colour map's
    first index."""
    return rc.tga(bytes(range(8)), 4, 2, 1, 8, cmap=(first, bytes(range(120)), 24), image_id=bytes(28))


@pytest.mark.parametrize("first", [100, 200])
def test_a_tga_that_iptc_reads_first(tmp_path, first):
    """IPTC, which has no signature test, comes before TGA in Image.ID: a
    length byte above 132 makes Pillow raise there, and the port too; below
    it the field walk fails and both read the TGA."""
    assert (agrees(_tga_iptc(first), tmp_path, "IPTC plugin's header check fails") is None) == (first > 132)


def test_iptc_and_pcd_are_refused_by_name():
    """An IPTC image (raw grey, which Pillow reads) and a file with PCD's
    mark at 2048: refused by name, at their places in Image.ID."""
    iptc = b"\x1c\x03\x3c\x00\x02\x01\x00\x1c\x03\x14\x00\x02\x00\x04\x1c\x03\x1e\x00\x02\x00\x02" + \
        b"\x1c\x03\x78\x00\x01\x01\x1c\x08\x0a\x00\x08" + bytes(range(8))
    assert pillow_rgb(iptc)[1] == (2, 4)
    with pytest.raises(ValueError, match="IPTC is not supported"):
        pnc.decode_bytes(iptc)
    with pytest.raises(ValueError, match="PCD is not supported"):
        pnc.decode_bytes(bytes(2048) + b"PCD_IPI" + bytes(2000))


def test_im_imt_and_spider_are_refused_unnamed():
    """IM, IMT and SPIDER have no _accept test; the port does not model
    their header parsers (a deviation, ROADMAP section 3): a file of
    theirs, which Pillow reads, is refused as unknown."""
    files = {"IM": pillow_saved("L", "IM"), "SPIDER": pillow_file(Image.fromarray(GREY.astype(np.float32)), "SPIDER"),
             "IMT": b"width 4\nheight 2\npixel n8\n\x0c" + bytes(range(8))}
    for fmt, data in files.items():
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == fmt
            im.convert("RGB")
        with pytest.raises(ValueError, match="not a PNG, JPEG, BMP, DIB"):
            pnc.decode_bytes(data)


def test_formats_that_open_as_none(tmp_path):
    """Bytes no plugin opens (TGA's colour map type 7 refuses them last):
    Pillow's UnidentifiedImageError, the port's ValueError naming what it
    reads."""
    data = bytes([3, 7, 2]) + bytes(40)
    with pytest.raises(Exception, match="cannot identify"):
        pillow_rgb(data)
    with pytest.raises(ValueError, match="not a PNG, JPEG, BMP, DIB, GIF, TIFF, WebP, Netpbm"):
        pnc.decode_bytes(data)


@pytest.mark.parametrize("fmt,data", [
    ("PSD", b"8BPS\x00\x01" + bytes(40)), ("DDS", b"DDS |\x00\x00\x00" + bytes(120))])
def test_psd_and_dds_are_refused_by_name(tmp_path, fmt, data):
    """PSD and DDS, queued for a later slice: refused by name from decode,
    decode_bytes, image_size and the loader."""
    from simple_sfod_tpu_torch.data.loader import DetectionLoader
    from test_torch_image_containers import LOADER_KW

    path = tmp_path / f"x.{fmt.lower()}"
    path.write_bytes(data)
    for call in (lambda: pnc.decode(str(path)), lambda: pnc.decode_bytes(data), lambda: pnc.image_size(str(path))):
        with pytest.raises(ValueError, match=f"{fmt} is not supported yet .*later slice"):
            call()
    rec = {"file_name": str(path)}
    with pytest.raises(ValueError, match=fmt):
        DetectionLoader([rec], **LOADER_KW)._prep_image(rec)


PIL_CANNOT_LOAD = {"EPS": b"%!PS-Adobe-3.0\n%%BoundingBox: 0 0 4 4\n" + bytes(40),
                   "MPEG": b"\x00\x00\x01\xb3\x02\x00\x10\x14" + bytes(60),
                   "BUFR": b"BUFR" + bytes(60), "GRIB": b"GRIB\x00\x00\x00\x01" + bytes(60),
                   "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(60)}


@pytest.mark.parametrize("fmt", sorted(PIL_CANNOT_LOAD))
def test_formats_pillow_opens_but_cannot_load(fmt):
    """EPS without Ghostscript, MPEG and the BUFR, GRIB and HDF5 stubs:
    Pillow identifies them and fails to load them; the port refuses them by
    name."""
    data = PIL_CANNOT_LOAD[fmt]
    with pytest.raises(OSError):
        pillow_rgb(data)
    with pytest.raises(ValueError, match=f"{fmt} is not supported .PIL opens it but cannot load it either"):
        pnc.decode_bytes(data)


# ---------------------------------------------------------------------------
# the entry points beside the loader
# ---------------------------------------------------------------------------

ENTRY = {"ppm": NETPBM["p6-255"], "pgm-16": NETPBM["p5-1000"], "pbm": NETPBM["p4-raw"], "pfm": NETPBM["pfm-big-endian"],
         "dib": DIB["pillow-p"], "ico": ICO["pillow-bmp-rgba"], "cur": CUR_ENTRIES["cur-8bit"],
         "qoi": QOI["pillow-rgba"],
         "sgi": SGI["rle-16bit-3ch"], "pcx": PCX["rgb-odd-width"], "dcx": DCX["two-pages"], "tga": TGA["type10-24bit"]}


@pytest.mark.parametrize("image_format", ["RGB", "BGR"])
def test_server_decodes_each_format_as_the_jax_server(image_format):
    from simple_sfod_tpu.engine.serve import DetectionService as JaxService
    from simple_sfod_tpu_torch.engine.serve import DetectionService

    svc = types.SimpleNamespace(image_format=image_format, predict_array=lambda arr, min_score=0.0: arr)
    for kind, make in ENTRY.items():
        data = make()
        got = DetectionService.predict_bytes(svc, data)
        want = JaxService.predict_bytes(svc, data)
        assert got.dtype == want.dtype == np.uint8, kind
        np.testing.assert_array_equal(got, want, err_msg=kind)


def test_toolkit_size_of_a_dib_named_bmp(tmp_path):
    """The metrics toolkit reads a .bmp name; Image.open and the port go by
    the bytes, so a DIB there has the JAX toolkit's size."""
    from simple_sfod_tpu.evaluation import toolkit as jax_toolkit
    from simple_sfod_tpu_torch.evaluation import toolkit

    (tmp_path / "frame.bmp").write_bytes(DIB["pillow-rgb"]())
    assert toolkit._image_size(str(tmp_path), "frame") == jax_toolkit._image_size(str(tmp_path), "frame") == (53, 37)


def test_pgm16_frame_chip_smoke_writes():
    """chip_smoke.pgm16_bytes (the 16-bit PGM the car phase times): Pillow
    opens it as mode I and clips it at 255; the port gives the same."""
    import chip_smoke

    frame = smooth_image(40, 64, seed=15, noise=20)
    data = chip_smoke.pgm16_bytes(frame)
    ref = pillow_rgb(data)[0]
    np.testing.assert_array_equal(pnc.decode_bytes(data), ref)
    np.testing.assert_array_equal(ref[..., 0], np.minimum(chip_smoke.pgm16_values(frame), 255))


@pytest.mark.parametrize("kind", ["tga", "pgm-16"])
def test_style_image_from_new_formats(tmp_path, kind):
    import torch

    from simple_sfod_tpu_torch.config import get_cfg
    from simple_sfod_tpu_torch.engine.trainers.source_free_adaptive_teacher import SourceFreeAdaptiveTeacherTrainer

    path = str(tmp_path / f"style.{kind}")
    with open(path, "wb") as f:
        f.write(ENTRY[kind]())
    cfg = get_cfg()
    cfg.STYLE.STYLE_IMAGE = path
    cfg.STYLE.VGG_MODEL = cfg.STYLE.DECODER = ""
    stub = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    module = SourceFreeAdaptiveTeacherTrainer._build_style_transfer(stub)
    with Image.open(path) as im:  # the JAX trainer's reading
        want = np.asarray(im.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(module.style_image.permute(1, 2, 0).numpy(), want)


# ---------------------------------------------------------------------------
# the committed fixtures (decoded on the card's host by chip_smoke.py)
# ---------------------------------------------------------------------------

def fixture_files() -> dict:
    """name -> (writer, kind)."""
    return {
        "p6_raw.ppm": (NETPBM["p6-255"], "PPM raw"), "p5_maxval_1000.pgm": (NETPBM["p5-1000"], "PGM 16-bit"),
        "p4.pbm": (NETPBM["p4-raw"], "PBM raw"), "p3_plain_comments.ppm": (NETPBM["comments-p3-in-data"], "PPM plain"),
        "le.pfm": (NETPBM["pfm-little-endian"], "PFM"), "rgb24.dib": (DIB["pillow-rgb"], "DIB"),
        "png_entries.ico": (ICO["pillow-png-rgba"], "ICO PNG entries"),
        "bmp_mask.ico": (ICO["bmp-1bit-mask"], "ICO BMP entry"),
        "largest.cur": (CUR_ENTRIES["cur-largest-wins"], "CUR"),
        "rgba.qoi": (QOI["pillow-rgba"], "QOI"), "rle16_rgb.sgi": (SGI["rle-16bit-3ch"], "SGI RLE 16-bit"),
        "raw_rgba.sgi": (SGI["raw-8bit-4ch"], "SGI raw"), "rgb.pcx": (PCX["rgb-odd-width"], "PCX RGB"),
        "planes4.pcx": (PCX["1bit-4planes"], "PCX 1 bit x 4 planes"), "pages.dcx": (DCX["two-pages"], "DCX"),
        "rle_bottom_up.tga": (TGA["orientation-0x00"], "TGA RLE"),
        "cmap16.tga": (TGA["type1-cmap16"], "TGA colour map"),
        "grey_rle.tga": (TGA["type11-8bit"], "TGA grey RLE"),
    }


def fixture_record() -> dict:
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        return json.load(f)


def write_fixtures(directory: str) -> dict:
    os.makedirs(directory, exist_ok=True)
    record = {}
    for name, (make, kind) in sorted(fixture_files().items()):
        data = make()
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rgb = pillow_rgb(data)[0]
        record[name] = {"bytes": len(data), "committed": True, "decoder": DECODER, "kind": kind,
                        "sha256": hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest(),
                        "shape": list(rgb.shape)}
    with open(os.path.join(directory, "fixtures.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")
    return record


@pytest.mark.parametrize("name", sorted(fixture_files()))
def test_committed_fixture(name):
    """Each fixture: the writer here still writes its bytes, and the port's
    RGB and Pillow's hash to the recorded SHA-256."""
    rec = fixture_record()[name]
    data = fixture_files()[name][0]()
    with open(os.path.join(FIXTURES, name), "rb") as f:
        assert f.read() == data
    got = pnc.decode_bytes(data, name)
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert hashlib.sha256(np.ascontiguousarray(pillow_rgb(data)[0]).tobytes()).hexdigest() == rec["sha256"]


def test_fixtures_fit_the_budget():
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 256 << 10


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        print(json.dumps(write_fixtures(FIXTURES), indent=1))
