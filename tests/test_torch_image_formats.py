"""Every JPEG and PNG that the JAX package's loader reads, read by the port:
progressive JPEG (SOF2), CMYK and YCCK JPEG, Adam7-interlaced PNG and
16-bit PNG, with tolerance 0.

The JAX loader decodes with its native codec and falls back to PIL on any
file that codec refuses (CMYK/YCCK JPEG, 16-bit PNG), so the reference for
each file is Pillow's convert("RGB"); the JAX codec, where it reads the
file, must agree with it. Each case holds the port's
`DetectionLoader._prep_image` (decode and shortest-edge resize) to the JAX
package's, and `native_codec.decode` to Pillow. PNG files come from
`png_file`, a writer kept here for every colour type, bit depth, Adam7
interlacing and tRNS, with a random filter type on each scanline.

What stays refused raises a ValueError that names it: an invalid or
out-of-order scan progression, JPEG with 2 components, a PNG with an
invalid bit depth or interlace method. The cases once refused here (a
progressive file that libjpeg-turbo smooths, BMP, GIF, TIFF and WebP) now
decode as Pillow does (DECODED_NOW); tests/test_torch_image_containers.py
and tests/test_torch_webp.py hold their variants. The JPEG refusals (hierarchical, 12-bit) are cases of
tests/test_torch_jpeg.py.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from simple_sfod_tpu.data import datasets as JD
from simple_sfod_tpu.data import native_codec as jnc
from simple_sfod_tpu.data.loader import DetectionLoader as JaxLoader
from simple_sfod_tpu.data.loader import build_test_loader as jax_build_test_loader
from simple_sfod_tpu_torch.data import datasets as PD
from simple_sfod_tpu_torch.data import native_codec as pnc
from simple_sfod_tpu_torch.data.loader import DetectionLoader, build_test_loader
from test_torch_data import _cfgs, assert_batches_equal, registries, write_coco  # noqa: F401 (a fixture)
from test_torch_jpeg import encode, jpeg_parts, drop_scans, pillow_jpeg, smooth_image

# min_size 20: the small cases are scaled up, the larger ones down
LOADER_KW = dict(batch_size=1, canvas_hw=(64, 128), min_size=20, max_size=128, gt_capacity=4, training=False,
                 prefetch=0)


@pytest.fixture(autouse=True)
def jax_codec_state(monkeypatch):
    """The JAX codec checks its first decode of each format against PIL and
    switches itself off for the process on a mismatch: each case starts and
    ends with the state it found."""
    monkeypatch.setattr(jnc, "_DISABLED", jnc._DISABLED)
    monkeypatch.setattr(jnc, "_CHECKED", dict(jnc._CHECKED))


def pillow_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def assert_reads_like_jax(data: bytes, tmp_path, name="case") -> np.ndarray:
    """The port's decode of `data` equal to Pillow's (and to the JAX codec's
    where it reads the file), and the port's _prep_image equal to the JAX
    loader's. -> the decoded RGB."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    ref = pillow_rgb(path)
    got = pnc.decode(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    jax_rgb = jnc.decode(path)
    if jax_rgb is not None:
        np.testing.assert_array_equal(jax_rgb, ref)
    rec = {"file_name": path}
    img, scale = DetectionLoader([rec], **LOADER_KW)._prep_image(rec)
    want_img, want_scale = JaxLoader([rec], **LOADER_KW)._prep_image(rec)
    assert img.dtype == want_img.dtype == np.uint8
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_array_equal(scale, want_scale)
    return got


def cmyk_image(h, w, seed) -> np.ndarray:
    return np.asarray(Image.fromarray(smooth_image(h, w, seed=seed, noise=20)).convert("CMYK"))


# ---------------------------------------------------------------------------
# progressive JPEG
# ---------------------------------------------------------------------------

SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": None}
SIZES = [(1, 1), (7, 9), (17, 33), (48, 64)]


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_progressive_sampling_and_sizes(tmp_path, sampling, hw):
    img = smooth_image(*hw, seed=hw[0] * 31 + hw[1], noise=20)
    if sampling == "grey":
        data = pillow_jpeg(img[..., 1], quality=85, progressive=True)
    else:
        data = pillow_jpeg(img, quality=85, progressive=True, subsampling=SAMPLING[sampling])
    assert b"\xff\xc2" in data
    assert_reads_like_jax(data, tmp_path)


@pytest.mark.parametrize("case", ["optimize", "restart-blocks", "restart-rows", "quality-100-noise"])
def test_progressive_variants(tmp_path, case):
    """Optimised tables, restart intervals in every scan (the EOB run and
    the predictors reset), and quality 100 on noise (large coefficients
    built up over the refinement scans)."""
    img = smooth_image(37, 61, seed=5, noise=15)
    kw = {
        "optimize": dict(optimize=True, subsampling=2),
        "restart-blocks": dict(restart_marker_blocks=3, subsampling=2),
        "restart-rows": dict(restart_marker_rows=1, optimize=True, subsampling=1),
        "quality-100-noise": dict(quality=100, subsampling=0),
    }[case]
    if case == "quality-100-noise":
        img = np.random.default_rng(4).integers(0, 256, img.shape, dtype=np.uint8)
    data = pillow_jpeg(img, progressive=True, **{"quality": 80, **kw})
    assert_reads_like_jax(data, tmp_path)


# ---------------------------------------------------------------------------
# four components: CMYK and YCCK
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_pillow_cmyk(tmp_path, progressive, subsampling):
    """Pillow's CMYK files (Adobe marker, transform 0; `subsampling` sets
    the first component's factors)."""
    data = pillow_jpeg(cmyk_image(29, 45, seed=subsampling), quality=85, progressive=progressive,
                       subsampling=subsampling)
    assert_reads_like_jax(data, tmp_path)


@pytest.mark.parametrize(
    "case", ["ycck", "ycck-420-k22", "ycck-non-interleaved", "cmyk-no-adobe", "adobe-transform-1", "ycck-restart"])
def test_encoder_four_components(tmp_path, case):
    """Files Pillow cannot write: YCCK (Adobe transform 2, converted to CMYK
    as jdcolor.c:ycck_cmyk_convert does), CMYK without an Adobe marker,
    and the transform libjpeg does not know, which it takes for YCCK."""
    img = cmyk_image(23, 37, seed=7)
    kw = {
        "ycck": dict(adobe=2),
        "ycck-420-k22": dict(adobe=2, factors=((2, 2), (1, 1), (1, 1), (2, 2))),
        "ycck-non-interleaved": dict(adobe=2, factors=((2, 1), (1, 1), (1, 1), (1, 1)), interleaved=False),
        "cmyk-no-adobe": dict(ycc=False),
        "adobe-transform-1": dict(adobe=1),
        "ycck-restart": dict(adobe=2, restart=2, factors=((1, 2), (1, 1), (1, 1), (1, 1))),
    }[case]
    assert_reads_like_jax(encode(img, quality=80, jfif=False, **kw), tmp_path)


def test_progressive_ycck(tmp_path):
    """A progressive YCCK file: Pillow's progressive CMYK with its Adobe
    transform byte set to 2."""
    data = bytearray(pillow_jpeg(cmyk_image(31, 40, seed=3), quality=80, progressive=True))
    transform = data.index(b"\xff\xee") + 4 + 11  # APP14: "Adobe", version, flags0, flags1, transform
    assert data[transform - 11:transform - 6] == b"Adobe" and data[transform] == 0
    data[transform] = 2
    assert_reads_like_jax(bytes(data), tmp_path)


# ---------------------------------------------------------------------------
# PNG: every colour type and bit depth, Adam7, 16 bits, tRNS
# ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
COMBOS = [(c, d) for c in sorted(DEPTHS) for d in DEPTHS[c]]


def png_samples(h, w, ctype, depth, seed) -> np.ndarray:
    """Random samples [h, w, channels] below 2**depth; at 16 bits half the
    rows stay below 512, so that 16-bit grey meets both sides of PIL's clip
    at 255."""
    s = np.random.default_rng(seed).integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
    if depth == 16:
        s[::2] %= 512
    return s


def _filtered(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each scanline behind a random filter type (PNG spec, section 9)."""
    out, prev = bytearray(), np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[: row.size]
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[: row.size]
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        ft = int(rng.integers(0, 5))
        pred = (np.zeros_like(row), a, prev, (a + prev) // 2, paeth)[ft]
        out += bytes([ft]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def png_file(samples: np.ndarray, ctype: int, depth: int, interlace=False, trns=None, seed=0) -> bytes:
    """A PNG of `samples` [h, w, channels] (palette indices for colour type
    3, with a random 2**depth-entry PLTE), Adam7 when `interlace`, with a
    tRNS chunk of `trns` bytes; the IDAT stream split over two chunks."""
    h, w, ch = samples.shape
    rng = np.random.default_rng(seed)
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(sub.shape[0], -1)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(sub.shape[0], -1)
        else:
            bits = (sub[..., :1] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.astype(np.uint8).reshape(sub.shape[0], -1), axis=1)
        raw += _filtered(rows, max(1, ch * depth // 8), rng)
    out = pnc.PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if ctype == 3:
        out += _chunk(b"PLTE", rng.integers(0, 256, 3 << depth).astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(bytes(raw))
    return out + _chunk(b"IDAT", z[: len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depth", COMBOS, ids=[f"type{c}-{d}bit" for c, d in COMBOS])
def test_adam7_every_colour_type_and_depth(tmp_path, ctype, depth):
    samples = png_samples(13, 19, ctype, depth, seed=ctype * 32 + depth)
    assert_reads_like_jax(png_file(samples, ctype, depth, interlace=True, seed=depth), tmp_path, "a.png")


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_sixteen_bit(tmp_path, ctype):
    """RGB, RGBA and grey with alpha keep the high byte; grey opens as
    I;16 and clips at 255."""
    samples = png_samples(11, 23, ctype, 16, seed=ctype)
    got = assert_reads_like_jax(png_file(samples, ctype, 16, seed=1), tmp_path, "s.png")
    want = np.minimum(samples[..., 0], 255) if ctype == 0 else samples[..., 0] >> 8
    np.testing.assert_array_equal(got[..., 0], want)


@pytest.mark.parametrize(
    "case", ["grey16-trns", "rgb16-trns", "palette-trns-adam7", "grey2-trns-adam7", "rgb8-trns", "tiny-adam7"])
def test_trns_and_tiny(tmp_path, case):
    """tRNS drops with the alpha in convert("RGB"); images smaller than
    Adam7's 8x8 cell leave passes empty."""
    ctype, depth, trns, interlace, hw = {
        "grey16-trns": (0, 16, struct.pack(">H", 300), False, (9, 14)),
        "rgb16-trns": (2, 16, struct.pack(">HHH", 1, 2, 3), True, (9, 14)),
        "palette-trns-adam7": (3, 4, bytes(range(0, 160, 20)), True, (9, 14)),
        "grey2-trns-adam7": (0, 2, struct.pack(">H", 1), True, (9, 14)),
        "rgb8-trns": (2, 8, struct.pack(">HHH", 10, 20, 30), False, (9, 14)),
        "tiny-adam7": (6, 16, None, True, (3, 2)),
    }[case]
    samples = png_samples(*hw, ctype, depth, seed=len(case))
    assert_reads_like_jax(png_file(samples, ctype, depth, interlace, trns), tmp_path, "t.png")


@settings(max_examples=12, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16),
       kind=st.sampled_from(["progressive-420", "progressive-444", "progressive-grey", "cmyk", "cmyk-progressive",
                             "ycck", "png-adam7", "png-16"]),
       combo=st.sampled_from(COMBOS))
def test_hypothesis_formats(tmp_path_factory, h, w, seed, kind, combo):
    tmp = tmp_path_factory.mktemp("fmt")
    if kind.startswith("png"):
        ctype, depth = (combo[0], 16 if combo[0] != 3 else 8) if kind == "png-16" else combo
        data = png_file(png_samples(h, w, ctype, depth, seed), ctype, depth, interlace=kind == "png-adam7", seed=seed)
    elif kind.startswith("progressive"):
        img = smooth_image(h, w, seed=seed, noise=30)
        sub = {"progressive-420": 2, "progressive-444": 0}.get(kind)
        data = pillow_jpeg(img[..., 0], progressive=True) if sub is None else pillow_jpeg(
            img, quality=30 + seed % 70, progressive=True, subsampling=sub)
    elif kind == "ycck":
        data = encode(cmyk_image(h, w, seed), quality=30 + seed % 70, jfif=False, adobe=2)
    else:
        data = pillow_jpeg(cmyk_image(h, w, seed), progressive=kind.endswith("progressive"))
    assert_reads_like_jax(data, tmp)


# ---------------------------------------------------------------------------
# the whole test loader
# ---------------------------------------------------------------------------


def test_test_loaders_on_mixed_formats(registries):
    """build_test_loader of both packages over a COCO JSON whose images are
    progressive, CMYK and YCCK JPEG and Adam7 and 16-bit PNG: equal
    batches."""
    root = str(registries)
    os.makedirs(os.path.join(root, "img"))
    img = smooth_image(48, 64, seed=2, noise=10)
    cmyk = cmyk_image(40, 70, seed=4)
    grey16 = png_samples(50, 60, 0, 16, seed=5)
    rgba16 = png_samples(48, 80, 6, 16, seed=6)
    files = {
        "prog.jpg": pillow_jpeg(img, quality=80, progressive=True),
        "cmyk.jpg": pillow_jpeg(cmyk, progressive=True),
        "ycck.jpg": encode(cmyk, ((2, 2), (1, 1), (1, 1), (2, 2)), jfif=False, adobe=2),
        "adam7.png": png_file(png_samples(45, 64, 2, 8, seed=7), 2, 8, interlace=True),
        "grey16.png": png_file(grey16, 0, 16),
        "rgba16-adam7.png": png_file(rgba16, 6, 16, interlace=True),
    }
    recs = []
    for i, (name, data) in enumerate(files.items()):
        with open(os.path.join(root, "img", name), "wb") as f:
            f.write(data)
        h, w = pnc.image_size(os.path.join(root, "img", name))
        recs.append({"image_id": i + 1, "file_name": "img/" + name, "height": h, "width": w,
                     "boxes": [[2.0, 3.0, 20.0, 30.0]], "classes": [i % 2]})
    path = write_coco(root, "mixed.json", recs, [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}])
    for mod in (PD, JD):
        mod.register_dataset("mixed_formats", path, root)
    pcfg, jcfg = _cfgs([])
    pt, jt = build_test_loader(pcfg, "mixed_formats"), jax_build_test_loader(jcfg, "mixed_formats")
    got, want = list(pt), list(jt)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


# ---------------------------------------------------------------------------
# what stays refused, each by name; the JAX loader reads these through PIL
# ---------------------------------------------------------------------------

PROGRESSIVE = pillow_jpeg(smooth_image(24, 40, seed=8, noise=10), progressive=True)


def _ss_after_se() -> bytes:
    """The second scan (Y AC 1-5) with Ss 6 > Se 5: JERR_BAD_PROGRESSION."""
    head, scans = jpeg_parts(PROGRESSIVE)
    s = bytearray(scans[1])
    sos = s.index(b"\xff\xda")
    ns = s[sos + 4]
    s[sos + 5 + 2 * ns] = s[sos + 6 + 2 * ns] + 1
    return head + scans[0] + bytes(s) + b"".join(scans[2:]) + b"\xff\xd9"


def _reordered(order) -> bytes:
    head, scans = jpeg_parts(PROGRESSIVE)
    return head + b"".join(scans[i] for i in order) + b"\xff\xd9"


def _bad_ihdr(depth: int, ctype: int, interlace: int) -> bytes:
    """An 8-bit RGB PNG whose IHDR declares other fields."""
    good = png_file(png_samples(4, 4, 2, 8, 0), 2, 8)
    return good[:8] + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0, interlace)) + good[33:]


def _other_format(fmt) -> bytes:
    b = io.BytesIO()
    Image.fromarray(smooth_image(8, 8, seed=1)).save(b, fmt)
    return b.getvalue()


REFUSED = {
    "progressive-ac-before-dc": (lambda: _reordered(range(1, 10)), "scan progression"),
    "progressive-dc-twice": (lambda: _reordered([0, 0, *range(1, 10)]), "scan progression"),
    "progressive-ss-after-se": (_ss_after_se, "scan progression"),
    "two-components": (lambda: encode(smooth_image(8, 8, seed=1)[..., :2], ycc=False, jfif=False),
                       "2 or more than 4 components"),
    "png-palette-16bit": (lambda: _bad_ihdr(16, 3, 0), "bit depth 16 with colour type 3"),
    "png-interlace-method-2": (lambda: _bad_ihdr(8, 2, 2), "interlace method 2"),
}


# refused until the port read them: they now decode as Pillow does
DECODED_NOW = {
    "progressive-unrefined": lambda: drop_scans(PROGRESSIVE, 6),
    "bmp": lambda: _other_format("BMP"),
    "gif": lambda: _other_format("GIF"),
    "tiff": lambda: _other_format("TIFF"),
    "webp": lambda: _other_format("WEBP"),
}


@pytest.mark.parametrize("case", sorted(REFUSED) + sorted(DECODED_NOW))
def test_refusals_name_the_feature(tmp_path, case, monkeypatch):
    """The port's decode and its loader raise a ValueError naming what is
    not read; no path falls back to another decoder. The cases of
    DECODED_NOW decode equal to Pillow and to the JAX loader, which reads
    them with PIL (its native codec switched off: on the smoothed file its
    libjpeg smooths otherwise than Pillow's libjpeg-turbo)."""
    if case in DECODED_NOW:
        monkeypatch.setattr(jnc, "_DISABLED", True)
        assert_reads_like_jax(DECODED_NOW[case](), tmp_path)
        return
    make, message = REFUSED[case]
    path = str(tmp_path / "refused")
    with open(path, "wb") as f:
        f.write(make())
    with pytest.raises(ValueError, match=message):
        pnc.decode(path)
    rec = {"file_name": path}
    with pytest.raises(ValueError, match=message):
        DetectionLoader([rec], **LOADER_KW)._prep_image(rec)


def test_scan_lists_of_the_refusal_cases():
    """The cases above cut and reorder the ten scans of libjpeg's
    jpeg_simple_progression for YCbCr (the first: DC of all components)."""
    head, scans = jpeg_parts(PROGRESSIVE)
    assert len(scans) == 10 and head.startswith(b"\xff\xd8") and b"\xff\xc2" in head
    sos = scans[0].index(b"\xff\xda")
    assert scans[0][sos + 4] == 3
