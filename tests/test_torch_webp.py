"""WebP, which the JAX package reads through PIL and the port now reads
itself (data/native_codec.py's demuxer, data/csrc/webp_vp8.cpp and
data/csrc/webp_vp8l.cpp), each case with tolerance 0.

Every case holds the port's `decode_bytes` (and, where a file is written,
`decode`, `image_size` and the loader's `_prep_image` in RGB and BGR, the
latter against the JAX loader, which opens WebP with PIL) to Pillow's
convert("RGB"); and the port's RGBA, before its alpha is dropped, to
Pillow's RGBA, so that the ALPH plane is checked too. Pillow 12.1 decodes
every WebP file through libwebp 1.6's WebPAnimDecoder.

Files: Pillow writes the quality x method sweep, odd sizes, lossless
settings, palettes, lossy + alpha and VP8X with ICC, EXIF and XMP; the
committed fixtures (tests/torch_webp/) add what Pillow cannot ask for,
written by the system libwebp's encoder through tests/torch_webp_coders.py:
the simple loop filter, every sharpness, 2, 4 and 8 token partitions, 1-4
segments, lossless ALPH with each filter and pre-processing; the 1914x1052
Sim10k frame lossy at quality 80 and with an ALPH plane, and a 957x526 crop
of it lossless (the frames chip_smoke.py times on the card). Hand-made
here: raw ALPH with each filter, the loop filter's ref and mode deltas
(which libwebp's encoder never writes) spliced into libwebp's frames,
animated files whose first frame sits at an offset on a larger canvas,
seeded single-byte flips (the port and Pillow both refuse or give the same
pixels), truncations and RIFF files PIL does not identify (both refuse).

The fixtures are rebuilt by `python tests/test_torch_webp.py
--write-fixtures` (gcc and the system libwebp's headers needed);
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
from PIL import Image, features  # noqa: E402

import torch_webp_coders as wc  # noqa: E402
from simple_sfod_tpu_torch.data import native_codec as pnc  # noqa: E402
from simple_sfod_tpu_torch.data.loader import DetectionLoader  # noqa: E402
from test_torch_image_containers import (  # noqa: E402,F401  (jax_loader_through_pil: autouse)
    LOADER_KW, assert_reads_like_pillow, jax_loader_through_pil, pillow_rgb)
from test_torch_jpeg import smooth_image  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_webp")
SIM10K_JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg", "sim10k_frame_0.jpg")
DECODER = f"Pillow {Image.__version__}, libwebp {features.version('webp')}"


def pillow_rgba(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA"))


def pillow_webp(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img, "RGBA" if img.shape[2] == 4 else "RGB").save(b, "WEBP", **kw)
    return b.getvalue()


def assert_webp_like_pillow(data: bytes, tmp_path, name="case") -> np.ndarray:
    """The RGB through every reader (assert_reads_like_pillow) and the RGBA
    equal to Pillow's. -> the RGBA."""
    assert_reads_like_pillow(data, tmp_path, name)
    got = pnc._decode_webp(data, name, rgba=True)
    np.testing.assert_array_equal(got, pillow_rgba(data))
    return got


def outcome(data: bytes):
    """(Pillow's RGBA or None where it raises, the port's or None where it
    raises)."""
    try:
        ref = pillow_rgba(data)
    except Exception:
        ref = None
    try:
        got = pnc._decode_webp(data, "case", rgba=True)
    except ValueError:
        got = None
    return ref, got


def with_alpha(img: np.ndarray, seed: int) -> np.ndarray:
    """img with a seeded alpha: a ramp across x and a few constant boxes."""
    h, w = img.shape[:2]
    r = np.random.default_rng(seed)
    a = np.broadcast_to(np.linspace(r.integers(0, 64), r.integers(192, 256), w), (h, w)).copy()
    for _ in range(4):
        y, x = r.integers(0, h), r.integers(0, w)
        a[y:y + r.integers(1, h // 2 + 2), x:x + r.integers(1, w // 2 + 2)] = r.integers(0, 256)
    return np.dstack([img, a.astype(np.uint8)])


def filtered_alpha(a: np.ndarray, f: int) -> bytes:
    """libwebp's forward alpha filters (src/dsp/filters.c): 0 none, 1
    horizontal, 2 vertical, 3 gradient; the first row and column predicted
    from the left (the first pixel from 0) and from above."""
    a = a.astype(np.int32)
    pred = np.zeros_like(a)
    if f:
        pred[0, 1:] = a[0, :-1]
    if f == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif f == 2:
        pred[1:] = a[:-1]
    elif f == 3:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8).tobytes()


def raw_alpha_file(img_rgba: np.ndarray, f: int, quality=70) -> bytes:
    """A lossy VP8X + ALPH file whose ALPH is uncompressed, with filter f."""
    base = pillow_webp(img_rgba[..., :3], quality=quality)
    h, w = img_rgba.shape[:2]
    vp8 = [p for t, p in wc.chunks(base) if t == b"VP8 "][0]
    alph = bytes([f << 2]) + filtered_alpha(img_rgba[..., 3], f)
    return wc.riff([wc.vp8x((w, h), 0x10), (b"ALPH", alph), (b"VP8 ", vp8)])


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

SMALL = (96, 64)  # the libwebp fixtures' height and width: 6x4 macroblocks


def _small(seed=1):
    return smooth_image(*SMALL, seed=seed, noise=12)


def _filtered_lossless_alpha(f: int) -> bytes:
    """A lossy VP8X + ALPH file whose lossless ALPH carries filter f: the
    alpha plane filtered here, coded by libwebp unfiltered, its header
    byte then set to filter f (libwebp's "best" filtering picks the
    horizontal filter on these images, never the other two)."""
    img = with_alpha(_small(13), 20 + f)
    residual = np.frombuffer(filtered_alpha(img[..., 3], f), np.uint8).reshape(SMALL)
    data = wc.libwebp_encode(np.dstack([img[..., :3], residual]), alpha_compression=1, alpha_filtering=0)
    at = data.index(b"ALPH") + 8
    assert data[at] >> 2 & 3 == 0
    return data[:at] + bytes([data[at] | f << 2]) + data[at + 1:]


def _sim10k(alpha=False):
    rgb = np.asarray(Image.open(SIM10K_JPEG).convert("RGB"))
    return pillow_webp(with_alpha(rgb, 7) if alpha else rgb, quality=80)


def _sim10k_crop():
    rgb = np.asarray(Image.open(SIM10K_JPEG).convert("RGB"))
    return pillow_webp(rgb[263:789, 478:1435], lossless=True)


def _anim(kind):
    """An animated file: frame 0 (17x33, or 20x30 for the lossy + alpha
    one) at (6, 4) on a 64x48 canvas, frame 1 at (0, 0)."""
    img = smooth_image(33, 17, seed=2, noise=10) if kind != "alpha" else smooth_image(30, 20, seed=2, noise=10)
    if kind == "lossless":
        first = pillow_webp(img, lossless=True)
    elif kind == "alpha":
        first = pillow_webp(with_alpha(img, 3), quality=60)
    else:
        first = pillow_webp(img, quality=60)
    second = pillow_webp(smooth_image(48, 64, seed=3), quality=50)
    h, w = img.shape[:2]
    return wc.animated((64, 48), [(6, 4, (w, h), wc.frame_chunks(first)), (0, 0, (64, 48), wc.frame_chunks(second))],
                       flags=0x02 | (0x10 if kind == "alpha" else 0))


def fixture_files() -> dict:
    """name -> (a function giving the bytes, a label) of every committed
    WebP fixture."""
    small = _small
    enc = wc.libwebp_encode
    files = {
        "lossy_simple_sharp0.webp": (lambda: enc(small(), filter_type=0, filter_strength=60, filter_sharpness=0),
                                     "VP8 simple filter"),
        "lossy_simple_sharp5_p8_seg4.webp": (lambda: enc(small(), filter_type=0, filter_strength=40, filter_sharpness=5,
                                                         partitions=3, method=2, segments=4),
                                             "VP8 simple filter, 8 partitions"),
        "lossy_normal_sharp1_p2_seg1.webp": (lambda: enc(small(), filter_type=1, filter_strength=60,
                                                         filter_sharpness=1, partitions=1, method=2, segments=1),
                                             "VP8 2 partitions, 1 segment"),
        "lossy_normal_sharp2_p4_seg2.webp": (lambda: enc(small(2), filter_type=1, filter_strength=80,
                                                         filter_sharpness=2, partitions=2, method=1, segments=2),
                                             "VP8 4 partitions, 2 segments"),
        "lossy_normal_sharp3_p8_seg3.webp": (lambda: enc(small(3), filter_type=1, filter_strength=50,
                                                         filter_sharpness=3, partitions=3, method=0, segments=3),
                                             "VP8 8 partitions, 3 segments"),
        "lossy_normal_sharp4_q10.webp": (lambda: enc(small(4), filter_type=1, filter_strength=100, filter_sharpness=4,
                                                     quality=10), "VP8 level 63"),
        "lossy_normal_sharp6_q30.webp": (lambda: enc(small(5), filter_type=1, filter_strength=70, filter_sharpness=6,
                                                     quality=30), "VP8 sharpness 6"),
        "lossy_normal_sharp7_q60.webp": (lambda: enc(small(6), filter_type=1, filter_strength=90, filter_sharpness=7,
                                                     quality=60), "VP8 sharpness 7"),
        "lossy_unfiltered.webp": (lambda: enc(small(7), filter_strength=0, quality=40), "VP8 no loop filter"),
        "alpha_raw.webp": (lambda: enc(with_alpha(small(8), 1), alpha_compression=0), "ALPH raw"),
        "alpha_lossless_unfiltered.webp": (lambda: enc(with_alpha(small(9), 2), alpha_compression=1,
                                                       alpha_filtering=0), "ALPH lossless"),
        "alpha_preprocessed.webp": (lambda: enc(with_alpha(small(10), 3), alpha_compression=1, alpha_filtering=2,
                                                alpha_quality=40), "ALPH pre-processed"),
        "lossless_exact_rgba.webp": (lambda: enc(_exact_rgba(), lossless=1, exact=1), "VP8L exact RGBA"),
        "lossless_method0.webp": (lambda: enc(small(11), lossless=1, method=0, quality=50), "VP8L"),
        "lossless_palette16.webp": (lambda: enc(_palette(16, (37, 45)), lossless=1), "VP8L palette"),
        "vp8x_metadata.webp": (lambda: pillow_webp(small(12), quality=75, icc_profile=b"\x00" * 101,
                                                   exif=b"Exif\x00\x00" + bytes(40), xmp=b"<x:xmpmeta/>"),
                               "VP8X ICCP EXIF XMP"),
        "anim_lossy_offset.webp": (lambda: _anim("lossy"), "ANMF VP8 at an offset"),
        "anim_lossless_offset.webp": (lambda: _anim("lossless"), "ANMF VP8L at an offset"),
        "anim_alpha_offset.webp": (lambda: _anim("alpha"), "ANMF ALPH + VP8 at an offset"),
        "sim10k_frame_0_q80.webp": (_sim10k, "VP8 1914x1052"),
        "sim10k_frame_0_alpha.webp": (lambda: _sim10k(alpha=True), "VP8X ALPH + VP8 1914x1052"),
        "sim10k_crop_lossless.webp": (_sim10k_crop, "VP8L 957x526"),
    }
    for f, name in ((1, "horizontal"), (2, "vertical"), (3, "gradient")):
        files[f"alpha_lossless_{name}.webp"] = (lambda f=f: _filtered_lossless_alpha(f), f"ALPH {name} filter")
    return files


def _exact_rgba():
    img = with_alpha(_small(14), 4)
    img[::3, :, 3] = 0  # transparent rows whose RGB the exact mode keeps
    return img


def _palette(n: int, hw, seed=0) -> np.ndarray:
    """An image of n seeded colours."""
    r = np.random.default_rng(seed)
    colours = r.integers(0, 256, (n, 3)).astype(np.uint8)
    idx = (smooth_image(*hw, seed=seed)[..., 0].astype(np.int64) * n) // 256
    return colours[np.clip(idx, 0, n - 1)]


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


def fixture_record() -> dict:
    """fixtures.json ({} before the fixtures are written)."""
    path = os.path.join(FIXTURES, "fixtures.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(fixture_record()))
def test_committed_fixture(tmp_path, name):
    """Each committed fixture through every reader equal to Pillow, and the
    RGB's SHA-256 equal to the recorded one."""
    rec = fixture_record()[name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    rgba = assert_webp_like_pillow(data, tmp_path, name)
    assert list(rgba.shape[:2]) == rec["shape"][:2]
    assert hashlib.sha256(np.ascontiguousarray(rgba[..., :3]).tobytes()).hexdigest() == rec["sha256"]


def test_fixtures_cover_the_features():
    """What the committed files exercise, read from their headers: both
    loop filters, every sharpness, 1/2/4/8 partitions, segments on and
    off, level 0 and 63; ALPH raw and lossless, each filter, pre-processing;
    every VP8L transform; VP8X with ICCP/EXIF/XMP; ANMF offsets. The
    fixtures are those fixture_files() writes, and stay under 1 MiB."""
    record = fixture_record()
    assert sorted(record) == sorted(fixture_files())
    vp8, alph, transforms, tags = [], set(), 0, set()
    lib = pnc._load()
    total = 0
    for name in record:
        data = open(os.path.join(FIXTURES, name), "rb").read()
        total += len(data)
        for tag, p in wc.chunks(data):
            tags.add(tag)
            top = tag != b"ANMF"
            for t, q in wc.chunks(b"RIFF\x00\x00\x00\x00WEBP" + p[16:]) if not top else [(tag, p)]:
                if t == b"VP8 ":
                    vp8.append(wc.vp8_header(q))
                elif t == b"VP8L":
                    transforms |= lib.sfod_webp_vp8l_transforms(q, len(q), 0, 0)
                elif t == b"ALPH":
                    a = wc.alph_header(q)
                    alph.add((a["compression"], a["filter"], a["preprocessing"]))
                    if a["compression"] == 1 and top:  # a still file: its frame is the canvas
                        w, h = record[name]["shape"][1], record[name]["shape"][0]
                        transforms |= max(0, lib.sfod_webp_vp8l_transforms(q[1:], len(q) - 1, w, h))
    assert total < 1 << 20
    assert {h["simple_filter"] for h in vp8 if h["filter_level"]} == {0, 1}
    assert {h["sharpness"] for h in vp8 if h["filter_level"]} == set(range(8))
    assert {h["partitions"] for h in vp8} == {1, 2, 4, 8}
    assert {h["segments"] for h in vp8} == {0, 1} and any(h["update_map"] for h in vp8)
    assert {0, 63} <= {h["filter_level"] for h in vp8}
    assert {(c, f) for c, f, _ in alph} >= {(0, 0), (1, 0), (1, 1), (1, 2), (1, 3)}
    assert any(p for _, _, p in alph)
    assert transforms == 0b1111
    assert {b"VP8X", b"ICCP", b"EXIF", b"XMP ", b"ANIM", b"ANMF", b"ALPH", b"VP8 ", b"VP8L"} <= tags


# ---------------------------------------------------------------------------
# files Pillow writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [1, 30, 75, 100])
@pytest.mark.parametrize("method", [0, 2, 4, 6])
def test_lossy_quality_method(tmp_path, quality, method):
    img = smooth_image(45, 63, seed=quality + 7 * method, noise=10)
    assert_webp_like_pillow(pillow_webp(img, quality=quality, method=method), tmp_path)


LF_DELTAS = {
    "unset": ((None,) * 4, (None,) * 4),
    "intra-up-bpred-down": ((10, None, -3, None), (-20, 5, None, 1)),
    "intra-down-bpred-up": ((-33, 7, None, None), (40, None, None, None)),
}


@pytest.mark.parametrize("case", sorted(LF_DELTAS))
@pytest.mark.parametrize("base", ["normal", "simple"])
def test_loop_filter_deltas(tmp_path, case, base):
    """The ref and mode loop-filter deltas (a key frame uses ref 0, and mode
    0 on its 4x4-predicted macroblocks), spliced into libwebp's frames."""
    name = "lossy_normal_sharp2_p4_seg2.webp" if base == "normal" else "lossy_simple_sharp0.webp"
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    with open(os.path.join(os.path.dirname(pnc.__file__), "csrc", "webp_vp8.cpp")) as f:
        source = f.read()
    vp8 = [p for t, p in wc.chunks(data) if t == b"VP8 "][0]
    new = wc.riff([(b"VP8 ", wc.vp8_with_lf_deltas(vp8, source, *LF_DELTAS[case]))])
    assert wc.vp8_header(wc.chunks(new)[0][1])["lf_delta"] == 1
    got = assert_webp_like_pillow(new, tmp_path)
    assert np.array_equal(got, pillow_rgba(data)) == (case == "unset")


@pytest.mark.parametrize("hw", [(1, 1), (1, 37), (37, 1), (17, 33), (45, 63), (2, 2)])
@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_odd_sizes(tmp_path, hw, kind):
    """Odd and tiny sizes: fancy upsampling's first and last rows and
    columns, partial macroblocks, VP8L rows of one pixel."""
    img = smooth_image(*hw, seed=sum(hw), noise=20)
    if kind == "alpha":
        data = pillow_webp(with_alpha(img, sum(hw)), quality=70, alpha_quality=90)
    else:
        data = pillow_webp(img, lossless=kind == "lossless", quality=70)
    assert_webp_like_pillow(data, tmp_path)


@pytest.mark.parametrize("quality,method", [(0, 0), (25, 2), (75, 4), (100, 5)])
def test_lossless_settings(tmp_path, quality, method):
    img = smooth_image(45, 63, seed=method, noise=8)
    assert_webp_like_pillow(pillow_webp(img, lossless=True, quality=quality, method=method), tmp_path)


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
def test_palette(tmp_path, colours):
    """Colour indexing at each bundling (8, 4, 2 and 1 pixels a byte) on a
    width that is no multiple of 8."""
    assert_webp_like_pillow(pillow_webp(_palette(colours, (19, 45), seed=colours), lossless=True), tmp_path)


@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
def test_lossy_with_alpha(tmp_path, alpha_quality):
    img = with_alpha(smooth_image(40, 56, seed=alpha_quality, noise=6), alpha_quality)
    rgba = assert_webp_like_pillow(pillow_webp(img, quality=60, alpha_quality=alpha_quality), tmp_path)
    if alpha_quality == 100:
        np.testing.assert_array_equal(rgba[..., 3], img[..., 3])


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
def test_raw_alpha_filters(tmp_path, filt):
    """Uncompressed ALPH with each filter gives back the alpha exactly."""
    img = with_alpha(smooth_image(21, 35, seed=filt), 10 + filt)
    rgba = assert_webp_like_pillow(raw_alpha_file(img, filt), tmp_path)
    np.testing.assert_array_equal(rgba[..., 3], img[..., 3])


def test_lossless_exact_and_transparent(tmp_path):
    img = _exact_rgba()
    rgba = assert_webp_like_pillow(pillow_webp(img, lossless=True, exact=True), tmp_path)
    np.testing.assert_array_equal(rgba, img)


def test_vp8x_chunks_skipped_or_ignored(tmp_path):
    """ICCP, EXIF, XMP and unknown chunks change no pixel; an ALPH chunk in
    a VP8X file without the alpha flag is ignored, even a corrupt one."""
    img = smooth_image(24, 40, seed=3)
    data = pillow_webp(img, quality=80, icc_profile=b"\x01" * 33, exif=b"Exif\x00\x00" + bytes(9), xmp=b"<x/>")
    ref = assert_webp_like_pillow(data, tmp_path, "meta")
    vp8 = [p for t, p in wc.chunks(data) if t == b"VP8 "][0]
    for parts in ([wc.vp8x((40, 24), 0), (b"ABCD", b"xyz"), (b"VP8 ", vp8), (b"EXIF", b"late")],
                  [wc.vp8x((40, 24), 0), (b"ALPH", b"\xff\x00"), (b"VP8 ", vp8)]):
        assert np.array_equal(assert_webp_like_pillow(wc.riff(parts), tmp_path), ref)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_animated_first_frame(tmp_path, kind):
    """Frame 0 of an animated file at (6, 4) on its 64x48 canvas, black
    (transparent) elsewhere; the size is the canvas's."""
    rgba = assert_webp_like_pillow(_anim(kind), tmp_path)
    assert rgba.shape[:2] == (48, 64)
    assert not rgba[:4, :, :3].any() and not rgba[:, :6, :3].any() and rgba[4:, 6:, :3].any()


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha-lossless", "alpha-raw", "partitions"])
def test_single_byte_flips(kind):
    """Seeded single-bit flips past the headers: wherever Pillow still reads
    the file the port gives the same pixels, and where Pillow refuses it the
    port refuses it too."""
    img = with_alpha(smooth_image(40, 56, seed=4, noise=10), 4)
    data = {"lossy": lambda: pillow_webp(img[..., :3], quality=70),
            "lossless": lambda: pillow_webp(img[..., :3], lossless=True),
            "alpha-lossless": lambda: pillow_webp(img, quality=70, alpha_quality=80),
            "alpha-raw": lambda: raw_alpha_file(img, 3),
            "partitions": lambda: open(os.path.join(FIXTURES, "lossy_normal_sharp3_p8_seg3.webp"), "rb").read(),
            }[kind]()
    rng = np.random.default_rng(len(kind))
    read = 0
    for _ in range(40):
        flipped = bytearray(data)
        flipped[rng.integers(30, len(data))] ^= 1 << int(rng.integers(8))
        ref, got = outcome(bytes(flipped))
        assert (ref is None) == (got is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
            read += 1
    assert read > 0


@pytest.mark.parametrize("cut", [10, 19, 26, 40, "half", "last"])
def test_truncated_files_are_refused(tmp_path, cut):
    """A file cut short: Pillow cannot create its decoder (or, cut before
    "WEBP", identify it), the port names the truncation (or says what it
    reads)."""
    data = pillow_webp(smooth_image(24, 40, seed=5), quality=80)
    n = {"half": len(data) // 2, "last": len(data) - 1}.get(cut, cut)
    short = data[:n]
    with pytest.raises(Exception):
        pillow_rgba(short)
    with pytest.raises(ValueError, match="the formats the port reads" if n < 12 else "truncated"):
        pnc.decode_bytes(short, "short")


REFUSED_RIFF = {
    "first-chunk-alph": (lambda d: d[:12] + b"ALPH" + d[16:], "first chunk is b'ALPH'"),
    "first-chunk-other": (lambda d: d[:12] + b"JUNK" + d[16:], "first chunk is b'JUNK'"),
    "riff-wave": (lambda d: d[:8] + b"WAVE" + d[12:], r"not a PNG, JPEG, BMP, DIB, GIF, TIFF, WebP, Netpbm \(PBM, PGM, PPM, PFM\), ICO, CUR, QOI, SGI, PCX, DCX or TGA file"),
    "vp8-inter-frame": (lambda d: d[:20] + bytes([d[20] | 1]) + d[21:], "corrupt VP8 frame header"),
    "vp8l-version": (lambda d: d, "corrupt VP8L header"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_RIFF))
def test_refusals_name_the_reason(tmp_path, case):
    """Files Pillow refuses raise a ValueError naming why, in decode and in
    the loader; no path falls back to PIL."""
    make, message = REFUSED_RIFF[case]
    img = smooth_image(16, 24, seed=6)
    if case == "vp8l-version":
        d = bytearray(pillow_webp(img, lossless=True))
        d[24] |= 0x20  # version 1
        data = bytes(d)
    else:
        data = make(pillow_webp(img, quality=80))
    with pytest.raises(Exception):
        pillow_rgba(data)
    path = str(tmp_path / "refused")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=message):
        pnc.decode(path)
    rec = {"file_name": path}
    with pytest.raises(ValueError, match=message):
        DetectionLoader([rec], **LOADER_KW)._prep_image(rec)


def _container_case(case: str) -> bytes:
    """Chunk layouts that libwebp's demuxer reads or refuses."""
    img = smooth_image(16, 24, seed=12)
    lossy = [p for t, p in wc.chunks(pillow_webp(img, quality=50)) if t == b"VP8 "][0]
    lossless = [p for t, p in wc.chunks(pillow_webp(img, lossless=True)) if t == b"VP8L"][0]
    alph = [p for t, p in wc.chunks(pillow_webp(with_alpha(img, 1), quality=50)) if t == b"ALPH"][0]
    x = wc.vp8x((24, 16), 0x10)
    if case == "trailing-partial-chunk":
        d = wc.riff([(b"VP8 ", lossy)])
        return d[:4] + struct.pack("<I", len(d) - 1) + d[8:] + bytes(7)
    if case == "past-the-riff-size":
        return wc.riff([(b"VP8 ", lossy)]) + b"JUNKJUNK"
    return wc.riff({
        "alph-vp8-vp8l": [x, (b"ALPH", alph), (b"VP8 ", lossy), (b"VP8L", lossless)],
        "vp8-then-vp8l": [x, (b"VP8 ", lossy), (b"VP8L", lossless)],
        "vp8l-then-alph": [x, (b"VP8L", lossless), (b"ALPH", alph)],
        "vp8l-then-alph-no-flag": [wc.vp8x((24, 16), 0), (b"VP8L", lossless), (b"ALPH", alph)],
        "alph-without-image": [x, (b"ALPH", alph)],
        "two-images": [x, (b"VP8 ", lossy), (b"ICCP", b"x"), (b"VP8 ", lossy)],
        "reserved-flag": [wc.vp8x((24, 16), 0x01), (b"VP8 ", lossy)],
        "canvas-mismatch": [wc.vp8x((25, 16), 0), (b"VP8 ", lossy)],
        "vp8-then-unknown": [(b"VP8 ", lossy), (b"JUNK", b"abc")],
        "anmf-without-anim": [wc.vp8x((24, 16), 0x02), (b"ANMF", bytes(16) + wc.chunk(b"VP8 ", lossy))],
    }[case])


@pytest.mark.parametrize("case", ["alph-vp8-vp8l", "vp8-then-vp8l", "vp8l-then-alph", "vp8l-then-alph-no-flag",
                                  "alph-without-image", "two-images", "reserved-flag", "canvas-mismatch",
                                  "vp8-then-unknown", "anmf-without-anim", "trailing-partial-chunk",
                                  "past-the-riff-size"])
def test_chunk_layouts_as_libwebp_demuxes_them(case):
    """The demuxer's rules: the port refuses the layouts libwebp refuses,
    and reads the others as Pillow does."""
    ref, got = outcome(_container_case(case))
    assert (ref is None) == (got is None)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the entry points that read images, against their JAX counterparts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("image_format", ["RGB", "BGR"])
def test_server_decodes_webp_as_the_jax_server(image_format):
    """DetectionService.predict_bytes of both packages on a WebP body, up to
    the array they hand to predict_array."""
    from simple_sfod_tpu.engine.serve import DetectionService as JaxService
    from simple_sfod_tpu_torch.engine.serve import DetectionService

    svc = types.SimpleNamespace(image_format=image_format, predict_array=lambda arr, min_score=0.0: arr)
    for data in (_anim("alpha"), pillow_webp(smooth_image(30, 50, seed=8), quality=60)):
        got = DetectionService.predict_bytes(svc, data)
        want = JaxService.predict_bytes(svc, data)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_style_image_from_webp(tmp_path):
    """STYLE.STYLE_IMAGE as a WebP file: the port's AdaIN style tensor
    equals the JAX trainer's (PIL's RGB / 255, channels last)."""
    import torch

    from simple_sfod_tpu_torch.config import get_cfg
    from simple_sfod_tpu_torch.engine.trainers.source_free_adaptive_teacher import SourceFreeAdaptiveTeacherTrainer

    path = str(tmp_path / "style.webp")
    with open(path, "wb") as f:
        f.write(pillow_webp(with_alpha(smooth_image(32, 48, seed=9), 9), quality=85))
    cfg = get_cfg()
    cfg.STYLE.STYLE_IMAGE = path
    cfg.STYLE.VGG_MODEL = cfg.STYLE.DECODER = ""
    stub = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"))
    module = SourceFreeAdaptiveTeacherTrainer._build_style_transfer(stub)
    with Image.open(path) as im:  # the JAX trainer's reading (source_free_adaptive_teacher.py)
        want = np.asarray(im.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(module.style_image.permute(1, 2, 0).numpy(), want)


def _webp_images(img_dir: str, sizes: dict) -> None:
    """The toolkit scene's images rewritten as lossy WebP under their .png
    and .jpg names, as a recompressed mirror keeps them (both packages'
    toolkits and GUIs look images up by those extensions; PIL, and the
    port's codec, read the content)."""
    for stem, (w, h) in sizes.items():
        for ext in (".png", ".jpg"):
            p = os.path.join(img_dir, stem + ext)
            if os.path.exists(p):
                with open(p, "wb") as f:
                    f.write(pillow_webp(smooth_image(h, w, seed=w), quality=50))


def test_toolkit_and_gui_on_webp_images(tmp_path):
    """YOLO boxes relative to WebP images' sizes read and scored as the JAX
    toolkit reads them; the GUI's overlay at each image's true size, its
    pages byte-equal to the JAX GUI's."""
    from simple_sfod_tpu.evaluation import gui as jax_gui
    from simple_sfod_tpu.evaluation import runner as jax_runner
    from simple_sfod_tpu_torch.evaluation import gui, runner
    from test_torch_metrics_toolkit import SIZES, assert_same, write_pair

    kw = write_pair(tmp_path / "yolo", "yolo", "yolo")
    _webp_images(kw["images_dir"], SIZES)
    want = jax_runner.load_inputs(**kw)
    got = runner.load_inputs(**kw)
    assert got == want
    args = dict(metrics=("coco", "voc", "f1"), want_curves=False)
    assert_same(runner.run_metrics(*got, **args)[0], jax_runner.run_metrics(*want, **args)[0])

    kw = write_pair(tmp_path / "coco", "coco", "coco")
    _webp_images(kw["images_dir"], SIZES)
    state = {"gt": kw["gt"], "gt_format": "coco", "det": kw["det"], "det_format": "coco",
             "img_dir": kw["images_dir"], "names": "", "iou": "0.5", "voc_method": "all_point"}
    files = sorted(os.listdir(kw["images_dir"]))
    assert files and all(open(os.path.join(kw["images_dir"], f), "rb").read(4) == b"RIFF" for f in files)
    for i, f in enumerate(files):
        w, h = SIZES[os.path.splitext(f)[0]]
        assert pnc.image_size(os.path.join(kw["images_dir"], f)) == (h, w)
        page = gui.view_page(dict(state), "det", i)
        assert page == jax_gui.view_page(dict(state), "det", i)
        assert f"viewBox='0 0 {w} {h}'" in page


def test_image_size_reads_headers_only(tmp_path):
    """image_size from the first chunk alone: VP8's 14-bit fields (scale
    bits ignored), VP8L's, VP8X's canvas, as Pillow's size."""
    img = smooth_image(20, 30, seed=11)
    lossy = bytearray(pillow_webp(img, quality=50))
    lossy[27] |= 0x40  # a horizontal scale code: VP8GetInfo ignores it
    for data in (bytes(lossy), pillow_webp(img, lossless=True), _anim("lossy")):
        path = tmp_path / "size.webp"
        path.write_bytes(data[:30])
        assert pnc.image_size(str(path)) == pillow_rgb(data)[1]


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        print(json.dumps(write_fixtures(FIXTURES), indent=1))
