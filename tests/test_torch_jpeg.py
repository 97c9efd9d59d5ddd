"""The port's JPEG decoder (simple_sfod_tpu_torch/data/csrc/
jpeg_decode.cpp) against libjpeg-turbo, bit for bit (tolerance 0).

The reference is the JAX package's codec (`simple_sfod_tpu.data.native_codec
.decode`, libjpeg with PIL's settings), asserted not None so that it really
decoded, and Pillow's own decode. Files come from Pillow (4:4:4, 4:2:2,
4:2:0, grey, Adobe RGB, optimised tables, restart markers, progressive,
CMYK) and from `encode`, a small baseline encoder kept here for what Pillow
cannot write: 4:4:0, 4:1:1 and other integral sampling factors,
non-interleaved scans, SOF1 with 16-bit quantisation tables, 'R','G','B'
component ids, files without DHT, YCCK, and the headers that must be
refused; with sof 0xC9/0xCA it codes the same coefficients arithmetically
(tests/torch_jpeg_coders.py). tests/test_torch_image_formats.py holds the
progressive, CMYK, YCCK and PNG cases against the JAX package's loader,
tests/test_torch_image_containers.py the arithmetic-coded, block-smoothed
and lossless ones.

The committed fixtures (tests/torch_jpeg/) are rebuilt by
`python tests/test_torch_jpeg.py --write-fixtures`; fixtures.json records
each file's shape, sampling, the decoder that made the reference (Pillow
and its libjpeg-turbo) and the SHA-256 of its RGB.
"""

import hashlib
import io
import json
import math
import os
import sys

if __name__ == "__main__":  # run as a script: the packages sit at the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from PIL import Image, ImageFile  # noqa: E402

from simple_sfod_tpu.data import native_codec as jnc  # noqa: E402
from simple_sfod_tpu_torch.data import native_codec as pnc  # noqa: E402
from torch_jpeg_coders import arith_scans, lossless_jpeg, transcode_arithmetic  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg")

# ---------------------------------------------------------------------------
# a baseline encoder (JPEG standard, Annex K tables)
# ---------------------------------------------------------------------------

ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63,
]
STD_DC = [([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
          ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))]


def _std_ac():
    """The Annex K AC tables, read from a JPEG that Pillow writes with its
    default (non-optimised) tables."""
    b = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(b, "JPEG")
    data, pos, out = b.getvalue(), 2, {}
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xC4:
            seg, i = data[pos + 4:pos + 2 + n], 0
            while i < len(seg):
                bits = list(seg[i + 1:i + 17])
                out[seg[i]] = (bits, list(seg[i + 17:i + 17 + sum(bits)]))
                i += 17 + sum(bits)
        pos += 2 + n
    return [out[0x10], out[0x11]]


STD_AC = _std_ac()
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29,
    51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121,
    120, 101, 72, 92, 95, 98, 112, 100, 103, 99]).reshape(8, 8)


def quant_table(quality: int, scale16: int = 1) -> np.ndarray:
    """libjpeg's quality scaling of the Annex K luminance table (natural
    order); `scale16` > 1 gives a table beyond 8 bits (16-bit DQT)."""
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((LUMA_Q * s + 50) // 100, 1, 255) * scale16


def _codes(bits, vals):
    code, out, k = 0, {}, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        self.acc, self.n = (self.acc << length) | code, self.n + length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + bytes(payload)


def _plane(chan, hf, vf, hmax, vmax, bw, bh):
    """A component's samples: the channel averaged over its sampling cell,
    edge-padded to bw x bh blocks."""
    H, W = chan.shape
    dh, dw = math.ceil(H * vf / vmax), math.ceil(W * hf / hmax)
    ry, rx = vmax // vf, hmax // hf
    pad = np.pad(chan.astype(np.float64), ((0, dh * ry - H), (0, dw * rx - W)), mode="edge")
    p = pad.reshape(dh, ry, dw, rx).mean(axis=(1, 3))
    return np.pad(p, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge")


_DCT = np.array([[(0.5 / math.sqrt(2) if u == 0 else 0.5) * math.cos((2 * x + 1) * u * math.pi / 16)
                  for x in range(8)] for u in range(8)])


def encode(rgb, factors=((1, 1), (1, 1), (1, 1)), quality=75, ids=None, interleaved=True, restart=0, sof=0xC0,
           scale16=1, jfif=True, adobe=None, dht=True, precision=8, ycc=True, skip_scan=None, dac=b""):
    """Baseline-encode uint8 [H, W, 3] (or [H, W] grey, or [H, W, 4] CMYK)
    with the given sampling factors per component; the header fields are
    free so that files libjpeg refuses can be written too. CMYK with `ycc`
    is written as YCCK (libjpeg's cmyk_ycck_convert: the YCbCr of
    255 - C, 255 - M, 255 - Y, and K). sof 0xC9 and 0xCA code the same
    coefficients arithmetically (tests/torch_jpeg_coders.py), sequential
    and in jpeg_simple_progression's scans, with the DAC payload `dac`."""
    rgb = np.asarray(rgb)
    H, W = rgb.shape[:2]
    if rgb.ndim == 2:
        chans = [rgb.astype(np.float64)]
    elif ycc:
        r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
        if rgb.shape[2] == 4:
            r, g, b = 255 - r, 255 - g, 255 - b
        chans = [0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
                 128 + 0.5 * r - 0.418688 * g - 0.081312 * b]
        if rgb.shape[2] == 4:
            chans.append(rgb[..., 3].astype(np.float64))
    else:
        chans = [rgb[..., i].astype(np.float64) for i in range(rgb.shape[2])]
    nc = len(chans)
    factors = list(factors)[:nc] + [(1, 1)] * (len(factors) < nc)
    ids = ids or list(range(1, len(factors) + 1))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    comps = []
    for ci, (hf, vf) in enumerate(factors):
        wib, hib = math.ceil(W * hf / (8 * hmax)), math.ceil(H * vf / (8 * vmax))
        bw, bh = math.ceil(wib / hf) * hf, math.ceil(hib / vf) * vf
        q = quant_table(quality, scale16) if ci == 0 else np.clip(quant_table(quality, scale16) + 4, 1, None)
        chan = chans[min(ci, nc - 1)]
        plane = _plane(chan, hf, vf, hmax, vmax, bw, bh) - 128
        blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.round(np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT) / q).astype(np.int64)
        comps.append(dict(h=hf, v=vf, wib=wib, hib=hib, coef=coef, q=q, tq=min(ci, 1), t=min(ci, 1)))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    for t in sorted({c["tq"] for c in comps}):
        q = next(c["q"] for c in comps if c["tq"] == t).reshape(64)[ZIGZAG]
        wide = int(q.max() > 255)
        out += _segment(0xDB, bytes([(wide << 4) | t]) + (q.astype(">u2").tobytes() if wide else bytes(q.astype(np.uint8))))
    out += _segment(sof, bytes([precision]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + bytes([len(comps)])
                    + b"".join(bytes([ids[i], (c["h"] << 4) | c["v"], c["tq"]]) for i, c in enumerate(comps)))
    arithmetic = sof in (0xC9, 0xCA)
    if dht and not arithmetic:
        for cls, tables in ((0, STD_DC), (1, STD_AC)):
            for t in range(2):
                bits, vals = tables[t]
                out += _segment(0xC4, bytes([(cls << 4) | t] + bits + vals))
    if dac:
        out += _segment(0xCC, dac)
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    if arithmetic:
        out += arith_scans(comps, W, H, hmax, vmax, ids, restart, progressive=sof == 0xCA, interleaved=interleaved,
                           dac=dac)
        return bytes(out + b"\xff\xd9")
    scans = [list(range(len(comps)))] if interleaved else [[i] for i in range(len(comps)) if i != skip_scan]
    for scan in scans:
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(bytes([ids[i], comps[i]["t"] * 17]) for i in scan)
                        + b"\x00\x3f\x00")
        out += _scan([comps[i] for i in scan], W, H, hmax, vmax, restart)
    return bytes(out + b"\xff\xd9")


def _scan(comps, W, H, hmax, vmax, restart):
    dc = [_codes(*STD_DC[c["t"]]) for c in comps]
    ac = [_codes(*STD_AC[c["t"]]) for c in comps]
    bw = _Bits()
    if len(comps) == 1:
        c = comps[0]
        mcus = [[(0, y, x)] for y in range(c["hib"]) for x in range(c["wib"])]
    else:
        mx, my = math.ceil(W / (8 * hmax)), math.ceil(H / (8 * vmax))
        mcus = [[(i, y * c["v"] + v, x * c["h"] + h) for i, c in enumerate(comps) for v in range(c["v"])
                 for h in range(c["h"])] for y in range(my) for x in range(mx)]
    pred = [0] * len(comps)
    for m, blocks in enumerate(mcus):
        if restart and m and m % restart == 0:
            bw.flush()
            bw.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            pred = [0] * len(comps)
        for i, y, x in blocks:
            z = comps[i]["coef"][y, x].reshape(64)[ZIGZAG]
            diff, pred[i] = int(z[0]) - pred[i], int(z[0])
            s = abs(diff).bit_length()
            bw.put(*dc[i][s])
            if s:
                bw.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
            run = 0
            for k in range(1, 64):
                v = int(z[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    bw.put(*ac[i][0xF0])
                    run -= 16
                s = abs(v).bit_length()
                bw.put(*ac[i][(run << 4) | s])
                bw.put(v if v >= 0 else v + (1 << s) - 1, s)
                run = 0
            if run:
                bw.put(*ac[i][0x00])
    bw.flush()
    return bytes(bw.out)


# ---------------------------------------------------------------------------
# images and references
# ---------------------------------------------------------------------------


def smooth_image(h, w, seed, noise=3.0):
    """Smooth colour waves with a little noise: compresses like a photo."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / r.uniform(9, 40) + y / r.uniform(9, 40) + r.uniform(0, 6))
                    for _ in range(3)], -1)
    return np.clip(img + r.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def pillow_jpeg(img, **kw) -> bytes:
    """Pillow's JPEG of uint8 [H, W, 3] RGB, [H, W] grey or [H, W, 4] CMYK."""
    b = io.BytesIO()
    cmyk = img.ndim == 3 and img.shape[2] == 4
    (Image.frombytes("CMYK", img.shape[1::-1], img.tobytes()) if cmyk else Image.fromarray(img)).save(b, "JPEG", **kw)
    return b.getvalue()


def reference(data: bytes, tmp_path) -> np.ndarray:
    """libjpeg's RGB through the JAX package's codec, which must agree with
    Pillow's decode."""
    p = str(tmp_path / "ref.jpg")
    with open(p, "wb") as f:
        f.write(data)
    ref = jnc.decode(p)
    assert ref is not None, "the JAX package's codec did not decode the file"
    with Image.open(p) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), ref)
    return ref


def assert_decodes_like_libjpeg(data: bytes, tmp_path):
    ref = reference(data, tmp_path)
    got = pnc.decode_bytes(data, "case")
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    return got


# ---------------------------------------------------------------------------
# the decoder against libjpeg
# ---------------------------------------------------------------------------

PILLOW_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
ENCODER_SAMPLING = {
    "4:4:0": ((1, 2), (1, 1), (1, 1)),
    "4:1:1": ((4, 1), (1, 1), (1, 1)),
    "4:2:0-h2v2-chroma-h1v2": ((2, 2), (1, 2), (1, 1)),
    "1x4/1x2": ((1, 4), (1, 2), (1, 2)),
    "4:1:0": ((4, 2), (1, 1), (1, 1)),
    "1x4": ((1, 4), (1, 1), (1, 1)),
    "2x1-all": ((2, 1), (2, 1), (2, 1)),
}


@pytest.mark.parametrize("sampling", sorted(PILLOW_SAMPLING))
@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (48, 64)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_pillow_sampling_and_sizes(tmp_path, sampling, hw):
    img = smooth_image(*hw, seed=hw[0] * 100 + hw[1], noise=20)
    assert_decodes_like_libjpeg(pillow_jpeg(img, quality=85, subsampling=PILLOW_SAMPLING[sampling]), tmp_path)


@pytest.mark.parametrize("sampling", sorted(ENCODER_SAMPLING))
@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33), (35, 70)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_encoder_sampling_and_sizes(tmp_path, sampling, hw):
    """Sampling factors Pillow does not write, the chroma width <= 2 cases
    (plain replication) included."""
    img = smooth_image(*hw, seed=hw[0] + hw[1], noise=25)
    assert_decodes_like_libjpeg(encode(img, ENCODER_SAMPLING[sampling], quality=80), tmp_path)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", [0, 2])
def test_qualities(tmp_path, quality, sampling):
    """Quality 100 (all-ones tables) on noise drives the IDCT's output
    past 0..255 into the range-limit table."""
    img = np.random.default_rng(quality).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    assert_decodes_like_libjpeg(pillow_jpeg(img, quality=quality, subsampling=sampling), tmp_path)


@pytest.mark.parametrize("case", ["grey", "adobe-rgb", "optimize", "restart", "restart-420-optimize", "icc-exif"])
def test_pillow_variants(tmp_path, case):
    img = smooth_image(37, 61, seed=5, noise=15)
    kw = {
        "grey": dict(),
        "adobe-rgb": dict(keep_rgb=True, subsampling=0),
        "optimize": dict(optimize=True, subsampling=1),
        "restart": dict(restart_marker_blocks=1, subsampling=0),
        "restart-420-optimize": dict(restart_marker_rows=1, optimize=True, subsampling=2),
        "icc-exif": dict(icc_profile=bytes(300), exif=b"Exif\x00\x00" + bytes(64), comment=b"a comment"),
    }[case]
    src = img[..., 0] if case == "grey" else img
    data = pillow_jpeg(src, quality=80, **kw)
    got = assert_decodes_like_libjpeg(data, tmp_path)
    if case == "grey":
        assert (got[..., 0] == got[..., 1]).all() and (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize(
    "case",
    ["non-interleaved-444", "non-interleaved-420", "no-scan-for-cr", "sof1-16bit-tables", "rgb-ids", "adobe-transform-1",
     "no-jfif-ycc", "no-dht", "restart-7-420", "restart-1-411", "grey-2x2-factors"],
)
def test_encoder_variants(tmp_path, case):
    img = smooth_image(29, 45, seed=11, noise=20)
    f420 = ((2, 2), (1, 1), (1, 1))
    kw = {
        "non-interleaved-444": dict(interleaved=False),
        "non-interleaved-420": dict(factors=f420, interleaved=False, restart=3),
        "no-scan-for-cr": dict(factors=f420, interleaved=False, skip_scan=2),
        "sof1-16bit-tables": dict(sof=0xC1, scale16=3, factors=f420),
        "rgb-ids": dict(ids=[ord("R"), ord("G"), ord("B")], jfif=False, ycc=False),
        "adobe-transform-1": dict(adobe=1, jfif=False, ids=[ord("R"), ord("G"), ord("B")]),
        "no-jfif-ycc": dict(jfif=False, ids=[7, 8, 9]),
        "no-dht": dict(dht=False, factors=f420),
        "restart-7-420": dict(factors=f420, restart=7),
        "restart-1-411": dict(factors=((4, 1), (1, 1), (1, 1)), restart=1),
        "grey-2x2-factors": dict(factors=((2, 2),)),
    }[case]
    src = img[..., 1] if case.startswith("grey") else img
    assert_decodes_like_libjpeg(encode(src, **kw), tmp_path)


def test_full_frame_1914x1052(tmp_path):
    """A Sim10k-sized frame, 4:2:0 at quality 75."""
    img = smooth_image(1052, 1914, seed=3)
    assert_decodes_like_libjpeg(pillow_jpeg(img, quality=75), tmp_path)


@settings(max_examples=12, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(30, 100),
       sampling=st.sampled_from(sorted(PILLOW_SAMPLING) + sorted(ENCODER_SAMPLING)), seed=st.integers(0, 2**16))
def test_hypothesis_sizes_sampling_quality(tmp_path_factory, h, w, quality, sampling, seed):
    img = smooth_image(h, w, seed=seed, noise=30)
    if sampling in PILLOW_SAMPLING:
        data = pillow_jpeg(img, quality=quality, subsampling=PILLOW_SAMPLING[sampling])
    else:
        data = encode(img, ENCODER_SAMPLING[sampling], quality=quality)
    assert_decodes_like_libjpeg(data, tmp_path_factory.mktemp("hyp"))


# ---------------------------------------------------------------------------
# refusals: each its own message, nothing falls back
# ---------------------------------------------------------------------------

SMALL = smooth_image(16, 16, seed=1)


def _with_sof(marker):
    return encode(SMALL, sof=marker)


REFUSALS = {
    "hierarchical": (lambda: _with_sof(0xC5), "hierarchical JPEG"),
    "hierarchical-dhp": (lambda: b"\xff\xd8\xff\xde\x00\x02" + _with_sof(0xC0)[2:], "hierarchical JPEG"),
    "precision-12": (lambda: encode(SMALL, sof=0xC1, precision=12), "sample precision"),
    "fractional": (lambda: _resample_header(((3, 1), (2, 1), (1, 1))), "fractional sampling"),
    "sampling-5": (lambda: _resample_header(((5, 1), (1, 1), (1, 1))), "sampling factors out of range"),
    "too-many-blocks": (lambda: encode(SMALL, factors=((4, 4), (1, 1), (1, 1))), "sampling factors out of range"),
    "corrupt-huffman": (lambda: _corrupt(), "corrupt JPEG data"),
    "missing-restart": (lambda: _drop_restart(), "corrupt JPEG data"),
    "no-image": (lambda: b"\xff\xd8\xff\xd9", "corrupt JPEG data"),
    "garbage-before-marker": (lambda: _garbage_before_eoi(), "corrupt JPEG data"),
    "truncated": (lambda: pillow_jpeg(SMALL)[:-40], "ends early"),
    "no-eoi": (lambda: pillow_jpeg(SMALL)[:-2], "ends early"),
}


# refused until the decoder read them: their cases now decode as Pillow does
DECODED_NOW = {
    "progressive": lambda: pillow_jpeg(SMALL, progressive=True),
    "cmyk": lambda: _cmyk(),
    "arithmetic": lambda: _with_sof(0xC9),
    "arithmetic-progressive": lambda: _with_sof(0xCA),
    "lossless": lambda: lossless_jpeg([SMALL[..., i] for i in range(3)], [(1, 1)] * 3, psv=4),
}
# refused by Pillow (libjpeg-turbo) on the same bytes
PILLOW_REFUSES = ("hierarchical", "hierarchical-dhp", "precision-12")


def _cmyk():
    b = io.BytesIO()
    Image.fromarray(SMALL).convert("CMYK").save(b, "JPEG")
    return b.getvalue()


def _resample_header(factors):
    """A 4:4:4 file whose SOF0 claims other sampling factors (libjpeg
    refuses them before reading a scan)."""
    data = bytearray(encode(SMALL))
    sof = data.index(b"\xff\xc0") + 10
    for i, (h, v) in enumerate(factors):
        data[sof + 3 * i + 1] = (h << 4) | v
    return bytes(data)


def _entropy_start(data):
    return data.index(b"\xff\xda") + 2 + int.from_bytes(data[data.index(b"\xff\xda") + 2:][:2], "big")


def _corrupt():
    """The entropy data replaced by all-ones bytes: no Huffman code of the
    standard tables is 16 ones."""
    data = bytearray(encode(SMALL))
    start = _entropy_start(data)
    for i in range(start, len(data) - 2):
        data[i] = 0xFF if i % 2 == 0 else 0x00  # stuffed 0xFF data bytes
    return bytes(data)


def _drop_restart():
    data = encode(SMALL, restart=1)
    i = data.index(b"\xff\xd0")
    return data[:i] + data[i + 2:]


def _garbage_before_eoi():
    data = encode(SMALL)
    return data[:-2] + b"\x12\x34" + data[-2:]


@pytest.mark.parametrize("case", sorted(REFUSALS) + sorted(DECODED_NOW))
def test_refusals_name_the_feature(case):
    """Each refusal by its message, and Pillow's own refusal of the same
    bytes where PILLOW_REFUSES says; the cases of DECODED_NOW, refused
    before the decoder read progressive, CMYK, arithmetic-coded and
    lossless files, equal to Pillow."""
    if case in DECODED_NOW:
        data = DECODED_NOW[case]()
        with Image.open(io.BytesIO(data)) as im:
            np.testing.assert_array_equal(pnc.decode_bytes(data, "case"), np.asarray(im.convert("RGB")))
        return
    make, message = REFUSALS[case]
    data = make()
    with pytest.raises(ValueError, match=f"JPEG decode failed: .*{message}"):
        pnc.decode_bytes(data, "case")
    if case in PILLOW_REFUSES:
        with pytest.raises(OSError):
            with Image.open(io.BytesIO(data)) as im:
                im.convert("RGB")


def test_truncated_file_deviation(tmp_path):
    """libjpeg warns on a truncated file and pads it with grey: the JAX
    package returns that image, the port raises."""
    data = pillow_jpeg(smooth_image(64, 64, seed=2), quality=90)
    p = tmp_path / "cut.jpg"
    p.write_bytes(data[: len(data) // 2])
    padded = jnc.decode(str(p))
    assert padded is not None and padded.shape == (64, 64, 3)
    with pytest.raises(ValueError, match="ends early"):
        pnc.decode(str(p))


def test_image_size_reads_headers_only(tmp_path):
    img = smooth_image(13, 29, seed=4)
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8" + b"\xff\xfe\x00\x04ab" + pillow_jpeg(img, icc_profile=bytes(99))[2:])
    Image.fromarray(img).save(tmp_path / "a.png")
    (tmp_path / "p.jpg").write_bytes(pillow_jpeg(img, progressive=True))
    for name in ("a.jpg", "a.png", "p.jpg"):
        assert pnc.image_size(str(tmp_path / name)) == (13, 29)
    (tmp_path / "x.bin").write_bytes(b"not an image")
    with pytest.raises(ValueError, match=r"not a PNG, JPEG, BMP, DIB, GIF, TIFF, WebP, Netpbm \(PBM, PGM, PPM, PFM\), ICO, CUR, QOI, SGI, PCX, DCX or TGA file"):
        pnc.image_size(str(tmp_path / "x.bin"))


# ---------------------------------------------------------------------------
# the committed fixtures (decoded on the card's host by chip_smoke.py)
# ---------------------------------------------------------------------------


def fixture_files():
    """name -> (a function giving its bytes, sampling label) of every
    committed fixture."""
    frame = lambda seed: smooth_image(1052, 1914, seed=seed, noise=1.5)  # noqa: E731
    img = smooth_image(45, 63, seed=9, noise=20)
    cmyk = lambda: np.asarray(Image.fromarray(img).convert("CMYK"))  # noqa: E731
    return {
        "f444_q90_45x63.jpg": (lambda: pillow_jpeg(img, quality=90, subsampling=0), "4:4:4"),
        "f422_q75_17x33.jpg": (lambda: pillow_jpeg(img[:17, :33], quality=75, subsampling=1), "4:2:2"),
        "f420_q50_45x63.jpg": (lambda: pillow_jpeg(img, quality=50, subsampling=2), "4:2:0"),
        "grey_q80_45x63.jpg": (lambda: pillow_jpeg(img[..., 0], quality=80), "grey"),
        "adobe_rgb_q80.jpg": (lambda: pillow_jpeg(img, quality=80, keep_rgb=True, subsampling=0), "4:4:4 RGB"),
        "optimized_q85.jpg": (lambda: pillow_jpeg(img, quality=85, optimize=True), "4:2:0"),
        "restart_q80.jpg": (lambda: pillow_jpeg(img, quality=80, restart_marker_blocks=3), "4:2:0"),
        "f440_q80.jpg": (lambda: encode(img, ENCODER_SAMPLING["4:4:0"], quality=80), "4:4:0"),
        "f411_q80.jpg": (lambda: encode(img, ENCODER_SAMPLING["4:1:1"], quality=80), "4:1:1"),
        "noninterleaved_sof1_q16.jpg": (lambda: encode(img, ((2, 2), (1, 1), (1, 1)), interleaved=False, sof=0xC1,
                                                       scale16=3, restart=5), "4:2:0"),
        "progressive.jpg": (lambda: pillow_jpeg(img, progressive=True), "progressive 4:2:0"),
        "progressive_420_restart.jpg": (lambda: pillow_jpeg(img, quality=80, progressive=True,
                                                            restart_marker_blocks=2), "progressive 4:2:0"),
        "cmyk_q85.jpg": (lambda: pillow_jpeg(cmyk(), quality=85), "CMYK"),
        "ycck_q80.jpg": (lambda: encode(cmyk(), ((2, 2), (1, 1), (1, 1), (2, 2)), quality=80, jfif=False, adobe=2),
                         "YCCK"),
        **{f"sim10k_frame_{i}.jpg": ((lambda i=i: pillow_jpeg(frame(100 + i), quality=75)), "4:2:0")
           for i in range(3)},
        "sim10k_frame_0_progressive.jpg": (lambda: pillow_jpeg(frame(100), quality=75, progressive=True),
                                           "progressive 4:2:0"),
        "arithmetic_sof9.jpg": (lambda: encode(img, sof=0xC9), "arithmetic 4:4:4"),
        "arithmetic_sof10_restart.jpg": (lambda: encode(img, ((2, 2), (1, 1), (1, 1)), sof=0xCA, restart=4),
                                         "arithmetic progressive 4:2:0"),
        "progressive_unrefined.jpg": (lambda: drop_scans(pillow_jpeg(img, progressive=True), keep=5),
                                      "progressive 4:2:0 smoothed"),
        "progressive_dc_only.jpg": (lambda: drop_scans(pillow_jpeg(img, progressive=True), keep=1),
                                    "progressive 4:2:0 smoothed, DC only"),
        "lossless_sof3_rgb.jpg": (lambda: lossless_jpeg([img[..., i] for i in range(3)], [(1, 1)] * 3, psv=6,
                                                        restart=63 * 5), "lossless RGB"),
        # the coefficients of sim10k_frame_0.jpg, arithmetic-coded: the same pixels
        "arithmetic_sim10k_frame_0.jpg": (
            lambda: transcode_arithmetic(open(os.path.join(FIXTURES, "sim10k_frame_0.jpg"), "rb").read()),
            "arithmetic 4:2:0"),
    }


# a fixture whose reference is another's pixels: Pillow cannot decode an
# arithmetic-coded file longer than its 64 KiB read block (ImageFile.MAXBLOCK:
# libjpeg's arithmetic decoder cannot suspend for more data, JERR_CANT_SUSPEND);
# the transcoded frame has sim10k_frame_0.jpg's coefficients and pixels
SAME_PIXELS_AS = {"arithmetic_sim10k_frame_0.jpg": "sim10k_frame_0.jpg"}
# the fixtures whose reference the JAX package's native codec does not give:
# 4 components and lossless it refuses (its loader reads them with PIL), and
# its libjpeg smooths otherwise than Pillow's libjpeg-turbo
JAX_CODEC_SKIPS = ("CMYK", "YCCK", "lossless", "smoothed")


def jpeg_parts(data: bytes) -> tuple:
    """A JPEG file's (bytes before its first scan, [each scan: the segments
    between it and the scan before (DHT, DRI), its SOS and its entropy-coded
    data]); EOI left out."""
    pos, mark, head, scans = 2, 2, None, []
    while data[pos + 1] != 0xD9:
        seg = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xDA:
            pos += 2 + seg
            continue
        end = pos + 2 + seg
        while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
            end += 1
        if head is None:
            head, mark = data[:pos], pos
        scans.append(data[mark:end])
        pos = mark = end
    return head, scans


def drop_scans(data: bytes, keep: int) -> bytes:
    """A JPEG file cut after its first `keep` scans, then EOI."""
    head, scans = jpeg_parts(data)
    return head + b"".join(scans[:keep]) + b"\xff\xd9"


def write_fixtures(directory: str) -> dict:
    """Write the fixtures and fixtures.json: the SHA-256 of Pillow's RGB of
    each file (libjpeg's through the JAX package's codec too, where it reads
    the file as Pillow does)."""
    from PIL import features

    os.makedirs(directory, exist_ok=True)
    decoder = f"Pillow {Image.__version__}, libjpeg-turbo {features.version('libjpeg_turbo')}"
    record = {}
    for name, (make, sampling) in sorted(fixture_files().items(), key=lambda kv: kv[0] in SAME_PIXELS_AS):
        data = make()
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(os.path.join(directory, SAME_PIXELS_AS.get(name, name))) as im:
            ref = np.asarray(im.convert("RGB"))
        if not any(k in sampling for k in JAX_CODEC_SKIPS):
            jax_ref = jnc.decode(path)
            assert jax_ref is None or np.array_equal(jax_ref, ref), name
        record[name] = {"shape": list(ref.shape), "sampling": sampling, "decoder": decoder,
                        "sha256": hashlib.sha256(ref.tobytes()).hexdigest(), "bytes": len(data)}
    with open(os.path.join(directory, "fixtures.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    return record


def test_pillow_cannot_read_a_large_arithmetic_file(monkeypatch):
    """The committed 1914x1052 arithmetic-coded frame: Pillow raises (its
    64 KiB read block and libjpeg's arithmetic decoder, which cannot
    suspend), the JAX package's native codec (libjpeg over the whole
    buffer) and the port decode it to sim10k_frame_0.jpg's pixels."""
    path = os.path.join(FIXTURES, "arithmetic_sim10k_frame_0.jpg")
    assert os.path.getsize(path) > ImageFile.MAXBLOCK
    with pytest.raises(OSError, match="broken data stream"):
        with Image.open(path) as im:
            im.convert("RGB")
    with Image.open(os.path.join(FIXTURES, "sim10k_frame_0.jpg")) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(pnc.decode(path), want)
    monkeypatch.setattr(jnc, "_DISABLED", False)
    monkeypatch.setattr(jnc, "_CHECKED", dict(jnc._CHECKED))
    np.testing.assert_array_equal(jnc.decode(path), want)  # what the JAX loader reads


def test_committed_fixtures_match_their_digests():
    """Each committed fixture: Pillow's RGB, libjpeg's through the JAX
    package's codec (where it reads the file as Pillow does) and the port's
    hash to the recorded SHA-256."""
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        record = json.load(f)
    assert sorted(record) == sorted(fixture_files())
    total = 0
    for name, rec in record.items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        got = pnc.decode(path)
        assert list(got.shape) == rec["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"], name
        with Image.open(os.path.join(FIXTURES, SAME_PIXELS_AS.get(name, name))) as im:
            assert hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest() == rec["sha256"], name
        if any(k in rec["sampling"] for k in JAX_CODEC_SKIPS):
            continue
        jax_ref = jnc.decode(path)
        assert jax_ref is not None, name
        assert hashlib.sha256(jax_ref.tobytes()).hexdigest() == rec["sha256"], name
    assert total < 1 << 20


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        print(json.dumps(write_fixtures(FIXTURES), indent=1))
