"""WebP files for tests/test_torch_webp.py and their readers.

  libwebp_encode  a uint8 RGB(A) array through the system libwebp's
                  WebPEncode with any WebPConfig field set (a small C
                  program built against <webp/encode.h>, -lwebp), to reach
                  what Pillow cannot ask for: the simple loop filter, a
                  sharpness, 2/4/8 token partitions, 1-4 segments, raw or
                  lossless ALPH with a chosen filtering. Used by
                  `python tests/test_torch_webp.py --write-fixtures` only;
                  the tests read the committed files
  riff, chunks    build a RIFF WEBP file from (tag, payload) chunks, and
                  split one into them
  animated        VP8X + ANIM + ANMF frames at offsets (Pillow's saver
                  refuses frames of unequal size)
  vp8_header      the key-frame header fields of a VP8 payload (a boolean
                  decoder in Python), to show what a fixture exercises
  alph_header     an ALPH payload's compression, filter and pre-processing
  vp8_with_lf_deltas  a VP8 key frame with the loop filter's ref and mode
                  deltas set, which libwebp's encoder never writes: its
                  first partition read boolean by boolean and coded anew
                  (RFC 6386's boolean encoder, BoolEncoder)
"""

import os
import struct
import subprocess
import tempfile

import numpy as np

ENCODER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>

/* in.raw width height channels out.webp [field=value ...] */
int main(int argc, char** argv) {
  if (argc < 6) return 2;
  const int w = atoi(argv[2]), h = atoi(argv[3]), c = atoi(argv[4]);
  uint8_t* px = (uint8_t*)malloc((size_t)w * h * c);
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(px, 1, (size_t)w * h * c, f) != (size_t)w * h * c) return 3;
  fclose(f);
  WebPConfig config;
  if (!WebPConfigInit(&config)) return 4;
  for (int i = 6; i < argc; ++i) {
    char key[64];
    double v;
    if (sscanf(argv[i], "%63[^=]=%lf", key, &v) != 2) return 5;
#define FIELD(name) else if (!strcmp(key, #name)) config.name = (int)v;
    if (!strcmp(key, "quality")) config.quality = (float)v;
    else if (!strcmp(key, "alpha_quality")) config.alpha_quality = (int)v;
    FIELD(lossless) FIELD(method) FIELD(segments) FIELD(sns_strength) FIELD(filter_strength)
    FIELD(filter_sharpness) FIELD(filter_type) FIELD(autofilter) FIELD(partitions) FIELD(alpha_compression)
    FIELD(alpha_filtering) FIELD(preprocessing) FIELD(exact) FIELD(near_lossless) FIELD(use_sharp_yuv)
    else return 6;
  }
  if (!WebPValidateConfig(&config)) return 7;
  WebPPicture pic;
  if (!WebPPictureInit(&pic)) return 8;
  pic.width = w;
  pic.height = h;
  pic.use_argb = config.lossless;
  if (!(c == 4 ? WebPPictureImportRGBA(&pic, px, w * 4) : WebPPictureImportRGB(&pic, px, w * 3))) return 9;
  WebPMemoryWriter wr;
  WebPMemoryWriterInit(&wr);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &wr;
  if (!WebPEncode(&config, &pic)) return 10;
  f = fopen(argv[5], "wb");
  fwrite(wr.mem, 1, wr.size, f);
  fclose(f);
  return 0;
}
"""

_ENCODER = {}


def encoder_path() -> str:
    """The C encoder, built once a process into a temporary directory."""
    if "path" not in _ENCODER:
        d = tempfile.mkdtemp(prefix="webp_encoder_")
        src, exe = os.path.join(d, "encode.c"), os.path.join(d, "encode")
        with open(src, "w") as f:
            f.write(ENCODER_C)
        subprocess.run(["gcc", "-O2", "-o", exe, src, "-lwebp"], check=True, capture_output=True)
        _ENCODER["path"] = exe
    return _ENCODER["path"]


def libwebp_encode(img: np.ndarray, **config) -> bytes:
    """img uint8 [H, W, 3 or 4] encoded by the system libwebp with the
    WebPConfig fields in config (WebPConfigInit's defaults otherwise)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    with tempfile.TemporaryDirectory() as d:
        raw, out = os.path.join(d, "in.raw"), os.path.join(d, "out.webp")
        img.tofile(raw)
        args = [f"{k}={v}" for k, v in config.items()]
        subprocess.run([encoder_path(), raw, str(w), str(h), str(c), out, *args], check=True)
        with open(out, "rb") as f:
            return f.read()


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def riff(parts) -> bytes:
    """A RIFF WEBP file of the (tag, payload) chunks, each padded to even."""
    body = b"WEBP" + b"".join(chunk(t, p) for t, p in parts)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def chunks(data: bytes) -> list:
    """The top-level (tag, payload) chunks of a RIFF WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def frame_chunks(data: bytes) -> list:
    """The ALPH and VP8/VP8L chunks of a still WebP file."""
    return [(t, p) for t, p in chunks(data) if t in (b"ALPH", b"VP8 ", b"VP8L")]


def vp8x(canvas, flags: int) -> tuple:
    w, h = canvas
    return b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")


def animated(canvas, frames, flags: int = 0x02) -> bytes:
    """An animated WebP file: frames are (x, y, (w, h), [still file's frame
    chunks]); x and y even, as ANMF stores them halved."""
    parts = [vp8x(canvas, flags), (b"ANIM", struct.pack("<IH", 0xFF336699, 0))]
    for x, y, (w, h), body in frames:
        hdr = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100)) + b"\x00"
        parts.append((b"ANMF", hdr + b"".join(chunk(t, p) for t, p in body)))
    return riff(parts)


class BoolDecoder:
    """RFC 6386's boolean decoder (section 7), for header fields."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.bit_count = 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            ret, self.range, self.value = 1, self.range - split, self.value - big
        else:
            ret, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        return ret

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v


def vp8_header(payload: bytes) -> dict:
    """A VP8 key frame's size, segment, loop-filter and partition fields."""
    first = struct.unpack("<I", payload[:3] + b"\x00")[0] >> 5
    d = BoolDecoder(payload[10:10 + first])
    out = {"width": struct.unpack("<H", payload[6:8])[0] & 0x3FFF,
           "height": struct.unpack("<H", payload[8:10])[0] & 0x3FFF}
    d.literal(2)  # colour space, clamping
    out["segments"] = d.literal(1)
    out["update_map"] = out["segment_data"] = 0
    if out["segments"]:
        out["update_map"] = d.literal(1)
        out["segment_data"] = d.literal(1)
        if out["segment_data"]:
            d.literal(1)
            for n in (7, 6):
                for _ in range(4):
                    if d.literal(1):
                        d.signed(n)
        if out["update_map"]:
            for _ in range(3):
                if d.literal(1):
                    d.literal(8)
    out["simple_filter"] = d.literal(1)
    out["filter_level"] = d.literal(6)
    out["sharpness"] = d.literal(3)
    out["lf_delta"] = d.literal(1)
    if out["lf_delta"] and d.literal(1):
        for _ in range(8):
            if d.literal(1):
                d.signed(6)
    out["partitions"] = 1 << d.literal(2)
    return out


def alph_header(payload: bytes) -> dict:
    b = payload[0]
    return {"compression": b & 3, "filter": (b >> 2) & 3, "preprocessing": (b >> 4) & 3}


class BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _add_one(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._add_one()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._add_one()
        v = (v << (c & 7)) & 0xFFFFFFFF
        v = (v << (8 * (c >> 3))) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


class _LoggingDecoder(BoolDecoder):
    """A BoolDecoder that keeps each (bit, probability) it reads."""

    def __init__(self, data: bytes):
        super().__init__(data)
        self.log = []

    def bit(self, prob: int) -> int:
        b = super().bit(prob)
        self.log.append((b, prob))
        return b


def _source_table(source: str, name: str, shape) -> np.ndarray:
    """A constant table of a C++ source (`const uint8_t name[..] = {...};`)."""
    import re

    body = re.search(r"const uint8_t " + re.escape(name) + r"(\[\d+\])+ = \{(.*?)\};", source, re.S).group(2)
    return np.array([int(v) for v in re.findall(r"\d+", body)], np.int64).reshape(shape)


def vp8_with_lf_deltas(payload: bytes, source: str, ref_deltas, mode_deltas) -> bytes:
    """The VP8 key frame `payload` with its first partition coded again with
    the loop filter's ref and mode deltas set (libwebp's encoder never
    writes them): every boolean of the partition read with its
    probability (the tables from the decoder's C++ `source`), the deltas
    spliced in after the sharpness, the partition coded anew and the frame
    tag's partition size updated. A delta of None stays unset."""
    update = _source_table(source, "kCoeffsUpdateProba", (4, 8, 3, 11))
    bmodes = _source_table(source, "kBModesProba", (10, 10, 9))
    first = struct.unpack("<I", payload[:3] + b"\x00")[0] >> 5
    w, h = (struct.unpack("<H", payload[6:8])[0] & 0x3FFF), (struct.unpack("<H", payload[8:10])[0] & 0x3FFF)
    d = _LoggingDecoder(payload[10:10 + first])
    d.literal(2)
    seg = d.literal(1)
    update_map, seg_probs = 0, [255, 255, 255]
    if seg:
        update_map = d.literal(1)
        if d.literal(1):
            d.literal(1)
            for n in (7, 6):
                for _ in range(4):
                    if d.literal(1):
                        d.signed(n)
        if update_map:
            seg_probs = [d.literal(8) if d.literal(1) else 255 for _ in range(3)]
    d.literal(1 + 6 + 3)  # simple, level, sharpness
    splice = len(d.log)
    assert d.literal(1) == 0, "the frame already has loop-filter deltas"
    d.literal(2)  # partitions
    d.literal(7)
    for _ in range(5):
        if d.literal(1):
            d.signed(4)
    d.literal(1)  # refresh entropy probs
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if d.bit(int(update[t, b, c, p])):
                        d.literal(8)
    skip = d.literal(1)
    skip_p = d.literal(8) if skip else 0
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    top = [0] * (4 * mb_w)
    for _ in range(mb_h):
        left = [0] * 4
        for x in range(mb_w):
            if update_map:
                d.bit(seg_probs[1]) if not d.bit(seg_probs[0]) else d.bit(seg_probs[2])
            if skip:
                d.bit(skip_p)
            if d.bit(145):  # 16x16: DC 0, TM 1, V 2, H 3 in libwebp's numbering
                mode = (1 if d.bit(128) else 3) if d.bit(156) else (2 if d.bit(163) else 0)
                top[4 * x:4 * x + 4] = [mode] * 4
                left = [mode] * 4
            else:
                for y in range(4):
                    m = left[y]
                    for i in range(4):
                        pr = bmodes[top[4 * x + i], m]
                        m = (0 if not d.bit(pr[0]) else 1 if not d.bit(pr[1]) else 2 if not d.bit(pr[2]) else
                             ((3 if not d.bit(pr[4]) else 4 if not d.bit(pr[5]) else 5) if not d.bit(pr[3]) else
                              (6 if not d.bit(pr[6]) else 7 if not d.bit(pr[7]) else 8 if not d.bit(pr[8]) else 9)))
                        top[4 * x + i] = m
                    left[y] = m
            if not d.bit(142):
                pass
            elif d.bit(114):
                d.bit(183)
    e = BoolEncoder()
    log = list(d.log)
    for b, p in log[:splice]:
        e.put(b, p)
    e.put(1, 128)  # use_lf_delta
    e.put(1, 128)  # update them
    for v in (*ref_deltas, *mode_deltas):
        e.put(v is not None, 128)
        if v is not None:
            for k in range(5, -1, -1):
                e.put((abs(v) >> k) & 1, 128)
            e.put(v < 0, 128)
    for b, p in log[splice + 1:]:
        e.put(b, p)
    part0 = e.flush()
    tag = struct.unpack("<I", payload[:3] + b"\x00")[0] & 0x1F | (len(part0) << 5)
    return struct.pack("<I", tag)[:3] + payload[3:10] + part0 + payload[10 + first:]
