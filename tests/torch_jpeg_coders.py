"""JPEG writers for the files Pillow cannot write, kept for the tests of the
port's decoder (simple_sfod_tpu_torch/data/csrc/jpeg_decode.cpp):

  arith_scans    the scans of an arithmetic-coded file (SOF9 sequential,
                 SOF10 progressive), after libjpeg's jcarith.c: the
                 QM-coder's encoder with its carry handling and
                 "Pacman" termination, DC and AC coding of sequential scans,
                 first scans and refinement scans, the DAC conditioning and
                 restarts
  lossless_jpeg  a lossless (SOF3) file after jclossls.c/jclhuff.c:
                 predictors 1-7 over the scaled samples, the point
                 transform, restart intervals in whole MCU rows, Huffman
                 coding of the differences with the standard DC tables

tests/test_torch_jpeg.py's `encode` calls arith_scans for sof 0xC9 and 0xCA;
the DCT coefficients are that encoder's. The arithmetic coder's Qe table is
the JPEG standard's Table D.2, written out again here (not read from the
decoder) so that the two sides meet only in the file and in Pillow's
decode of it.
"""

from __future__ import annotations

import math

import numpy as np

# Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); entry 113 is
# the fixed 0.5 estimate (ITU-T T.851) that libjpeg codes signs and
# refinement bits with
QE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0),
    (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0), (0x001A, 33, 10, 0),
    (0x000D, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0),
    (0x002C, 33, 9, 0), (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0),
    (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1),
    (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0), (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0), (0x34EE, 91, 85, 0),
    (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0),
    (0x56A8, 95, 96, 1), (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504F, 111, 107, 0),
    (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]

# jcparam.c:jpeg_simple_progression: (components, Ss, Se, Ah, Al), None =
# every component
PROGRESSION_YCC = [(None, 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
                   ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), (None, 0, 0, 1, 0), ([2], 1, 63, 1, 0),
                   ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
PROGRESSION_OTHER = [(None, 0, 0, 0, 1), ("each", 1, 5, 0, 2), ("each", 6, 63, 0, 2), ("each", 1, 63, 2, 1),
                     (None, 0, 0, 1, 0), ("each", 1, 63, 1, 0)]


class ArithEncoder:
    """jcarith.c's coder: the C and A registers, the byte buffer, the
    stacked 0xFF (sc) and pending 0x00 (zc) counts."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _settle(self):
        """Output the buffered byte and the stacked 0xFF bytes (no carry)."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        """A carry into the buffered byte turns the stacked 0xFF into 0x00."""
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st: bytearray, i: int, val: int):
        """arith_encode: the decision `val` with the estimate st[i]."""
        sv = st[i]
        qe, nlps, nmps, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ ((switch << 7) | nlps)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:  # renormalisation and output (section D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        """finish_pass: the value in the final interval with the most
        trailing zero bits, and no trailing zero bytes."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)


class _Stats:
    """The statistics of one scan: DC and AC bins by table, the fixed bin."""

    def __init__(self):
        self.dc, self.ac, self.fixed = {}, {}, bytearray([113, 0, 0, 0])

    def reset(self, dc_tables, ac_tables):
        for t in dc_tables:
            self.dc[t] = bytearray(64)
        for t in ac_tables:
            self.ac[t] = bytearray(256)


def _encode_dc(e, st, ctx, last, i, m, lo, hi):
    """Figures F.4 and F.6-F.9: the DC value m against last[i]."""
    s0 = ctx[i]
    v = m - last[i]
    if v == 0:
        e.encode(st, s0, 0)
        ctx[i] = 0
        return
    last[i] = m
    e.encode(st, s0, 1)
    if v > 0:
        e.encode(st, s0 + 1, 0)
        p, ctx[i] = s0 + 2, 4
    else:
        v = -v
        e.encode(st, s0 + 1, 1)
        p, ctx[i] = s0 + 3, 8
    m = 0
    v -= 1
    if v:
        e.encode(st, p, 1)
        m, p, v2 = 1, 20, v >> 1
        while v2:
            e.encode(st, p, 1)
            m, p, v2 = m << 1, p + 1, v2 >> 1
    e.encode(st, p, 0)
    if m < (1 << lo) >> 1:
        ctx[i] = 0
    elif m > (1 << hi) >> 1:
        ctx[i] += 8
    p += 14
    m >>= 1
    while m:
        e.encode(st, p, 1 if m & v else 0)
        m >>= 1


def _encode_ac(e, st, fixed, z, ss, se, al, kx):
    """Figure F.5 over [ss, se] of the zigzag coefficients z, shifted by al
    (encode_mcu, encode_mcu_AC_first)."""
    ke = se
    while ke > 0 and abs(int(z[ke])) >> al == 0:
        ke -= 1
    k = ss
    while k <= ke:
        p = 3 * (k - 1)
        e.encode(st, p, 0)  # not EOB
        while True:
            v = int(z[k])
            mag = abs(v) >> al
            if mag:
                e.encode(st, p + 1, 1)
                e.encode(fixed, 0, 1 if v < 0 else 0)
                break
            e.encode(st, p + 1, 0)
            p, k = p + 3, k + 1
        p += 2
        m, v = 0, mag - 1
        if v:
            e.encode(st, p, 1)
            m, v2 = 1, v >> 1
            if v2:
                e.encode(st, p, 1)
                m, p, v2 = m << 1, 189 if k <= kx else 217, v2 >> 1
                while v2:
                    e.encode(st, p, 1)
                    m, p, v2 = m << 1, p + 1, v2 >> 1
        e.encode(st, p, 0)
        p += 14
        m >>= 1
        while m:
            e.encode(st, p, 1 if m & v else 0)
            m >>= 1
        k += 1
    if k <= se:
        e.encode(st, 3 * (k - 1), 1)  # EOB


def _encode_ac_refine(e, st, fixed, z, ss, se, ah, al):
    """encode_mcu_AC_refine (Figure G.10)."""
    ke = se
    while ke > 0 and abs(int(z[ke])) >> al == 0:
        ke -= 1
    kex = ke
    while kex > 0 and abs(int(z[kex])) >> ah == 0:
        kex -= 1
    k = ss
    while k <= ke:
        p = 3 * (k - 1)
        if k > kex:
            e.encode(st, p, 0)
        while True:
            v = int(z[k])
            mag = abs(v) >> al
            if mag:
                if mag >> 1:  # nonzero before: its correction bit
                    e.encode(st, p + 2, mag & 1)
                else:
                    e.encode(st, p + 1, 1)
                    e.encode(fixed, 0, 1 if v < 0 else 0)
                break
            e.encode(st, p + 1, 0)
            p, k = p + 3, k + 1
        k += 1
    if k <= se:
        e.encode(st, 3 * (k - 1), 1)


def _mcus(comps, W, H, hmax, vmax, unit=8):
    """The blocks (component index, block row, block column) of each MCU of
    a scan over `comps` (the MCU order of the standard's section A.2)."""
    if len(comps) == 1:
        c = comps[0]
        return [[(0, y, x)] for y in range(c["hib"]) for x in range(c["wib"])]
    mx, my = math.ceil(W / (unit * hmax)), math.ceil(H / (unit * vmax))
    return [[(i, y * c["v"] + v, x * c["h"] + h) for i, c in enumerate(comps) for v in range(c["v"])
             for h in range(c["h"])] for y in range(my) for x in range(mx)]


def _segment(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + bytes(payload)


def arith_scans(comps, W, H, hmax, vmax, ids, restart=0, progressive=False, interleaved=True, dac=b""):
    """The SOS segments and arithmetic-coded data of every scan of a file
    whose components `comps` (test_torch_jpeg.encode's: h, v, wib, hib, t
    and coef [rows, cols, 8, 8] in natural order) are coded with the
    conditioning of the DAC payload `dac` (L, U 0 and 1, Kx 5 by default)."""
    lo, hi, kx = [0] * 16, [1] * 16, [5] * 16
    for i in range(0, len(dac), 2):
        idx, val = dac[i], dac[i + 1]
        if idx >= 16:
            kx[idx - 16] = val
        else:
            lo[idx], hi[idx] = val & 15, val >> 4
    zig = [np.asarray(c["coef"]).reshape(c["coef"].shape[0], c["coef"].shape[1], 64)[:, :, ZIGZAG].astype(np.int64)
           for c in comps]
    if not progressive:
        script = [(None if interleaved else [i], 0, 63, 0, 0) for i in ([0] if interleaved else range(len(comps)))]
    else:
        script = []
        for sel, ss, se, ah, al in (PROGRESSION_YCC if len(comps) == 3 else PROGRESSION_OTHER):
            for s in ([[i] for i in range(len(comps))] if sel == "each" else [sel]):
                script.append((s, ss, se, ah, al))
    out = bytearray()
    for sel, ss, se, ah, al in script:
        scan = list(range(len(comps))) if sel is None else sel
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(bytes([ids[i], comps[i]["t"] * 17]) for i in scan)
                        + bytes([ss, se, (ah << 4) | al]))
        out += _arith_scan([comps[i] for i in scan], [zig[i] for i in scan], W, H, hmax, vmax, restart,
                           progressive, ss, se, ah, al, lo, hi, kx)
    return bytes(out)


def _arith_scan(comps, zig, W, H, hmax, vmax, restart, progressive, ss, se, ah, al, lo, hi, kx):
    e, stats = ArithEncoder(), _Stats()
    dc_first = not progressive or (ss == 0 and ah == 0)
    uses_ac = not progressive or se != 0
    dc_tables = [c["t"] for c in comps] if dc_first else []
    ac_tables = [c["t"] for c in comps] if uses_ac else []
    stats.reset(dc_tables, ac_tables)
    last, ctx = [0] * len(comps), [0] * len(comps)
    for m, blocks in enumerate(_mcus(comps, W, H, hmax, vmax)):
        if restart and m and m % restart == 0:  # emit_restart
            e.finish()
            e.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            e.reset()
            stats.reset(dc_tables, ac_tables)
            last, ctx = [0] * len(comps), [0] * len(comps)
        for i, y, x in blocks:
            z, t = zig[i][y, x], comps[i]["t"]
            if not progressive:
                _encode_dc(e, stats.dc[t], ctx, last, i, int(z[0]), lo[t], hi[t])
                _encode_ac(e, stats.ac[t], stats.fixed, z, 1, 63, 0, kx[t])
            elif ss == 0 and ah == 0:
                _encode_dc(e, stats.dc[t], ctx, last, i, int(z[0]) >> al, lo[t], hi[t])
            elif ss == 0:
                e.encode(stats.fixed, 0, (int(z[0]) >> al) & 1)
            elif ah == 0:
                _encode_ac(e, stats.ac[t], stats.fixed, z, ss, se, al, kx[t])
            else:
                _encode_ac_refine(e, stats.ac[t], stats.fixed, z, ss, se, ah, al)
    e.finish()
    return bytes(e.out)


# ---------------------------------------------------------------------------
# lossless (SOF3)
# ---------------------------------------------------------------------------

STD_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))


def _huff_codes(bits, vals):
    code, out, k = 0, {}, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _BitWriter:
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


def predict(psv, ra, rb, rc):
    """The predictors of Table H.1 (jdlossls.c's PREDICTOR1-7)."""
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
            7: (ra + rb) >> 1}[psv]


def _differences(vals, first, psv, pt):
    """The differences of one row `vals` (scaled samples): the first row of
    the scan or of a restart interval from 1 << (7 - pt) and the left
    neighbour, the others by the predictor over the row above."""
    prev, row = first
    out = []
    for x, v in enumerate(row):
        if prev is None:
            p = (1 << (7 - pt)) if x == 0 else row[x - 1]
        elif x == 0:
            p = prev[0]
        else:
            p = predict(psv, row[x - 1], prev[x], prev[x - 1])
        out.append(v - p)
    return out


def lossless_jpeg(planes, factors, psv=1, pt=0, restart=0, ids=None, jfif=False, adobe=None, interleaved=True,
                  precision=8, size=None):
    """A lossless SOF3 file of component sample planes (uint8 arrays, each
    ceil(H * v / vmax) x ceil(W * h / hmax)); `size` (H, W) defaults to the
    first plane's. The samples are shifted right by the point transform
    pt; dummy samples of partial MCUs code a difference of 0. `restart`
    counts MCUs (a multiple of the MCUs in a row)."""
    planes = [np.asarray(p, np.int64) >> pt for p in planes]
    H, W = size or planes[0].shape
    nc = len(planes)
    ids = ids or list(range(1, nc + 1))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    comps = [dict(h=h, v=v, wib=math.ceil(W * h / hmax), hib=math.ceil(H * v / vmax), t=0) for h, v in factors]
    for c, p in zip(comps, planes):
        assert p.shape == (c["hib"], c["wib"]), (p.shape, c)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    out += _segment(0xC3, bytes([precision]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + bytes([nc])
                    + b"".join(bytes([ids[i], (c["h"] << 4) | c["v"], 0]) for i, c in enumerate(comps)))
    bits, vals = STD_DC_LUMA
    out += _segment(0xC4, bytes([0] + bits + vals))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    codes = _huff_codes(bits, vals)
    for scan in ([list(range(nc))] if interleaved else [[i] for i in range(nc)]):
        out += _segment(0xDA, bytes([len(scan)]) + b"".join(bytes([ids[i], 0]) for i in scan) + bytes([psv, 0, pt]))
        out += _lossless_scan([comps[i] for i in scan], [planes[i] for i in scan], W, H, hmax, vmax, psv, pt,
                              restart, codes)
    return bytes(out + b"\xff\xd9")


def _lossless_scan(comps, planes, W, H, hmax, vmax, psv, pt, restart, codes):
    """One scan: the differences of each iMCU row's rows (a restart before
    any MCU row of an iMCU row makes its first row a first row, as the
    decoder undifferences the iMCU row after reading it), then the MCUs."""
    ns = len(comps)
    if ns == 1:
        mcus_x, mcus_y = comps[0]["wib"], comps[0]["hib"]
    else:
        mcus_x, mcus_y = math.ceil(W / hmax), math.ceil(H / vmax)
    assert restart % mcus_x == 0
    rst_rows = restart // mcus_x
    total = math.ceil(H / vmax)
    diffs = [np.zeros((c["v"] * total, mcus_x * (1 if ns == 1 else c["h"])), np.int64) for c in comps]
    prev = [None] * ns
    mcu_row = 0
    for im in range(total):
        rows_here = 1 if ns > 1 else min(comps[0]["v"], comps[0]["hib"] - im * comps[0]["v"])
        restarted = im == 0 or any(rst_rows and (mcu_row + k) and (mcu_row + k) % rst_rows == 0
                                   for k in range(rows_here))
        mcu_row += rows_here
        if restarted:
            prev = [None] * ns
        for i, (c, p) in enumerate(zip(comps, planes)):
            for r in range(min(c["v"], c["hib"] - im * c["v"])):
                y = im * c["v"] + r
                row = [int(v) for v in p[y]]
                diffs[i][y, :c["wib"]] = _differences(row, (prev[i], row), psv, pt)
                prev[i] = row
    bw = _BitWriter()
    for m in range(mcus_x * mcus_y):
        if restart and m and m % restart == 0:
            bw.flush()
            bw.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
        my, mx = divmod(m, mcus_x)
        for i, c in enumerate(comps):
            bh, bwid = (1, 1) if ns == 1 else (c["v"], c["h"])
            for y in range(bh):
                for x in range(bwid):
                    d = int(diffs[i][my * bh + y, mx * bwid + x])
                    s = abs(d).bit_length()
                    bw.put(*codes[s])
                    if s:
                        bw.put(d if d >= 0 else d + (1 << s) - 1, s)
    bw.flush()
    return bytes(bw.out)


# jutils.c:jpeg_natural_order: the natural index of each zigzag position
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63,
]


# ---------------------------------------------------------------------------
# transcoding a baseline file to arithmetic coding (the same coefficients)
# ---------------------------------------------------------------------------


def _segments(data: bytes):
    """(marker, payload, start) of each segment up to the first SOS, and
    the offset of its entropy-coded data."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, data[pos + 4:pos + 2 + n], pos))
        pos += 2 + n
        if marker == 0xDA:
            return out, pos


def huffman_coefficients(data: bytes):
    """The quantised coefficients of a baseline, interleaved, Huffman-coded
    file without restarts: (segments, components as arith_scans takes
    them, W, H, hmax, vmax, component ids)."""
    segs, pos = _segments(data)
    tables, sof, sos = {}, None, None
    for marker, body, _ in segs:
        if marker == 0xC4:
            i = 0
            while i < len(body):
                bits = list(body[i + 1:i + 17])
                tables[body[i]] = _huff_codes(bits, list(body[i + 17:i + 17 + sum(bits)]))
                i += 17 + sum(bits)
        elif marker in (0xC0, 0xC1):
            sof = body
        elif marker == 0xDA:
            sos = body
        elif marker == 0xDD:
            assert int.from_bytes(body, "big") == 0, "restart intervals are not transcoded"
    H, W, nc = int.from_bytes(sof[1:3], "big"), int.from_bytes(sof[3:5], "big"), sof[5]
    ids = [sof[6 + 3 * i] for i in range(nc)]
    factors = [(sof[7 + 3 * i] >> 4, sof[7 + 3 * i] & 15) for i in range(nc)]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    assert sos[0] == nc, "one interleaved scan"
    sel = {sos[1 + 2 * i]: sos[2 + 2 * i] for i in range(nc)}
    comps = []
    for i, (h, v) in enumerate(factors):
        wib, hib = math.ceil(W * h / (8 * hmax)), math.ceil(H * v / (8 * vmax))
        bw, bh = math.ceil(wib / h) * h, math.ceil(hib / v) * v
        comps.append(dict(h=h, v=v, wib=wib, hib=hib, t=min(i, 1), coef=np.zeros((bh, bw, 8, 8), np.int64),
                          dc={code: s for s, code in tables[sel[ids[i]] >> 4].items()},
                          ac={code: s for s, code in tables[0x10 | (sel[ids[i]] & 15)].items()}))
    # the entropy-coded data as a string of bits, stuffed zeros removed
    end = data.index(b"\xff\xd9", pos)
    raw = data[pos:end].replace(b"\xff\x00", b"\xff")
    bits = bin(int.from_bytes(b"\x01" + raw, "big"))[3:]
    p = 0

    def symbol(table):
        nonlocal p
        for length in range(1, 17):
            s = table.get((int(bits[p:p + length], 2), length))
            if s is not None:
                p += length
                return s
        raise ValueError("no Huffman code")

    def extend(s):
        nonlocal p
        if s == 0:
            return 0
        v = int(bits[p:p + s], 2)
        p += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    pred = [0] * nc
    for blocks in _mcus(comps, W, H, hmax, vmax):
        for i, y, x in blocks:
            c, z = comps[i], np.zeros(64, np.int64)
            pred[i] += extend(symbol(c["dc"]))
            z[0] = pred[i]
            k = 1
            while k < 64:
                rs = symbol(c["ac"])
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    z[k] = extend(s)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
            nat = np.zeros(64, np.int64)
            nat[ZIGZAG] = z
            c["coef"][y, x] = nat.reshape(8, 8)
    return segs, comps, W, H, hmax, vmax, ids


def transcode_arithmetic(data: bytes, progressive=False) -> bytes:
    """A baseline Huffman file rewritten as SOF9 (or SOF10) with the same
    coefficients, quantisation tables and markers: it decodes to the same
    pixels."""
    segs, comps, W, H, hmax, vmax, ids = huffman_coefficients(data)
    out = bytearray(b"\xff\xd8")
    for marker, body, _ in segs:
        if marker in (0xC4, 0xDA):
            continue
        if marker in (0xC0, 0xC1):
            marker = 0xCA if progressive else 0xC9
        out += _segment(marker, body)
    return bytes(out + arith_scans(comps, W, H, hmax, vmax, ids, progressive=progressive) + b"\xff\xd9")
