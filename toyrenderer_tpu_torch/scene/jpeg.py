"""JPEG decoder for material textures: stdlib + numpy, no imaging library.

The reference package decodes JPEG textures through Pillow
(toyrenderer_tpu/scene/textures.py:131-132: `convert("RGBA")`), which
runs libjpeg-turbo with its defaults; this decoder reproduces that
output bit for bit for every JPEG Pillow decodes:

* DCT frames of 8-bit samples, Huffman- or arithmetic-coded, sequential
  (SOF0 baseline, SOF1 extended, SOF9) or progressive (SOF2, SOF10):
  one or several scans, interleaved or not, spectral selection and
  successive approximation in any order the standard allows, EOB runs,
  restart intervals (DRI / RSTn), the arithmetic coder's conditioning
  (DAC), and libjpeg's default Huffman tables where a frame defines
  none;
* lossless frames (SOF3) of 8-bit samples: predictors 1-7 and the point
  transform;
* one component (grey), three (YCbCr, or RGB where the markers say so:
  libjpeg's rule -- a JFIF APP0 means YCbCr, else an Adobe APP14
  marker's transform flag, 0 for RGB, else component ids 'R', 'G', 'B'
  for RGB) or four (CMYK: Adobe transform 0 or no Adobe marker; else
  YCCK), each at any sampling factors 1..4 whose ratios to the largest
  are integral.

The arithmetic is libjpeg-turbo's: the `islow` integer IDCT (13-bit
constants, two passes with their roundings and its range limit table);
the block smoothing of progressive frames whose scans leave the DC term
or the first nine AC terms short of full precision (jdcoefct.c); the
"fancy" triangle upsampling of h2v1, h2v2 and h1v2 ratios, replication
for the others and for lossless frames (jdsample.c); the fixed-point
YCbCr -> RGB and YCCK -> CMYK tables (16 fraction bits, jdcolor.c); then
Pillow's reading of CMYK (inverted, Adobe's convention) and its
CMYK -> RGB.

What Pillow (libjpeg-turbo 3.1) refuses raises JpegError, as does data
that is not a well-formed JPEG: samples of other than 8 bits,
hierarchical frames (SOF5-7, SOF13-15), arithmetic-coded lossless
frames (SOF11), sampling factors outside 1..4 or with non-integral
ratios, an interleaved scan of more than 10 blocks (or samples) per
MCU, two components or more than four.

read_coefficients(raw) is libjpeg's jpeg_read_coefficients: the frame's
quantized DCT blocks; decode_jpeg(raw) finishes them into pixels.
"""

from __future__ import annotations

import itertools
import struct
from dataclasses import dataclass

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# libjpeg's jpeg_natural_order: 16 extra entries catch a run past 63
_ZZ = _ZIGZAG.tolist() + [63] * 16

# Annex K.3 Huffman tables: (counts of codes of length 1..16, symbols);
# libjpeg-turbo installs them in slots 0 and 1 that a frame leaves
# undefined by its first scan (jstdhuff.c)
_DC_BITS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
_DC_VALS = (bytes(range(12)), bytes(range(12)))
_AC_BITS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
            (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# frame markers: (progressive, arithmetic, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, False, True),
        0xC9: (False, True, False), 0xCA: (True, True, False)}
_REFUSED_SOF = {0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical", 0xCD: "hierarchical",
                0xCE: "hierarchical", 0xCF: "hierarchical",
                0xCB: "arithmetic-coded lossless", 0xC8: "reserved (JPG)"}
_MAX_BLOCKS_IN_MCU = 10               # libjpeg's D_MAX_BLOCKS_IN_MCU


class JpegError(ValueError):
    pass


@dataclass
class JpegComponent:
    """One component of a DCT frame as libjpeg holds it after its last
    scan: `blocks` (rows, cols, 64) int32 quantized coefficients in
    natural order on the component's block grid, padded to whole MCUs as
    libjpeg's coefficient arrays are (an interleaved scan fills the
    padding too); the component's own grid is `blocks_high` x
    `blocks_wide`; `quant` (64,) natural order, latched at the first scan
    that names the component (None if none did)."""
    id: int
    h: int
    v: int
    table: int
    quant: np.ndarray | None
    blocks: np.ndarray
    blocks_high: int
    blocks_wide: int


@dataclass
class JpegCoefficients:
    """A DCT frame's coefficients and the markers that decide its
    colours.  `adobe`: the Adobe APP14 marker's transform flag, None
    without one.  `coef_bits` (components, 10): for a progressive frame,
    the point transform of the last scan that sent each of the DC term
    and the first nine AC terms, in zigzag order (-1: none did), which
    decides libjpeg's block smoothing; None for a sequential frame."""
    width: int
    height: int
    components: list[JpegComponent]
    jfif: bool
    adobe: int | None
    coef_bits: np.ndarray | None

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)


# -- entropy-coded segments ---------------------------------------------------

def _huffman_lut(counts, symbols) -> list:
    """A 16-bit lookahead table: entry (length << 8) | symbol for every
    16-bit window starting with a code, 0 where none starts."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols) or code >= (1 << length):
                raise JpegError("bad Huffman table")
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _scan_segments(raw: bytes, pos: int):
    """(the scan's restart segments, unstuffed; the position of the marker
    that ends it)."""
    segs = []
    start = pos
    n = len(raw)
    while True:
        ff = raw.find(b"\xff", pos)
        if ff < 0 or ff + 1 >= n:
            raise JpegError("entropy-coded data runs past the end")
        nxt = raw[ff + 1]
        if nxt == 0x00 or nxt == 0xFF:
            pos = ff + 1 if nxt == 0xFF else ff + 2
            continue
        segs.append(raw[start:ff].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= nxt <= 0xD7:
            start = pos = ff + 2
            continue
        return segs, ff


class _Bits:
    """One restart segment's bits, most significant first, zeros past its
    end (libjpeg feeds zeros once it meets a marker)."""
    __slots__ = ("data", "pos", "buf", "nbits")

    def __init__(self, data: bytes):
        self.data, self.pos, self.buf, self.nbits = data, 0, 0, 0

    def _fill(self):
        data, pos, nbits = self.data, self.pos, self.nbits
        buf = self.buf & ((1 << nbits) - 1)
        n = len(data)
        while nbits < 32:
            buf = (buf << 8) | (data[pos] if pos < n else 0)
            pos += 1
            nbits += 8
        self.buf, self.pos, self.nbits = buf, pos, nbits

    def huff(self, lut) -> int:
        if self.nbits < 16:
            self._fill()
        e = lut[(self.buf >> (self.nbits - 16)) & 0xFFFF]
        if e == 0:
            raise JpegError("bad Huffman code")
        self.nbits -= e >> 8
        return e & 0xFF

    def get(self, n: int) -> int:
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        return (self.buf >> self.nbits) & ((1 << n) - 1)

    def extend(self, s: int) -> int:
        """The s-bit value that follows, sign-extended (HUFF_EXTEND)."""
        v = self.get(s)
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_segment(data: bytes, units, tables, preds):
    """Sequential Huffman: decode `units` ((scan member, its coefficient
    store, the block's index), in stream order) from one restart
    segment's unstuffed bytes; tables[member] = (DC, AC table); preds:
    the DC predictions, zero at the segment's start."""
    buf = 0
    nbits = 0
    pos = 0
    n = len(data)
    zz = _ZZ
    for m, store, row in units:
        dc_lut, ac_lut = tables[m]
        blk = [0] * 64
        # DC
        while nbits < 32:
            buf = ((buf << 8) | (data[pos] if pos < n else 0)) & 0xFFFFFFFFFF
            pos += 1
            nbits += 8
        e = dc_lut[(buf >> (nbits - 16)) & 0xFFFF]
        if e == 0:
            raise JpegError("bad Huffman code")
        nbits -= e >> 8
        s = e & 0xFF
        v = 0
        if s:
            v = (buf >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        preds[m] += v
        blk[0] = preds[m]
        # AC
        k = 1
        while k < 64:
            if nbits < 32:
                while nbits < 32:
                    buf = ((buf << 8) | (data[pos] if pos < n else 0)) \
                        & 0xFFFFFFFFFF
                    pos += 1
                    nbits += 8
            e = ac_lut[(buf >> (nbits - 16)) & 0xFFFF]
            if e == 0:
                raise JpegError("bad Huffman code")
            nbits -= e >> 8
            rs = e & 0xFF
            s = rs & 15
            r = rs >> 4
            if s == 0:
                if r != 15:
                    break                         # end of block
                k += 16
                continue
            k += r
            v = (buf >> (nbits - s)) & ((1 << s) - 1)
            nbits -= s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            blk[zz[k]] = v
            k += 1
        store[row] = blk
    if pos > n + 4:
        raise JpegError("entropy-coded data ends early")


# -- progressive Huffman scans (libjpeg's jdphuff.c) --------------------------

def _dc_first(bits, units, luts, preds, al):
    for m, blk in units:
        s = bits.huff(luts[m])
        if s:
            preds[m] += bits.extend(s)
        blk[0] = preds[m] << al


def _dc_refine(bits, units, p1):
    for _, blk in units:
        if bits.get(1):
            blk[0] |= p1


def _ac_first(bits, units, lut, ss, se, al):
    zz = _ZZ
    eobrun = 0
    for _, blk in units:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            rs = bits.huff(lut)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[zz[k]] = bits.extend(s) << al
            elif r == 15:
                k += 15
            else:
                eobrun = (1 << r) + (bits.get(r) if r else 0) - 1
                break
            k += 1


def _ac_refine(bits, units, lut, ss, se, al):
    zz = _ZZ
    p1, m1 = 1 << al, -1 << al
    eobrun = 0
    for _, blk in units:
        k = ss
        if eobrun == 0:
            while k <= se:
                rs = bits.huff(lut)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if bits.get(1) else m1
                elif r != 15:
                    eobrun = (1 << r) + (bits.get(r) if r else 0)
                    break
                # skip the already-nonzero terms (each takes a correction
                # bit) and r zero terms
                while k <= se:
                    pos = zz[k]
                    c = blk[pos]
                    if c:
                        if bits.get(1) and not c & p1:
                            blk[pos] = c + p1 if c >= 0 else c + m1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    blk[zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                pos = zz[k]
                c = blk[pos]
                if c and bits.get(1) and not c & p1:
                    blk[pos] = c + p1 if c >= 0 else c + m1
                k += 1
            eobrun -= 1


# -- arithmetic coding (T.81 Annex D; libjpeg's jaricom.c / jdarith.c) --------

# Table D.2: (Qe, next index after an LPS, after an MPS, switch MPS); the
# last row is libjpeg's fixed probability-1/2 bin
_QM = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
QM_QE = tuple(q for q, _, _, _ in _QM)
# libjpeg's packing: the next state after an LPS with the switch in bit 7
QM_NEXT_LPS = tuple(nl | sw << 7 for _, nl, _, sw in _QM)
QM_NEXT_MPS = tuple(nm for _, _, nm, _ in _QM)
FIXED_BIN = 113
DC_BINS, AC_BINS = 64, 256


class _Arith:
    """The QM decoder of one restart segment (libjpeg's arith_decode):
    decode(bins, i) is the next binary decision under the adaptive
    state bins[i] (index | MPS << 7); zeros past the data's end."""
    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def decode(self, st, i) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.data[pos] if pos < len(self.data)
                                else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000             # two initial bytes read
            a <<= 1
        sv = st[i]
        q = sv & 0x7F
        qe = QM_QE[q]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:                         # conditional exchange: MPS
                st[i] = (sv & 0x80) ^ QM_NEXT_MPS[q]
            else:
                st[i] = (sv & 0x80) ^ QM_NEXT_LPS[q]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:                         # conditional exchange: LPS
                st[i] = (sv & 0x80) ^ QM_NEXT_LPS[q]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ QM_NEXT_MPS[q]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_magnitude(dec, st, i, m, x_bin):
    """Figures F.23-F.24 after the first magnitude decision m (0 or 1)
    at bin i: |v| - 1, X bins from x_bin (None: the DC's, from 20)."""
    if m:
        if x_bin is None:
            i = 20
        else:
            if not dec(st, i):
                return 1
            m = 2
            i = x_bin
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise JpegError("arithmetic magnitude overflow")
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    return v


def _arith_dc(dec, st, m, ctx, bounds) -> int:
    """One DC difference (Figure F.19) for scan member m; updates its
    conditioning context ctx[m]; bounds: the table's (L, U)."""
    s0 = ctx[m]
    if not dec(st, s0):
        ctx[m] = 0
        return 0
    sign = dec(st, s0 + 1)
    i = s0 + 2 + sign
    first = dec(st, i)
    mag = _arith_magnitude(dec, st, i, first, None)
    top = 0
    if mag:
        top = 1 << (mag.bit_length() - 1)
    lo, hi = bounds
    if top < (1 << lo) >> 1:
        ctx[m] = 0
    elif top > (1 << hi) >> 1:
        ctx[m] = 12 + sign * 4
    else:
        ctx[m] = 4 + sign * 4
    return -(mag + 1) if sign else mag + 1


def _arith_ac(dec, st, fixed, blk, k, se, kx, al):
    """AC terms k..se of one block (Figure F.20; the progressive first
    scan's and, from k = 1 with al = 0, the sequential one's)."""
    zz = _ZZ
    while k <= se:
        i = 3 * (k - 1)
        if dec(st, i):
            break                              # end of block
        while not dec(st, i + 1):
            i += 3
            k += 1
            if k > se:
                raise JpegError("arithmetic spectral overflow")
        sign = dec(fixed, 0)
        i += 2
        v = _arith_magnitude(dec, st, i, dec(st, i),
                             189 if k <= kx else 217) + 1
        blk[zz[k]] = (-v if sign else v) << al
        k += 1


def _arith_ac_refine(dec, st, fixed, blk, ss, se, al):
    zz = _ZZ
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not blk[zz[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and dec(st, i):
            break                              # end of block
        while True:
            pos = zz[k]
            c = blk[pos]
            if c:
                if dec(st, i + 2):
                    blk[pos] = c + m1 if c < 0 else c + p1
                break
            if dec(st, i + 1):
                blk[pos] = m1 if dec(fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                raise JpegError("arithmetic spectral overflow")
        k += 1


# -- lossless (libjpeg-turbo's jdlhuff.c, jdpred.c) ---------------------------

def _lossless_diffs(bits, units, luts):
    for m, plane, pos in units:
        s = bits.huff(luts[m])
        if s == 16:
            plane[pos] = 32768
        elif s:
            plane[pos] = bits.extend(s)


def _undifference(diff: np.ndarray, width: int, height: int, pred: int,
                  pt: int, first_rows) -> np.ndarray:
    """Samples from one component's differences (rows, padded cols):
    a row in first_rows (the scan's and each restart's first) predicts
    from its left neighbour, its first sample from 2^(7 - pt); any other
    row's first sample from the one above, the rest by predictor
    `pred` (1-7)."""
    out = np.zeros((height, width), np.int64)
    prev = None
    for y in range(height):
        d = diff[y].tolist()
        row = [0] * width
        if y in first_rows or prev is None:
            ra = (d[0] + (1 << (7 - pt))) & 0xFFFF
            row[0] = ra
            for x in range(1, width):
                ra = (d[x] + ra) & 0xFFFF
                row[x] = ra
        else:
            rb = prev[0]
            ra = (d[0] + rb) & 0xFFFF
            row[0] = ra
            for x in range(1, width):
                rc, rb = rb, prev[x]
                if pred == 1:
                    p = ra
                elif pred == 2:
                    p = rb
                elif pred == 3:
                    p = rc
                elif pred == 4:
                    p = ra + rb - rc
                elif pred == 5:
                    p = ra + ((rb - rc) >> 1)
                elif pred == 6:
                    p = rb + ((ra - rc) >> 1)
                else:
                    p = (ra + rb) >> 1
                ra = (d[x] + p) & 0xFFFF
                row[x] = ra
        out[y] = row
        prev = row
    return (out << pt) & 0xFF


# -- markers and scans --------------------------------------------------------

def _segments(raw: bytes):
    """Yield (marker, position after its segment, payload) of each marker
    segment (after SOS, the caller sends the position where its scan
    ends); EOI or the end of the data ends it (libjpeg decodes a file
    without EOI, with a warning)."""
    pos = 2
    n = len(raw)
    while pos < n:
        if raw[pos] != 0xFF:
            raise JpegError(f"marker expected at {pos}")
        while pos < n and raw[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = raw[pos]
        pos += 1
        if m == 0xD9:
            return
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > n:
            break
        length = struct.unpack(">H", raw[pos:pos + 2])[0]
        if length < 2 or pos + length > n:
            raise JpegError("truncated marker segment")
        payload = raw[pos + 2:pos + length]
        pos += length
        new_pos = yield m, pos, payload
        if new_pos is not None:
            pos = new_pos


class _Frame:
    """The frame header and the decoding state of its components."""

    def __init__(self, marker: int, p: bytes):
        self.progressive, self.arithmetic, self.lossless = _SOF[marker]
        if len(p) < 6:
            raise JpegError("truncated frame header")
        prec, h, w, nc = struct.unpack(">BHHB", p[:6])
        if prec != 8:
            raise JpegError(f"{prec}-bit samples (Pillow reads 8-bit JPEG "
                            "only)")
        if nc not in (1, 3, 4):
            raise JpegError(f"{nc} components (Pillow reads 1, 3 or 4)")
        if h == 0 or w == 0 or len(p) < 6 + 3 * nc:
            raise JpegError(f"bad frame header ({nc} components of "
                            f"{w}x{h})")
        self.width, self.height = w, h
        self.comps = []
        for i in range(nc):
            cid, hv, tq = p[6 + 3 * i:9 + 3 * i]
            c = dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq, quant=None)
            if not (1 <= c['h'] <= 4 and 1 <= c['v'] <= 4):
                raise JpegError(f"sampling factors {c['h']}x{c['v']}")
            self.comps.append(c)
        self.hmax = max(c['h'] for c in self.comps)
        self.vmax = max(c['v'] for c in self.comps)
        for c in self.comps:
            if self.hmax % c['h'] or self.vmax % c['v']:
                raise JpegError("non-integral sampling ratio "
                                f"{self.hmax}/{c['h']} x "
                                f"{self.vmax}/{c['v']}")
        unit = 1 if self.lossless else 8      # samples per block side
        self.mcux = -(-w // (unit * self.hmax))
        self.mcuy = -(-h // (unit * self.vmax))
        for c in self.comps:
            c['dw'] = -(-w * c['h'] // self.hmax)
            c['dh'] = -(-h * c['v'] // self.vmax)
            c['wb'], c['hb'] = -(-c['dw'] // unit), -(-c['dh'] // unit)
            c['bw'], c['bh'] = self.mcux * c['h'], self.mcuy * c['v']
            if self.lossless:
                c['diff'] = [0] * (c['bh'] * c['bw'])
                c['plane'] = None
            else:
                c['store'] = [[0] * 64 for _ in range(c['bh'] * c['bw'])]
        self.coef_bits = np.full((nc, 64), -1, np.int64)
        self.scans = 0

    def units(self, members) -> list:
        """The scan's MCUs, each the list of (scan member, component
        index, block index) in stream order: a single component's scan
        walks its own block grid, an interleaved one the MCU grid."""
        if len(members) == 1:
            c = self.comps[members[0]]
            return [[(0, members[0], r * c['bw'] + col)]
                    for r in range(c['hb']) for col in range(c['wb'])]
        mcus = []
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                mcu = []
                for m, ci in enumerate(members):
                    c = self.comps[ci]
                    for by in range(c['v']):
                        for bx in range(c['h']):
                            mcu.append((m, ci, (my * c['v'] + by) * c['bw']
                                        + mx * c['h'] + bx))
                mcus.append(mcu)
        return mcus


def _read(raw: bytes) -> _Frame:
    """Walk the markers and decode every scan into the frame's
    coefficient stores (or, lossless, its sample planes)."""
    if raw[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG")
    quant = {}
    dc_tabs, ac_tabs = {}, {}
    dac = {}
    frame = None
    restart = 0
    jfif = False
    adobe = None
    gen = _segments(raw)
    seg = next(gen, None)
    while seg is not None:
        m, end, p = seg
        resume = None
        if m == 0xE0 and len(p) >= 14 and p[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and len(p) >= 12 and p[:5] == b"Adobe":
            adobe = p[11]
        elif m == 0xDB:
            q = 0
            while q < len(p):
                prec, tid = p[q] >> 4, p[q] & 15
                size = 128 if prec else 64
                vals = np.frombuffer(p[q + 1:q + 1 + size],
                                     ">u2" if prec else np.uint8)
                if vals.size != 64 or tid > 3:
                    raise JpegError("bad DQT")
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG] = vals
                quant[tid] = nat
                q += 1 + size
        elif m == 0xC4:
            q = 0
            while q < len(p):
                cls, tid = p[q] >> 4, p[q] & 15
                counts = list(p[q + 1:q + 17])
                total = sum(counts)
                syms = list(p[q + 17:q + 17 + total])
                if cls > 1 or tid > 3 or len(syms) != total:
                    raise JpegError("bad DHT")
                (ac_tabs if cls else dc_tabs)[tid] = _huffman_lut(counts,
                                                                  syms)
                q += 17 + total
        elif m == 0xCC:
            for q in range(0, len(p) - 1, 2):
                index, val = p[q], p[q + 1]
                if index >= 32 or (index < 16 and (val & 15) > val >> 4):
                    raise JpegError("bad DAC")
                dac[index] = val
        elif m in _REFUSED_SOF:
            raise JpegError(f"{_REFUSED_SOF[m]} frame (SOF{m - 0xC0}): "
                            "libjpeg-turbo does not decode it")
        elif m in _SOF:
            if frame is not None:
                raise JpegError("a second frame header")
            frame = _Frame(m, p)
        elif m == 0xDD:
            if len(p) < 2:
                raise JpegError("bad DRI")
            restart = struct.unpack(">H", p[:2])[0]
        elif m in (0xDE, 0xDF) or 0xF0 <= m <= 0xFD:
            raise JpegError(f"unsupported marker 0x{m:02X}")
        elif m == 0xDA:
            if frame is None:
                raise JpegError("scan before the frame header")
            if frame.scans == 0 and not frame.arithmetic:
                for tid in (0, 1):              # jstdhuff.c
                    if tid not in dc_tabs:
                        dc_tabs[tid] = _huffman_lut(_DC_BITS[tid],
                                                    _DC_VALS[tid])
                    if tid not in ac_tabs:
                        ac_tabs[tid] = _huffman_lut(_AC_BITS[tid],
                                                    _AC_VALS[tid])
            resume = _scan(raw, end, p, frame, quant, dc_tabs, ac_tabs,
                           dac, restart)
            frame.scans += 1
        try:
            seg = gen.send(resume) if resume is not None else next(gen)
        except StopIteration:
            seg = None
    if frame is None:
        raise JpegError("no frame")
    if frame.scans == 0:
        raise JpegError("no scan")
    frame.jfif, frame.adobe = jfif, adobe
    return frame


def _scan(raw, end, p, frame, quant, dc_tabs, ac_tabs, dac,
          restart) -> int:
    """Decode one scan (its header `p`, its data at `end`) into the
    frame; returns the position of the marker after it."""
    ns = p[0] if p else 0
    if not 1 <= ns <= 4 or len(p) < 4 + 2 * ns:
        raise JpegError("bad scan header")
    by_id = {c['id']: i for i, c in enumerate(frame.comps)}
    members, td, ta = [], [], []
    for k in range(ns):
        cid, tabs = p[1 + 2 * k], p[2 + 2 * k]
        if cid not in by_id or by_id[cid] in members:
            raise JpegError(f"scan names component {cid} wrongly")
        members.append(by_id[cid])
        td.append(tabs >> 4)
        ta.append(tabs & 15)
    ss, se, ahal = p[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    comps = [frame.comps[ci] for ci in members]
    if ns > 1 and sum(c['h'] * c['v'] for c in comps) > _MAX_BLOCKS_IN_MCU:
        raise JpegError("more than 10 blocks in an MCU")
    mcus = frame.units(members)
    if frame.lossless:
        if not 1 <= ss <= 7 or se or ah or al >= 8:
            raise JpegError(f"bad lossless scan (Ss={ss} Se={se} "
                            f"Ah={ah} Al={al})")
        if restart and restart % (frame.mcux if ns > 1
                                  else comps[0]['wb']):
            raise JpegError("lossless restart interval not a whole number "
                            "of MCU rows")
    else:
        for c in comps:                         # latch_quant_tables
            if c['quant'] is None:
                if c['tq'] not in quant:
                    raise JpegError("undefined quantisation table")
                c['quant'] = quant[c['tq']].copy()
    if frame.progressive:
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        if bad or (ah and al != ah - 1) or al > 13:
            raise JpegError(f"bad progression (Ss={ss} Se={se} Ah={ah} "
                            f"Al={al})")
        for ci in members:
            frame.coef_bits[ci, ss:se + 1] = al
    # the tables the scan's coding reads
    need_dc = not frame.progressive or (ss == 0 and ah == 0)
    need_ac = not frame.lossless and (not frame.progressive or ss > 0)
    if not frame.arithmetic:
        for k in range(ns):
            if (need_dc and td[k] not in dc_tabs) or (
                    need_ac and ta[k] not in ac_tabs):
                raise JpegError("scan uses an undefined Huffman table")
    segs, marker_pos = _scan_segments(raw, end)
    per = restart if restart else len(mcus)
    for s, first in enumerate(range(0, len(mcus), per)):
        if s >= len(segs):
            raise JpegError("missing restart segment")
        chunk = mcus[first:first + per]
        if frame.lossless:
            _lossless_segment(frame, segs[s], chunk, members, td, dc_tabs)
        elif frame.arithmetic:
            _arith_segment(frame, segs[s], chunk, members, td, ta, dac,
                           ss, se, ah, al)
        else:
            _huffman_segment(frame, segs[s], chunk, members, td, ta,
                             dc_tabs, ac_tabs, ss, se, ah, al)
    if frame.lossless:
        for m, ci in enumerate(members):
            c = frame.comps[ci]
            if restart:
                rows = restart // (frame.mcux if ns > 1 else c['wb'])
                step = rows * (c['v'] if ns > 1 else 1)
                first_rows = set(range(0, c['dh'], step))
            else:
                first_rows = {0}
            diff = np.array(c['diff'], np.int64).reshape(c['bh'], c['bw'])
            c['plane'] = _undifference(diff, c['dw'], c['dh'], ss, al,
                                       first_rows).astype(np.uint8)
    return marker_pos


def _huffman_segment(frame, data, mcus, members, td, ta, dc_tabs, ac_tabs,
                     ss, se, ah, al):
    stores = [frame.comps[ci]['store'] for ci in members]
    if not frame.progressive:
        units = [(m, stores[m], idx) for mcu in mcus for m, _, idx in mcu]
        _decode_segment(data, units, [(dc_tabs[td[m]], ac_tabs[ta[m]])
                                      for m in range(len(members))],
                        [0] * len(members))
        return
    units = [(m, stores[m][idx]) for mcu in mcus for m, _, idx in mcu]
    bits = _Bits(data)
    if ss == 0 and ah == 0:
        _dc_first(bits, units, [dc_tabs[t] for t in td], [0] * len(members),
                  al)
    elif ss == 0:
        _dc_refine(bits, units, 1 << al)
    elif ah == 0:
        _ac_first(bits, units, ac_tabs[ta[0]], ss, se, al)
    else:
        _ac_refine(bits, units, ac_tabs[ta[0]], ss, se, al)


def _arith_segment(frame, data, mcus, members, td, ta, dac, ss, se, ah, al):
    """One restart segment of an arithmetic-coded scan: the statistics
    bins, DC predictions and contexts start afresh in each."""
    dec = _Arith(data).decode
    fixed = bytearray([FIXED_BIN])
    dc_st = {t: bytearray(DC_BINS) for t in td}
    ac_st = {t: bytearray(AC_BINS) for t in ta}
    dcs = [dc_st[t] for t in td]
    acs = [ac_st[t] for t in ta]
    bounds = []
    for t in td:
        v = dac.get(t, 0x10)                    # default L = 0, U = 1
        bounds.append((v & 15, v >> 4))
    kxs = [dac.get(16 + t, 5) for t in ta]
    preds = [0] * len(members)
    ctx = [0] * len(members)
    stores = [frame.comps[ci]['store'] for ci in members]
    for mcu in mcus:
        for m, _, idx in mcu:
            blk = stores[m][idx]
            if not frame.progressive:
                preds[m] += _arith_dc(dec, dcs[m], m, ctx, bounds[m])
                blk[0] = preds[m]
                _arith_ac(dec, acs[m], fixed, blk, 1, 63, kxs[m], 0)
            elif ss == 0 and ah == 0:
                preds[m] += _arith_dc(dec, dcs[m], m, ctx, bounds[m])
                blk[0] = preds[m] << al
            elif ss == 0:
                if dec(fixed, 0):
                    blk[0] |= 1 << al
            elif ah == 0:
                _arith_ac(dec, acs[m], fixed, blk, ss, se, kxs[m], al)
            else:
                _arith_ac_refine(dec, acs[m], fixed, blk, ss, se, al)


def _lossless_segment(frame, data, mcus, members, td, dc_tabs):
    if frame.arithmetic:
        raise JpegError("arithmetic-coded lossless frame")
    diffs = [frame.comps[ci]['diff'] for ci in members]
    _lossless_diffs(_Bits(data), [(m, diffs[m], idx) for mcu in mcus
                                  for m, _, idx in mcu],
                    [dc_tabs[t] for t in td])


# -- IDCT (libjpeg-turbo jidctint.c, jpeg_idct_islow) ------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c, shift):
    """The 8-point islow butterfly over axis -1 of c (..., 8) i64, each
    output descaled by `shift`: the pass's outputs 0..7."""
    z2, z3 = c[..., 2], c[..., 6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 + z3 * -_F1847
    tmp3 = z1 + z2 * _F0765
    z2, z3 = c[..., 0], c[..., 4]
    tmp0 = (z2 + z3) << _CONST_BITS
    tmp1 = (z2 - z3) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0 = tmp0 * _F0298
    tmp1 = tmp1 * _F2053
    tmp2 = tmp2 * _F3072
    tmp3 = tmp3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    tmp0 = tmp0 + (z1 + z3)
    tmp1 = tmp1 + (z2 + z4)
    tmp2 = tmp2 + (z2 + z3)
    tmp3 = tmp3 + (z1 + z4)
    return np.stack([_descale(tmp10 + tmp3, shift),
                     _descale(tmp11 + tmp2, shift),
                     _descale(tmp12 + tmp1, shift),
                     _descale(tmp13 + tmp0, shift),
                     _descale(tmp13 - tmp0, shift),
                     _descale(tmp12 - tmp1, shift),
                     _descale(tmp11 - tmp2, shift),
                     _descale(tmp10 - tmp3, shift)], -1)


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (x & 1023)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE_LIMIT = _range_limit_table()


def idct_islow(coef, quant) -> np.ndarray:
    """(N, 64) natural-order coefficients x (64,) quantisers -> (N, 8, 8)
    u8 samples, as libjpeg-turbo's jpeg_idct_islow computes them (its
    all-zero shortcuts give the same values as the full butterflies)."""
    c = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (the vertical frequencies, axis 1)
    ws = _idct_1d(c.transpose(0, 2, 1), _CONST_BITS - _PASS1_BITS)
    ws = ws.transpose(0, 2, 1)                      # ws[n, row, col]
    # pass 2: rows
    out = _idct_1d(ws, _CONST_BITS + _PASS1_BITS + 3)
    return _RANGE_LIMIT[out & 1023]


# -- block smoothing (libjpeg-turbo jdcoefct.c, decompress_smooth_data) -------

def _kernel(rows) -> np.ndarray:
    return np.array(rows, np.int64)


# The estimates' weights over the 5x5 neighbourhood of DC terms (rows:
# two block rows above .. two below; columns: two blocks left .. two
# right), by the zigzag index of the term they estimate (1..9), with the
# DC interpolation (no AC term of the component known yet) and without
_SMOOTH_DC = {
    1: _kernel([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3],
                [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
                [-1, -1, 0, 1, 1]]),
    3: _kernel([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
                [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]]),
    4: _kernel([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
                [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
    6: _kernel([[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
                [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    7: _kernel([[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
                [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]]),
}
_SMOOTH_DC[2] = _SMOOTH_DC[1].T.copy()
_SMOOTH_DC[5] = _SMOOTH_DC[3].T.copy()
_SMOOTH_DC[8] = _SMOOTH_DC[7].T.copy()
_SMOOTH_DC[9] = _SMOOTH_DC[6].T.copy()
_SMOOTH_AC = {
    1: _kernel([[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5]),
    3: _kernel([[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
                [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]]),
    4: _kernel([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0],
                [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]),
}
_SMOOTH_AC[2] = _SMOOTH_AC[1].T.copy()
_SMOOTH_AC[5] = _SMOOTH_AC[3].T.copy()
_SMOOTH_DC0 = _kernel([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                       [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                       [-2, -6, -8, -6, -2]])


def _smoothing_on(co: JpegCoefficients) -> bool:
    """libjpeg's smoothing_ok: a progressive frame whose every component
    has a latched table with nonzero DC and first nine AC quantisers
    and some DC data, and some component a term of the first nine AC
    terms short of full precision."""
    if co.coef_bits is None:
        return False
    for c in co.components:
        if c.quant is None or not np.all(c.quant[_ZIGZAG[:10]]):
            return False
    bits = co.coef_bits
    return bool(np.all(bits[:, 0] >= 0) and np.any(bits[:, 1:10] != 0))


def _smooth(c: JpegComponent, bits, imcu_rows: int) -> np.ndarray:
    """The component's own-grid blocks (hb, wb, 64) with libjpeg-turbo's
    estimates in the first nine AC terms (and, before any AC data, the
    DC term) from the DC terms of the 5x5 blocks around each; bits: the
    component's coef_bits (10,)."""
    hb, wb, v = c.blocks_high, c.blocks_wide, c.v
    blocks = c.blocks.astype(np.int64)
    dc = blocks[:, :, 0]
    # the block rows libjpeg reads above and below each row: in the last
    # iMCU row it numbers rows by that row's own block count, so near
    # the bottom it may take a padding row or repeat one
    rows = np.zeros((hb, 5), np.int64)
    for r in range(imcu_rows):
        b = v if r < imcu_rows - 1 else (hb % v or v)
        for br in range(b):
            y = r * v + br
            ibr, n = r * b + br, b * imcu_rows
            prev = y - 1 if ibr > 0 else y
            nxt = y + 1 if ibr < n - 1 else y
            rows[y] = (y - 2 if ibr > 1 else prev, prev, y, nxt,
                       y + 2 if ibr < n - 2 else nxt)
    cols = np.clip(np.arange(wb)[:, None] + np.arange(-2, 3), 0, wb - 1)
    nb = dc[rows[:, None, :, None], cols[None, :, None, :]]  # (hb,wb,5,5)
    out = blocks[:hb, :wb].copy()
    change_dc = bool(np.all(bits[1:10] == -1))
    kernels = _SMOOTH_DC if change_dc else _SMOOTH_AC
    q = c.quant.astype(np.int64)
    q00 = q[0]
    for zi, w in kernels.items():
        al = int(bits[zi])
        pos = _ZIGZAG[zi]
        if al == 0:
            continue
        num = q00 * np.einsum('abij,ij->ab', nb, w)
        qk = q[pos]
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num < 0, -pred, pred)
        here = out[:, :, pos]
        out[:, :, pos] = np.where(here == 0, pred, here)
    if change_dc:
        num = q00 * np.einsum('abij,ij->ab', nb, _SMOOTH_DC0)
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        out[:, :, 0] = np.where(num < 0, -pred, pred)
    return out


# -- upsampling and colour ----------------------------------------------------

def _edge(x, axis, side):
    """x shifted by one along axis, the edge sample repeated (side -1: each
    sample's predecessor, +1: its successor)."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + side, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _upsample(plane: np.ndarray, fx: int, fy: int,
              fancy: bool = True) -> np.ndarray:
    """A component plane upsampled by (fx, fy) as libjpeg-turbo's
    jdsample.c does it: "fancy" triangle filters for (2, 1) and (2, 2)
    on planes wider than 2 samples and for (1, 2), the edge samples
    repeated; replication for every other ratio and without `fancy`
    (lossless frames)."""
    if (fx, fy) == (1, 1):
        return plane
    p = plane.astype(np.int32)
    wide = p.shape[1] > 2
    if fancy and (fx, fy) == (2, 1) and wide:
        three = 3 * p
        even = (three + _edge(p, 1, -1) + 1) >> 2
        odd = (three + _edge(p, 1, 1) + 2) >> 2
        return np.stack([even, odd], 2).reshape(p.shape[0], -1).astype(
            np.uint8)
    if fancy and (fx, fy) == (1, 2):
        three = 3 * p
        above = (three + _edge(p, 0, -1) + 1) >> 2
        below = (three + _edge(p, 0, 1) + 2) >> 2
        return np.stack([above, below], 1).reshape(-1, p.shape[1]).astype(
            np.uint8)
    if fancy and (fx, fy) == (2, 2) and wide:
        rows = []
        for side in (-1, 1):                     # the output row above, below
            cs = 3 * p + _edge(p, 0, side)       # column sums
            even = (3 * cs + _edge(cs, 1, -1) + 8) >> 4
            odd = (3 * cs + _edge(cs, 1, 1) + 7) >> 4
            rows.append(np.stack([even, odd], 2).reshape(p.shape[0], -1))
        return np.stack(rows, 1).reshape(2 * p.shape[0], -1).astype(np.uint8)
    return np.repeat(np.repeat(plane, fy, 0), fx, 1)


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + _ONE_HALF) >> _SCALEBITS
_CB_B = (_fix(1.77200) * _X + _ONE_HALF) >> _SCALEBITS
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + _ONE_HALF


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg-turbo's ycc_rgb_convert: (H, W) u8 planes -> (H, W, 3)."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _colour_space(n: int, ids, jfif: bool, adobe, lossless: bool) -> str:
    """libjpeg-turbo's jpeg_color_space (jdapimin.c): 'grey', 'ycc',
    'rgb', 'cmyk' or 'ycck'.  Without a JFIF or Adobe marker, three
    components are RGB if their ids are 'R', 'G', 'B' -- or, in a
    lossless frame, any ids -- else YCbCr."""
    if n == 1:
        return 'grey'
    if n == 4:
        return 'cmyk' if adobe is None or adobe == 0 else 'ycck'
    if jfif:
        return 'ycc'
    if adobe is not None:
        return 'rgb' if adobe == 0 else 'ycc'
    return 'rgb' if lossless or ids == [82, 71, 66] else 'ycc'


def _colour(planes, space: str) -> np.ndarray:
    """Component planes in colour space `space` -> (H, W, 4) u8 RGBA as
    libjpeg's conversion and Pillow's convert("RGBA") make them."""
    h, w = planes[0].shape
    alpha = np.full((h, w, 1), 255, np.uint8)
    if space == 'grey':
        return np.concatenate([planes[0][..., None]] * 3 + [alpha], -1)
    if space in ('rgb', 'ycc'):
        out = np.stack(planes, -1) if space == 'rgb' else ycc_to_rgb(*planes)
        return np.concatenate([out, alpha], -1)
    # four components: libjpeg's CMYK (YCCK converted: ycck_cmyk_convert),
    # which Pillow reads inverted ("CMYK;I") and converts to RGB
    if space == 'cmyk':
        cmy = 255 - np.stack(planes[:3], -1).astype(np.int64)
    else:
        cmy = ycc_to_rgb(*planes[:3]).astype(np.int64)
    nk = planes[3].astype(np.int64)[..., None]
    out = np.clip(nk - _muldiv255(cmy, nk), 0, 255).astype(np.uint8)
    return np.concatenate([out, alpha], -1)


# -- the frame's pixels -------------------------------------------------------

def _coefficients(frame: _Frame) -> JpegCoefficients:
    comps = []
    for c in frame.comps:
        blocks = np.fromiter(itertools.chain.from_iterable(c['store']),
                             np.int32, c['bh'] * c['bw'] * 64).reshape(
            c['bh'], c['bw'], 64)
        comps.append(JpegComponent(
            id=c['id'], h=c['h'], v=c['v'], table=c['tq'], quant=c['quant'],
            blocks=blocks, blocks_high=c['hb'], blocks_wide=c['wb']))
    return JpegCoefficients(
        width=frame.width, height=frame.height, components=comps,
        jfif=frame.jfif, adobe=frame.adobe,
        coef_bits=frame.coef_bits[:, :10].copy() if frame.progressive
        else None)


def read_coefficients(raw: bytes) -> JpegCoefficients:
    """JPEG bytes -> the DCT frame's quantized coefficients, as libjpeg's
    jpeg_read_coefficients reads them (a lossless frame has none:
    JpegError)."""
    frame = _read(raw)
    if frame.lossless:
        raise JpegError("a lossless frame has no DCT coefficients")
    return _coefficients(frame)


def _finish(co: JpegCoefficients) -> np.ndarray:
    """Smooth (where libjpeg would), dequantise, inverse-transform,
    upsample and convert to RGBA."""
    w, h = co.width, co.height
    hmax, vmax = co.hmax, co.vmax
    smooth = _smoothing_on(co)
    imcu_rows = -(-h // (8 * vmax))
    planes = []
    for ci, c in enumerate(co.components):
        quant = c.quant if c.quant is not None else np.zeros(64, np.int64)
        if smooth:
            blocks = _smooth(c, co.coef_bits[ci], imcu_rows)
        else:
            blocks = c.blocks[:c.blocks_high, :c.blocks_wide]
        hb, wb = blocks.shape[:2]
        samples = idct_islow(blocks.reshape(-1, 64), quant)
        plane = samples.reshape(hb, wb, 8, 8).transpose(0, 2, 1, 3).reshape(
            hb * 8, wb * 8)
        plane = plane[:-(-h * c.v // vmax), :-(-w * c.h // hmax)]
        planes.append(_upsample(plane, hmax // c.h, vmax // c.v)[:h, :w])
    return _colour(planes, _colour_space(len(planes),
                                         [c.id for c in co.components],
                                         co.jfif, co.adobe, False))


def decode_jpeg(raw: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) u8 RGBA (see the module docstring)."""
    frame = _read(raw)
    if not frame.lossless:
        return _finish(_coefficients(frame))
    space = _colour_space(len(frame.comps), [c['id'] for c in frame.comps],
                          frame.jfif, frame.adobe, True)
    if space in ('ycc', 'ycck'):
        raise JpegError(f"lossless frame in {space.upper()}: libjpeg-turbo "
                        "converts no colour in lossless mode")
    if any(c['plane'] is None for c in frame.comps):
        raise JpegError("a lossless frame's component in no scan")
    planes = [_upsample(c['plane'], frame.hmax // c['h'],
                        frame.vmax // c['v'], fancy=False)
              [:frame.height, :frame.width] for c in frame.comps]
    return _colour(planes, space)
