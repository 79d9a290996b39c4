"""JPEG streams of every kind the port's decoder reads, written from a
coefficient set (toyrenderer_tpu_torch.scene.jpeg.read_coefficients) or
from samples: the test corpus of tests/test_torch_jpeg_modes.py and of
chip_smoke.py's JPEG phase.  numpy and the port only -- no imaging
library -- so it runs where Pillow is absent.

Re-encoding the same quantized coefficients losslessly, as jpegtran
does, gives streams whose decode must equal the baseline decode of those
coefficients bit for bit (libjpeg's block smoothing aside, which only an
incomplete progression triggers):

* sequential Huffman (SOF0 / SOF1) with optimal tables, interleaved
  where an MCU holds at most 10 blocks, else one scan per component;
* progressive Huffman (SOF2) under libjpeg's default script
  (jcparam.c, jpeg_simple_progression), spectral selection alone, or a
  script that stops early (libjpeg then smooths the blocks);
* sequential and progressive arithmetic coding (SOF9, SOF10), with
  optional DAC conditioning;
* restart intervals (DRI) in every mode;
* any sampling factors, component ids, JFIF / Adobe markers (Adobe
  transform 0, 1 or 2), which the coefficient set carries;
* lossless (SOF3) from samples: predictors 1-7, the point transform.

    from jpeg_streams import coefficients, write, write_lossless
"""

from __future__ import annotations

import struct

import numpy as np

from toyrenderer_tpu_torch.scene.jpeg import (
    AC_BINS, DC_BINS, FIXED_BIN, QM_NEXT_LPS, QM_NEXT_MPS, QM_QE, _ZIGZAG,
    _ZZ, JpegCoefficients, JpegComponent)
from toyrenderer_tpu_torch.scene.jpeg_encode import quant_tables

__all__ = ["coefficients", "planes", "write", "write_lossless", "SCRIPTS",
           "script"]


# -- coefficient sets from samples --------------------------------------------

def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m[0] *= np.sqrt(1 / 8)
    m[1:] *= np.sqrt(2 / 8)
    return m


_DCT = _dct_matrix()


def planes(img: np.ndarray, sampling) -> list[np.ndarray]:
    """(H, W, nc) u8 component samples -> each component's plane at its
    sampling factors (h, v): the box mean over the (hmax/h) x (vmax/v)
    samples it covers, the image's edge repeated."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    hgt, wid, _ = img.shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    out = []
    for ci, (h, v) in enumerate(sampling):
        fx, fy = hmax // h, vmax // v
        dw, dh = -(-wid * h // hmax), -(-hgt * v // vmax)
        p = np.pad(img[..., ci].astype(np.float64),
                   ((0, dh * fy - hgt), (0, dw * fx - wid)), mode='edge')
        p = p.reshape(dh, fy, dw, fx).mean(axis=(1, 3))
        out.append(np.clip(np.rint(p), 0, 255).astype(np.uint8))
    return out


def coefficients(img: np.ndarray, sampling, quality: int = 75, ids=None,
                 jfif: bool = True, adobe: int | None = None
                 ) -> JpegCoefficients:
    """A coefficient set of the samples img (H, W, nc) u8, taken as the
    components' own values (no colour transform), at `sampling` [(h, v)
    per component]: each plane edge-padded to whole MCUs, a float DCT,
    quantised by the IJG tables at `quality` (the luminance table for
    the first component, the chrominance table for the others)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    hgt, wid, nc = img.shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    qy, qc = quant_tables(quality)
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    comps = []
    for ci, ((h, v), plane) in enumerate(zip(sampling, planes(img,
                                                              sampling))):
        bh, bw = mcuy * v, mcux * h
        dh, dw = plane.shape
        p = np.pad(plane.astype(np.float64) - 128.0,
                   ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode='edge')
        b = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = (_DCT @ b @ _DCT.T).reshape(bh, bw, 64)
        q = np.zeros(64, np.int64)
        q[_ZIGZAG] = qy if ci == 0 else qc
        comps.append(JpegComponent(
            id=ids[ci], h=h, v=v, table=0 if ci == 0 else 1, quant=q,
            blocks=np.rint(coef / q).astype(np.int32), blocks_high=-(-dh // 8),
            blocks_wide=-(-dw // 8)))
    return JpegCoefficients(width=wid, height=hgt, components=comps,
                            jfif=jfif, adobe=adobe, coef_bits=None)


# -- progression scripts ------------------------------------------------------

def _default_script(nc: int, ycc: bool) -> list:
    """libjpeg's jpeg_simple_progression: (components, Ss, Se, Ah, Al)."""
    every = tuple(range(nc))
    if nc == 3 and ycc:
        return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), (every, 0, 0, 1, 0),
                ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    return ([(every, 0, 0, 0, 1)]
            + [((c,), 1, 5, 0, 2) for c in every]
            + [((c,), 6, 63, 0, 2) for c in every]
            + [((c,), 1, 63, 2, 1) for c in every]
            + [(every, 0, 0, 1, 0)]
            + [((c,), 1, 63, 1, 0) for c in every])


SCRIPTS = ("default", "spectral", "early", "dc-only")


def script(name: str, nc: int, ycc: bool = True) -> list:
    """A progression: libjpeg's default; spectral selection alone (each
    component's DC in its own scan, then three AC bands, no successive
    approximation); the default stopped after its fourth scan; or the DC
    terms alone (first and refinement).  The last two leave terms short
    of full precision: libjpeg smooths such frames."""
    if name == "default":
        return _default_script(nc, ycc)
    if name == "spectral":
        return ([((c,), 0, 0, 0, 0) for c in range(nc)]
                + [((c,), lo, hi, 0, 0) for c in range(nc)
                   for lo, hi in ((1, 2), (3, 9), (10, 63))])
    if name == "early":
        return _default_script(nc, ycc)[:4]
    if name == "dc-only":
        every = tuple(range(nc))
        return [(every, 0, 0, 0, 1), (every, 0, 0, 1, 0)]
    raise ValueError(f"unknown script {name!r}")


# -- Huffman coding -----------------------------------------------------------

def _optimal_table(freq: dict) -> tuple[list, list]:
    """(bits[1..16], symbols) of libjpeg's jpeg_gen_optimal_table
    (Annex K.2 with a reserved all-ones code point)."""
    f = [0] * 257
    for s, n in freq.items():
        f[s] = n
    f[256] = 1
    size = [0] * 257
    others = [-1] * 257
    live = sorted(i for i in range(257) if f[i])
    while len(live) > 1:
        # the two least frequent, the larger symbol first on a tie
        c1 = min(reversed(live), key=lambda i: f[i])
        c2 = min((i for i in reversed(live) if i != c1), key=lambda i: f[i])
        f[c1] += f[c2]
        f[c2] = 0
        live.remove(c2)
        size[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            size[c1] += 1
        others[c1] = c2
        size[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            size[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    syms = [s for n in range(1, 33) for s in range(256) if size[s] == n]
    return bits[1:17], syms


def _codes(bits, syms) -> dict:
    out, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            out[syms[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, n: int):
        if n:
            self.acc = (self.acc << n) | (value & ((1 << n) - 1))
            self.n += n
            while self.n >= 8:
                self.n -= 8
                b = (self.acc >> self.n) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
            self.acc &= (1 << self.n) - 1

    def align(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v: int) -> int:
    return abs(v).bit_length()


def _bits_of(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


class _Events:
    """A scan's Huffman symbols and raw bits in stream order, counted per
    table so that optimal tables can be made before the bits are
    written."""

    def __init__(self):
        self.items = []
        self.freq = {}

    def sym(self, table, s):
        self.items.append((table, s, 0, 0))
        f = self.freq.setdefault(table, {})
        f[s] = f.get(s, 0) + 1

    def bits(self, value, n):
        if n:
            self.items.append((None, 0, value, n))

    def value(self, table, v):
        """A DC difference or lossless difference: category + bits."""
        s = _category(v)
        self.sym(table, s)
        self.bits(_bits_of(v, s), s)

    def restart(self, n):
        self.items.append(("RST", n, 0, 0))


def _seq_block(ev, blk, dc_t, ac_t, pred):
    """One sequential block's DC difference (from pred) and AC terms."""
    ev.value(dc_t, blk[0] - pred)
    zz = [blk[_ZZ[k]] for k in range(64)]
    last = max((k for k in range(1, 64) if zz[k]), default=0)
    r = 0
    for k in range(1, last + 1):
        v = zz[k]
        if v == 0:
            r += 1
            continue
        while r > 15:
            ev.sym(ac_t, 0xF0)
            r -= 16
        s = _category(v)
        ev.sym(ac_t, (r << 4) | s)
        ev.bits(_bits_of(v, s), s)
        r = 0
    if last < 63:
        ev.sym(ac_t, 0x00)


class _Progressive:
    """libjpeg's jcphuff.c for one scan: DC first / refine, AC first /
    refine with EOB runs and buffered correction bits."""

    def __init__(self, ev, ss, se, al):
        self.ev, self.ss, self.se, self.al = ev, ss, se, al
        self.eobrun = 0
        self.be = []                  # correction bits held by the EOB run

    def emit_eobrun(self, t):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.ev.sym(t, n << 4)
            self.ev.bits(self.eobrun, n)
            self.eobrun = 0
            for b in self.be:
                self.ev.bits(b, 1)
            self.be = []

    def ac_first(self, blk, t):
        al, r = self.al, 0
        for k in range(self.ss, self.se + 1):
            v = blk[_ZZ[k]]
            a = (v if v >= 0 else -v) >> al
            if a == 0:
                r += 1
                continue
            self.emit_eobrun(t)
            while r > 15:
                self.ev.sym(t, 0xF0)
                r -= 16
            s = a.bit_length()
            self.ev.sym(t, (r << 4) | s)
            self.ev.bits(a if v >= 0 else ~a, s)
            r = 0
        if r > 0:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun(t)

    def ac_refine(self, blk, t):
        al, ss, se = self.al, self.ss, self.se
        absv = {k: abs(blk[_ZZ[k]]) >> al for k in range(ss, se + 1)}
        eob = max((k for k in absv if absv[k] == 1), default=0)
        r, br = 0, []
        for k in range(ss, se + 1):
            a = absv[k]
            if a == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun(t)
                self.ev.sym(t, 0xF0)
                r -= 16
                for b in br:
                    self.ev.bits(b, 1)
                br = []
            if a > 1:
                br.append(a & 1)
                continue
            self.emit_eobrun(t)
            self.ev.sym(t, (r << 4) | 1)
            self.ev.bits(0 if blk[_ZZ[k]] < 0 else 1, 1)
            for b in br:
                self.ev.bits(b, 1)
            br = []
            r = 0
        if r > 0 or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 1000 - 64 + 1:
                self.emit_eobrun(t)


# -- arithmetic coding (T.81 Annex D; libjpeg's jcarith.c) --------------------

class _ArithEncoder:
    """The QM coder: the interval's base C and size A, bytes out with
    their carries propagated in place, stuffed when the segment ends."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11

    def encode(self, st, i, val):
        sv = st[i]
        q = sv & 0x7F
        qe = QM_QE[q]
        self.a -= qe
        if val != sv >> 7:                       # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ QM_NEXT_LPS[q]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ QM_NEXT_MPS[q]
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte()
                self.ct = 8

    def _byte(self):
        t = self.c >> 19
        if t > 0xFF:
            j = len(self.out) - 1
            while self.out[j] == 0xFF:
                self.out[j] = 0
                j -= 1
            self.out[j] += 1
        self.out.append(t & 0xFF)
        self.c &= 0x7FFFF

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        self._byte()
        self.c <<= 8
        self._byte()
        out = bytes(self.out).rstrip(b"\x00")
        return out.replace(b"\xff", b"\xff\x00")


def _enc_magnitude(enc, st, i, v, x_bin):
    """Figures F.8-F.9 for |value| - 1 = v from bin i (x_bin None: DC)."""
    m = 0
    if v:
        enc(st, i, 1)
        m = 1
        v2 = v
        if x_bin is None:
            i = 20
            v2 >>= 1
            while v2:
                enc(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                enc(st, i, 1)
                m <<= 1
                i = x_bin
                v2 >>= 1
                while v2:
                    enc(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
    enc(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc(st, i, 1 if m & v else 0)
        m >>= 1


def _enc_dc(enc, st, diff, m, ctx, bounds):
    s0 = ctx[m]
    if diff == 0:
        enc(st, s0, 0)
        ctx[m] = 0
        return
    enc(st, s0, 1)
    sign = 1 if diff < 0 else 0
    enc(st, s0 + 1, sign)
    v = abs(diff) - 1
    top = 1 << (v.bit_length() - 1) if v else 0
    lo, hi = bounds
    if top < (1 << lo) >> 1:
        ctx[m] = 0
    elif top > (1 << hi) >> 1:
        ctx[m] = 12 + 4 * sign
    else:
        ctx[m] = 4 + 4 * sign
    _enc_magnitude(enc, st, s0 + 2 + sign, v, None)


def _enc_ac(enc, st, fixed, vals, ss, se, kx):
    """AC terms ss..se (values already point-transformed) of one block."""
    ke = se
    while ke >= ss and not vals[ke]:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc(st, i, 0)
        while not vals[k]:
            enc(st, i + 1, 0)
            i += 3
            k += 1
        enc(st, i + 1, 1)
        v = vals[k]
        enc(fixed, 0, 1 if v < 0 else 0)
        _enc_magnitude(enc, st, i + 2, abs(v) - 1, 189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc(st, 3 * (k - 1), 1)


def _enc_ac_refine(enc, st, fixed, blk, ss, se, ah, al):
    def mag(k, shift):
        v = blk[_ZZ[k]]
        return (v if v >= 0 else -v) >> shift
    ke = se
    while ke > 0 and not mag(ke, al):
        ke -= 1
    kex = ke
    while kex > 0 and not mag(kex, ah):
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc(st, i, 0)
        while True:
            a = mag(k, al)
            if a:
                if a >> 1:
                    enc(st, i + 2, a & 1)
                else:
                    enc(st, i + 1, 1)
                    enc(fixed, 0, 1 if blk[_ZZ[k]] < 0 else 0)
                break
            enc(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        enc(st, 3 * (k - 1), 1)


# -- streams ------------------------------------------------------------------

def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _header(co, sof: int, restart: int, dac, tables_q: bool = True) -> bytes:
    out = b"\xff\xd8"
    if co.jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if co.adobe is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                     co.adobe))
    if tables_q:
        qs = {}
        for c in co.components:
            qs[c.table] = c.quant
        out += _segment(0xDB, b"".join(
            bytes([t]) + np.asarray(q)[_ZIGZAG].astype(np.uint8).tobytes()
            if np.max(q) < 256 else bytes([0x10 | t]) + np.asarray(q)[
                _ZIGZAG].astype(">u2").tobytes() for t, q in qs.items()))
    out += _segment(sof, struct.pack(">BHHB", 8, co.height, co.width,
                                     len(co.components)) + b"".join(
        bytes([c.id, c.h << 4 | c.v, c.table]) for c in co.components))
    if dac:
        out += _segment(0xCC, b"".join(bytes([k, v]) for k, v in dac.items()))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    return out


def _mcus(co, members) -> list:
    """(component, block row, block col) of each block of each MCU, in
    the decoder's order."""
    if len(members) == 1:
        c = co.components[members[0]]
        return [[(members[0], r, col)] for r in range(c.blocks_high)
                for col in range(c.blocks_wide)]
    hmax = max(c.h for c in co.components)
    vmax = max(c.v for c in co.components)
    mcux, mcuy = -(-co.width // (8 * hmax)), -(-co.height // (8 * vmax))
    return [[(ci, my * co.components[ci].v + by,
              mx * co.components[ci].h + bx)
             for ci in members for by in range(co.components[ci].v)
             for bx in range(co.components[ci].h)]
            for my in range(mcuy) for mx in range(mcux)]


def _sequential_scans(co) -> list:
    nc = len(co.components)
    if nc == 1 or sum(c.h * c.v for c in co.components) <= 10:
        return [(tuple(range(nc)), 0, 63, 0, 0)]
    return [((c,), 0, 63, 0, 0) for c in range(nc)]


def _huffman_scan(co, members, ss, se, ah, al, progressive, restart):
    """(DHT + SOS + data) of one Huffman scan."""
    blocks = [c.blocks.tolist() for c in co.components]
    ev = _Events()
    # table ids: the component's table slot, each class its own tables
    dc_t = {ci: ("dc", co.components[ci].table) for ci in members}
    ac_t = {ci: ("ac", co.components[ci].table) for ci in members}
    mcus = _mcus(co, members)
    per = restart or len(mcus)
    prog = _Progressive(ev, ss, se, al) if progressive else None
    for first in range(0, len(mcus), per):
        if first:
            if prog is not None and members:
                prog.emit_eobrun(ac_t[members[0]])
            ev.restart((first // per - 1) & 7)
        preds = {ci: 0 for ci in members}
        for mcu in mcus[first:first + per]:
            for ci, r, col in mcu:
                blk = blocks[ci][r][col]
                if not progressive:
                    _seq_block(ev, blk, dc_t[ci], ac_t[ci], preds[ci])
                    preds[ci] = blk[0]
                elif ss == 0 and ah == 0:
                    d = blk[0] >> al
                    ev.value(dc_t[ci], d - preds[ci])
                    preds[ci] = d
                elif ss == 0:
                    ev.bits((blk[0] >> al) & 1, 1)
                elif ah == 0:
                    prog.ac_first(blk, ac_t[ci])
                else:
                    prog.ac_refine(blk, ac_t[ci])
    if prog is not None:
        prog.emit_eobrun(ac_t[members[0]])
    codes, dht = {}, b""
    for key in sorted(ev.freq):
        bits, syms = _optimal_table(ev.freq[key])
        codes[key] = _codes(bits, syms)
        dht += bytes([(key[0] == "ac") << 4 | key[1]]) + bytes(bits) + bytes(
            syms)
    w = _BitWriter()
    for table, s, value, n in ev.items:
        if table == "RST":
            w.align()
            w.out += bytes([0xFF, 0xD0 + s])
        elif table is None:
            w.put(value, n)
        else:
            code, length = codes[table][s]
            w.put(code, length)
    w.align()
    sos = bytes([len(members)]) + b"".join(
        bytes([co.components[ci].id, co.components[ci].table << 4
               | co.components[ci].table]) for ci in members) + bytes(
        [ss, se, ah << 4 | al])
    return (_segment(0xC4, dht) if dht else b"") + _segment(0xDA, sos) + bytes(
        w.out)


def _arith_scan(co, members, ss, se, ah, al, progressive, restart, dac):
    """(SOS + data) of one arithmetic-coded scan."""
    blocks = [c.blocks.tolist() for c in co.components]
    dac = dac or {}
    mcus = _mcus(co, members)
    per = restart or len(mcus)
    data = b""
    for first in range(0, len(mcus), per):
        if first:
            data += bytes([0xFF, 0xD0 + ((first // per - 1) & 7)])
        coder = _ArithEncoder()
        enc = coder.encode
        fixed = bytearray([FIXED_BIN])
        tabs = {co.components[ci].table for ci in members}
        dc_st = {t: bytearray(DC_BINS) for t in tabs}
        ac_st = {t: bytearray(AC_BINS) for t in tabs}
        preds = {ci: 0 for ci in members}
        ctx = {ci: 0 for ci in members}
        for mcu in mcus[first:first + per]:
            for ci, r, col in mcu:
                t = co.components[ci].table
                bounds = (dac.get(t, 0x10) & 15, dac.get(t, 0x10) >> 4)
                kx = dac.get(16 + t, 5)
                blk = blocks[ci][r][col]
                if not progressive or (ss == 0 and ah == 0):
                    d = blk[0] >> al
                    _enc_dc(enc, dc_st[t], d - preds[ci], ci, ctx, bounds)
                    preds[ci] = d
                    if not progressive:
                        _enc_ac(enc, ac_st[t], fixed,
                                [0] + [blk[_ZZ[k]] for k in range(1, 64)],
                                1, 63, kx)
                elif ss == 0:
                    enc(fixed, 0, (blk[0] >> al) & 1)
                elif ah == 0:
                    vals = [0] * 64
                    for k in range(ss, se + 1):
                        v = blk[_ZZ[k]]
                        vals[k] = (v >> al) if v >= 0 else -((-v) >> al)
                    _enc_ac(enc, ac_st[t], fixed, vals, ss, se, kx)
                else:
                    _enc_ac_refine(enc, ac_st[t], fixed, blk, ss, se, ah, al)
        data += coder.finish()
    sos = bytes([len(members)]) + b"".join(
        bytes([co.components[ci].id, co.components[ci].table << 4
               | co.components[ci].table]) for ci in members) + bytes(
        [ss, se, ah << 4 | al])
    return _segment(0xDA, sos) + data


def write(co: JpegCoefficients, coding: str = "huffman",
          progression=None, restart: int = 0, dac: dict | None = None
          ) -> bytes:
    """The coefficient set as a JPEG stream: `coding` "huffman" or
    "arithmetic"; `progression` None (sequential), the name of a script
    (SCRIPTS) or a list of (components, Ss, Se, Ah, Al); `restart` the
    DRI interval in MCUs (0: none); `dac` {index: value} the DAC
    segment's entries (index = class << 4 | table; a DC value U << 4 | L,
    an AC value Kx)."""
    nc = len(co.components)
    if isinstance(progression, str):
        ycc = nc == 3 and (co.jfif or co.adobe not in (0,))
        progression = script(progression, nc, ycc)
    arith = coding == "arithmetic"
    if progression is None:
        scans = _sequential_scans(co)
        tables = {c.table for c in co.components}
        sof = 0xC9 if arith else (0xC0 if max(tables) <= 1 else 0xC1)
    else:
        scans = progression
        sof = 0xCA if arith else 0xC2
    out = _header(co, sof, restart, dac if arith else None)
    for members, ss, se, ah, al in scans:
        members = tuple(members)
        if arith:
            out += _arith_scan(co, members, ss, se, ah, al,
                               progression is not None, restart, dac)
        else:
            out += _huffman_scan(co, members, ss, se, ah, al,
                                 progression is not None, restart)
    return out + b"\xff\xd9"


# -- lossless -----------------------------------------------------------------

def write_lossless(img: np.ndarray, sampling, predictor: int = 1,
                   pt: int = 0, restart_rows: int = 0,
                   interleave: bool = True, ids=None, jfif: bool = True,
                   adobe: int | None = None) -> bytes:
    """A lossless (SOF3) Huffman stream of the samples img (H, W, nc) u8
    at `sampling` (planes() makes the components' samples): predictor
    1-7, point transform pt, a restart every `restart_rows` MCU rows
    (libjpeg-turbo takes only whole MCU rows), one interleaved scan (at
    most 10 samples per MCU) or one scan per component."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    hgt, wid, nc = img.shape
    ps = planes(img, sampling)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-wid // hmax), -(-hgt // vmax)
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    co = JpegCoefficients(
        width=wid, height=hgt, jfif=jfif, adobe=adobe, coef_bits=None,
        components=[JpegComponent(id=ids[i], h=h, v=v, table=0, quant=None,
                                  blocks=None, blocks_high=0, blocks_wide=0)
                    for i, (h, v) in enumerate(sampling)])
    inter = interleave and nc > 1 and sum(h * v for h, v in sampling) <= 10
    scans = [tuple(range(nc))] if inter else [(c,) for c in range(nc)]
    # the restart interval in MCUs: whole MCU rows of every scan
    restart = restart_rows * (mcux if inter else
                              int(np.lcm.reduce([p.shape[1] for p in ps])))
    out = _header(co, 0xC3, restart, None, tables_q=False)
    for members in scans:
        ev = _Events()
        diffs = {}
        for ci in members:
            p = ps[ci].astype(np.int64) >> pt
            dh, dw = p.shape
            h, v = sampling[ci]
            step = (restart_rows * v if len(members) > 1
                    else restart // dw)
            d = np.zeros((mcuy * v if len(members) > 1 else dh,
                          mcux * h if len(members) > 1 else dw), np.int64)
            for y in range(dh):
                first = y == 0 or (step and y % step == 0)
                for x in range(dw):
                    if first:
                        pred = (1 << (7 - pt)) if x == 0 else p[y, x - 1]
                    elif x == 0:
                        pred = p[y - 1, 0]
                    else:
                        ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                        pred = (ra, rb, rc, ra + rb - rc,
                                ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                                (ra + rb) >> 1)[predictor - 1]
                    dd = (int(p[y, x]) - int(pred)) & 0xFFFF
                    d[y, x] = dd - 0x10000 if dd >= 0x8000 else dd
            diffs[ci] = d
        if len(members) > 1:
            order = [[(ci, my * sampling[ci][1] + by,
                       mx * sampling[ci][0] + bx)
                      for ci in members for by in range(sampling[ci][1])
                      for bx in range(sampling[ci][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        else:
            ci = members[0]
            order = [[(ci, y, x)] for y in range(diffs[ci].shape[0])
                     for x in range(diffs[ci].shape[1])]
        per = restart or len(order)
        for first in range(0, len(order), per):
            if first:
                ev.restart((first // per - 1) & 7)
            for mcu in order[first:first + per]:
                for ci, y, x in mcu:
                    v = int(diffs[ci][y, x])
                    if v == -32768:
                        ev.sym(("dc", 0), 16)
                    else:
                        ev.value(("dc", 0), v)
        bits, syms = _optimal_table(ev.freq[("dc", 0)])
        codes = _codes(bits, syms)
        w = _BitWriter()
        for table, s, value, n in ev.items:
            if table == "RST":
                w.align()
                w.out += bytes([0xFF, 0xD0 + s])
            elif table is None:
                w.put(value, n)
            else:
                w.put(*codes[s])
        w.align()
        sos = bytes([len(members)]) + b"".join(
            bytes([ids[ci], 0]) for ci in members) + bytes([predictor, 0, pt])
        out += (_segment(0xC4, bytes([0]) + bytes(bits) + bytes(syms))
                + _segment(0xDA, sos) + bytes(w.out))
    return out + b"\xff\xd9"
