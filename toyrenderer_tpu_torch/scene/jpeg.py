"""Baseline JPEG decoder for material textures: stdlib + numpy, no imaging
library.

The reference package decodes JPEG textures through Pillow
(toyrenderer_tpu/scene/textures.py:131-132: `convert("RGBA")`), which
runs libjpeg-turbo with its defaults; this decoder reproduces that
output bit for bit for the JPEGs it takes:

* sequential Huffman-coded frames (SOF0 baseline, SOF1 extended) of
  8-bit samples, one or several scans, interleaved or not, with restart
  intervals (DRI / RSTn);
* one component (grey) or three (YCbCr, or RGB where the markers say so:
  libjpeg's rule -- a JFIF APP0 means YCbCr, else an Adobe APP14 marker's
  transform flag, 0 for RGB, else component ids 'R', 'G', 'B' for RGB),
  with chroma at 4:4:4, 4:2:2 or 4:2:0.

The arithmetic is libjpeg-turbo's: the `islow` integer IDCT (13-bit
constants, two passes with their roundings and its range limit table),
its "fancy" triangle upsampling of 4:2:2 and 4:2:0 chroma, and its
fixed-point YCbCr -> RGB tables (16 fraction bits).

Progressive (SOF2), lossless, hierarchical and arithmetic-coded frames,
12-bit samples, other chroma subsamplings and 4-component (CMYK / YCCK)
images raise NotImplementedError (ROADMAP queue 1 item 6).  Data that is not a
well-formed JPEG raises JpegError.
"""

from __future__ import annotations

import struct

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = _ZIGZAG.tolist()
_UNPORTED_SOF = {0xC2: "progressive", 0xC3: "lossless",
                 0xC5: "hierarchical", 0xC6: "hierarchical",
                 0xC7: "hierarchical", 0xC9: "arithmetic-coded",
                 0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded",
                 0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
                 0xCF: "arithmetic-coded"}


class JpegError(ValueError):
    pass


def _unported(what: str):
    raise NotImplementedError(f"JPEG {what}: the port decodes baseline and "
                              "extended sequential Huffman JPEG of 8-bit "
                              "samples (ROADMAP queue 1 item 6)")


# -- Huffman ------------------------------------------------------------------

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


def _decode_segment(data: bytes, units, comps, preds):
    """Decode `units` ((component, its block's index) per block, in stream
    order) from one restart segment's unstuffed bytes into the
    components' (blocks, 64) natural-order coefficient rows; comps[c] =
    (DC table, AC table, coefficient rows); preds: the DC predictions,
    zero at the segment's start."""
    done = {ci: ([], []) for ci in comps}
    buf = 0
    nbits = 0
    pos = 0
    n = len(data)
    zz = _ZZ
    for ci, row in units:
        dc_lut, ac_lut, _ = comps[ci]
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
        preds[ci] += v
        blk[0] = preds[ci]
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
            if k < 64:
                blk[zz[k]] = v
            k += 1
        done[ci][0].append(row)
        done[ci][1].append(blk)
    if pos > n + 4:
        raise JpegError("entropy-coded data ends early")
    for ci, (rows, blks) in done.items():
        if rows:
            comps[ci][2][rows] = blks


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


# -- upsampling and colour ----------------------------------------------------

def _edge(x, axis, side):
    """x shifted by one along axis, the edge sample repeated (side -1: each
    sample's predecessor, +1: its successor)."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + side, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """libjpeg-turbo's "fancy" triangle upsampling of a component plane
    by (fx, fy) = (2, 1) or (2, 2), the edge samples repeated."""
    p = plane.astype(np.int32)
    if (fx, fy) == (1, 1):
        return plane
    if (fx, fy) == (2, 1):
        three = 3 * p
        even = (three + _edge(p, 1, -1) + 1) >> 2
        odd = (three + _edge(p, 1, 1) + 2) >> 2
        return np.stack([even, odd], 2).reshape(p.shape[0], -1).astype(
            np.uint8)
    rows = []
    for side in (-1, 1):                     # the output row above, below
        cs = 3 * p + _edge(p, 0, side)       # column sums
        even = (3 * cs + _edge(cs, 1, -1) + 8) >> 4
        odd = (3 * cs + _edge(cs, 1, 1) + 7) >> 4
        rows.append(np.stack([even, odd], 2).reshape(p.shape[0], -1))
    return np.stack(rows, 1).reshape(2 * p.shape[0], -1).astype(np.uint8)


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


# -- markers ------------------------------------------------------------------

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


def decode_jpeg(raw: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) u8 RGBA (see the module docstring)."""
    if raw[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG")
    quant = {}
    dc_tabs, ac_tabs = {}, {}
    frame = None
    restart = 0
    jfif = False
    adobe = None
    coefs = None
    gen = _segments(raw)
    seg = next(gen, None)
    while seg is not None:
        m, end, p = seg
        resume = None
        if m == 0xE0 and p[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and p[:5] == b"Adobe" and len(p) >= 12:
            adobe = p[11]
        elif m == 0xDB:
            q = 0
            while q < len(p):
                prec, tid = p[q] >> 4, p[q] & 15
                size = 128 if prec else 64
                vals = np.frombuffer(p[q + 1:q + 1 + size],
                                     ">u2" if prec else np.uint8)
                if vals.size != 64:
                    raise JpegError("truncated DQT")
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
                (ac_tabs if cls else dc_tabs)[tid] = _huffman_lut(counts,
                                                                  syms)
                q += 17 + total
        elif m == 0xCC:
            _unported("arithmetic coding (DAC)")
        elif m in _UNPORTED_SOF:
            _unported(f"{_UNPORTED_SOF[m]} frame (SOF{m - 0xC0})")
        elif m in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", p[:6])
            if prec != 8:
                _unported(f"{prec}-bit samples")
            if nc == 4:
                _unported("4-component (CMYK / YCCK) image")
            if nc not in (1, 3) or h == 0 or w == 0:
                raise JpegError(f"{nc} components of {w}x{h}")
            comps = []
            for i in range(nc):
                cid, hv, tq = p[6 + 3 * i:9 + 3 * i]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            hmax = max(c['h'] for c in comps)
            vmax = max(c['v'] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c['bw'], c['bh'] = mcux * c['h'], mcuy * c['v']
                c['dw'] = -(-w * c['h'] // hmax)
                c['dh'] = -(-h * c['v'] // vmax)
            frame = dict(w=w, h=h, comps=comps, hmax=hmax, vmax=vmax,
                         mcux=mcux, mcuy=mcuy)
            coefs = [np.zeros((c['bh'] * c['bw'], 64), np.int64)
                     for c in comps]
        elif m == 0xDD:
            restart = struct.unpack(">H", p[:2])[0]
        elif m == 0xDA:
            if frame is None:
                raise JpegError("scan before the frame header")
            resume = _scan(raw, end, p, frame, coefs, dc_tabs, ac_tabs,
                           restart)
        try:
            seg = gen.send(resume) if resume is not None else next(gen)
        except StopIteration:
            seg = None
    if frame is None:
        raise JpegError("no frame")
    return _finish(frame, coefs, quant, jfif, adobe)


def _scan(raw, end, p, frame, coefs, dc_tabs, ac_tabs, restart) -> int:
    """Decode one scan (its header `p`, its data at `end`) into coefs;
    returns the position of the marker after it."""
    ns = p[0]
    comps = frame['comps']
    by_id = {c['id']: i for i, c in enumerate(comps)}
    members = []
    for k in range(ns):
        cid, tabs = p[1 + 2 * k], p[2 + 2 * k]
        if cid not in by_id:
            raise JpegError(f"scan names unknown component {cid}")
        members.append((by_id[cid], tabs >> 4, tabs & 15))
    ss, se, ahal = p[1 + 2 * ns:4 + 2 * ns]
    if ss != 0 or se != 63 or ahal != 0:
        _unported("spectral selection or successive approximation")
    tables = {}
    for ci, td, ta in members:
        if td not in dc_tabs or ta not in ac_tabs:
            raise JpegError("scan uses an undefined Huffman table")
        tables[ci] = (dc_tabs[td], ac_tabs[ta], coefs[ci])
    # the blocks in stream order, per MCU
    if ns == 1:
        ci = members[0][0]
        c = comps[ci]
        bw, bh = -(-c['dw'] // 8), -(-c['dh'] // 8)
        mcus = [[(ci, r * c['bw'] + col)] for r in range(bh)
                for col in range(bw)]
    else:
        mcus = []
        for my in range(frame['mcuy']):
            for mx in range(frame['mcux']):
                units = []
                for ci, _, _ in members:
                    c = comps[ci]
                    for by in range(c['v']):
                        for bx in range(c['h']):
                            units.append((ci, (my * c['v'] + by) * c['bw']
                                          + mx * c['h'] + bx))
                mcus.append(units)
    segs, marker_pos = _scan_segments(raw, end)
    per = restart if restart else len(mcus)
    for s, first in enumerate(range(0, len(mcus), per)):
        if s >= len(segs):
            raise JpegError("missing restart segment")
        units = [u for mcu in mcus[first:first + per] for u in mcu]
        _decode_segment(segs[s], units, tables,
                        {ci: 0 for ci, _, _ in members})
    return marker_pos


def _finish(frame, coefs, quant, jfif, adobe) -> np.ndarray:
    """Dequantise, inverse-transform, upsample and convert to RGBA."""
    w, h = frame['w'], frame['h']
    planes = []
    for c, coef in zip(frame['comps'], coefs):
        if c['tq'] not in quant:
            raise JpegError("undefined quantisation table")
        blocks = idct_islow(coef, quant[c['tq']])
        plane = blocks.reshape(c['bh'], c['bw'], 8, 8).transpose(
            0, 2, 1, 3).reshape(c['bh'] * 8, c['bw'] * 8)
        plane = plane[:c['dh'], :c['dw']]
        fx, fy = frame['hmax'] // c['h'], frame['vmax'] // c['v']
        if (fx * c['h'], fy * c['v']) != (frame['hmax'], frame['vmax']):
            raise JpegError("non-integral sampling ratio")
        if (fx, fy) not in ((1, 1), (2, 1), (2, 2)):
            _unported(f"chroma sampling {fx}:1 x {fy}:1 (4:4:4, 4:2:2 and "
                      "4:2:0 are decoded)")
        planes.append(_upsample(plane, fx, fy)[:h, :w])
    alpha = np.full((h, w, 1), 255, np.uint8)
    if len(planes) == 1:
        return np.concatenate([planes[0][..., None]] * 3 + [alpha], -1)
    ids = [c['id'] for c in frame['comps']]
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == [82, 71, 66]
    if rgb:
        out = np.stack(planes, -1)
    else:
        out = ycc_to_rgb(*planes)
    return np.concatenate([out, alpha], -1)
