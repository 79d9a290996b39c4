"""Baseline JPEG encoder for streamed frames: stdlib + numpy, no imaging
library (the card's machine has none).

The reference's viewer encodes its frames through Pillow at quality 88
(toyrenderer_tpu/tools/shell.py:392); this encoder writes what libjpeg
writes with its defaults there, in numpy:

* JFIF, one baseline (SOF0) interleaved scan of 8-bit YCbCr with 4:2:0
  chroma, the JFIF colour transform;
* the Annex K quantization tables scaled by quality as the IJG library
  scales them (scale = 5000 / q below 50, else 200 - 2q; each entry
  (base * scale + 50) // 100, clamped to 1..255);
* the Annex K Huffman tables;
* a float DCT, and chroma downsampled by the mean of each 2x2 block.

The entropy coding is vectorized: every Huffman symbol and its extra
bits become one (code, length) field, the fields are ordered block by
block and packed into bytes at once, then each 0xFF byte is stuffed.
scene/jpeg.py decodes the output.
"""

from __future__ import annotations

import struct

import numpy as np

from toyrenderer_tpu_torch.scene.jpeg import (
    _AC_BITS, _AC_VALS, _DC_BITS, _DC_VALS, _ZIGZAG)

# Annex K.1 / K.2 quantization tables, in zigzag order
_BASE_Q = (
    np.array([16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
              26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
              56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81,
              87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92,
              101, 103, 99]),
    np.array([17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66]
             + [99] * 50))

def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The luminance and chrominance tables (zigzag order) at `quality`
    (1-100), scaled as the IJG library scales them."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int64)
                 for t in _BASE_Q)


def _huffman_codes(bits, vals) -> tuple[np.ndarray, np.ndarray]:
    """(code (256,), length (256,)) of each symbol (Annex C)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            code[vals[k]] = c
            length[vals[k]] = n
            c += 1
            k += 1
        c <<= 1
    return code, length


_DC_CODES = [_huffman_codes(b, v) for b, v in zip(_DC_BITS, _DC_VALS)]
_AC_CODES = [_huffman_codes(b, v) for b, v in zip(_AC_BITS, _AC_VALS)]


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m[0] *= np.sqrt(1 / 8)
    m[1:] *= np.sqrt(2 / 8)
    return m


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _quantized(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """DCT + quantization of every 8x8 block -> (by, bx, 64) in zigzag
    order, int64."""
    b = _blocks(plane - 128.0)
    coef = _DCT @ b @ _DCT.T
    zz = coef.reshape(*coef.shape[:2], 64)[..., _ZIGZAG]
    return np.rint(zz / table).astype(np.int64)


def _size(v: np.ndarray) -> np.ndarray:
    """The JPEG magnitude category of each value (bits of |v|)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The value's bits as JPEG writes them (negatives: v - 1 masked)."""
    return np.where(v < 0, v - 1 + (1 << size), v) & ((1 << size) - 1)


def _fields(blocks: np.ndarray, comp: np.ndarray):
    """Every (bits, length) field of the scan, in stream order.
    blocks: (B, 64) quantized zigzag coefficients in scan order; comp:
    (B,) each block's component (0 Y, 1 Cb, 2 Cr): its DC predictor, and
    its Huffman tables (luminance for Y, chrominance for the others)."""
    nb = blocks.shape[0]
    table = (comp > 0).astype(np.int64)
    # DC: the difference to the previous block of the same component
    dc = blocks[:, 0]
    prev = np.zeros(nb, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        prev[idx[1:]] = dc[idx[:-1]]
    diff = dc - prev
    s = _size(diff)
    dcode = np.stack([_DC_CODES[0][0], _DC_CODES[1][0]])[table, s]
    dlen = np.stack([_DC_CODES[0][1], _DC_CODES[1][1]])[table, s]
    keys = [np.arange(nb) * 128]
    vals = [(dcode << s) | _extra_bits(diff, s)]
    lens = [dlen + s]
    # AC: (run, size) symbols, a ZRL per 16 zeros a run holds, EOB
    ac = blocks[:, 1:]
    b_i, k_i = np.nonzero(ac)
    v = ac[b_i, k_i]
    k1 = k_i + 1
    first = np.r_[True, b_i[1:] != b_i[:-1]]
    prev_k = np.where(first, 0, np.r_[0, k1[:-1]])
    run = k1 - prev_k - 1
    nzrl = run // 16
    s = _size(v)
    sym = ((run % 16) << 4) | s
    ac_code = np.stack([_AC_CODES[0][0], _AC_CODES[1][0]])
    ac_len = np.stack([_AC_CODES[0][1], _AC_CODES[1][1]])
    t = table[b_i]
    keys.append(b_i * 128 + k1 * 2 + 1)
    vals.append((ac_code[t, sym] << s) | _extra_bits(v, s))
    lens.append(ac_len[t, sym] + s)
    if nzrl.any():
        rep = np.repeat(np.arange(len(nzrl)), nzrl)
        # a ZRL sorts before its coefficient: key one less (ZRLs of one
        # coefficient are identical fields, so their order is moot)
        keys.append(b_i[rep] * 128 + k1[rep] * 2)
        vals.append(ac_code[t[rep], 0xF0])
        lens.append(ac_len[t[rep], 0xF0])
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b_i, k1)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 128 + 127)
    vals.append(ac_code[table[eob], 0x00])
    lens.append(ac_len[table[eob], 0x00])
    keys, vals, lens = (np.concatenate(x) for x in (keys, vals, lens))
    order = np.argsort(keys, kind='stable')
    return vals[order], lens[order]


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """The fields' bits, MSB first, padded with 1s to a byte, 0xFF bytes
    stuffed with 0x00."""
    total = int(lens.sum())
    field = np.repeat(np.arange(len(lens)), lens)
    start = np.cumsum(lens) - lens
    pos = np.arange(total) - start[field]
    bits = (vals[field] >> (lens[field] - 1 - pos)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(img: np.ndarray, quality: int = 88) -> bytes:
    """(H, W, 3) u8 RGB -> baseline JFIF JPEG bytes (4:2:0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) u8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = np.pad(img, ((0, hp - h), (0, wp - w), (0, 0)),
                 mode='edge').astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0

    def down(p):
        return p.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))
    qy, qc = quant_tables(quality)
    zy = _quantized(y, qy)                            # (hp/8, wp/8, 64)
    zcb = _quantized(down(cb), qc)                    # (hp/16, wp/16, 64)
    zcr = _quantized(down(cr), qc)
    my, mx = hp // 16, wp // 16
    # MCU order: the 2x2 luminance blocks, then Cb, then Cr
    ly = zy.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    mcu = np.concatenate([ly, zcb[:, :, None], zcr[:, :, None]], axis=2)
    blocks = mcu.reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    scan = _pack(*_fields(blocks, comp))

    dqt = b"".join(bytes([i]) + t.astype(np.uint8).tobytes()
                   for i, t in enumerate((qy, qc)))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([cls << 4 | i]) + bytes(bits) + vals
                   for cls, tabs in ((0, zip(_DC_BITS, _DC_VALS)),
                                     (1, zip(_AC_BITS, _AC_VALS)))
                   for i, (bits, vals) in enumerate(tabs))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, sof)
            + _segment(0xC4, dht) + _segment(0xDA, sos) + scan
            + b"\xff\xd9")
