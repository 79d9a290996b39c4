"""PNG decoder for material textures, and the writer of rendered frames:
stdlib zlib + numpy, no imaging library.

Decodes 8-bit RGB and RGBA, non-interlaced PNGs -- every texture of the
bundled courtyard asset -- to (H, W, 4) u8 RGBA (RGB gains alpha 255).
All five scanline filters are undone, Paeth included.  Every other kind
(palette, grey, 16-bit, interlaced) raises PngError: a texture that
cannot be decoded must not render silently untextured.  `encode_png`
writes (H, W, 3) u8 RGB as an 8-bit RGB PNG (filter 0 on every row).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}           # colour type -> samples per pixel


class PngError(ValueError):
    pass


def _chunks(raw: bytes):
    off = len(SIGNATURE)
    while off + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[off:off + 8])
        data = raw[off + 8:off + 8 + length]
        if len(data) != length:
            raise PngError("truncated chunk")
        yield kind, data
        if kind == b"IEND":
            return
        off += 12 + length
    raise PngError("missing IEND")


def _unfilter(filtered: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the per-row filters of (H, W, C) filtered samples.

    Each filter predicts a pixel from its left (a), upper (b) and
    upper-left (c) neighbours, so pixels on one anti-diagonal r + x = s
    are independent: the loop runs over the H + W - 1 diagonals and each
    step reconstructs a whole diagonal, every row with its own filter.
    """
    h, w, ch = filtered.shape
    f = filtered.astype(np.int32)
    # out[r + 1, x + 1] holds pixel (r, x); row 0 / column 0 are the
    # zero neighbours the filters see outside the image
    out = np.zeros((h + 1, w + 1, ch), np.int32)
    ft = ftype.astype(np.int32)
    for s in range(h + w - 1):
        r = np.arange(max(0, s - w + 1), min(h, s + 1))
        x = s - r
        a = out[r + 1, x]
        b = out[r, x + 1]
        c = out[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        t = ft[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, paeth, 0))))
        out[r + 1, x + 1] = (f[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(raw: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) u8 RGBA."""
    if raw[:8] != SIGNATURE:
        raise PngError("not a PNG")
    header = None
    idat = []
    for kind, data in _chunks(raw):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise PngError("missing IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise PngError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} (only 8-bit RGB/RGBA, non-interlaced)")
    if comp != 0 or filt != 0:
        raise PngError("unknown PNG compression or filter method")
    ch = _CHANNELS[ctype]
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if stream.size != h * (w * ch + 1):
        raise PngError("image data size does not match the header")
    rows = stream.reshape(h, w * ch + 1)
    ftype = rows[:, 0]
    if np.any(ftype > 4):
        raise PngError("unknown scanline filter type")
    img = _unfilter(rows[:, 1:].reshape(h, w, ch), ftype)
    if ch == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return img


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 RGB -> PNG bytes (8-bit RGB, non-interlaced)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise PngError(f"encode_png takes (H, W, 3) u8, got "
                       f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
