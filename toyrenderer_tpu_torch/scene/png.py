"""PNG decoder for material textures, and the writer of rendered frames:
stdlib zlib + numpy, no imaging library.

Decodes every PNG kind -- colour types 0 (grey), 2 (RGB), 3 (palette),
4 (grey + alpha) and 6 (RGBA) at each bit depth the format allows (1, 2,
4, 8, 16), with or without Adam7 interlacing, with `tRNS` transparency
on grey, RGB and palette images -- to (H, W, 4) u8 RGBA, as the
reference package decodes it (Pillow's `Image.open(...).convert("RGBA")`,
toyrenderer_tpu/scene/textures.py:131-132), bit for bit:

* grey at 1, 2 and 4 bits scales to 0..255 (x 255, 85, 17); 16-bit
  samples keep their high byte, except 16-bit grey, which Pillow reads
  as a 16-bit integer image and converts by clamping the value to 255;
* a `tRNS` grey or RGB colour key makes the pixels that equal it
  transparent, compared with the converted 8-bit pixel (a 1-bit key
  scaled to 0/255, the others as they are; for 16-bit RGB, the key's
  low bytes -- Pillow's own comparisons);
* palette images take each index's palette entry, alpha from `tRNS`
  (255 past its end); an index past the palette reads black.

All five scanline filters are undone, Paeth included.  A file that is
not a well-formed PNG (bad signature, chunk CRC, header or data size)
raises PngError.  `encode_png` writes (H, W, C) u8 -- grey, grey +
alpha, RGB or RGBA -- as an 8-bit PNG of that colour type (filter 0 on
every row).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


class PngError(ValueError):
    pass


def _chunks(raw: bytes):
    off = len(SIGNATURE)
    while off + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[off:off + 8])
        data = raw[off + 8:off + 8 + length]
        crc = raw[off + 8 + length:off + 12 + length]
        if len(data) != length or len(crc) != 4:
            raise PngError("truncated chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + data) & 0xFFFFFFFF:
            raise PngError(f"bad CRC in chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return
        off += 12 + length
    raise PngError("missing IEND")


def _unfilter(filtered: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the per-row filters of (H, W, C) filtered bytes (W units of C
    bytes: a pixel's bytes, or one byte where a pixel has less).

    Each filter predicts a unit from its left (a), upper (b) and
    upper-left (c) neighbours, so units on one anti-diagonal r + x = s
    are independent: the loop runs over the H + W - 1 diagonals and each
    step reconstructs a whole diagonal, every row with its own filter.
    """
    h, w, ch = filtered.shape
    f = filtered.astype(np.int32)
    # out[r + 1, x + 1] holds unit (r, x); row 0 / column 0 are the
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


def _samples(stream, pos, h, w, ch, depth):
    """One (sub-)image's samples (h, w, ch) (u8, or u16 at depth 16) from
    the filtered byte stream at pos; returns (samples, next pos)."""
    row_bytes = (w * ch * depth + 7) // 8
    n = h * (row_bytes + 1)
    if h == 0 or w == 0:
        return np.zeros((h, w, ch), np.uint16 if depth == 16
                        else np.uint8), pos
    if pos + n > stream.size:
        raise PngError("image data size does not match the header")
    rows = stream[pos:pos + n].reshape(h, row_bytes + 1)
    ftype = rows[:, 0]
    if np.any(ftype > 4):
        raise PngError("unknown scanline filter type")
    unit = max(1, ch * depth // 8)                   # bytes the filter steps
    raw = _unfilter(rows[:, 1:].reshape(h, row_bytes // unit, unit), ftype)
    raw = raw.reshape(h, row_bytes)
    if depth == 16:
        s = raw.reshape(h, w * ch, 2).astype(np.uint16)
        return ((s[..., 0] << 8) | s[..., 1]).reshape(h, w, ch), pos + n
    if depth < 8:
        bits = np.unpackbits(raw, axis=1).reshape(h, row_bytes * 8 // depth,
                                                  depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (bits * weights).sum(-1, dtype=np.uint8)
        return vals[:, :w * ch].reshape(h, w, ch), pos + n
    return raw.reshape(h, w, ch), pos + n


def _decode_samples(stream, h, w, ch, depth, interlace):
    if not interlace:
        img, pos = _samples(stream, 0, h, w, ch, depth)
    else:
        img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for r0, c0, dr, dc in _ADAM7:
            ph = max(0, -(-(h - r0) // dr))
            pw = max(0, -(-(w - c0) // dc))
            sub, pos = _samples(stream, pos, ph, pw, ch, depth)
            img[r0::dr, c0::dc] = sub
    if pos != stream.size:
        raise PngError("image data size does not match the header")
    return img


def _to_rgba(img, ctype, depth, palette, trns):
    """Samples (H, W, C) -> (H, W, 4) u8 at Pillow's convert("RGBA")."""
    h, w = img.shape[:2]
    opaque = np.full((h, w, 1), 255, np.uint8)
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        n = min(len(palette) // 3, 256)
        pal[:n, :3] = np.frombuffer(palette[:3 * n], np.uint8).reshape(n, 3)
        if trns is not None:
            a = np.frombuffer(trns[:256], np.uint8)
            pal[:a.size, 3] = a
        return pal[img[..., 0]]
    if ctype in (4, 6):
        v = (img >> 8).astype(np.uint8) if depth == 16 else img
        if ctype == 4:
            return np.concatenate([v[..., :1]] * 3 + [v[..., 1:]], -1)
        return v.astype(np.uint8)
    if ctype == 0:
        if depth == 16:                # Pillow's I;16 -> RGBA: clamp
            g = np.minimum(img, 255).astype(np.uint8)
        else:
            g = (img.astype(np.uint16) * (255 // ((1 << depth) - 1))
                 ).astype(np.uint8)
        out = np.concatenate([g] * 3 + [opaque], -1)
        if trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            # against the converted grey byte; a 1-bit key scales to 255
            out[g[..., 0] == (key * 255 if depth == 1 else key), 3] = 0
        return out
    # RGB
    v = (img >> 8).astype(np.uint8) if depth == 16 else img.astype(np.uint8)
    out = np.concatenate([v, opaque], -1)
    if trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), np.int64)
        if depth == 16:
            key = key & 0xFF
        out[(v.astype(np.int64) == key).all(-1), 3] = 0
    return out


def decode_png(raw: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) u8 RGBA (see the module docstring)."""
    if raw[:8] != SIGNATURE:
        raise PngError("not a PNG")
    header = palette = trns = None
    idat = []
    for kind, data in _chunks(raw):
        if kind == b"IHDR":
            if len(data) != 13:
                raise PngError("bad IHDR")
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = data
        elif kind == b"tRNS":
            trns = data
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise PngError("missing IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise PngError(f"invalid PNG: bit depth {depth}, colour type {ctype}")
    if comp != 0 or filt != 0 or interlace > 1:
        raise PngError("unknown PNG compression, filter or interlace method")
    if ctype == 3 and palette is None:
        raise PngError("palette image without PLTE")
    try:
        stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PngError(f"corrupt image data: {e}") from None
    img = _decode_samples(stream, h, w, _CHANNELS[ctype], depth, interlace)
    return _to_rgba(img, ctype, depth, palette, trns)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


_CTYPE_OF = {1: 0, 2: 4, 3: 2, 4: 6}          # samples -> colour type


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) u8 -> PNG bytes, 8 bits a sample,
    non-interlaced, filter 0 on every row: C = 1 grey, 2 grey + alpha,
    3 RGB, 4 RGBA (what a texture writer and the frame writer need)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if (img.dtype != np.uint8 or img.ndim != 3
            or img.shape[-1] not in _CTYPE_OF):
        raise PngError(f"encode_png takes (H, W[, 1-4]) u8, got "
                       f"{img.shape} {img.dtype}")
    h, w, ch = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * ch)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _CTYPE_OF[ch], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
