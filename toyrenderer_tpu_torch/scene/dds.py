"""DDS texture file loader with BC block decompression (host side, numpy).

The port's own copy of toyrenderer_tpu/scene/dds.py (reference: the DDS
path of source/TextureLoading.cpp:635-781: legacy + DX10 header parsing,
per-mip offsets with BC-block-aware pitches, streaming per-mip reads).
Mips are decompressed to RGBA8 on load (vectorized block decode) and fed
to the mip atlas, as the reference package does: its sampler reads the
atlas's RGBA8 texel rows, not block-compressed data.

Supported: BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4, BC5, and common
uncompressed RGBA8/BGRA8 layouts.  Unsupported formats fall back to None.
"""

from __future__ import annotations

import struct

import numpy as np

DDS_MAGIC = 0x20534444          # 'DDS '
DDPF_FOURCC = 0x4
DDPF_RGB = 0x40

_FOURCC = {
    b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3",
    b"ATI1": "BC4", b"BC4U": "BC4", b"ATI2": "BC5", b"BC5U": "BC5",
}
_DXGI = {
    71: "BC1", 72: "BC1", 74: "BC2", 75: "BC2", 77: "BC3", 78: "BC3",
    80: "BC4", 83: "BC5", 28: "RGBA8", 29: "RGBA8", 87: "BGRA8",
    88: "BGRA8", 91: "BGRA8",
}
_BLOCK_BYTES = {"BC1": 8, "BC2": 16, "BC3": 16, "BC4": 8, "BC5": 16}


def parse_dds_header(data: bytes):
    """Returns (format str, width, height, mip_count, data_offset) or None."""
    if len(data) < 128 or struct.unpack_from("<I", data, 0)[0] != DDS_MAGIC:
        return None
    (size, flags, height, width, pitch, depth, mips) = struct.unpack_from(
        "<7I", data, 4)
    mips = max(mips, 1)
    # DDS_PIXELFORMAT at byte 80: size, flags, fourCC, bitcount, masks
    pf_flags, = struct.unpack_from("<I", data, 84)
    offset = 128
    fmt = None
    if pf_flags & DDPF_FOURCC:
        cc = data[88:92]
        if cc == b"DX10":
            dxgi, = struct.unpack_from("<I", data, 128)
            fmt = _DXGI.get(dxgi)
            offset = 148
        else:
            fmt = _FOURCC.get(cc)
    elif pf_flags & DDPF_RGB:
        rgb_bits, rmask = struct.unpack_from("<II", data, 92)
        if rgb_bits == 32:
            fmt = "RGBA8" if rmask == 0x000000FF else "BGRA8"
    if fmt is None:
        return None
    return fmt, width, height, mips, offset


def mip_byte_size(fmt: str, w: int, h: int) -> int:
    if fmt in _BLOCK_BYTES:
        return max(w + 3, 4) // 4 * (max(h + 3, 4) // 4) * _BLOCK_BYTES[fmt]
    return w * h * 4


def _decode_bc1_colors(blocks_u16: np.ndarray, allow_alpha: bool,
                       force_four: bool = False):
    """blocks_u16: (N, 2) c0, c1 -> palette (N, 4, 4) u8 RGBA.

    force_four: BC2/BC3 color blocks are ALWAYS 4-color mode per the DX
    spec, regardless of endpoint order; only standalone BC1 switches to
    3-color + transparent when c0 <= c1.
    """
    def c565(c):
        r = ((c >> 11) & 31).astype(np.uint32) * 255 // 31
        g = ((c >> 5) & 63).astype(np.uint32) * 255 // 63
        b = (c & 31).astype(np.uint32) * 255 // 31
        return np.stack([r, g, b], -1).astype(np.int32)
    c0 = c565(blocks_u16[:, 0])
    c1 = c565(blocks_u16[:, 1])
    pal = np.zeros((len(c0), 4, 4), np.int32)
    pal[:, :, 3] = 255
    pal[:, 0, :3] = c0
    pal[:, 1, :3] = c1
    if force_four:
        four = np.ones(len(c0), bool)
    else:
        four = blocks_u16[:, 0] > blocks_u16[:, 1]
    pal[:, 2, :3] = np.where(four[:, None],
                             (2 * c0 + c1) // 3, (c0 + c1) // 2)
    pal[:, 3, :3] = np.where(four[:, None], (c0 + 2 * c1) // 3, 0)
    if allow_alpha:
        pal[:, 3, 3] = np.where(four, 255, 0)
    return pal.astype(np.uint8)


def _bc1_rgba(raw: np.ndarray, nb: int, allow_alpha: bool,
              force_four: bool = False):
    """raw (nb, 8) u8 -> (nb, 4, 4, 4) u8 texel blocks."""
    colors = raw[:, :4].view("<u2").reshape(nb, 2)
    pal = _decode_bc1_colors(colors, allow_alpha, force_four)
    bits = raw[:, 4:8].view("<u4").reshape(nb)
    idx = np.zeros((nb, 16), np.uint8)
    for t in range(16):
        idx[:, t] = (bits >> (2 * t)) & 3
    out = pal[np.arange(nb)[:, None], idx]            # (nb, 16, 4)
    return out.reshape(nb, 4, 4, 4)


def _bc_alpha8(raw8: np.ndarray, nb: int):
    """BC3/BC4/BC5 interpolated alpha block (nb, 8) u8 -> (nb, 4, 4) u8."""
    a0 = raw8[:, 0].astype(np.int32)
    a1 = raw8[:, 1].astype(np.int32)
    pal = np.zeros((nb, 8), np.int32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    gt = a0 > a1
    for i in range(1, 7):                 # palette entries 2..7
        eight = ((7 - i) * a0 + i * a1) // 7
        if i <= 4:
            six = ((5 - i) * a0 + i * a1) // 5
        else:
            six = np.full_like(a0, 0 if i == 5 else 255)
        pal[:, i + 1] = np.where(gt, eight, six)
    bits = np.zeros(nb, np.uint64)
    for k in range(6):
        bits |= raw8[:, 2 + k].astype(np.uint64) << np.uint64(8 * k)
    idx = np.zeros((nb, 16), np.uint8)
    for t in range(16):
        idx[:, t] = ((bits >> np.uint64(3 * t)) & np.uint64(7)).astype(
            np.uint8)
    out = pal[np.arange(nb)[:, None], idx].astype(np.uint8)
    return out.reshape(nb, 4, 4)


def decode_mip(fmt: str, data: bytes, w: int, h: int) -> np.ndarray | None:
    """One mip -> (h, w, 4) u8 RGBA."""
    if fmt == "RGBA8":
        return np.frombuffer(data, np.uint8, w * h * 4).reshape(h, w, 4)
    if fmt == "BGRA8":
        img = np.frombuffer(data, np.uint8, w * h * 4).reshape(h, w, 4)
        return img[..., [2, 1, 0, 3]]
    if fmt not in _BLOCK_BYTES:
        return None
    bw, bh = max(w + 3, 4) // 4, max(h + 3, 4) // 4
    nb = bw * bh
    bb = _BLOCK_BYTES[fmt]
    raw = np.frombuffer(data, np.uint8, nb * bb).reshape(nb, bb)
    if fmt == "BC1":
        blocks = _bc1_rgba(raw, nb, allow_alpha=True)
    elif fmt == "BC2":
        blocks = _bc1_rgba(raw[:, 8:], nb, allow_alpha=False,
                           force_four=True)
        a4 = raw[:, :8].view("<u8").reshape(nb)
        for t in range(16):
            blocks[:, t // 4, t % 4, 3] = (
                ((a4 >> np.uint64(4 * t)) & np.uint64(15)).astype(np.uint32)
                * 17).astype(np.uint8)
    elif fmt == "BC3":
        blocks = _bc1_rgba(raw[:, 8:], nb, allow_alpha=False,
                           force_four=True)
        blocks[..., 3] = _bc_alpha8(raw[:, :8], nb)
    elif fmt == "BC4":
        r = _bc_alpha8(raw, nb)
        blocks = np.zeros((nb, 4, 4, 4), np.uint8)
        blocks[..., 0] = r
        blocks[..., 3] = 255
    else:  # BC5
        r = _bc_alpha8(raw[:, :8], nb)
        g = _bc_alpha8(raw[:, 8:], nb)
        blocks = np.zeros((nb, 4, 4, 4), np.uint8)
        blocks[..., 0] = r
        blocks[..., 1] = g
        blocks[..., 3] = 255
    img = blocks.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(bh * 4, bw * 4, 4)
    return img[:h, :w]


def load_dds(data: bytes) -> list[np.ndarray] | None:
    """Full mip chain of RGBA8 images, or None if unsupported."""
    hdr = parse_dds_header(data)
    if hdr is None:
        return None
    fmt, w, h, mips, off = hdr
    out = []
    for m in range(mips):
        mw, mh = max(w >> m, 1), max(h >> m, 1)
        n = mip_byte_size(fmt, mw, mh)
        if off + n > len(data):
            break
        img = decode_mip(fmt, data[off:off + n], mw, mh)
        if img is None:
            return None
        out.append(img)
        off += n
    return out if out else None
