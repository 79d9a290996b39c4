"""Hierarchical Z-buffer (HZB): build and conservative occlusion queries.

Counterpart of toyrenderer_tpu/ops/hzb.py (reference: depth -> min-
downsampled mip0 -> min-reduced mip chain, BasePassRenderers.cpp:505-542,
sampled by gpuculling.hlsl / basepass.hlsl for 2-phase occlusion
culling, culling.hlsli:36-82).

Reverse-Z: larger depth is closer.  The HZB stores the MINIMUM (farthest)
depth of each region; an occludee whose nearest depth is still smaller
(farther) than its footprint's minimum is hidden.  The mip chain is a
tuple of tensors carried across frames; a query flattens it into one
vector so a batch of boxes gathers from their own levels at once.
"""

from __future__ import annotations

import math

import torch


def _next_pow2(n: int) -> int:
    return 1 << (int(n - 1).bit_length())


def hzb_shape(width: int, height: int):
    """(mip0_h, mip0_w): half resolution, power of two."""
    return _next_pow2(height) // 2, _next_pow2(width) // 2


def num_hzb_mips(width: int, height: int) -> int:
    h0, w0 = hzb_shape(width, height)
    return int(math.log2(min(h0, w0))) + 1


def _min2x2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))


def build_hzb(depth: torch.Tensor, width: int, height: int):
    """depth (H, W) reverse-Z -> tuple of min-reduced mips.

    mip0 is (pow2(H)/2, pow2(W)/2); each next mip halves.  The padding is
    0 (infinitely far), which is conservative for occlusion."""
    h0, w0 = hzb_shape(width, height)
    p = torch.nn.functional.pad(
        depth, (0, 2 * w0 - depth.shape[1], 0, 2 * h0 - depth.shape[0]))
    mips = [_min2x2(p)]
    for _ in range(num_hzb_mips(width, height) - 1):
        mips.append(_min2x2(mips[-1]))
    return tuple(mips)


def init_hzb(width: int, height: int, device=None):
    """All-far HZB (first frame: nothing occludes)."""
    h, w = hzb_shape(width, height)
    mips = []
    for _ in range(num_hzb_mips(width, height)):
        mips.append(torch.zeros((h, w), dtype=torch.float32, device=device))
        h, w = max(h // 2, 1), max(w // 2, 1)
    return tuple(mips)


def _flatten_mips(mips):
    """(flat (sum of sizes,), offsets (n,) i64, shapes (n, 2) i64)."""
    dev = mips[0].device
    flat = torch.cat([m.reshape(-1) for m in mips])
    sizes = [m.numel() for m in mips]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(mips))],
                           dtype=torch.int64, device=dev)
    shapes = torch.tensor([tuple(m.shape) for m in mips], dtype=torch.int64,
                          device=dev)
    return flat, offsets, shapes


def hzb_level(mips, u0, v0, u1, v1, width: int, height: int):
    """The mip each box is tested at, and its corners in HZB uv.

    The level is the one at which the box spans at most 2 texels,
    ceil(log2(extent)), computed as the reference package computes it
    (natural log over log 2): a box whose extent lies within an ulp of a
    power of two would otherwise change level.  Returns (level (N,) i64,
    (u0c, v0c, u1c, v1c))."""
    h0, w0 = mips[0].shape
    # uv is over W x H; the pow2 HZB covers [0, W / (2 w0)] of itself
    su = width / (2.0 * w0)
    sv = height / (2.0 * h0)
    u0c = torch.clamp(u0, 0.0, 1.0) * su
    u1c = torch.clamp(u1, 0.0, 1.0) * su
    v0c = torch.clamp(v0, 0.0, 1.0) * sv
    v1c = torch.clamp(v1, 0.0, 1.0) * sv
    ext = torch.clamp(torch.maximum((u1c - u0c) * w0, (v1c - v0c) * h0),
                      min=1e-6)
    log2 = torch.log(ext) / torch.log(ext.new_tensor(2.0))
    level = torch.clamp(torch.ceil(log2), 0, len(mips) - 1).long()
    return level, (u0c, v0c, u1c, v1c)


def hzb_test_bbox(mips, u0, v0, u1, v1, depth_near, width: int,
                  height: int):
    """Conservative visibility of screen boxes against the HZB.

    u0, v0, u1, v1: (N,) box in [0, 1] uv over the rendered W x H image;
    depth_near: (N,) the occludee's closest depth (reverse-Z maximum).
    Returns (N,) bool: True = potentially visible (not occluded)."""
    flat, offsets, shapes = _flatten_mips(mips)
    level, (u0c, v0c, u1c, v1c) = hzb_level(mips, u0, v0, u1, v1, width,
                                             height)
    mh, mw = shapes[level, 0], shapes[level, 1]

    def texel(c, size):
        return torch.minimum((c * size.float()).to(torch.int64), size - 1)
    x0, x1 = texel(u0c, mw), texel(u1c, mw)
    y0, y1 = texel(v0c, mh), texel(v1c, mh)
    x1 = torch.minimum(x1, x0 + 1)
    y1 = torch.minimum(y1, y0 + 1)
    base = offsets[level]

    def fetch(y, x):
        return flat[base + y * mw + x]
    occ = torch.minimum(torch.minimum(fetch(y0, x0), fetch(y0, x1)),
                        torch.minimum(fetch(y1, x0), fetch(y1, x1)))
    # visible if the occludee's closest point is nearer than (or level
    # with) the farthest occluder of its footprint
    return depth_near >= occ
