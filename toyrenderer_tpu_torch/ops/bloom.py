"""Physically-based bloom: 13-tap Karis downsample + 9-tap tent upsample.

Counterpart of toyrenderer_tpu/ops/bloom.py (reference:
source/BloomRenderer.cpp + bloom.hlsl:16-129, the CoD:AW-style mip
chain: repeated 13-tap downsamples with a Karis average on the first
level, then tent-filter upsamples accumulated back up the chain).  The
chain runs planar, (C, H, W), as the reference package's does, with the
same factorisations: downsample = 2x2 average pool of the image
convolved with the diagonal cross [[1,0,1],[0,4,0],[1,0,1]]/8, and the
2x tent upsample as two 3-tap filters per axis, interleaved.
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops.taa import _pad_edge
from toyrenderer_tpu_torch.ops.texture import _avgpool2

DEFAULT_MIPS = 6


def _pad_even(img):
    _, h, w = img.shape
    return _pad_edge(img, 0, h % 2, 0, w % 2, dim=1)


def _box2(img, oy: int, ox: int):
    """Average of the 2x2 texel block at offset (oy, ox) on the stride-2
    grid: one bilinear tap at a half-texel corner."""
    img = _pad_even(img)
    _, h, w = img.shape
    p = _pad_edge(img, 2, 2, 2, 2, dim=1)
    return _avgpool2(p[:, 2 + oy:2 + oy + h, 2 + ox:2 + ox + w])


def _luma(img):
    return img[0] * 0.2127 + img[1] * 0.7152 + img[2] * 0.0722


def downsample_13tap(img, karis: bool = False):
    """(C, H, W) -> (C, ceil(H/2), ceil(W/2)), the Jimenez 13-tap
    pattern: 5 overlapping 2x2 quads, the centre one weighted .5, the
    corner ones .125; with `karis`, each quad also weighted by
    1 / (1 + luma)."""
    if not karis:
        x = _pad_even(img)
        _, h, w = x.shape
        p = _pad_edge(x, 1, 1, 1, 1, dim=1)

        def sh(dy, dx):
            return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        f = (x * 0.5 + (((sh(-1, -1) + sh(-1, 1)) + sh(1, -1)) + sh(1, 1))
             * 0.125)
        return _avgpool2(f)
    quads = [_box2(img, 0, 0), _box2(img, -1, -1), _box2(img, -1, 1),
             _box2(img, 1, -1), _box2(img, 1, 1)]
    mix = (0.5, 0.125, 0.125, 0.125, 0.125)
    num = den = None
    for q, m in zip(quads, mix):
        wq = (m / (1.0 + _luma(q)))[None]
        num = q * wq if num is None else num + q * wq
        den = wq if den is None else den + wq
    return num / torch.clamp(den, min=1e-8)


def _up2_axis(img, axis: int, out_n: int):
    """Exact 2x (bilinear-2x then tent) upsample along `axis` (1 = rows,
    2 = columns): even texels get [5, 10, 1]/16 of source k-1..k+1, odd
    ones [1, 10, 5]/16."""
    n = img.shape[axis]
    p = torch.cat([img.narrow(axis, 0, 1), img, img.narrow(axis, n - 1, 1)],
                  dim=axis)
    sm1, s0, sp1 = (p.narrow(axis, k, n) for k in range(3))
    even = ((5.0 * sm1 + 10.0 * s0) + 1.0 * sp1) * (1.0 / 16.0)
    odd = ((1.0 * sm1 + 10.0 * s0) + 5.0 * sp1) * (1.0 / 16.0)
    out = torch.stack([even, odd], dim=axis + 1)
    shape = list(img.shape)
    shape[axis] = 2 * n
    return out.reshape(shape).narrow(axis, 0, out_n)


def upsample_tent(img, out_h: int, out_w: int):
    """~2x bilinear upsample + 3x3 tent filter, separable on the even 2x
    grid (odd targets crop the last texel).  Planar (C, H, W)."""
    return _up2_axis(_up2_axis(img, 1, out_h), 2, out_w)


def bloom(hdr, num_mips: int = DEFAULT_MIPS):
    """The bloom chain on (H, W, 3) HDR; returns the full-resolution
    bloom texture (H, W, 3)."""
    x = hdr.permute(2, 0, 1)
    chain = [x]
    for i in range(num_mips):
        if min(x.shape[1], x.shape[2]) < 4:
            break
        x = downsample_13tap(x, karis=(i == 0))
        chain.append(x)
    acc = chain[-1]
    for i in range(len(chain) - 2, -1, -1):
        target = chain[i]
        acc = target + upsample_tent(acc, target.shape[1], target.shape[2])
    return (acc / len(chain)).permute(1, 2, 0).contiguous()
