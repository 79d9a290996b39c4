"""Colour and vector encodings (counterpart of toyrenderer_tpu/ops/
packing.py, itself after the reference's packunpack.hlsli): the RGBA8
texel unpack the sampler needs, the linear -> sRGB encode of the final
image, and the codecs of the DDGI probe sampler -- octahedral unit
vectors, RGB9E5 shared-exponent colour and f16 pairs.

A packed u32 is held as an int32 tensor with the same bit pattern
(`.view(np.uint32)` on its numpy array reads the u32).  The packed
4 x u32 GBuffer codecs wait with `pack_gbuffer`."""

from __future__ import annotations

import torch


def unpack_rgba8(u: torch.Tensor) -> torch.Tensor:
    """(...) int32 holding u32 RGBA8 bit patterns (r in the low byte)
    -> (..., 4) f32 in [0, 1]."""
    return torch.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF,
                        (u >> 24) & 0xFF], dim=-1).to(torch.float32) / 255.0


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308, c * 12.92,
        1.055 * torch.pow(torch.clamp(c, min=1e-8), 1.0 / 2.4) - 0.055)


# -- octahedral unit vectors (Meyer et al.) -----------------------------------

def oct_encode(n: torch.Tensor) -> torch.Tensor:
    """Unit vectors (..., 3) -> octahedral uv in [0, 1]^2 (..., 2)."""
    l1 = torch.abs(n[..., 0]) + torch.abs(n[..., 1]) + torch.abs(n[..., 2])
    p = n[..., :2] / torch.clamp(l1[..., None], min=1e-20)
    # fold the lower hemisphere
    flipped = (1.0 - torch.abs(p.flip(-1))) * torch.where(p >= 0.0, 1.0,
                                                          -1.0)
    uv = torch.where(n[..., 2:3] < 0.0, flipped, p)
    return uv * 0.5 + 0.5


def oct_decode(uv: torch.Tensor) -> torch.Tensor:
    """Octahedral uv in [0, 1]^2 (..., 2) -> unit vectors (..., 3)."""
    p = uv * 2.0 - 1.0
    z = 1.0 - torch.abs(p[..., 0]) - torch.abs(p[..., 1])
    t = torch.clamp(-z, min=0.0)
    xy = p - torch.where(p >= 0.0, 1.0, -1.0) * t[..., None]
    v = torch.cat([xy, z[..., None]], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


# -- RGB9E5 shared-exponent HDR colour ----------------------------------------

_RGB9E5_EXP_BIAS = 15
_RGB9E5_MANTISSA_BITS = 9
_RGB9E5_MAX_EXP = 31
# the largest value it holds: (511/512) * 2^(31-15) = 65408
_RGB9E5_MAX = (511.0 / 512.0) * float(2 ** (_RGB9E5_MAX_EXP
                                            - _RGB9E5_EXP_BIAS))


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^(e - 24) for integer-valued e in [0, 31], exactly: the float is
    built from its bits (exp2 is not exact on every backend)."""
    return ((e.to(torch.int32) + (127 - _RGB9E5_EXP_BIAS
                                  - _RGB9E5_MANTISSA_BITS)) << 23).view(
        torch.float32)


def pack_rgb9e5_u32(c: torch.Tensor) -> torch.Tensor:
    """HDR colour (..., 3), >= 0 -> RGB9E5 (9-bit mantissas, 5-bit
    shared exponent; the OpenGL EXT_texture_shared_exponent rounding)
    as int32 bit patterns."""
    c = torch.clamp(c, 0.0, _RGB9E5_MAX)
    maxc = torch.maximum(torch.maximum(c[..., 0], c[..., 1]), c[..., 2])
    exp_f = torch.floor(torch.log2(torch.clamp(maxc, min=1e-30))) + 1.0
    exp = torch.clamp(exp_f + _RGB9E5_EXP_BIAS, 0.0, _RGB9E5_MAX_EXP)
    scale = _pow2(exp)
    m = torch.clamp(torch.round(c / scale[..., None]), 0.0, 511.0)
    # rounding can push a mantissa to 512; bump the exponent
    bump = torch.any(m > 511.0, dim=-1)
    exp = torch.where(bump, torch.clamp(exp + 1, max=_RGB9E5_MAX_EXP), exp)
    scale = _pow2(exp)
    m = torch.clamp(torch.round(c / scale[..., None]), 0.0, 511.0).to(
        torch.int32)
    e = exp.to(torch.int32)
    return m[..., 0] | (m[..., 1] << 9) | (m[..., 2] << 18) | (e << 27)


def unpack_rgb9e5_u32(u: torch.Tensor) -> torch.Tensor:
    """int32 RGB9E5 bit patterns -> (..., 3) f32."""
    scale = _pow2((u >> 27) & 0x1F)
    return torch.stack([(u & 0x1FF), ((u >> 9) & 0x1FF),
                        ((u >> 18) & 0x1FF)], dim=-1).to(
        torch.float32) * scale[..., None]


# -- f16 pairs ----------------------------------------------------------------

def pack_half2_u32(v: torch.Tensor) -> torch.Tensor:
    """(..., 2) float -> two IEEE halves (rounded to nearest even) in one
    int32 bit pattern, the first in the low 16 bits."""
    bits = v.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    return bits[..., 0] | (bits[..., 1] << 16)


def _half_of(bits: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int32 tensors, read as halves -> f32."""
    signed = bits - ((bits >> 15) & 1) * 0x10000     # into int16's range
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def unpack_half2_u32(u: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns of two halves -> (..., 2) f32."""
    return torch.stack([_half_of(u & 0xFFFF), _half_of((u >> 16) & 0xFFFF)],
                       dim=-1)
