"""Colour and vector encodings (counterpart of toyrenderer_tpu/ops/
packing.py, itself after the reference's packunpack.hlsli): the packed
4 x u32 GBuffer's codecs -- octahedral normals in 2 x 16 bits, RGBA8,
R10G10B10A2 and unit vectors in 10:10:10 --, the linear -> sRGB encode
of the final image, and the codecs of the DDGI probe sampler --
octahedral unit vectors, RGB9E5 shared-exponent colour and f16 pairs.

A packed u32 is held as an int32 tensor with the same bit pattern
(`.view(np.uint32)` on its numpy array reads the u32); the unpackers
also take int64 tensors holding the u32 values.  The packers assemble
the word in int64 (PyTorch has no u32 arithmetic) and round and clamp
as the reference does: clip(x * max + 0.5, 0, max), truncated."""

from __future__ import annotations

import torch


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values in [0, 2^32) -> int32 tensors of the same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def _unorm(x: torch.Tensor, top: float) -> torch.Tensor:
    """clip(x * top + 0.5, 0, top) truncated to an integer (int64)."""
    return torch.clamp(x * top + 0.5, 0.0, top).to(torch.int64)


def unpack_rgba8(u: torch.Tensor) -> torch.Tensor:
    """(...) int32 holding u32 RGBA8 bit patterns (r in the low byte)
    -> (..., 4) f32 in [0, 1]."""
    return torch.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF,
                        (u >> 24) & 0xFF], dim=-1).to(torch.float32) / 255.0


unpack_rgba8_u32 = unpack_rgba8


def pack_rgba8_u32(c: torch.Tensor) -> torch.Tensor:
    """(..., 4) in [0, 1] -> RGBA8 (r in the low byte) as int32 bits."""
    q = _unorm(c, 255.0)
    return u32_bits(q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
                 | (q[..., 3] << 24))


def pack_r10g10b10a2_u32(c: torch.Tensor) -> torch.Tensor:
    """(..., 4) in [0, 1] -> 10/10/10/2-bit unorm as int32 bits (the
    packed vertex normal format, ShaderInterop.h:278-283)."""
    q = _unorm(c[..., :3], 1023.0)
    a = _unorm(c[..., 3], 3.0)
    return u32_bits(q[..., 0] | (q[..., 1] << 10) | (q[..., 2] << 20)
                 | (a << 30))


def unpack_r10g10b10a2_u32(u: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) 10/10/10/2 words -> (..., 4) f32 in [0, 1]."""
    f32 = torch.float32
    return torch.stack([(u & 0x3FF).to(f32) / 1023.0,
                        ((u >> 10) & 0x3FF).to(f32) / 1023.0,
                        ((u >> 20) & 0x3FF).to(f32) / 1023.0,
                        ((u >> 30) & 0x3).to(f32) / 3.0], dim=-1)


def _normalized(v: torch.Tensor) -> torch.Tensor:
    """v / |v| along the last axis of 3, |v|^2 summed as the reference's
    jnp.linalg.norm sums it on the CPU: x*x, then two fused multiply-adds
    (y*y + s, z*z + s, each rounded once; the products are exact in
    f64).  The square root is taken in f64 and rounded once, so it is
    correctly rounded on every device (the CPU's vector f32 sqrt is
    within an ulp, not exact)."""
    x, y, z = v.double().unbind(-1)
    s = (x * x).float().double()
    s = (y * y + s).float().double()
    s = (z * z + s).float().double()
    return v / torch.sqrt(s).float()[..., None]


def pack_unit_vector_r10g10b10(n: torch.Tensor) -> torch.Tensor:
    """Signed unit vectors (..., 3) -> 10:10:10 unorm-mapped int32 bits
    (the alpha bits 0)."""
    return pack_r10g10b10a2_u32(
        torch.cat([n * 0.5 + 0.5, torch.zeros_like(n[..., :1])], -1))


def unpack_unit_vector_r10g10b10(u: torch.Tensor) -> torch.Tensor:
    return _normalized(unpack_r10g10b10a2_u32(u)[..., :3] * 2.0 - 1.0)


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


def _oct_unfold(uv: torch.Tensor) -> torch.Tensor:
    """Octahedral uv in [0, 1]^2 (..., 2) -> the unnormalized vectors."""
    p = uv * 2.0 - 1.0
    z = 1.0 - torch.abs(p[..., 0]) - torch.abs(p[..., 1])
    t = torch.clamp(-z, min=0.0)
    xy = p - torch.where(p >= 0.0, 1.0, -1.0) * t[..., None]
    return torch.cat([xy, z[..., None]], dim=-1)


def oct_decode(uv: torch.Tensor) -> torch.Tensor:
    """Octahedral uv in [0, 1]^2 (..., 2) -> unit vectors (..., 3)."""
    v = _oct_unfold(uv)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def pack_normal_oct_u32(n: torch.Tensor) -> torch.Tensor:
    """Unit vectors (..., 3) -> 2 x 16-bit unorm octahedral coordinates
    (x in the low half) as int32 bits."""
    q = _unorm(oct_encode(n), 65535.0)
    return u32_bits(q[..., 0] | (q[..., 1] << 16))


def unpack_normal_oct_u32(u: torch.Tensor) -> torch.Tensor:
    f32 = torch.float32
    x = (u & 0xFFFF).to(f32) / 65535.0
    y = ((u >> 16) & 0xFFFF).to(f32) / 65535.0
    return _normalized(_oct_unfold(torch.stack([x, y], dim=-1)))


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
