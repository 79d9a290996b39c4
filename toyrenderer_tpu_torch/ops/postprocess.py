"""Final post-process: exposure, tonemap, sRGB encode, u8 quantize.

Counterpart of toyrenderer_tpu/ops/postprocess.py (reference:
PostProcessRenderer.cpp + postprocess.hlsl:44-69: bloom lerp, exposure
scale, Khronos PBR-neutral tonemap, linear -> sRGB).
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops.packing import linear_to_srgb


def tonemap_pbr_neutral(color):
    """Khronos PBR Neutral tonemapper; color >= 0 HDR in, [0,1] out."""
    start_compression = 0.8 - 0.04
    desaturation = 0.15

    x = torch.amin(color, dim=-1, keepdim=True)
    offset = torch.where(x < 0.08, x - 6.25 * x * x, 0.04)
    c = color - offset

    peak = torch.amax(c, dim=-1, keepdim=True)
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / torch.clamp(peak + d - start_compression,
                                         min=1e-6)
    scale = new_peak / torch.clamp(peak, min=1e-6)
    g = 1.0 - 1.0 / (desaturation * torch.clamp(peak - new_peak, min=0.0)
                     + 1.0)
    out = torch.where(peak > start_compression,
                      c * scale * (1.0 - g) + new_peak * g, c)
    return torch.clamp(out, 0.0, 1.0)


def compose_final(hdr, exposure=1.0, bloom=None,
                  bloom_strength: float = 0.04):
    """HDR (H, W, 3) -> sRGB u8 (H, W, 3); `bloom` (H, W, 3) is lerped
    in at `bloom_strength` first."""
    if bloom is not None:
        hdr = hdr * (1.0 - bloom_strength) + bloom * bloom_strength
    x = tonemap_pbr_neutral(hdr * exposure)
    x = linear_to_srgb(x)
    return torch.clamp(x * 255.0 + 0.5, 0, 255).to(torch.uint8)
