"""Deferred lighting composite.

Counterpart of toyrenderer_tpu/ops/lighting.py (reference:
source/DeferredLightingRenderer.cpp + deferredlighting.hlsl): read the
GBuffer shading planes, evaluate the directional sun BRDF, add ambient
and emissive, and write sky radiance where no geometry was rasterized
(depth == 0); the sun term is multiplied by the shadow mask when one is
given, and the ambient term -- the probe irradiance when GI is on, else
the constant ambient -- by the AO.  The GBuffer is read through
gbuffer.unpack_gbuffer (float planes or the packed words).  Also the
14 debug views (`debug_view`, the reference's ShaderInterop.h:26-38
modes).
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops import brdf
from toyrenderer_tpu_torch.ops import sky as sky_mod
from toyrenderer_tpu_torch.ops.gbuffer import unpack_gbuffer

# debug view modes (RenderSettings.debug_mode)
DEBUG_NONE = 0
DEBUG_ALBEDO = 1
DEBUG_NORMAL = 2
DEBUG_ROUGHNESS = 3
DEBUG_METALLIC = 4
DEBUG_EMISSIVE = 5
DEBUG_DEPTH = 6
DEBUG_MOTION = 7
DEBUG_SHADOW = 8
DEBUG_AO = 9
DEBUG_GI = 10
DEBUG_MESHLET = 11
DEBUG_LOD = 12
DEBUG_UV = 13
DEBUG_MIP = 14   # texture-feedback / MinMip viewer


def world_pos_from_depth(depth, inv_view_proj, width, height):
    """Reconstruct world position from reverse-Z depth."""
    h, w = depth.shape
    dev = depth.device
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5
          )[None, :].expand(h, w)
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5
          )[:, None].expand(h, w)
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = (0.5 - py / height) * 2.0
    clip = torch.stack([ndc_x, ndc_y, depth, torch.ones_like(depth)], -1)
    wp = torch.matmul(clip, inv_view_proj.T)
    return wp[..., :3] / torch.where(
        torch.abs(wp[..., 3:4]) < 1e-20, 1e-20, wp[..., 3:4])


def deferred_lighting(gb: dict, cam_pos, inv_view_proj, sun_direction,
                      sun_color, sun_intensity, sky_fn,
                      ambient_factor: float = 0.03, shadow_mask=None,
                      ao=None, gi_irradiance=None):
    """HDR lighting (H, W, 3).  sky_fn: callable(dirs (..., 3)) ->
    (..., 3) sky radiance (Hosek or Preetham, chosen by the frame);
    shadow_mask: optional (H, W) sun visibility (1 = lit); ao: optional
    (H, W) ambient occlusion (1 = open); gi_irradiance: optional
    (H, W, 3) probe irradiance, which replaces the constant ambient."""
    m = unpack_gbuffer(gb)
    depth = m['depth']
    h, w = depth.shape
    hit = depth > 0.0
    albedo = m['albedo']

    world_pos = world_pos_from_depth(depth, inv_view_proj, w, h)
    view_dir = cam_pos - world_pos
    view_dir = view_dir / torch.clamp(
        torch.linalg.vector_norm(view_dir, dim=-1, keepdim=True), min=1e-8)
    light_dir = -sun_direction                      # surface -> sun

    radiance = brdf.shade_directional(
        m['normal'], view_dir, light_dir.expand(view_dir.shape), albedo,
        m['roughness'], m['metallic'])
    lit = radiance * (sun_color * sun_intensity)
    if shadow_mask is not None:
        lit = lit * shadow_mask[..., None]
    if gi_irradiance is not None:
        ambient = gi_irradiance * albedo
    else:
        ambient = albedo * ambient_factor * sun_intensity
    if ao is not None:
        ambient = ambient * ao[..., None]
    lit = lit + ambient + m['emissive']

    sky_rgb = sky_fn(sky_mod.view_rays(inv_view_proj, w, h))
    return torch.where(hit[..., None], lit, sky_rgb)


# 3x5 bitmap digits 0-9 (rows top-down, 3-bit masks) for the MinMip
# overlay: the function of the reference's SDF digit atlas
# (visualizeminmip.hlsl) without font data
_DIGITS = (
    (0b111, 0b101, 0b101, 0b101, 0b111),   # 0
    (0b010, 0b110, 0b010, 0b010, 0b111),   # 1
    (0b111, 0b001, 0b111, 0b100, 0b111),   # 2
    (0b111, 0b001, 0b111, 0b001, 0b111),   # 3
    (0b101, 0b101, 0b111, 0b001, 0b001),   # 4
    (0b111, 0b100, 0b111, 0b001, 0b111),   # 5
    (0b111, 0b100, 0b111, 0b101, 0b111),   # 6
    (0b111, 0b001, 0b010, 0b010, 0b010),   # 7
    (0b111, 0b101, 0b111, 0b101, 0b111),   # 8
    (0b111, 0b101, 0b111, 0b001, 0b111),   # 9
)


def _digit_overlay(img, values, block: int = 32, scale: int = 3):
    """Draw each 32 px block's floor(value) as a bitmap digit (white on
    a darkened pad) in its top-left corner; negative values draw
    nothing."""
    h, w = values.shape
    dev = values.device
    py = torch.arange(h, device=dev)[:, None].expand(h, w)
    px = torch.arange(w, device=dev)[None, :].expand(h, w)

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode='floor')
    # the value at each pixel's block origin, so the whole block agrees
    v = values[fdiv(py, block) * block, fdiv(px, block) * block]
    d = torch.clamp(torch.floor(v), 0, 9).long()
    ly = torch.remainder(py, block) - 2
    lx = torch.remainder(px, block) - 2
    fy = fdiv(ly, scale)
    fx = fdiv(lx, scale)
    inside = (ly >= 0) & (lx >= 0) & (fy < 5) & (fx < 3) & (v >= 0)
    digits = torch.tensor(_DIGITS, dtype=torch.int64, device=dev)
    rows = digits[d, torch.clamp(fy, 0, 4)]
    on = ((rows >> (2 - torch.clamp(fx, 0, 2))) & 1) == 1
    pad = (ly >= -1) & (lx >= -1) & (fy <= 5) & (fx <= 3) & (v >= 0)
    img = torch.where(pad[..., None], img * 0.35, img)
    return torch.where((inside & on)[..., None], 1.0, img)


def _grey(x):
    return x[..., None].expand(*x.shape, 3)


def debug_view(gb: dict, mode: int, extras: dict | None = None):
    """The debug visualizations (H, W, 3) of the GBuffer and the frame's
    intermediate planes (reference package, lighting.py:112-178).
    extras: motion, uv, tex_desired_mip, shadow, ao, tri_id, each when
    the frame has it.  A mode whose plane is missing, DEBUG_GI and
    DEBUG_LOD (which have no view in the reference either) and mode 0
    show the albedo."""
    m = unpack_gbuffer(gb)
    extras = extras or {}
    if mode == DEBUG_ALBEDO:
        return m['albedo']
    if mode == DEBUG_NORMAL:
        return m['normal'] * 0.5 + 0.5
    if mode == DEBUG_ROUGHNESS:
        return _grey(m['roughness'])
    if mode == DEBUG_METALLIC:
        return _grey(m['metallic'])
    if mode == DEBUG_EMISSIVE:
        return m['emissive']
    if mode == DEBUG_DEPTH:
        # normalized by the frame's nearest depth: a reduction that stays
        # on the device
        d = m['depth']
        return _grey(d / torch.clamp(d.max(), min=1e-8))
    if mode == DEBUG_MOTION and 'motion' in extras:
        mo = extras['motion']
        return torch.stack([torch.abs(mo[..., 0]), torch.abs(mo[..., 1]),
                            torch.zeros_like(mo[..., 0])], -1) * 0.1
    if mode == DEBUG_SHADOW and 'shadow' in extras:
        return _grey(extras['shadow'])
    if mode == DEBUG_AO and 'ao' in extras:
        return _grey(extras['ao'])
    if mode == DEBUG_UV and 'uv' in extras:
        uv = extras['uv']
        return torch.stack([torch.remainder(uv[..., 0], 1.0),
                            torch.remainder(uv[..., 1], 1.0),
                            torch.zeros_like(uv[..., 0])], -1)
    if mode == DEBUG_MIP and 'tex_desired_mip' in extras:
        # fine mips hot (red), coarse cool (blue), untextured grey, and
        # each 32 px block's mip as a digit
        mip = extras['tex_desired_mip']
        t = torch.clamp(mip / 10.0, 0.0, 1.0)
        color = torch.stack([1.0 - t, 0.2 + 0.3 * t, t], -1)
        img = torch.where((mip >= 0)[..., None], color, 0.3)
        return _digit_overlay(img, mip)
    if mode == DEBUG_MESHLET and 'tri_id' in extras:
        # a hash of the meshlet (96 triangle slots each), mod 2^32
        tid = torch.div(torch.clamp(extras['tri_id'], min=0).long(), 96,
                        rounding_mode='floor')
        c = (tid * 2654435761) & 0xFFFFFFFF
        return torch.stack([(c & 0xFF), ((c >> 8) & 0xFF),
                            ((c >> 16) & 0xFF)], -1).to(torch.float32) / 255.0
    return m['albedo']
