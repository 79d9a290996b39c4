"""Deferred lighting composite.

Counterpart of toyrenderer_tpu/ops/lighting.py (reference:
source/DeferredLightingRenderer.cpp + deferredlighting.hlsl): read the
GBuffer shading planes, evaluate the directional sun BRDF, add ambient
and emissive, and write sky radiance where no geometry was rasterized
(depth == 0); the sun term is multiplied by the shadow mask when one is
given, and the ambient term -- the probe irradiance when GI is on, else
the constant ambient -- by the AO.  The debug views wait for their
slice.
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops import brdf
from toyrenderer_tpu_torch.ops import sky as sky_mod


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
    depth = gb['depth']
    h, w = depth.shape
    hit = depth > 0.0
    albedo = gb['albedo_f']

    world_pos = world_pos_from_depth(depth, inv_view_proj, w, h)
    view_dir = cam_pos - world_pos
    view_dir = view_dir / torch.clamp(
        torch.linalg.vector_norm(view_dir, dim=-1, keepdim=True), min=1e-8)
    light_dir = -sun_direction                      # surface -> sun

    radiance = brdf.shade_directional(
        gb['normal_f'], view_dir, light_dir.expand(view_dir.shape), albedo,
        gb['rough_f'], gb['metal_f'])
    lit = radiance * (sun_color * sun_intensity)
    if shadow_mask is not None:
        lit = lit * shadow_mask[..., None]
    if gi_irradiance is not None:
        ambient = gi_irradiance * albedo
    else:
        ambient = albedo * ambient_factor * sun_intensity
    if ao is not None:
        ambient = ambient * ao[..., None]
    lit = lit + ambient + gb['emissive_f']

    sky_rgb = sky_fn(sky_mod.view_rays(inv_view_proj, w, h))
    return torch.where(hit[..., None], lit, sky_rgb)
