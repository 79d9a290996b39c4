"""The rasterized sun shadow map.

Counterpart of toyrenderer_tpu/ops/shadowmap.py: an orthographic depth
map from the sun, rendered with the frame's raster front end and the
L-layer peel fill (K2, ops/peel_cuda.py) at one layer, then sampled with
one bilinear depth-compare tap per 2x2 quad (`sample_shadow_map`, the
ShadowMask pass's raw mask) or per point (`sample_shadow_map_points`,
the DDGI probe hits' sun taps).  The map is quad-row expanded
(`quad_expand_map`) so a tap is one row gather.

`render_shadow_map` takes the reference's accelerator branch on every
device: content-sized streamed caps (`_content_caps`), the tile-sorted
pair stream and the peel fill.  The reference's CPU branch (the dense
XLA fill, K clamped to 1024) is not carried: it drops casters on dense
scenes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from toyrenderer_tpu_torch.ops import geometry as geo_mod
from toyrenderer_tpu_torch.ops import raster as raster_mod
from toyrenderer_tpu_torch.ops.peel_cuda import fill_peel_stream
from toyrenderer_tpu_torch.ops.raster import RasterConfig
from toyrenderer_tpu_torch.ops.raster_cuda import bin_pairs_with_budget
from toyrenderer_tpu_torch.ops.shadows import interleaved_gradient_noise


def sun_ortho_matrix(world_aabb, sun_direction) -> np.ndarray:
    """Orthographic sun view-projection covering the scene AABB (host).

    Output clip: x,y in [-1,1], z in [0,1] with 1 == closest to the sun
    (the raster's reverse-Z 'greater wins' convention), w == 1.
    """
    d = np.asarray(sun_direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-8)
    up = (np.array([0.0, 1.0, 0.0]) if abs(d[1]) < 0.95
          else np.array([1.0, 0.0, 0.0]))
    right = np.cross(up, d)
    right /= max(np.linalg.norm(right), 1e-8)
    up = np.cross(d, right)

    bmin, bmax = np.asarray(world_aabb, np.float64)
    corners = np.array([[x, y, z]
                        for x in (bmin[0], bmax[0])
                        for y in (bmin[1], bmax[1])
                        for z in (bmin[2], bmax[2])])
    basis = np.stack([right, up, d], axis=0)          # rows
    proj = corners @ basis.T                          # sun-space coords
    lo = proj.min(0)
    hi = proj.max(0)
    margin = (hi - lo) * 0.01 + 1e-3
    lo -= margin
    hi += margin

    # geometry closest to the sun has the smallest d-coordinate -> 1
    m = np.zeros((4, 4), np.float64)
    m[0, :3] = right * (2.0 / (hi[0] - lo[0]))
    m[1, :3] = up * (2.0 / (hi[1] - lo[1]))
    m[2, :3] = -d / (hi[2] - lo[2])
    m[0, 3] = -(lo[0] + hi[0]) / (hi[0] - lo[0])
    m[1, 3] = -(lo[1] + hi[1]) / (hi[1] - lo[1])
    m[2, 3] = hi[2] / (hi[2] - lo[2])
    m[3, 3] = 1.0
    return m.astype(np.float32)


def shadow_map_config(resolution: int) -> RasterConfig:
    """Base sun-map raster config; render_shadow_map rescales the caps
    from the caster count (the sun view holds the whole unculled scene,
    so its per-tile density is ~10-20x the camera view's)."""
    return RasterConfig(width=resolution, height=resolution,
                        tile_h=16, tile_w=128,
                        max_tris_per_tile=256, chunk=32,
                        max_big_tris=128, tile_batch=8,
                        compact_frac=1.0, short_frac=0.5,
                        rest_frac=0.25)


def _content_caps(cfg: RasterConfig, n_tris: int) -> RasterConfig:
    """The streamed fill's caps from the caster-stream length (reference
    package, shadowmap.py:83, `streamed=True`): K at 8x the mean per-tile
    density, rounded up to 128, within [1024, 32768] (the fill's cost
    tracks the real counts, so K is only a clamp); B = 2048."""
    avg = max(n_tris / cfg.num_tiles, 1.0)
    want = -(-int(8 * avg) // 128) * 128
    return dataclasses.replace(cfg, max_tris_per_tile=min(max(want, 1024),
                                                          32768),
                               max_big_tris=2048)


def render_shadow_map(scene, inst_world, pair_inst, pair_meshlet,
                      sun_view_proj, cfg: RasterConfig, tri_keep=None):
    """Depth from the sun through the raster pipeline (reference package,
    shadowmap.py:104), over the FULL pair list: off-screen geometry casts
    shadows.  Every caster is drawn double-sided.  tri_keep: optional (T,)
    bool per pair-stream triangle, the masked set's alpha-coverage keep.
    Returns (depth (S, S) f32, 0 = nothing; dropped, the summed overflow
    counters of binning and of the fill's chunk budget: a dropped caster
    is a light leak)."""
    geo = geo_mod.meshlet_clip_triangles(
        scene, inst_world, sun_view_proj, pair_inst, pair_meshlet)
    if tri_keep is not None:
        geo = dict(geo, tri_valid=geo['tri_valid'] & tri_keep)
    geo = dict(geo, double_sided=torch.ones_like(geo['double_sided']))
    cfg = _content_caps(cfg, geo['tri_valid'].shape[0])
    setup = raster_mod.setup_triangles(geo, cfg)
    bins = bin_pairs_with_budget(setup, cfg)
    z, _ = fill_peel_stream(setup, bins, cfg, layers=1)
    return z[0], sum(bins['drop'].values())


def quad_expand_map(depth):
    """(S, S) -> (S*S, 4) rows of each texel's 2x2 footprint (clamped)."""
    xp = torch.cat([depth[:, 1:], depth[:, -1:]], dim=1)
    yp = torch.cat([depth[1:], depth[-1:]], dim=0)
    xyp = torch.cat([yp[:, 1:], yp[:, -1:]], dim=1)
    return torch.stack([depth, xp, yp, xyp], -1).reshape(-1, 4)


def _tap(map_quads, resolution: int, x, y, z):
    """Percentage-closer bilinear tap: each footprint texel compared
    (lit where the map is not nearer the sun than z), then mixed."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = torch.clamp(x0, 0, resolution - 1).to(torch.int64)
    yi = torch.clamp(y0, 0, resolution - 1).to(torch.int64)
    quad = map_quads[yi * resolution + xi]
    lit4 = (quad <= z[..., None]).to(torch.float32)
    return ((lit4[..., 0] * (1 - fx) + lit4[..., 1] * fx) * (1 - fy)
            + (lit4[..., 2] * (1 - fx) + lit4[..., 3] * fx) * fy)


def sample_shadow_map_points(map_quads, resolution: int, sun_view_proj,
                             points, bias: float = 3e-3):
    """Sun visibility of world points (N, 3) -> (N,) in [0, 1]: one
    bilinear depth-compare tap each, no jitter (the DDGI probe hits' sun
    taps, reference package shadowmap.py:152).  Points outside the map
    count as lit."""
    ph = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    clip = ph @ sun_view_proj.T
    u = clip[..., 0] * 0.5 + 0.5
    v = 0.5 - clip[..., 1] * 0.5
    s = float(resolution)
    lit = _tap(map_quads, resolution, u * s - 0.5, v * s - 0.5,
               clip[..., 2] + bias)
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return torch.where(inside, lit, 1.0)


def sample_shadow_map(map_quads, resolution: int, sun_view_proj,
                      world_pos, normal, sun_dir_to_light, hit_mask,
                      frame_index, bias: float = 2e-3,
                      jitter_texels: float = 1.0):
    """The raw sun mask (H, W) f32, 1 = lit (reference package,
    shadowmap.py:184): one temporally jittered bilinear depth-compare
    tap per 2x2 quad at the quad's mean world position (per pixel for
    odd sizes), expanded to full resolution; back-facing pixels (n.l <=
    0) are shadowed and pixels off the geometry lit.  The mask is a
    1-spp stochastic signal for the temporal + spatial denoiser."""
    h, w = hit_mask.shape
    quad_rate = h % 2 == 0 and w % 2 == 0
    if quad_rate:
        hq, wq = h // 2, w // 2
        # the quad's four positions summed in row-major order, as the
        # reference's 2x2 window sum adds them
        p = world_pos
        wp = (((p[0::2, 0::2] + p[0::2, 1::2]) + p[1::2, 0::2])
              + p[1::2, 1::2]) * 0.25
    else:
        hq, wq = h, w
        wp = world_pos
    ph = torch.cat([wp, torch.ones_like(wp[..., :1])], -1)
    clip = torch.einsum('ij,...j->...i', sun_view_proj, ph)
    u = clip[..., 0] * 0.5 + 0.5
    v = 0.5 - clip[..., 1] * 0.5
    r1 = interleaved_gradient_noise(hq, wq, frame_index)
    r2 = interleaved_gradient_noise(hq, wq, frame_index + 29)
    s = float(resolution)
    x = u * s - 0.5 + (r1 - 0.5) * 2.0 * jitter_texels
    y = v * s - 0.5 + (r2 - 0.5) * 2.0 * jitter_texels
    lit = _tap(map_quads, resolution, x, y, clip[..., 2] + bias)
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    lit = torch.where(inside, lit, 1.0)
    if quad_rate:
        lit = lit.repeat_interleave(2, 0).repeat_interleave(2, 1)
    ndotl = torch.sum(normal * sun_dir_to_light, -1)
    lit = torch.where(ndotl <= 0.0, 0.0, lit)
    return torch.where(hit_mask, lit, 1.0)
