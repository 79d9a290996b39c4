"""DDGI: dynamic diffuse global illumination through light-field probes.

Counterpart of toyrenderer_tpu/ops/ddgi.py (reference: the RTXGI-DDGI
integration, source/GIRenderer.cpp:23-596 and giprobetrace.hlsl): a
probe grid sized from the scene's box; each update traces
`rays_per_probe` rays per probe (spherical-Fibonacci directions rotated
per frame) closest-hit through the GI tree, shades the hits with the
direct sun (an any-hit shadow ray toward it) and the previous probe
field's irradiance, and blends the results into octahedral irradiance
(8x8 texels) and mean / mean-squared distance (16x16) probe textures
with hysteresis 0.5.  The probe lifecycle relocates probes stuck in
geometry, deactivates probes with no geometry near them (they keep 16
live rays) and tracks the update's variability for the convergence
test.  Shading samples the field trilinearly with backface and
Chebyshev-visibility weights.

The rays run through ops/bvh_cuda.traverse_auto (K3-SAH on the GI tree,
K3 on the complete tree), laid out in cones (TR_CONE_DIRS neighbouring
directions, 16 by default, x a brick of at most TR_CONE_BRICK probes,
256 by default), or with TR_GI_GDIR=1 in 32-direction x 128-probe
blocks whose every 128 rays share a direction, for the grouped-direction
kernel K5, or direction-major, 128 probes of one direction to a block,
with TR_RT_CHUNKS=1 through the chunk route (ops/rt_chunks.py, K8) or
with TR_GI_PAIRS=1 through the pair route (ops/rt_pairs.py, K6), whose
tables trace_probe_block builds once for both of its traces; the chunk
route takes precedence, as in the reference.  Texel updates are small
matrix products.  Probe textures are dense (P, T, C) tensors in the
frame's carry.  A phased block is addressed with index tensors, so
nothing here waits on the host.

`trace_probes` traces the whole volume at once (the reference's unphased
trace); the frame traces a block a frame with `trace_probe_block`.  With
TR_GI_VIS_PACK=1 the sampler fetches the 8 corners' distance moments at
one shared texel (`_sample`).  `visualize_probes` draws the probe
overlay.  Every switch is read at call time.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from toyrenderer_tpu_torch.mathlib.transforms import cross
from toyrenderer_tpu_torch.ops import packing as P
from toyrenderer_tpu_torch.ops.bvh_cuda import GROUP, traverse_auto
from toyrenderer_tpu_torch.ops.rt_pairs import BLOCK as PAIR_BLOCK
from toyrenderer_tpu_torch.ops.rt_pairs import mt_tables

IRR_RES = 8           # octahedral irradiance texels per probe side
DIST_RES = 16         # distance texels per probe side
VAR_WINDOW = 16       # kMinimumVariabilitySamples (GIRenderer.cpp:162)
HYSTERESIS = 0.5      # GIRenderer.cpp:115

# the default cone layout: CONE_DIRS neighbouring directions x a brick of
# at most CONE_BRICK probes per block of the ray stream (it groups similar
# rays so a warp walks the tree coherently; a ray's result does not depend
# on its slot); TR_CONE_DIRS / TR_CONE_BRICK change it (cone_layout)
CONE_DIRS = 16
CONE_BRICK = 256
# the gdir layout: 32 cone directions x 128 probes, so every 128
# consecutive rays share one direction (K5)
GDIR_DIRS = 32
GDIR_BRICK = GROUP

# the lifecycle (RTXGI probe relocation and classification)
BACKFACE_FRAC_THRESHOLD = 0.25    # relocate when this share hits backs
OFFSET_LIMIT = 0.45               # max |offset| / spacing per axis
FIXED_RAYS = 16                   # rays an inactive probe keeps


@dataclass(frozen=True)
class DdgiVolume:
    """The probe grid (sized from the scene's box on the host)."""
    origin: tuple          # world min corner (3,)
    spacing: tuple         # probe spacing (3,)
    counts: tuple          # probes per axis (3,)
    rays_per_probe: int = 64
    max_ray_distance: float = 1e4   # the probe rays' t_max

    @property
    def num_probes(self) -> int:
        return int(np.prod(self.counts))

    def probe_positions(self, device=None) -> torch.Tensor:
        """(P, 3) probe positions, z fastest."""
        cx, cy, cz = self.counts
        ii = np.arange(cx * cy * cz)
        grid = np.stack([ii // (cz * cy), (ii // cz) % cy, ii % cz],
                        -1).astype(np.float32)
        pos = (np.asarray(self.origin, np.float32)
               + grid * np.asarray(self.spacing, np.float32))
        return torch.from_numpy(pos).to(device)


def volume_from_aabb(bmin, bmax, max_probes_axis: int = 12,
                     rays_per_probe: int = 256) -> DdgiVolume:
    """A probe grid covering a scene box with a 2% margin, at most
    `max_probes_axis` probes along its longest side (GIRenderer.cpp:43-
    156); 256 rays per probe as the reference (DDGIShaderConfig.h)."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    ext = np.maximum(bmax - bmin, 1e-3)
    margin = ext * 0.02
    bmin = bmin - margin
    ext = ext + margin * 2
    counts = np.clip(np.ceil(ext / ext.max() * max_probes_axis), 2,
                     max_probes_axis).astype(int)
    spacing = ext / np.maximum(counts - 1, 1)
    return DdgiVolume(origin=tuple(float(x) for x in bmin),
                      spacing=tuple(float(x) for x in spacing),
                      counts=tuple(int(x) for x in counts),
                      rays_per_probe=rays_per_probe,
                      max_ray_distance=float(np.linalg.norm(ext) * 0.5))


def init_probes(volume: DdgiVolume, device=None) -> dict:
    """The initial (dark) probe state of the carry: irradiance (P, 64, 3)
    and distance moments (P, 256, 2); the lifecycle's per-probe offsets
    (P, 3) and states (P,) (1 = active); the variability (its EMA), the
    ring of its last 16 per-cycle samples, the samples since the last
    reset and the cycle's accumulator; the sun signature whose change
    restarts the convergence count."""
    p = volume.num_probes
    dev = torch.device('cpu') if device is None else device

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)
    return dict(
        ddgi_irradiance=full((p, IRR_RES * IRR_RES, 3), 0.0),
        ddgi_distance=full((p, DIST_RES * DIST_RES, 2), 0.0),
        ddgi_offset=full((p, 3), 0.0),
        ddgi_state=full((p,), 1.0),
        ddgi_variability=full((), 1.0),
        ddgi_var_ring=full((VAR_WINDOW,), 1.0),
        ddgi_var_samples=full((), 0.0),
        ddgi_var_accum=full((), 0.0),
        ddgi_sun_sig=full((7,), float('inf')),
    )


# -- ray directions and the layouts of the ray stream ------------------------

def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], -1).astype(np.float32)


def _cone_order(r: int) -> np.ndarray:
    """Permutation clustering the r Fibonacci directions into cones of
    CONE_DIRS similar directions (octant, then polar angle)."""
    d = _fibonacci_sphere(r)
    oct_id = ((d[:, 0] >= 0).astype(int) * 4
              + (d[:, 1] >= 0).astype(int) * 2 + (d[:, 2] >= 0))
    return np.lexsort((d[:, 2], oct_id)).astype(np.int32)


def _gi_gdir_enabled() -> bool:
    return os.environ.get('TR_GI_GDIR', '0') == '1'


def _gi_pairs_enabled() -> bool:
    """TR_GI_PAIRS=1: the probe rays take the pair route (K6), read at
    call time as the reference reads it (ddgi.py:177-187)."""
    return os.environ.get('TR_GI_PAIRS', '0') == '1'


def _gi_chunks_enabled() -> bool:
    """TR_RT_CHUNKS=1: the probe rays take the chunk route (K8), read at
    call time as the reference reads it (ddgi.py:190-197)."""
    return os.environ.get('TR_RT_CHUNKS', '0') == '1'


def _gi_vis_pack_enabled() -> bool:
    return os.environ.get('TR_GI_VIS_PACK', '0') == '1'


def cone_layout() -> tuple[int, int]:
    """(directions per cone, the largest brick of probes): TR_CONE_DIRS
    and TR_CONE_BRICK, 16 and 256 when unset (the reference reads them
    once, at import: its ddgi.py:137-139)."""
    return (int(os.environ.get('TR_CONE_DIRS', str(CONE_DIRS))),
            int(os.environ.get('TR_CONE_BRICK', str(CONE_BRICK))))


def _cone_block(x, r: int, pbp: int, brick: int, dirs: int):
    """Direction-major rays (r * pbp, ...) -> the blocked order (cone,
    brick, direction in cone, probe in brick)."""
    s = x.shape[1:]
    return x.reshape(r // dirs, dirs, pbp // brick, brick, *s).transpose(
        1, 2).reshape(-1, *s)


def _cone_unblock(x, r: int, pbp: int, brick: int, dirs: int):
    s = x.shape[1:]
    return x.reshape(r // dirs, pbp // brick, dirs, brick, *s).transpose(
        1, 2).reshape(-1, *s)


def _brick_for(pb: int) -> int:
    """The smallest multiple of 32 (at least 64) that covers pb probes in
    ceil(pb / brick) bricks, at most the layout's brick (cone_layout):
    padding wastes < 32 probes a brick."""
    cone_brick = cone_layout()[1]
    nb = -(-pb // cone_brick)
    per = -(-pb // nb)
    return min(cone_brick, max(64, -(-per // 32) * 32))


def _frame_rotation(frame_index) -> torch.Tensor:
    """(3, 3) per-frame rotation (a golden-angle spin about an axis that
    wanders with the frame)."""
    f = frame_index.to(torch.float32)
    a = f * 2.399963
    b = f * 1.513473 + 1.0
    axis = torch.stack([torch.sin(b), torch.cos(b) * 0.7 + 0.3,
                        torch.sin(b * 1.7)], -1)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis), min=1e-6)
    c, s = torch.cos(a), torch.sin(a)
    z = torch.zeros_like(a)
    k = torch.stack([torch.stack([z, -axis[2], axis[1]]),
                     torch.stack([axis[2], z, -axis[0]]),
                     torch.stack([-axis[1], axis[0], z])])
    eye = torch.eye(3, device=f.device)
    return eye + s * k + (1 - c) * (k @ k)


def _oct_texel_dirs(res: int, device) -> torch.Tensor:
    """(res * res, 3) directions of the octahedral texel centres."""
    u = (np.arange(res) + 0.5) / res
    uu, vv = np.meshgrid(u, u, indexing='xy')
    uv = np.stack([uu, vv], -1).reshape(-1, 2).astype(np.float32)
    return P.oct_decode(torch.from_numpy(uv).to(device))


# -- tracing ------------------------------------------------------------------

def _probe_route() -> dict:
    """traverse_auto's route switches for the probe rays: the chunk route
    with TR_RT_CHUNKS=1, else the pair route with TR_GI_PAIRS=1 (the
    reference's precedence, its ddgi.py:280-281, 665)."""
    chunks = _gi_chunks_enabled()
    return dict(chunked=chunks, pairs=_gi_pairs_enabled() and not chunks)


def trace_probes(volume: DdgiVolume, bvh, shade_rec, prev_irradiance,
                 sun_dir_to_light, sun_color, sun_intensity, frame_index,
                 sky_fn, max_steps: int = 64, sun_vis_fn=None,
                 sp_mesh=None):
    """Trace rays_per_probe rays from every probe (the reference's
    unphased trace, its ddgi.py:252-323): direction-major, closest hit
    through traverse_auto (the chunk or pair route when their switches
    are on), each hit shaded by the sun (an any-hit shadow ray, or
    `sun_vis_fn(points)`), its emission and the previous field's
    irradiance.  Returns (radiance (P, R, 3), distance (P, R),
    directions (R, 3))."""
    dev = prev_irradiance.device
    p = volume.num_probes
    r = volume.rays_per_probe
    dirs = (torch.from_numpy(_fibonacci_sphere(r)).to(dev)
            @ _frame_rotation(frame_index).T)
    pos = volume.probe_positions(dev)
    origins = pos.repeat(r, 1)                         # (R * P, 3)
    d_all = dirs.repeat_interleave(p, dim=0)
    route = _probe_route()
    res = traverse_auto(bvh, origins, d_all.contiguous(),
                        t_max=volume.max_ray_distance, max_steps=max_steps,
                        sp_mesh=sp_mesh, **route)
    hit, t = res['hit'], res['t']
    rec = shade_rec[torch.clamp(res['tri'], min=0).long()]
    n_w, albedo, emissive = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    # two-sided shading normal (probe rays hit backfaces too)
    n_w = torch.where(torch.sum(n_w * d_all, -1, keepdim=True) > 0, -n_w,
                      n_w)
    hit_pos = origins + d_all * t[:, None]
    if sun_vis_fn is not None:
        sun_vis = sun_vis_fn(hit_pos + n_w * 1e-2)
    else:
        sh = traverse_auto(bvh, (hit_pos + n_w * 1e-2).contiguous(),
                           sun_dir_to_light.expand(hit_pos.shape)
                           .contiguous(), t_max=1e4, max_steps=max_steps,
                           any_hit=True, sp_mesh=sp_mesh, **route)
        sun_vis = 1.0 - sh['hit'].to(torch.float32)
    ndotl = torch.clamp(torch.sum(n_w * sun_dir_to_light, -1), min=0.0)
    direct = (albedo / math.pi) * (ndotl * sun_vis)[:, None] * (
        sun_color * sun_intensity)
    bounce = sample_irradiance(volume, prev_irradiance, hit_pos,
                               n_w) * albedo / math.pi
    radiance = torch.where(hit[:, None], direct + emissive + bounce,
                           sky_fn(d_all))
    dist = torch.where(hit, t, 1e4)
    return (radiance.reshape(r, p, 3).transpose(0, 1),
            dist.reshape(r, p).T, dirs)


def visualize_probes(hdr, depth, volume: DdgiVolume, irradiance,
                     view_proj, cam_pos, radius_world: float | None = None,
                     probe_offset=None, patch: int = 32):
    """The probe overlay (show_gi_probes): depth-tested, fake-lit probe
    spheres in their own mean irradiance (GIDebugRenderer /
    giprobevisualization.hlsl; reference package, ddgi.py:577-630).

    The reference splats a patch x patch square per probe, probe by
    probe, at x0 = clip(int32(cx) - patch // 2, 0, w - patch) (int32
    truncates toward zero, left of the screen too), and a later probe
    overwrites an earlier one where both are inside.  So a pixel shows
    the highest probe index whose patch is inside there, else the HDR:
    here one scatter (amax) of probe indices over every patch's inside
    pixels, then one gather of the winner's colour."""
    h, w = depth.shape
    if h < patch or w < patch:
        raise ValueError(f"a {w}x{h} frame cannot hold a {patch} px patch")
    dev = hdr.device
    if radius_world is None:
        radius_world = float(min(volume.spacing)) * 0.12
    pos = volume.probe_positions(dev)                      # (P, 3)
    if probe_offset is not None:
        pos = pos + probe_offset
    n = pos.shape[0]
    clip = torch.cat([pos, torch.ones_like(pos[:, :1])], -1) @ view_proj.T
    wc = clip[:, 3]
    in_front = wc > 1e-3
    wsafe = torch.where(in_front, wc, 1.0)
    sx = (clip[:, 0] / wsafe * 0.5 + 0.5) * w
    sy = (0.5 - clip[:, 1] / wsafe * 0.5) * h
    pd = clip[:, 2] / wsafe                                # reverse-Z depth
    dist = torch.linalg.vector_norm(pos - cam_pos[None], dim=-1)
    r_px = torch.clamp(radius_world / torch.clamp(dist, min=1e-3)
                       * 0.5 * h * 1.2, 1.0, patch * 0.45)
    mean_irr = irradiance.mean(dim=1)                      # (P, 3)

    # every probe's patch: its origin, its pixels, and where it is inside
    x0 = torch.clamp(sx.to(torch.int32) - patch // 2, 0, w - patch)
    y0 = torch.clamp(sy.to(torch.int32) - patch // 2, 0, h - patch)
    k = torch.arange(patch, dtype=torch.int32, device=dev)
    xs = x0[:, None, None] + k[None, None, :]              # (P, 1, patch)
    ys = y0[:, None, None] + k[None, :, None]              # (P, patch, 1)

    def offsets(px, py, i):
        """(dx, dy) of pixels from probe i's centre, in its radii."""
        return ((px.to(torch.float32) + 0.5 - sx[i]) / r_px[i],
                (py.to(torch.float32) + 0.5 - sy[i]) / r_px[i])
    pi = torch.arange(n, device=dev)[:, None, None]
    dx, dy = offsets(xs, ys, pi)
    inside = ((dx * dx + dy * dy < 1.0) & in_front[pi]
              & (pd[pi] > depth[ys.long(), xs.long()]))
    flat = (ys * w + xs).long().expand(n, patch, patch)
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, flat.reshape(-1),
                           torch.where(inside, pi, -1).reshape(-1), 'amax')
    winner = winner.reshape(h, w)

    # the winner's fake sphere shade at each pixel: brighter toward the
    # rim facing up
    i = torch.clamp(winner, min=0)
    py, px = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing='ij')
    dx, dy = offsets(px, py, i)
    nz = torch.sqrt(torch.clamp(1.0 - (dx * dx + dy * dy), min=0.0))
    shade = 0.3 + 0.7 * torch.clamp(nz * 0.7 - dy * 0.6, min=0.0)
    color = mean_irr[i] * shade[..., None] + 1e-3
    return torch.where((winner >= 0)[..., None], color, hdr)


def build_shade_records(scene, pair_inst, pair_meshlet, v0, v1, v2):
    """(T, 9) shading records of the pair-expanded triangles (the order
    of ops/bvh.world_triangles, whose payloads the trees carry): world
    face normal, albedo, emissive."""
    fn = cross(v1 - v0, v2 - v0)
    fn = fn / torch.clamp(torch.linalg.vector_norm(fn, dim=-1, keepdim=True),
                          min=1e-12)
    prim = scene.meshlet_prim[pair_meshlet.long()].long()
    mat = scene.prim_material[prim].long().repeat_interleave(
        scene.meshlet_tris.shape[1])
    albedo = scene.mat_base_color[mat][:, :3]
    emissive = scene.mat_emissive[mat]
    return torch.cat([fn, albedo, emissive], dim=1)


def trace_probe_block(volume: DdgiVolume, bvh, shade_rec, prev_irradiance,
                      sun_dir_to_light, sun_color, sun_intensity,
                      frame_index, sky_fn, num_phases: int,
                      max_steps: int = 64, probe_offset=None,
                      probe_state=None, sun_vis_fn=None, sp_mesh=None,
                      pair_tables=None):
    """Trace one block of ceil(P / num_phases) probes (block
    frame_index % num_phases, its start clamped so the last block ends at
    P): every ray of the block closest-hit, then each hit's shadow ray
    toward the sun any-hit (or `sun_vis_fn(points)` when given).
    Inactive probes keep only FIXED_RAYS live rays.  Returns (radiance
    (Pb, R, 3), distance (Pb, R), directions (R, 3), block start (an
    int64 tensor scalar), the lifecycle's inputs for
    update_probe_block).  With TR_RT_CHUNKS=1 both traces take the chunk
    route in direction-major order (the cone layout still orders the
    directions and pads the block); else with TR_GI_PAIRS=1 the pair
    route, with `pair_tables` (rt_pairs.mt_tables of `bvh`, built here
    for both traces when None), in direction-major order with the block
    padded to whole 128-probe blocks."""
    dev = prev_irradiance.device
    p = volume.num_probes
    pb = -(-p // num_phases)
    phase = torch.remainder(frame_index.long(), num_phases)
    start = torch.clamp(phase * pb, max=p - pb)
    blk = start + torch.arange(pb, device=dev)

    r = volume.rays_per_probe
    base = _fibonacci_sphere(r)
    route = _probe_route()
    use_pairs = route['pairs']
    if use_pairs and pair_tables is None:
        pair_tables = mt_tables(bvh)
    cone_dirs = cone_layout()[0]
    cone_ok = r % cone_dirs == 0 and not use_pairs
    if cone_ok:
        base = base[_cone_order(r)]
    dirs = torch.from_numpy(base).to(dev) @ _frame_rotation(frame_index).T

    pos = volume.probe_positions(dev)[blk]
    if probe_offset is not None:
        pos = pos + probe_offset[blk]
    state = (probe_state[blk] if probe_state is not None
             else torch.ones(pb, device=dev))
    use_gdir = cone_ok and r % GDIR_DIRS == 0 and _gi_gdir_enabled()
    ndirs = GDIR_DIRS if use_gdir else cone_dirs
    brick = GDIR_BRICK if use_gdir else _brick_for(pb)
    if cone_ok:
        pbp = -(-pb // brick) * brick
    elif use_pairs:
        pbp = -(-pb // PAIR_BLOCK) * PAIR_BLOCK
    else:
        pbp = pb
    pos_p = torch.nn.functional.pad(pos, (0, 0, 0, pbp - pb))
    state_p = torch.nn.functional.pad(state, (0, pbp - pb))
    origins = pos_p.repeat(r, 1)                       # (R * Pbp, 3)
    d_all = dirs.repeat_interleave(pbp, dim=0)
    ray_is_fixed = torch.arange(r, device=dev).repeat_interleave(pbp) \
        < FIXED_RAYS
    pad_live = (torch.arange(pbp, device=dev) < pb).to(torch.float32)
    live = (torch.maximum(state_p.repeat(r), ray_is_fixed.to(torch.float32))
            * pad_live.repeat(r))

    def trace(o, d, lv, **kw):
        if use_pairs or route['chunked']:
            return traverse_auto(bvh, o.contiguous(), d.contiguous(),
                                 live=lv, sp_mesh=sp_mesh,
                                 pair_tables=pair_tables, **route, **kw)
        if not cone_ok:
            return traverse_auto(bvh, o.contiguous(), d.contiguous(),
                                 live=lv, sp_mesh=sp_mesh, **kw)

        def blocked(x):
            return _cone_block(x, r, pbp, brick, ndirs).contiguous()
        db = blocked(d)
        # gdir: every 128 rays share one direction, the kernel's table
        gd = (db.reshape(-1, GDIR_BRICK, 3)[:, 0].contiguous()
              if use_gdir else None)
        res = traverse_auto(bvh, blocked(o), db, live=blocked(lv),
                            sp_mesh=sp_mesh, group_dirs=gd, **kw)
        return {k: _cone_unblock(v, r, pbp, brick, ndirs)
                for k, v in res.items()}

    res = trace(origins, d_all, live, t_max=volume.max_ray_distance,
                max_steps=max_steps)
    hit = res['hit']
    t = res['t']
    rec = shade_rec[torch.clamp(res['tri'], min=0).long()]
    n_raw, albedo, emissive = rec[:, 0:3], rec[:, 3:6], rec[:, 6:9]
    backface = hit & (torch.sum(n_raw * d_all, -1) > 0.0)
    n_w = torch.where(backface[:, None], -n_raw, n_raw)
    hit_pos = origins + d_all * t[:, None]
    if sun_vis_fn is not None:
        sun_vis = sun_vis_fn(hit_pos + n_w * 1e-2)
    else:
        sh = trace(hit_pos + n_w * 1e-2,
                   sun_dir_to_light.expand(hit_pos.shape),
                   live * hit.to(torch.float32), t_max=1e4,
                   max_steps=max_steps, any_hit=True)
        sun_vis = 1.0 - sh['hit'].to(torch.float32)
    ndotl = torch.clamp(torch.sum(n_w * sun_dir_to_light, -1), min=0.0)
    direct = (albedo / math.pi) * (ndotl * sun_vis)[:, None] * (
        sun_color * sun_intensity)
    bounce = sample_irradiance(volume, prev_irradiance, hit_pos,
                               n_w) * albedo / math.pi
    radiance = torch.where(hit[:, None], direct + emissive + bounce,
                           sky_fn(d_all))
    dist = torch.where(hit, t, 1e4)

    # the lifecycle's inputs, per probe of the block
    hit_rp = hit.reshape(r, pbp)[:, :pb]
    back_rp = backface.reshape(r, pbp)[:, :pb]
    t_rp = dist.reshape(r, pbp)[:, :pb]
    t_back = torch.where(back_rp, t_rp, 1e4)
    k_back = torch.argmin(t_back, dim=0)
    lifecycle = dict(
        frac_back=back_rp.to(torch.float32).mean(0),
        closest_back_t=torch.gather(t_back, 0, k_back[None])[0],
        closest_back_dir=dirs[k_back],
        closest_front_t=torch.where(hit_rp & ~back_rp, t_rp, 1e4).amin(0))

    radiance = radiance.reshape(r, pbp, 3)[:, :pb].transpose(0, 1)
    dist = dist.reshape(r, pbp)[:, :pb].T
    return radiance, dist, dirs, start, lifecycle


# -- the probe update ---------------------------------------------------------

def _texel_updates(volume: DdgiVolume, radiance, dist, dirs):
    """The block's new irradiance (Pb, 64, 3) (cosine lobes) and distance
    moments (Pb, 256, 2) (cosine^16 lobes), as small matrix products."""
    dev = radiance.device
    w_irr = torch.clamp(_oct_texel_dirs(IRR_RES, dev) @ dirs.T, min=0.0)
    w_sum = torch.clamp(w_irr.sum(1, keepdim=True), min=1e-4)
    new_irr = torch.einsum('tr,prc->ptc', w_irr, radiance) / w_sum[None]
    w_d = torch.clamp(_oct_texel_dirs(DIST_RES, dev) @ dirs.T,
                      min=0.0) ** 16.0
    wd_sum = torch.clamp(w_d.sum(1, keepdim=True), min=1e-4)
    max_d = float(np.linalg.norm(np.asarray(volume.spacing))) * 1.5
    dc = torch.clamp(dist, max=max_d)
    mean_d = torch.einsum('tr,pr->pt', w_d, dc) / wd_sum[None, :, 0]
    mean_d2 = torch.einsum('tr,pr->pt', w_d, dc * dc) / wd_sum[None, :, 0]
    return new_irr, torch.stack([mean_d, mean_d2], -1)


def update_probes(volume: DdgiVolume, carry_probes: dict, radiance, dist,
                  dirs, first_frame):
    """Blend a whole-volume trace into the probe textures (hysteresis
    0.5; 0 on the first frame)."""
    new_irr, new_dist = _texel_updates(volume, radiance, dist, dirs)
    h = torch.where(torch.as_tensor(first_frame, device=radiance.device),
                    0.0, HYSTERESIS)
    return dict(
        ddgi_irradiance=carry_probes['ddgi_irradiance'] * h
        + new_irr * (1.0 - h),
        ddgi_distance=carry_probes['ddgi_distance'] * h
        + new_dist * (1.0 - h))


def update_probe_block(volume: DdgiVolume, carry_probes: dict, radiance,
                       dist, dirs, block_start, first_frame,
                       lifecycle: dict | None = None, cycle_end=None,
                       num_phases: int = 1) -> dict:
    """Blend one traced block into the carry's probe textures, then, with
    `lifecycle` from trace_probe_block, relocate and classify its probes
    and measure the update's variability.  first_frame / cycle_end: bool
    tensor scalars.  With phased updates one ring sample is a whole
    cycle's mean (accumulated in ddgi_var_accum, pushed when cycle_end);
    cycle_end=None pushes every update's own."""
    dev = radiance.device
    new_irr, new_dist = _texel_updates(volume, radiance, dist, dirs)
    pb = radiance.shape[0]
    p = volume.num_probes
    start = torch.clamp(torch.as_tensor(block_start, device=dev), max=p - pb)
    blk = start + torch.arange(pb, device=dev)
    first = torch.as_tensor(first_frame, device=dev)

    h = torch.where(first, 0.0, HYSTERESIS)
    old_irr = carry_probes['ddgi_irradiance'][blk]
    old_dist = carry_probes['ddgi_distance'][blk]
    blended_irr = old_irr * h + new_irr * (1.0 - h)
    out = dict(
        ddgi_irradiance=carry_probes['ddgi_irradiance'].index_copy(
            0, blk, blended_irr),
        ddgi_distance=carry_probes['ddgi_distance'].index_copy(
            0, blk, old_dist * h + new_dist * (1.0 - h)))
    for k in ('ddgi_offset', 'ddgi_state', 'ddgi_variability',
              'ddgi_var_ring'):
        if k in carry_probes:
            out[k] = carry_probes[k]
    if lifecycle is None:
        return out

    # relocation: a probe that sees many backfaces sits inside geometry;
    # push it just past the closest backface, within OFFSET_LIMIT x the
    # spacing per axis
    spacing = torch.tensor(volume.spacing, dtype=torch.float32, device=dev)
    old_off = carry_probes['ddgi_offset'][blk]
    inside = lifecycle['frac_back'] > BACKFACE_FRAC_THRESHOLD
    step = (lifecycle['closest_back_dir']
            * (lifecycle['closest_back_t']
               + 0.25 * float(min(volume.spacing)))[:, None])
    lim = OFFSET_LIMIT * spacing
    new_off = torch.clamp(old_off + torch.where(inside[:, None], step, 0.0),
                          -lim, lim)
    out['ddgi_offset'] = carry_probes['ddgi_offset'].index_copy(
        0, blk, new_off)

    # classification: active when geometry is near (a frontface hit
    # within 2.5 grid diagonals) or the probe is inside
    near = lifecycle['closest_front_t'] < (
        2.5 * float(np.linalg.norm(np.asarray(volume.spacing))))
    out['ddgi_state'] = carry_probes['ddgi_state'].index_copy(
        0, blk, (near | inside).to(torch.float32))

    # variability: the relative change of the gamma-encoded irradiance
    # (RTXGI stores irradiance with gamma 5), EMA'd
    enc_new = torch.pow(torch.clamp(blended_irr, min=0.0), 0.2)
    enc_old = torch.pow(torch.clamp(old_irr, min=0.0), 0.2)
    var = (torch.abs(enc_new - enc_old).mean()
           / torch.clamp(enc_new.mean(), min=1e-6))
    prev = carry_probes['ddgi_variability']
    out['ddgi_variability'] = torch.where(first, var, prev * 0.9 + var * 0.1)
    # the ring of raw samples for the windowed-std convergence test
    # (GIRenderer.cpp:162-179): cursor = sample count mod window
    if ('ddgi_var_ring' in carry_probes
            and 'ddgi_var_samples' in carry_probes):
        ring = carry_probes['ddgi_var_ring']
        cur = torch.remainder(
            carry_probes['ddgi_var_samples'].to(torch.int32), VAR_WINDOW)
        at_cur = torch.arange(VAR_WINDOW, device=dev) == cur
        if cycle_end is not None and 'ddgi_var_accum' in carry_probes:
            end = torch.as_tensor(cycle_end, device=dev)
            acc = carry_probes['ddgi_var_accum'] + var
            out['ddgi_var_accum'] = torch.where(end, 0.0, acc)
            out['ddgi_var_ring'] = torch.where(
                end & at_cur, acc * (1.0 / max(num_phases, 1)), ring)
        else:
            if 'ddgi_var_accum' in carry_probes:
                out['ddgi_var_accum'] = carry_probes['ddgi_var_accum']
            out['ddgi_var_ring'] = torch.where(at_cur, var, ring)
    return out


# -- sampling -----------------------------------------------------------------

def sample_irradiance(volume: DdgiVolume, irradiance, world_pos, normal):
    """Trilinear probe irradiance (..., 3) at shading points, weighted by
    the soft backface term (no visibility: see
    sample_irradiance_visibility)."""
    return _sample(volume, irradiance, None, world_pos, normal)


def sample_irradiance_visibility(volume: DdgiVolume, irradiance, distance,
                                 world_pos, normal, probe_offset=None,
                                 vis_pool: int = 1, vis_pack=None):
    """Trilinear x backface x Chebyshev-visibility irradiance (..., 3).
    probe_offset: (P, 3) relocation offsets (the weights measure from the
    relocated probes).  vis_pool > 1 (image-shaped inputs): each corner's
    visibility factor is evaluated vis_pool x coarser and expanded.
    vis_pack (None: TR_GI_VIS_PACK=1): the 8 corners' distance moments
    are fetched at one shared texel, the direction from the cell centre
    (see _sample)."""
    return _sample(volume, irradiance, distance, world_pos, normal,
                   probe_offset=probe_offset, vis_pool=vis_pool,
                   vis_pack=vis_pack)


def mean_pool(x, f: int):
    """(H, W, C) -> (H / f, W / f, C) mean over f x f blocks."""
    h, w, c = x.shape
    return x.reshape(h // f, f, w // f, f, c).sum(dim=(1, 3)) * (
        1.0 / (f * f))


def _sample(volume, irradiance, distance, world_pos, normal,
            probe_offset=None, vis_pool: int = 1, _vis_only: bool = False,
            vis_pack=None):
    """The probe sampler.  The 8 trilinear corners' probe ids differ from
    the base probe's by fixed strides and share one octahedral texel, so
    the irradiance is fetched as one row of an (P * 64, 8) table of
    RGB9E5-packed corners, and the relocation offsets as one (P, 16) row
    of f16 pairs; distance moments stay per corner (each corner's texel
    is the direction to that corner) as one f16 pair each, or with
    vis_pack (None: TR_GI_VIS_PACK=1) as one row of a (P * 256, 8)
    corner-packed table at the texel of the direction from the cell's
    centre to the point, shared by the 8 corners.  With _vis_only,
    returns the 8 visibility factors (..., 8)."""
    shape = world_pos.shape[:-1]
    dev = world_pos.device
    vis_coarse = None
    if (not _vis_only and vis_pool > 1 and distance is not None
            and len(shape) == 2 and shape[0] % vis_pool == 0
            and shape[1] % vis_pool == 0):
        wp_c = mean_pool(world_pos, vis_pool)
        n_c = mean_pool(normal, vis_pool)
        n_c = n_c / torch.clamp(torch.linalg.vector_norm(n_c, dim=-1,
                                                         keepdim=True),
                                min=1e-6)
        vis = _sample(volume, None, distance, wp_c, n_c,
                      probe_offset=probe_offset, _vis_only=True,
                      vis_pack=vis_pack)
        vis_coarse = vis.repeat_interleave(vis_pool, 0).repeat_interleave(
            vis_pool, 1).reshape(-1, 8)
        distance = None                       # the corner loop reads it
    if vis_pack is None:
        vis_pack = _gi_vis_pack_enabled()
    wp = world_pos.reshape(-1, 3)
    n = normal.reshape(-1, 3)
    origin = torch.tensor(volume.origin, dtype=torch.float32, device=dev)
    spacing = torch.tensor(volume.spacing, dtype=torch.float32, device=dev)
    cx, cy, cz = (int(c) for c in volume.counts)
    p_n = cx * cy * cz

    # the surface bias (RTXGI DDGIGetSurfaceBias): off the surface along
    # the normal, before the grid lookup and the Chebyshev test
    wp = wp + n * (0.3 * float(np.min(np.asarray(volume.spacing))))
    g = (wp - origin) / spacing
    hi = torch.tensor(volume.counts, dtype=torch.float32, device=dev) - 2
    g0 = torch.minimum(torch.clamp(torch.floor(g), min=0.0), hi)
    frac = torch.clamp(g - g0, 0.0, 1.0)
    g0 = g0.to(torch.int64)
    base_pid = (g0[:, 0] * cy + g0[:, 1]) * cz + g0[:, 2]

    uv = P.oct_encode(n)
    tx = torch.clamp((uv * IRR_RES).to(torch.int64), 0, IRR_RES - 1)
    texel = tx[:, 1] * IRR_RES + tx[:, 0]

    corners = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
               for dz in (0, 1)]
    strides = [(dx * cy + dy) * cz + dz for dx, dy, dz in corners]
    pid_all = torch.arange(p_n, device=dev)

    def corner_rows(s):
        return torch.clamp(pid_all + s, 0, p_n - 1)

    if not _vis_only:
        irr_pack = torch.stack(
            [P.pack_rgb9e5_u32(torch.clamp(irradiance[corner_rows(s)],
                                           min=0.0))
             for s in strides], dim=-1).reshape(p_n * IRR_RES * IRR_RES, 8)
        irr_rows = irr_pack[base_pid * (IRR_RES * IRR_RES) + texel]
    if probe_offset is not None:
        offs = [probe_offset[corner_rows(s)] for s in strides]
        off_pack = torch.stack(
            [u for o in offs
             for u in (P.pack_half2_u32(o[:, 0:2]),
                       P.pack_half2_u32(torch.stack(
                           [o[:, 2], torch.zeros_like(o[:, 2])], -1)))],
            dim=-1)                                    # (P, 16)
        off_rows = off_pack[base_pid]
    if distance is not None:
        dist_pack = P.pack_half2_u32(distance)              # (P, 256)
        if vis_pack:
            # the 8 corners' moments at the texel of the direction from
            # the cell centre: one row gather
            dist8 = torch.stack([dist_pack[corner_rows(s)] for s in strides],
                                -1).reshape(p_n * DIST_RES * DIST_RES, 8)
            dc = origin + (g0.to(torch.float32) + 0.5) * spacing - wp
            dcn = dc / torch.clamp(torch.linalg.vector_norm(
                dc, dim=-1, keepdim=True), min=1e-6)
            ct = torch.clamp((P.oct_encode(-dcn) * DIST_RES).to(torch.int64),
                             0, DIST_RES - 1)
            drows = dist8[base_pid * (DIST_RES * DIST_RES)
                          + ct[:, 1] * DIST_RES + ct[:, 0]]
        else:
            dist_pack = dist_pack.reshape(-1)                # (P * 256,)

    acc = torch.zeros((wp.shape[0], 3), device=dev)
    wacc = torch.zeros((wp.shape[0], 1), device=dev)
    vis_out = []
    for k, (dx, dy, dz) in enumerate(corners):
        gi_f = g0.to(torch.float32) + torch.tensor(
            [dx, dy, dz], dtype=torch.float32, device=dev)
        w = ((frac[:, 0] if dx else 1 - frac[:, 0])
             * (frac[:, 1] if dy else 1 - frac[:, 1])
             * (frac[:, 2] if dz else 1 - frac[:, 2]))
        probe_pos = origin + gi_f * spacing
        if probe_offset is not None:
            oxy = P.unpack_half2_u32(off_rows[:, 2 * k])
            oz = P.unpack_half2_u32(off_rows[:, 2 * k + 1])[:, 0:1]
            probe_pos = probe_pos + torch.cat([oxy, oz], -1)
        to_probe = probe_pos - wp
        dist_p = torch.clamp(torch.linalg.vector_norm(to_probe, dim=-1),
                             min=1e-4)
        dir_p = to_probe / dist_p[:, None]
        # soft backface: probes behind the surface count less
        wn = torch.clamp(torch.sum(dir_p * n, -1) * 0.5 + 0.5,
                         min=0.0) ** 2 + 0.05
        w = w * wn
        if distance is not None:
            if vis_pack:
                d2 = P.unpack_half2_u32(drows[:, k])
            else:
                duv = P.oct_encode(-dir_p)
                dt = torch.clamp((duv * DIST_RES).to(torch.int64), 0,
                                 DIST_RES - 1)
                dtex = dt[:, 1] * DIST_RES + dt[:, 0]
                pid_k = torch.clamp(base_pid + strides[k], 0, p_n - 1)
                d2 = P.unpack_half2_u32(
                    dist_pack[pid_k * (DIST_RES * DIST_RES) + dtex])
            md, md2 = d2[:, 0], d2[:, 1]
            var = torch.clamp(md2 - md * md, min=1e-6)
            cheb = var / (var + torch.clamp(dist_p - md, min=0.0) ** 2)
            cheb = torch.clamp(cheb ** 3, 0.05, 1.0)
            vis_k = torch.where(dist_p > md, cheb, 1.0)
            if _vis_only:
                vis_out.append(vis_k)
                continue
            w = w * vis_k
        elif vis_coarse is not None:
            w = w * vis_coarse[:, k]
        e = P.unpack_rgb9e5_u32(irr_rows[:, k])
        acc = acc + e * w[:, None]
        wacc = wacc + w[:, None]
    if _vis_only:
        return torch.stack(vis_out, dim=-1).reshape(*shape, 8)
    return (acc / torch.clamp(wacc, min=1e-6)).reshape(*shape, 3)
