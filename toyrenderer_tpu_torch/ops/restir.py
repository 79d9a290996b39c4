"""ReSTIR DI: reservoir-resampled direct light from the scene's emissive
triangles.

Counterpart of toyrenderer_tpu/ops/restir.py (reference: the RTXDI
integration, source/ReSTIRRenderer.cpp + restirshading.hlsl): RIS over
`num_candidates` light samples into a per-pixel reservoir, temporal reuse
of the previous frame's reservoir along the motion vectors, spatial reuse
over disk neighbours with geometric rejection, then one visibility ray
per pixel toward the kept sample and the shading.  As in the reference
renderer the pass is off by default (RenderSettings.enable_restir).

Every step is dense per-pixel PyTorch; the noise is the shadows'
interleaved-gradient noise, a function of the pixel and the frame (no
random generator).  The visibility rays -- every pixel's, dead ones
included, as the reference traces them -- go through
bvh_cuda.traverse_auto any-hit: the traversal kernel (K3) on the card,
its plain version on the CPU.
"""

from __future__ import annotations

import math
import os

import torch

from toyrenderer_tpu_torch.ops.bvh_cuda import traverse_auto
from toyrenderer_tpu_torch.ops.shadows import interleaved_gradient_noise


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _cross(a, b):
    """a x b with each component's first product fused into the
    subtraction, fma(a_i, b_j, -(a_k * b_l)), as the reference's CPU
    backend computes jnp.cross (the f32 products are exact in f64): a
    degenerate triangle -- a sphere's pole -- gets the same rounding-
    sized area there as here, so the same triangles pass the light
    test."""
    a64 = a.double()
    b64 = b.double()

    def comp(i, j):
        return (a64[..., i] * b64[..., j]
                - (a[..., j] * b[..., i]).double()).float()
    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], -1)


def collect_emissive_lights(scene, pair_inst, pair_meshlet, v0, v1, v2,
                            max_lights: int) -> dict:
    """The emissive triangles of the pair stream's world triangles (v0,
    v1, v2 (T, 3), the order of bvh.world_triangles) as a light list of
    fixed capacity: dict of v0 / e1 / e2 (L, 3), emission (L, 3), area
    (L,), valid (L,) and count (); lights past max_lights drop.  Slot k
    holds the k-th emissive triangle in stream order, found without a
    host sync (one scatter of triangle indices to their ranks)."""
    pm = pair_meshlet.long()
    prim = scene.meshlet_prim[pm].long()
    mat = scene.prim_material[prim].long().repeat_interleave(96)
    emission = scene.mat_emissive[mat]
    lum = torch.sum(emission, -1)
    e1 = v1 - v0
    e2 = v2 - v0
    area = 0.5 * _norm(_cross(e1, e2))
    is_light = (lum > 1e-3) & (area > 1e-10)

    dev = v0.device
    rank = torch.cumsum(is_light.to(torch.int64), 0) - 1
    slot = torch.where(is_light & (rank < max_lights), rank, max_lights)
    idx = torch.zeros(max_lights + 1, dtype=torch.int64, device=dev)
    idx.scatter_reduce_(0, slot, torch.arange(v0.shape[0], device=dev),
                        'amax')
    count = torch.clamp(torch.sum(is_light.to(torch.int32)), max=max_lights)
    valid = torch.arange(max_lights, device=dev) < count
    safe = torch.where(valid, idx[:max_lights], 0)
    return dict(v0=v0[safe], e1=e1[safe], e2=e2[safe],
                emission=emission[safe], area=area[safe], valid=valid,
                count=count)


def _sample_light_point(lights, li, r1, r2):
    """A uniform point on light triangle li: (pos, normal, area)."""
    li = li.long()
    su = torch.sqrt(r1)
    b1 = 1.0 - su
    b2 = r2 * su
    e1 = lights['e1'][li]
    e2 = lights['e2'][li]
    pos = lights['v0'][li] + e1 * b1[..., None] + e2 * b2[..., None]
    n = _cross(e1, e2)
    n = n / torch.clamp(_norm(n)[..., None], min=1e-12)
    return pos, n, lights['area'][li]


def _target_pdf(world_pos, normal, albedo, lpos, lnormal, emission, area):
    """The unshadowed contribution's luminance: the resampling target."""
    d = lpos - world_pos
    dist2 = torch.clamp(torch.sum(d * d, -1), min=1e-6)
    dist = torch.sqrt(dist2)
    wi = d / dist[..., None]
    cos_s = torch.clamp(torch.sum(normal * wi, -1), min=0.0)
    cos_l = torch.clamp(torch.sum(lnormal * -wi, -1), min=0.0)
    g = cos_s * cos_l / dist2
    lum = torch.sum(emission, -1) * torch.sum(albedo, -1) / (3.0 * math.pi)
    return lum * g * area


def _pixel_grid(h: int, w: int, device, offset: float):
    ys = torch.arange(h, dtype=torch.float32, device=device) + offset
    xs = torch.arange(w, dtype=torch.float32, device=device) + offset
    return ys[:, None].expand(h, w), xs[None, :].expand(h, w)


def restir_di(scene_bvh, lights, world_pos, normal, albedo, hit_mask,
              frame_index, prev_reservoir=None, motion=None,
              num_candidates: int = 8, max_steps: int = 64,
              num_spatial: int = 4, spatial_radius: float = 16.0):
    """One ReSTIR DI step (reference package, restir.py:92-239): RIS
    candidates -> temporal reuse (with prev_reservoir and motion) ->
    spatial reuse -> one any-hit visibility ray per pixel + shading.

    world_pos, normal, albedo (H, W, 3), hit_mask (H, W) bool,
    frame_index an int32 tensor scalar.  Returns (radiance (H, W, 3),
    the reservoir for the carry: li (i32), r1, r2 (the sample's
    barycentric noise), w (its weight), m (candidates behind it), each
    (H, W); the carry keeps the reservoir before spatial reuse).
    max_steps is accepted; it does not bound the walk (see
    bvh_cuda.traverse_auto)."""
    h, w = hit_mask.shape
    dev = hit_mask.device
    l_count = torch.clamp(lights['count'], min=1)
    l_count_f = l_count.to(torch.float32)

    def noise(k):
        return interleaved_gradient_noise(h, w, frame_index * 31 + k)

    # -- initial candidates (RIS) ---------------------------------------
    zeros = torch.zeros((h, w), device=dev)
    res_li = torch.zeros((h, w), dtype=torch.int32, device=dev)
    res_r1, res_r2, res_wsum, res_p = zeros, zeros, zeros, zeros
    for k in range(num_candidates):
        li = torch.remainder((noise(4 * k) * l_count_f).to(torch.int32),
                             l_count)
        r1 = noise(4 * k + 1)
        r2 = noise(4 * k + 2)
        lpos, ln, area = _sample_light_point(lights, li, r1, r2)
        p_hat = _target_pdf(world_pos, normal, albedo, lpos, ln,
                            lights['emission'][li.long()], area)
        # source pdf 1 / (count * area); the area is in p_hat already
        wgt = p_hat * l_count_f
        res_wsum = res_wsum + wgt
        take = noise(4 * k + 3) < wgt / torch.clamp(res_wsum, min=1e-12)
        res_li = torch.where(take, li, res_li)
        res_r1 = torch.where(take, r1, res_r1)
        res_r2 = torch.where(take, r2, res_r2)
        res_p = torch.where(take, p_hat, res_p)
    res_m = torch.full((h, w), float(num_candidates), device=dev)

    # -- temporal reuse: the previous reservoir at the reprojected pixel --
    if prev_reservoir is not None and motion is not None:
        py, px = _pixel_grid(h, w, dev, 0.5)
        ppy = torch.clamp(py - motion[..., 1] - 0.5, 0, h - 1).to(
            torch.int32).long()
        ppx = torch.clamp(px - motion[..., 0] - 0.5, 0, w - 1).to(
            torch.int32).long()
        pr = {k: v[ppy, ppx] for k, v in prev_reservoir.items()}
        pm = torch.clamp(pr['m'], max=20.0 * num_candidates)
        pli = torch.clamp(pr['li'], torch.zeros_like(l_count), l_count - 1)
        lpos, ln, area = _sample_light_point(lights, pli, pr['r1'], pr['r2'])
        p_hat_prev = _target_pdf(world_pos, normal, albedo, lpos, ln,
                                 lights['emission'][pli.long()], area)
        w_prev = p_hat_prev * pr['w'] * pm
        res_wsum = res_wsum + w_prev
        take = noise(71) < w_prev / torch.clamp(res_wsum, min=1e-12)
        res_li = torch.where(take, pli.to(torch.int32), res_li)
        res_r1 = torch.where(take, pr['r1'], res_r1)
        res_r2 = torch.where(take, pr['r2'], res_r2)
        res_p = torch.where(take, p_hat_prev, res_p)
        res_m = res_m + pm

    big_w = res_wsum / torch.clamp(res_m * torch.clamp(res_p, min=1e-12),
                                   min=1e-12)
    # the carry keeps the reservoir before spatial reuse (feeding the
    # merged one back compounds neighbour correlation frame over frame)
    reservoir = dict(li=res_li, r1=res_r1, r2=res_r2, w=big_w, m=res_m)

    # -- spatial reuse: disk neighbours' reservoirs, with normal and
    #    tangent-plane rejection, re-weighted at this pixel -------------
    if num_spatial > 0:
        py, px = _pixel_grid(h, w, dev, 0.0)
        in_li, in_r1, in_r2 = res_li, res_r1, res_r2
        in_w, in_m, in_p = big_w, res_m, res_p
        # restart with this pixel's own sample (Bitterli alg. 4)
        res_wsum = in_p * in_w * in_m
        for k in range(num_spatial):
            ang = noise(83 + 5 * k) * (2.0 * math.pi)
            rad = torch.sqrt(noise(84 + 5 * k)) * spatial_radius
            ny = torch.clamp(py + rad * torch.sin(ang), 0, h - 1).to(
                torch.int32).long()
            nx = torch.clamp(px + rad * torch.cos(ang), 0, w - 1).to(
                torch.int32).long()
            n_li = in_li[ny, nx]
            n_r1 = in_r1[ny, nx]
            n_r2 = in_r2[ny, nx]
            n_w = in_w[ny, nx]
            n_m = in_m[ny, nx]
            dwp = world_pos[ny, nx] - world_pos
            plane_d = torch.abs(torch.sum(normal * dwp, -1))
            lateral = torch.clamp(_norm(dwp), min=1e-6)
            ok = ((torch.sum(normal * normal[ny, nx], -1) > 0.9)
                  & (plane_d < 0.1 * lateral + 1e-5) & hit_mask[ny, nx])
            lpos, ln, area = _sample_light_point(lights, n_li, n_r1, n_r2)
            p_hat = _target_pdf(world_pos, normal, albedo, lpos, ln,
                                lights['emission'][n_li.long()], area)
            wgt = torch.where(ok, p_hat * n_w * n_m, 0.0)
            res_wsum = res_wsum + wgt
            take = (noise(85 + 5 * k)
                    < wgt / torch.clamp(res_wsum, min=1e-12))
            res_li = torch.where(take, n_li, res_li)
            res_r1 = torch.where(take, n_r1, res_r1)
            res_r2 = torch.where(take, n_r2, res_r2)
            res_p = torch.where(take, p_hat, res_p)
            res_m = res_m + torch.where(ok, n_m, 0.0)
        big_w = res_wsum / torch.clamp(
            res_m * torch.clamp(res_p, min=1e-12), min=1e-12)

    # -- one visibility ray per pixel, then the shading ------------------
    lpos, ln, _ = _sample_light_point(lights, res_li, res_r1, res_r2)
    d = lpos - world_pos
    dist = torch.clamp(_norm(d), min=1e-4)
    wi = d / dist[..., None]
    origin = world_pos + normal * 1e-2
    # t_max from the offset origin, short of the light's own surface
    odist = torch.clamp(_norm(lpos - origin), min=1e-4)
    sh = traverse_auto(
        scene_bvh, origin.reshape(-1, 3).contiguous(),
        wi.reshape(-1, 3).contiguous(),
        t_max=(odist * 0.99 - 1e-3).reshape(-1), max_steps=max_steps,
        any_hit=True, chunked=os.environ.get('TR_RT_CHUNKS', '0') == '1')
    visible = ~sh['hit'].reshape(h, w)

    li = res_li.long()
    cos_s = torch.clamp(torch.sum(normal * wi, -1), min=0.0)
    cos_l = torch.clamp(torch.sum(ln * -wi, -1), min=0.0)
    g = cos_s * cos_l / torch.clamp(dist * dist, min=1e-6)
    lit = (albedo / math.pi) * lights['emission'][li] * (
        g * lights['area'][li] * big_w * visible.to(torch.float32))[..., None]
    lit = torch.where((hit_mask & (lights['count'] > 0))[..., None], lit,
                      0.0)
    return lit, reservoir
