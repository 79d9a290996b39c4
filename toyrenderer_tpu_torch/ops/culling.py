"""GPU-driven culling: frustum, occlusion and cone tests, screen-error LOD
selection, and the compacted (instance, meshlet) pair list.

Counterpart of toyrenderer_tpu/ops/culling.py (reference:
gpuculling.hlsl per-instance frustum cull, 2-phase HZB occlusion against
the previous frame's HZB and transforms, screen-error LOD selection,
amplification into bounded indirect arguments; basepass.hlsl
AS_Main:40-122 per-meshlet frustum + cone + HZB).

No atomics and no host syncs: the pair list is compacted by a cumsum and
a searchsorted into a capacity fixed by the caller (a Python int), and
overflow drops work, as the reference's bounded amplification does
(gpuculling.hlsl:69-74).  Every test is dense masked math over all
instances or pairs, so shapes never depend on the data.
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops import hzb as hzb_mod

_CORNERS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
            for sz in (-1, 1)]


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def sphere_screen_bbox(center_w, radius, view_proj, width, height):
    """Conservative uv box + nearest depth of world-space spheres.

    Returns (u0, v0, u1, v1, depth_near, in_front), each (N,): the box of
    the sphere's AABB corners projected; spheres touching the camera
    plane are in_front=False (treated as visible)."""
    offs = center_w.new_tensor(_CORNERS)
    corners = center_w[:, None, :] + offs[None] * radius[:, None, None]
    clip = torch.matmul(_homogeneous(corners), view_proj.T)   # (N, 8, 4)
    w = clip[..., 3]
    in_front = torch.all(w > 1e-6, dim=-1)
    w_safe = torch.clamp(w, min=1e-6)
    u = (clip[..., 0] / w_safe) * 0.5 + 0.5
    v = 0.5 - (clip[..., 1] / w_safe) * 0.5
    # conservative nearest depth from the centre's projection: w is the
    # view-forward distance, so the sphere's closest point has w - radius
    cclip = torch.matmul(_homogeneous(center_w), view_proj.T)
    d_near = cclip[..., 2] / torch.clamp(cclip[..., 3] - radius, min=1e-6)
    return (u.amin(-1), v.amin(-1), u.amax(-1), v.amax(-1), d_near,
            in_front)


def _max_axis_scale(world: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(world[..., :3, :3], dim=-2).amax(-1)


def world_spheres(centers_local, radii_local, world):
    """Bounding spheres by instance matrices (radius by the max axis
    scale)."""
    c = torch.matmul(world, _homogeneous(centers_local)[..., None])
    return c[..., :3, 0], radii_local * _max_axis_scale(world)


def frustum_visible(planes, center_w, radius_w):
    d = torch.matmul(center_w, planes[:, :3].T) + planes[None, :, 3]
    return torch.all(d >= -radius_w[:, None], dim=-1)


def select_lod(scene, prim_ids, dist, proj_scale_px,
               error_threshold_px: float = 1.0, forced_lod: int = -1,
               error_scale=None):
    """Screen-error LOD (gpuculling.hlsl:39-58): the coarsest LOD whose
    object-space error projects below the threshold."""
    prim = prim_ids.long()
    errors = scene.prim_lod_error[prim]                 # (N, L)
    if error_scale is not None:
        errors = errors * error_scale[:, None]
    counts = scene.prim_lod_count[prim]                 # (N,)
    n_lods = errors.shape[1]
    err_px = errors * (proj_scale_px / torch.clamp(dist, min=1e-3))[:, None]
    lod_idx = torch.arange(n_lods, dtype=torch.int32,
                           device=errors.device)[None, :]
    ok = (err_px <= error_threshold_px) & (lod_idx < counts[:, None])
    # LOD 0 always qualifies (error 0)
    pick = torch.where(ok, lod_idx, 0).amax(dim=1)
    if forced_lod >= 0:
        pick = torch.clamp(counts - 1, max=forced_lod)
    return pick


def cull_instances(scene, inst_world, planes, cam_pos, proj_scale_px,
                   width, height, hzb=None, hzb_view_proj=None,
                   hzb_inst_world=None, error_threshold_px: float = 1.0,
                   forced_lod: int = -1):
    """Instance-level culling.

    Occlusion tests against `hzb` with `hzb_inst_world` / `hzb_view_proj`
    (the previous frame's transforms for the early phase,
    gpuculling.hlsl:143-146).  Returns dict(visible (I,) bool,
    occluded_candidate (I,) bool, lod (I,) i32)."""
    prim = scene.inst_prim.long()
    c_l = scene.prim_center[prim]
    r_l = scene.prim_radius[prim]
    c_w, r_w = world_spheres(c_l, r_l, inst_world)

    vis = frustum_visible(planes, c_w, r_w)
    real = torch.arange(vis.shape[0], device=vis.device) < scene.num_instances
    vis = vis & real

    dist = torch.linalg.vector_norm(c_w - cam_pos[None], dim=-1)
    # LOD errors are object-space: scale by the instance's max axis scale
    lod = select_lod(scene, prim, torch.clamp(dist - r_w, min=1e-3),
                     proj_scale_px, error_threshold_px, forced_lod,
                     error_scale=_max_axis_scale(inst_world))

    occluded = torch.zeros_like(vis)
    if hzb is not None:
        c_prev, r_prev = world_spheres(
            c_l, r_l,
            inst_world if hzb_inst_world is None else hzb_inst_world)
        u0, v0, u1, v1, d_near, in_front = sphere_screen_bbox(
            c_prev, r_prev, hzb_view_proj, width, height)
        hzb_vis = hzb_mod.hzb_test_bbox(hzb, u0, v0, u1, v1, d_near, width,
                                        height)
        occluded = vis & in_front & ~hzb_vis
        vis = vis & ~occluded
    return dict(visible=vis, occluded_candidate=occluded, lod=lod)


def build_pairs(scene, inst_mask, lod, capacity: int):
    """Compact the (instance, meshlet) pairs of the masked instances at
    their LODs into a list of `capacity` entries.

    Returns (pair_inst (C,) i32, pair_meshlet (C,) i32, pair_valid (C,)
    bool, total () i32: the pairs wanted, which may exceed C)."""
    prim = scene.inst_prim.long()
    lod_l = lod.long()
    counts = torch.where(inst_mask, scene.prim_meshlet_count[prim, lod_l],
                         0).to(torch.int32)
    cum = torch.cumsum(counts, 0, dtype=torch.int32)
    total = cum[-1]
    starts = cum - counts
    j = torch.arange(capacity, dtype=torch.int32, device=cum.device)
    inst = torch.searchsorted(cum, j, right=True)
    valid = j < torch.clamp(total, max=capacity)
    inst_safe = torch.clamp(inst, max=prim.shape[0] - 1)
    local = j - starts[inst_safe]
    meshlet = (scene.prim_meshlet_offset[prim[inst_safe], lod_l[inst_safe]]
               + local)
    meshlet = torch.where(valid, meshlet, 0)
    return inst_safe.to(torch.int32), meshlet.to(torch.int32), valid, total


def cull_meshlets(scene, pair_inst, pair_meshlet, pair_valid, inst_world,
                  planes, cam_pos, width, height, hzb=None,
                  hzb_view_proj=None, cone_cull: bool = True):
    """Per-meshlet culling of a pair list (basepass.hlsl AS_Main: frustum
    + cone + optional HZB).  Returns the refined pair_valid."""
    pm = pair_meshlet.long()
    c_l = scene.meshlet_center[pm]
    r_l = scene.meshlet_radius[pm]
    world = inst_world[pair_inst.long()]
    c_w, r_w = world_spheres(c_l, r_l, world)

    ok = pair_valid & frustum_visible(planes, c_w, r_w)

    if cone_cull:
        axis_l = scene.meshlet_cone_axis[pm]
        cutoff = scene.meshlet_cone_cutoff[pm]
        axis_w = torch.matmul(world[..., :3, :3], axis_l[..., None])[..., 0]
        axis_w = axis_w / torch.clamp(torch.linalg.vector_norm(
            axis_w, dim=-1, keepdim=True), min=1e-8)
        to_c = c_w - cam_pos[None]
        dist = torch.linalg.vector_norm(to_c, dim=-1)
        # backfacing cluster: dot(view -> centre, axis) >= cutoff*dist + r
        backfacing = torch.sum(to_c * axis_w, -1) >= cutoff * dist + r_w
        # double-sided materials skip cone culling (alpha-masked parity)
        mat = scene.prim_material[scene.meshlet_prim[pm].long()]
        ds = scene.mat_double_sided[mat.long()] != 0
        ok = ok & (ds | ~backfacing | (cutoff >= 1.0))

    if hzb is not None:
        u0, v0, u1, v1, d_near, in_front = sphere_screen_bbox(
            c_w, r_w, hzb_view_proj, width, height)
        hzb_vis = hzb_mod.hzb_test_bbox(hzb, u0, v0, u1, v1, d_near, width,
                                        height)
        ok = ok & (~in_front | hzb_vis)
    return ok
