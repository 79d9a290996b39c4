"""Geometry stage: node hierarchy -> world matrices -> clip-space meshlet
triangles.

Counterpart of toyrenderer_tpu/ops/geometry.py (reference:
updateinstanceconsts.hlsl:12-53, BasePassRenderers.cpp:125-162).  The
hierarchy resolves in `node_depth` batched compose passes; the meshlet
-> triangle expansion transforms each pair's 64-vertex window and
gathers per-triangle vertices from it, giving fixed-shape (T, 3, 4)
clip-space triangles.
"""

from __future__ import annotations

import numpy as np
import torch

from toyrenderer_tpu_torch.mathlib.transforms import adjugate3, compose_trs
from toyrenderer_tpu_torch.scene.gltf import ALPHA_BLEND, ALPHA_MASK


def node_world_matrices(scene, node_translation, node_rotation, node_scale):
    """(N,4,4) world matrices from per-node local TRS + the parent array;
    each of the `node_depth - 1` passes resolves one more level."""
    local = compose_trs(node_translation, node_rotation, node_scale)
    parent = scene.node_parent
    has_parent = (parent >= 0)[:, None, None]
    parent_safe = torch.clamp(parent, min=0).long()
    world = local
    for _ in range(max(scene.node_depth - 1, 0)):
        composed = torch.matmul(world[parent_safe], local)
        world = torch.where(has_parent, composed, world)
    return world


def instance_transforms(scene, world):
    """Per-instance world matrix (I,4,4) + adjugate normal matrix (I,3,3)."""
    inst_world = world[scene.inst_node.long()]
    return inst_world, adjugate3(inst_world)


def meshlet_clip_triangles(scene, inst_world, view_proj, pair_inst,
                           pair_meshlet, pair_valid=None):
    """Expand (instance, meshlet) pairs into clip-space triangles.

    pair_valid: optional (Tp,) bool, False for pairs culling removed (or
    past a compacted list's end); their triangles are invalid.
    Returns dense (T = Tp*96, ...) tensors: clip (T, 3, 4), vtx_ids
    (T, 3), inst_id / mat_id (T,), double_sided / tri_valid (T,) bool,
    plus the (Tp,) pair arrays for pair-rate consumers.
    """
    pm = pair_meshlet.long()
    pi = pair_inst.long()
    tris = scene.meshlet_tris[pm]                     # (Tp, 96, 3)
    tp, mt, _ = tris.shape
    tri_in_meshlet = torch.arange(mt, device=pm.device)[None, :]
    tri_valid = tri_in_meshlet < scene.meshlet_tri_count[pm][:, None]
    if pair_valid is not None:
        tri_valid = tri_valid & pair_valid[:, None]

    prim = scene.meshlet_prim[pm].long()
    mat = scene.prim_material[prim]                   # (Tp,)
    double_sided = scene.mat_double_sided[mat.long()] != 0

    mvp = torch.matmul(view_proj, inst_world[pi])     # (Tp, 4, 4)
    win = scene.ml_verts[pm]                          # (Tp, 64, 8)
    lt = scene.ml_local_tris[pm].long()               # (Tp, 96, 3)
    wpos_h = torch.cat([win[..., 0:3], torch.ones_like(win[..., :1])], -1)
    clip_w = torch.matmul(wpos_h, mvp.transpose(-1, -2))   # (Tp, 64, 4)
    rows = torch.arange(tp, device=pm.device)[:, None, None]
    clip = clip_w[rows, lt]                           # (Tp, 96, 3, 4)

    def rep(x):
        return x.repeat_interleave(mt, dim=0)
    return dict(
        clip=clip.reshape(tp * mt, 3, 4),
        vtx_ids=tris.reshape(tp * mt, 3),
        inst_id=rep(pair_inst.to(torch.int32)),
        mat_id=rep(mat.to(torch.int32)),
        double_sided=rep(double_sided),
        tri_valid=tri_valid.reshape(tp * mt),
        pair_meshlet=pair_meshlet.to(torch.int32),
        pair_inst=pair_inst.to(torch.int32),
    )


def rt_lod_pairs(scene_host, alpha_filter: str = 'all',
                 budget_tris: int = 500_000):
    """The RT pair list at the finest LOD whose triangle count fits the
    budget (shadow rays of large scenes trace simplified geometry;
    primary visibility stays at full LOD).  Returns (pair_inst,
    pair_meshlet, lod)."""
    max_lods = int(np.asarray(scene_host.prim_meshlet_offset).shape[1])
    counts = np.asarray(scene_host.meshlet_tri_count)
    for lod in range(max_lods):
        pi, pm = static_meshlet_pairs(scene_host, alpha_filter, lod=lod)
        if int(counts[pm].sum()) <= budget_tris or lod == max_lods - 1:
            return pi, pm, lod
    return pi, pm, max_lods - 1


def static_meshlet_pairs(scene_host, alpha_filter: str = 'all',
                         lod: int = 0):
    """Host helper: the no-culling (instance, meshlet) pair list at a
    fixed LOD (default LOD0), from the host SceneBuffers (numpy).

    alpha_filter: 'all' | 'opaque' (opaque + alpha-masked) |
    'opaque_strict' (no masked) | 'not_mask' | 'mask' | 'blend' -- the
    alpha-mode set split of the reference's base pass.
    """
    pi, pm = [], []
    for i in range(scene_host.num_instances):
        p = int(scene_host.inst_prim[i])
        mode = int(scene_host.mat_alpha_mode[
            int(scene_host.prim_material[p])])
        if alpha_filter == 'opaque' and mode == ALPHA_BLEND:
            continue
        if alpha_filter == 'opaque_strict' and mode != 0:
            continue
        if alpha_filter == 'not_mask' and mode == ALPHA_MASK:
            continue
        if alpha_filter == 'mask' and mode != ALPHA_MASK:
            continue
        if alpha_filter == 'blend' and mode != ALPHA_BLEND:
            continue
        li = lod
        while li > 0 and int(scene_host.prim_meshlet_count[p, li]) == 0:
            li -= 1
        off = int(scene_host.prim_meshlet_offset[p, li])
        cnt = int(scene_host.prim_meshlet_count[p, li])
        pi.extend([i] * cnt)
        pm.extend(range(off, off + cnt))
    if not pi:
        if alpha_filter in ('blend', 'mask'):
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        # the base (opaque) set cannot be empty: instance 0 pads it
        pi, pm = [0], [0]
    return (np.asarray(pi, np.int32), np.asarray(pm, np.int32))
