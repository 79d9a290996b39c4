"""The ray-tracing tree: the frozen static topology (host, numpy) and its
per-frame refit (device, PyTorch).

Counterpart of toyrenderer_tpu/ops/bvh.py's host and refit half
(reference: the BLAS built once per mesh, source/Visual.cpp:509-542, and
the TLAS updated per frame, source/Scene.cpp:411-466).  At scene load
`build_rt_static` freezes the order of the RT pair list's triangles
(a forced-size best-axis median split into a COMPLETE 8-ary tree of
12-triangle leaves) and keeps them in object space; each frame
`refit_bvh` transforms them by the current instance matrices and reduces
the boxes up the levels.  No sort runs per frame -- unless the frame has
no static topology: then `build_bvh` rebuilds the tree every frame from
a morton sort of the world triangles (the reference's per-frame path).

Row layouts are the reference package's, so a tree built there and
carried across (weights.bvh_from_numpy) is traversed unchanged:
* `child_boxes` (R, 48): one row per parent node, component-major
  [lo.x x8 | lo.y x8 | lo.z x8 | hi.x x8 | hi.y x8 | hi.z x8]; child k of
  node i at level l is node 8i+k at level l+1.  Levels are stored as
  their reachable prefix (valid leaf groups sort first), `level_offset`
  giving each parent level's first row; empty boxes are sealed to a far
  point, which no slab test accepts.
* `leaf_rows` (G, 120): one row per leaf group, [v0.x x12 | v0.y x12 |
  v0.z x12 | e1 .. | e2 .. | payload x12], payload -1 for padding.

The traversal (K3) is ops/bvh_cuda.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LEAF_TRIS = 12
ARITY = 8
_BIG = 3e37             # empty-box sentinel (far point once sealed)


@dataclass
class Bvh:
    """The traversable tree (see the module docstring for the rows)."""
    child_boxes: torch.Tensor    # (R, 48) f32
    level_offset: tuple          # first row of each parent level
    num_levels: int              # the leaf level is num_levels - 1
    leaf_rows: torch.Tensor      # (G, 120) f32


@dataclass
class RtStatic:
    """The static topology: triangles in tree order, in object space.

    Arrays cover the reachable leaf-group prefix (a multiple of 8 groups
    of 12): obj_v0 / obj_e1 / obj_e2 (cap, 3) f32 (v0, v1 - v0, v2 - v0),
    tri_inst (cap,) i32 (0 for padding), payload (cap,) i32 (the
    triangle's index in the pair-expanded stream, -1 padding), pair_keep
    (T,) bool (the masked set's alpha-coverage keep over that stream;
    all True without one)."""
    obj_v0: torch.Tensor
    obj_e1: torch.Tensor
    obj_e2: torch.Tensor
    tri_inst: torch.Tensor
    payload: torch.Tensor
    pair_keep: torch.Tensor
    num_levels: int
    n_real_groups: int
    n_mask_pairs: int = 0        # masked pairs appended to the pair list


def _level_sizes(n_levels: int, n_real_groups: int) -> list:
    """Stored parent-row count per level 0..n_levels-2: the reachable
    prefix ceil(n_real / 8^depth), 8-row aligned, capped at the complete
    level size."""
    sizes = []
    for lv in range(n_levels - 1):
        depth = (n_levels - 1) - lv
        n = -(-max(n_real_groups, 1) // ARITY ** depth)
        sizes.append(min(-(-n // 8) * 8, ARITY ** lv))
    return sizes


def num_levels_for(n_tris: int) -> int:
    n_groups = max(-(-n_tris // LEAF_TRIS), 1)
    levels = 1
    while ARITY ** (levels - 1) < n_groups:
        levels += 1
    return levels


# -- host: the static topology ------------------------------------------------

def alpha_coverage_keep(scene_host, pair_inst, pair_meshlet,
                        thresh: float = 0.3, samples: int = 7) -> np.ndarray:
    """(T,) bool per pair-expanded triangle: the mean alpha-test coverage
    of the triangle's base-colour texture is >= thresh.

    The reference's shadow rays alpha-test cutout hits in the any-hit
    (shadowmask.hlsl); here each alpha-masked triangle is classified once
    at scene load from a handful of barycentric samples of its texture's
    alpha at a coarse mip: triangles lying in cutout holes drop from the
    tree, mostly-opaque ones occlude."""
    pm = np.asarray(pair_meshlet)
    tris = np.asarray(scene_host.meshlet_tris)[pm]
    mt = tris.shape[1]
    counts = np.asarray(scene_host.meshlet_tri_count)[pm]
    valid = (np.arange(mt)[None, :] < counts[:, None]).reshape(-1)
    uv = np.asarray(scene_host.uvs)[tris.reshape(-1, 3)]      # (T, 3, 2)
    prim = np.asarray(scene_host.meshlet_prim)[pm]
    mat = np.repeat(np.asarray(scene_host.prim_material)[prim], mt)
    entry = np.asarray(scene_host.mat_base_color_tex)[mat]
    cutoff = np.asarray(scene_host.mat_alpha_cutoff)[mat]
    base_a = np.asarray(scene_host.mat_base_color)[mat, 3]

    # barycentric sample set (interior-biased)
    bw = np.asarray([(1 / 3, 1 / 3), (0.6, 0.2), (0.2, 0.6), (0.2, 0.2),
                     (0.45, 0.45), (0.1, 0.45), (0.45, 0.1)],
                    np.float32)[:samples]
    w = np.stack([1.0 - bw[:, 0] - bw[:, 1], bw[:, 0], bw[:, 1]], -1)
    uv_s = np.einsum('sk,tkc->tsc', w, uv)                    # (T, S, 2)

    keep = base_a >= np.minimum(cutoff, 0.999)                # untextured
    if np.any(entry >= 0):
        texels = np.asarray(scene_host.tex_texels)
        off_t = np.asarray(scene_host.tex_offset)
        w_t = np.asarray(scene_host.tex_width)
        h_t = np.asarray(scene_host.tex_height)
        nm_t = np.asarray(scene_host.tex_num_mips)
        wrap = np.asarray(scene_host.tex_wrap)
        # per texture: a coarse resident mip (~<= 64x64)
        n_tex = off_t.shape[0]
        mip_of = np.zeros(n_tex, np.int32)
        for t in range(n_tex):
            m = max(int(nm_t[t]) - 1, 0)
            while m > 0 and (off_t[t, m] < 0
                             or w_t[t, m] * h_t[t, m] < 32 * 32):
                m -= 1
            while m > 0 and off_t[t, m] < 0:
                m -= 1
            mip_of[t] = m
        e = np.maximum(entry, 0)
        m = mip_of[e]
        ww = w_t[e, m].astype(np.float32)
        hh = h_t[e, m].astype(np.float32)
        u = uv_s[..., 0]
        v = uv_s[..., 1]
        is_rep = (wrap[e] == 0)[:, None]
        u = np.where(is_rep, u - np.floor(u), np.clip(u, 0.0, 1.0))
        v = np.where(is_rep, v - np.floor(v), np.clip(v, 0.0, 1.0))
        wi = w_t[e, m].astype(np.int64)[:, None]
        hi_ = h_t[e, m].astype(np.int64)[:, None]
        x = np.minimum((u * ww[:, None]).astype(np.int64), wi - 1)
        y = np.minimum((v * hh[:, None]).astype(np.int64), hi_ - 1)
        row = off_t[e, m].astype(np.int64)[:, None] + y * wi + x
        row = np.clip(row, 0, texels.shape[0] - 1)
        alpha = ((texels[row, 0].astype(np.uint32) >> 24) & 0xFF) / 255.0
        cov = (alpha * base_a[:, None] >= cutoff[:, None]).mean(axis=1)
        keep = np.where(entry >= 0, cov >= thresh, keep)
    return keep & valid


def _median8_order(centroid: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The frozen triangle order: a recursive forced-size best-axis median
    partition of the complete tree's leaf-group slots; invalid triangles
    last, so valid groups stay a contiguous prefix (the per-level prefix
    storage relies on it)."""
    ids = np.nonzero(valid)[0]
    n = len(ids)
    if n == 0:
        return np.argsort(~valid, kind='stable').astype(np.int32)
    cent = centroid[ids]
    levels = num_levels_for(n)
    total_slots = ARITY ** (levels - 1)
    out = np.empty(n, np.int64)
    pos = [0]

    def rec(idxs, slots):
        if slots == 1 or len(idxs) <= LEAF_TRIS:
            out[pos[0]:pos[0] + len(idxs)] = idxs
            pos[0] += len(idxs)
            return
        sub = slots // ARITY
        rem = idxs
        for c in range(ARITY):
            if len(rem) == 0:
                break
            take = min(sub * LEAF_TRIS, len(rem))
            if c == ARITY - 1 or take == len(rem):
                part, rem2 = rem, rem[:0]
            else:
                cc = cent[rem]
                ax = int(np.argmax(cc.max(0) - cc.min(0)))
                sel = np.argpartition(cc[:, ax], take - 1)
                part, rem2 = rem[sel[:take]], rem[sel[take:]]
            rec(part, sub)
            rem = rem2

    rec(np.arange(n), total_slots)
    inval = np.nonzero(~valid)[0]
    return np.concatenate([ids[out], inval]).astype(np.int32)


def _pair_world_tris(scene_host, pair_inst, pair_meshlet,
                     rest_inst_world=None):
    """The pair list expanded to triangles: (object-space vertices (T, 3,
    3), instance (T,) i32, rest-pose world vertices (T, 3, 3), valid (T,)
    bool)."""
    if rest_inst_world is None:
        from toyrenderer_tpu_torch.scene.scenebuild import (
            _world_matrices_host)
        nw = _world_matrices_host(
            scene_host.node_parent, scene_host.node_translation,
            scene_host.node_rotation, scene_host.node_scale)
        rest_inst_world = nw[np.asarray(scene_host.inst_node)]
    pm = np.asarray(pair_meshlet)
    tris = np.asarray(scene_host.meshlet_tris)[pm]            # (Tp, 96, 3)
    mt = tris.shape[1]
    counts = np.asarray(scene_host.meshlet_tri_count)[pm]
    valid = (np.arange(mt)[None, :] < counts[:, None]).reshape(-1)
    obj = np.asarray(scene_host.positions)[tris.reshape(-1, 3)]
    inst = np.repeat(np.asarray(pair_inst, np.int32), mt)
    world = np.asarray(rest_inst_world)[inst]                 # (T, 4, 4)
    obj_h = np.concatenate([obj, np.ones_like(obj[..., :1])], axis=-1)
    w = np.einsum('tik,tvk->tvi', world, obj_h)[..., :3]
    return obj, inst, w, valid


def rt_pairs_with_mask(scene_host, pair_inst, pair_meshlet,
                       mask_pair_inst, mask_pair_meshlet):
    """Append the alpha-masked pair set (coverage-classified, see
    alpha_coverage_keep) to the opaque RT pair list.  Returns (pair_inst,
    pair_meshlet, keep (T,) bool or None, n_mask_pairs); keep spans the
    concatenated pair-triangle stream."""
    if mask_pair_inst is None or len(mask_pair_inst) == 0:
        return pair_inst, pair_meshlet, None, 0
    mk_i = np.asarray(mask_pair_inst, np.int32)
    mk_m = np.asarray(mask_pair_meshlet, np.int32)
    pi = np.concatenate([np.asarray(pair_inst, np.int32), mk_i])
    pm = np.concatenate([np.asarray(pair_meshlet, np.int32), mk_m])
    keep_m = alpha_coverage_keep(scene_host, mk_i, mk_m)
    mt = np.asarray(scene_host.meshlet_tris).shape[1]
    keep = np.concatenate(
        [np.ones(len(np.asarray(pair_inst)) * mt, bool), keep_m])
    return pi, pm, keep, len(mk_i)


def build_rt_static(scene_host, pair_inst, pair_meshlet,
                    rest_inst_world=None, mask_pair_inst=None,
                    mask_pair_meshlet=None, device=None) -> RtStatic:
    """The static RT topology over the RT pair list, built once at scene
    load on the host (numpy) and returned on `device` (default: the CUDA
    device).  The order comes from rest-pose world centroids (the host
    scene's node TRS unless rest_inst_world is given); triangles are kept
    in object space for refit_bvh.  The masked set, when given, joins the
    tree coverage-classified (rt_pairs_with_mask)."""
    from toyrenderer_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    pair_inst, pair_meshlet, keep, n_mask = rt_pairs_with_mask(
        scene_host, pair_inst, pair_meshlet, mask_pair_inst,
        mask_pair_meshlet)
    obj, inst, w, valid = _pair_world_tris(
        scene_host, pair_inst, pair_meshlet, rest_inst_world)
    if keep is not None:
        valid = valid & keep
    t = w.shape[0]
    n_levels = num_levels_for(t)
    n_groups = ARITY ** (n_levels - 1)

    order = _median8_order(w.mean(axis=1), valid)
    n_valid = int(valid.sum())
    n_real = min(-(-max(n_valid, 1) // LEAF_TRIS), n_groups)
    n_real = min(-(-n_real // 8) * 8, n_groups)
    cap = n_real * LEAF_TRIS
    order = order[:cap]
    obj_s = obj[order]
    pay = np.where(valid[order], order, -1).astype(np.int32)
    inst_s = np.where(pay >= 0, inst[order], 0).astype(np.int32)
    if cap > len(order):                                     # tiny scenes
        extra = cap - len(order)
        obj_s = np.pad(obj_s, [(0, extra), (0, 0), (0, 0)])
        pay = np.pad(pay, (0, extra), constant_values=-1)
        inst_s = np.pad(inst_s, (0, extra))

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    obj_s = obj_s.astype(np.float32)
    return RtStatic(
        obj_v0=on(obj_s[:, 0]), obj_e1=on(obj_s[:, 1] - obj_s[:, 0]),
        obj_e2=on(obj_s[:, 2] - obj_s[:, 0]), tri_inst=on(inst_s),
        payload=on(pay),
        pair_keep=on(keep if keep is not None else np.ones(t, bool)),
        num_levels=n_levels, n_real_groups=n_real, n_mask_pairs=n_mask)


# -- device: the per-frame morton rebuild --------------------------------------

def _expand_bits(v):
    """Spread 10 bits to every 3rd bit (morton); int64 in, int64 out."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(p01):
    """(N, 3) coords in [0,1] -> (N,) 30-bit morton codes (int64 holding
    the reference's uint32 values)."""
    q = torch.clamp(p01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def build_bvh(v0, v1, v2, valid) -> Bvh:
    """The per-frame tree over world-space triangles (T, 3) x3 and their
    validity (reference package, bvh.py:106): the triangles sorted by the
    morton code of their centroid in the valid centroids' box (invalid
    ones last, code 0xFFFFFFFF; a stable sort, as jnp.argsort), packed
    into the complete tree that refit_bvh also builds.  Payloads are the
    triangles' indices in the input."""
    t = v0.shape[0]
    n_levels = num_levels_for(t)
    n_groups = ARITY ** (n_levels - 1)
    centroid = (v0 + v1 + v2) * (1.0 / 3.0)
    lo = torch.amin(torch.where(valid[:, None], centroid, _BIG), dim=0)
    hi = torch.amax(torch.where(valid[:, None], centroid, -_BIG), dim=0)
    ext = torch.clamp(hi - lo, min=1e-6)
    codes = torch.where(valid, morton3d((centroid - lo) / ext), 0xFFFFFFFF)
    order = torch.argsort(codes, stable=True)
    payload = torch.where(valid[order], order.to(torch.int32), -1)
    cap = n_groups * LEAF_TRIS
    v0s, v1s, v2s = v0[order][:cap], v1[order][:cap], v2[order][:cap]
    if cap > t:
        pad = (0, 0, 0, cap - t)
        v0s, v1s, v2s = (torch.nn.functional.pad(x, pad)
                         for x in (v0s, v1s, v2s))
        payload = torch.nn.functional.pad(payload, (0, cap - t), value=-1)
    n_real = min(-(-t // LEAF_TRIS), n_groups)
    return _pack_tree(v0s, v1s - v0s, v2s - v0s, payload[:cap], n_levels,
                      n_real)


# -- device: the per-frame refit ------------------------------------------------

def world_triangles(scene, inst_world, pair_inst, pair_meshlet):
    """The pair list expanded to world-space triangles in pair order
    (T = Tp * 96): (v0, v1, v2 (T, 3), valid (T,) bool).  The payloads of
    a tree over these pairs index this stream."""
    pm = pair_meshlet.long()
    tris = scene.meshlet_tris[pm].long()                      # (Tp, 96, 3)
    tp, mt, _ = tris.shape
    valid = (torch.arange(mt, device=pm.device)[None, :]
             < scene.meshlet_tri_count[pm][:, None])
    world = inst_world[pair_inst.long()]                      # (Tp, 4, 4)
    obj = scene.positions[tris]                               # (Tp, 96, 3, 3)
    obj_h = torch.cat([obj, torch.ones_like(obj[..., :1])], -1)
    w = torch.einsum('tik,tmvk->tmvi', world, obj_h)[..., :3]
    w = w.reshape(tp * mt, 3, 3)
    return w[:, 0], w[:, 1], w[:, 2], valid.reshape(-1)


def transform_leaf_tris(tri_inst, obj_v0, obj_e1, obj_e2, inst_world):
    """Object -> world transform of the static leaf triangles by the
    current instance matrices (a row gather of each triangle's matrix)."""
    w_tri = inst_world[tri_inst.long()]                       # (cap, 4, 4)
    r = w_tri[:, :3, :3]
    t = w_tri[:, :3, 3]

    def tf(v):
        return torch.einsum('tij,tj->ti', r, v)
    return tf(obj_v0) + t, tf(obj_e1), tf(obj_e2)


def _seal(lo, hi):
    """Collapse empty boxes (lo > hi) to a far point: an inverted box
    would read as an infinite one to the slab test."""
    empty = lo[..., :1] > hi[..., :1]
    return torch.where(empty, _BIG, lo), torch.where(empty, _BIG, hi)


def _pack_tree(v0s, e1s, e2s, payload, n_levels: int,
               n_real_groups: int) -> Bvh:
    """Pack ordered, padded triangles (8^(levels-1) * 12 rows; payload -1
    = padding) into the flattened complete tree (reference package,
    bvh.py:143)."""
    n_groups = ARITY ** (n_levels - 1)
    valid = (payload >= 0)[:, None]
    v1s = v0s + e1s
    v2s = v0s + e2s
    tri_lo = torch.where(valid, torch.minimum(torch.minimum(v0s, v1s), v2s),
                         _BIG)
    tri_hi = torch.where(valid, torch.maximum(torch.maximum(v0s, v1s), v2s),
                         -_BIG)
    # reductions run on the raw (big, -big) sentinels; boxes are sealed
    # only when packed into parent rows
    level_lo = [tri_lo.reshape(n_groups, LEAF_TRIS, 3).amin(1)]
    level_hi = [tri_hi.reshape(n_groups, LEAF_TRIS, 3).amax(1)]
    for _ in range(n_levels - 1):
        level_lo.insert(0, level_lo[0].reshape(-1, ARITY, 3).amin(1))
        level_hi.insert(0, level_hi[0].reshape(-1, ARITY, 3).amax(1))

    sizes = _level_sizes(n_levels, n_real_groups)
    rows = []
    for lv in range(n_levels - 1):
        clo, chi = _seal(level_lo[lv + 1], level_hi[lv + 1])
        both = torch.cat([clo.reshape(-1, ARITY, 3),
                          chi.reshape(-1, ARITY, 3)], dim=-1)  # (n, 8, 6)
        rows.append(both.transpose(1, 2).reshape(-1, 48)[:sizes[lv]])
    child_boxes = (torch.cat(rows, dim=0) if rows else
                   torch.zeros((1, 48), dtype=torch.float32,
                               device=v0s.device))
    offsets = tuple(int(x) for x in np.cumsum([0] + sizes)[:-1])

    leaf = torch.cat([v0s, e1s, e2s, payload.to(torch.float32)[:, None]],
                     dim=1)                                    # (Ng*12, 10)
    leaf_rows = leaf.reshape(n_groups, LEAF_TRIS, 10).transpose(
        1, 2).reshape(n_groups, LEAF_TRIS * 10)
    n_real = min(-(-n_real_groups // 8) * 8, n_groups)
    return Bvh(child_boxes=child_boxes.contiguous(), level_offset=offsets,
               num_levels=n_levels,
               leaf_rows=leaf_rows[:n_real].contiguous())


def refit_bvh(rts: RtStatic, inst_world) -> Bvh:
    """Per-frame refit: transform the static object-space leaves by the
    current instance matrices and rebuild the box levels (the
    reference's per-frame TLAS update).  No sort, no host sync."""
    cap = rts.tri_inst.shape[0]
    v0w, e1w, e2w = transform_leaf_tris(
        rts.tri_inst, rts.obj_v0, rts.obj_e1, rts.obj_e2, inst_world)
    full = ARITY ** (rts.num_levels - 1) * LEAF_TRIS
    payload = rts.payload
    if cap < full:
        # complete-tree padding beyond the reachable prefix
        pad = (0, 0, 0, full - cap)
        v0w = torch.nn.functional.pad(v0w, pad)
        e1w = torch.nn.functional.pad(e1w, pad)
        e2w = torch.nn.functional.pad(e2w, pad)
        payload = torch.nn.functional.pad(payload, (0, full - cap),
                                          value=-1)
    return _pack_tree(v0w, e1w, e2w, payload, rts.num_levels,
                      rts.n_real_groups)
