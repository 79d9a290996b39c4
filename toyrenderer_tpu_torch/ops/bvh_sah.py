"""The adaptive binned-SAH 8-wide tree with explicit child refs: the GI
tree.  Its frozen topology is built once on the host (numpy and the
native builder, native/sah.cpp) and refit every update on the device.

Counterpart of toyrenderer_tpu/ops/bvh_sah.py (reference: the BLAS built
once per mesh, source/Visual.cpp:509-542, the TLAS updated per frame,
source/Scene.cpp:411-466).  The complete tree of ops/bvh.py cannot adapt
its depth to the geometry; this tree does, so DDGI's probe rays, which
trace an LOD-reduced copy of the scene, visit fewer leaves.

Storage (the reference's layout, so either package's tree traverses
unchanged): node rows (PR, 64) f32 -- 48 child-box floats in the
component-major layout of Bvh.child_boxes, then 8 child refs as floats
(>= 0: internal node row; < -0.5: leaf row -(ref + 1); ABSENT_REF: empty
slot), the node's split axis (its children are sorted along it) and 7
floats of padding.  Leaf rows (NG, 120) f32 are laid out as
Bvh.leaf_rows.  Nodes are stored grouped by depth, root first.

The traversal (K3-SAH, and K5 on grouped directions) is ops/bvh_cuda.py.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from toyrenderer_tpu_torch.ops.bvh import (
    LEAF_TRIS, _pair_world_tris, build_rt_static, rt_pairs_with_mask,
    transform_leaf_tris)

ABSENT_REF = -3.0e8     # float child ref of an empty slot
_ABSENT_I = np.int32(-2147483648)
BIG = 3.0e37
NBINS = 16              # SAH bins per split


@dataclass
class BvhSah:
    """The traversable SAH tree (see the module docstring for the rows);
    `depth` is its number of node levels, which sizes the traversal's
    stack."""
    node_rows: torch.Tensor      # (PR, 64) f32
    leaf_rows: torch.Tensor      # (NG, 120) f32
    depth: int


@dataclass
class RtStaticSah:
    """The frozen SAH topology: triangles in leaf order, in object space.

    obj_v0 / obj_e1 / obj_e2 (NG*12, 3) f32, tri_inst (NG*12,) i32 (0 for
    padding), payload (NG*12,) i32 (the triangle's index in the pair-
    expanded stream, -1 padding), child_ref (PR, 8) i32 (INT32_MIN for an
    empty slot), node_axis (PR,) i32, pair_keep (T,) bool (see
    RtStatic.pair_keep), seg_inst (S,) i32 and seg_lens (S,) i64: the
    instance and triangle count of each contiguous leaf segment (the
    topology is instance-major), depth_ranges: ((first row, rows), ...)
    per depth."""
    obj_v0: torch.Tensor
    obj_e1: torch.Tensor
    obj_e2: torch.Tensor
    tri_inst: torch.Tensor
    payload: torch.Tensor
    child_ref: torch.Tensor
    node_axis: torch.Tensor
    pair_keep: torch.Tensor
    seg_inst: torch.Tensor
    seg_lens: torch.Tensor
    depth_ranges: tuple = ()
    n_mask_pairs: int = 0


# -- host: the frozen topology ------------------------------------------------

def _build_one(tlo, thi, nbins: int = NBINS):
    """The native builder over triangle boxes (n, 3): (child (PR, 8) i32,
    axis (PR,) i32, leaf (NL, 12) i32 triangle ids -1 padded, max
    depth).  A failed build raises."""
    from toyrenderer_tpu_torch.native import sah_lib
    n = tlo.shape[0]
    max_nodes = max(n, 8)
    max_leaves = max(n, 8)
    tlo = np.ascontiguousarray(tlo, np.float32)
    thi = np.ascontiguousarray(thi, np.float32)
    child = np.empty((max_nodes, 8), np.int32)
    axis = np.empty((max_nodes,), np.int32)
    leaf = np.empty((max_leaves, LEAF_TRIS), np.int32)
    counts = np.zeros((3,), np.int32)
    rc = sah_lib().build_sah8(
        tlo.ctypes.data_as(ctypes.c_void_p),
        thi.ctypes.data_as(ctypes.c_void_p),
        n, LEAF_TRIS, nbins, max_nodes, max_leaves,
        child.ctypes.data_as(ctypes.c_void_p),
        axis.ctypes.data_as(ctypes.c_void_p),
        leaf.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"build_sah8 failed ({rc}) on {n} triangles")
    pr, nl, md = int(counts[0]), int(counts[1]), int(counts[2])
    return child[:pr], axis[:pr], leaf[:nl], md


def _build_instance_major(tlo, thi, inst_v, nbins: int = NBINS):
    """One SAH subtree per instance over its own triangles (the BLAS),
    under a median-split top tree over the instances' boxes (the TLAS),
    flattened into one node array.  Each instance's triangles are one
    contiguous leaf segment, so the refit broadcasts one matrix per
    segment.  Returns (child (PR, 8), axis (PR,), leaf (NL, 12) global
    triangle ids, seg_inst list, seg_tris list)."""
    uinst = np.unique(inst_v)
    childs, axes, leaves = [], [], []
    roots, seg_inst, seg_tris = [], [], []
    n_off = 0
    l_off = 0
    ilo = np.empty((len(uinst), 3), np.float32)
    ihi = np.empty((len(uinst), 3), np.float32)
    for j, iid in enumerate(uinst):
        sel = np.nonzero(inst_v == iid)[0]
        c, a, lf, _md = _build_one(tlo[sel], thi[sel], nbins)
        # globalize: internal refs shift by n_off, leaf refs by l_off,
        # local triangle ids -> this selection's
        gi = np.where(c >= 0, c + n_off,
                      np.where(c == _ABSENT_I, c, c - l_off))
        childs.append(gi)
        axes.append(a)
        leaves.append(np.where(lf >= 0, sel[np.maximum(lf, 0)], -1))
        roots.append(n_off)
        seg_inst.append(int(iid))
        seg_tris.append(int(lf.shape[0]) * LEAF_TRIS)
        ilo[j] = tlo[sel].min(0)
        ihi[j] = thi[sel].max(0)
        n_off += c.shape[0]
        l_off += lf.shape[0]

    child = np.concatenate(childs, axis=0)
    axis = np.concatenate(axes, axis=0)
    leaf = np.concatenate(leaves, axis=0)
    if len(uinst) == 1:
        return child, axis, leaf, seg_inst, seg_tris

    # the top tree: median splits over the instance box centres; top
    # node t's final id is n_off + t, so its refs are final at once
    cent = (ilo + ihi) * 0.5
    n_inst_nodes = n_off
    top_child, top_axis = [], []

    def build_top(items):
        me = len(top_child)
        top_child.append(np.full(8, _ABSENT_I, np.int64))
        top_axis.append(0)
        c = cent[items]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        top_axis[me] = ax
        order = items[np.argsort(c[:, ax], kind='stable')]
        if len(order) <= 8:
            groups = [order[i:i + 1] for i in range(len(order))]
        else:
            bounds = np.linspace(0, len(order), 9).astype(int)
            groups = [order[bounds[i]:bounds[i + 1]] for i in range(8)
                      if bounds[i] < bounds[i + 1]]
        for k, g in enumerate(groups):
            top_child[me][k] = (roots[g[0]] if len(g) == 1
                                else build_top(g))
        return n_inst_nodes + me

    root_final = build_top(np.arange(len(uinst)))
    child = np.concatenate(
        [child, np.stack(top_child).astype(child.dtype)], axis=0)
    axis = np.concatenate([axis, np.asarray(top_axis, axis.dtype)], axis=0)
    # the depth relabel of build_rt_static_sah moves the root to node 0
    assert root_final == n_inst_nodes
    return child, axis, leaf, seg_inst, seg_tris


def build_rt_static_sah(scene_host, pair_inst, pair_meshlet,
                        rest_inst_world=None, mask_pair_inst=None,
                        mask_pair_meshlet=None, nbins: int = NBINS,
                        device=None) -> RtStaticSah:
    """The SAH topology over an RT pair list, built once at scene load
    on the host and returned on `device` (default: the CUDA device).
    Rest-pose world boxes drive the build; triangles are kept in object
    space for refit_sah.  The masked set, when given, joins coverage-
    classified (ops/bvh.rt_pairs_with_mask)."""
    from toyrenderer_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    pair_inst, pair_meshlet, keep, n_mask = rt_pairs_with_mask(
        scene_host, pair_inst, pair_meshlet, mask_pair_inst,
        mask_pair_meshlet)
    obj, inst, w, valid = _pair_world_tris(
        scene_host, pair_inst, pair_meshlet, rest_inst_world)
    if keep is not None:
        valid = valid & keep
    ids = np.nonzero(valid)[0]
    wv = w[ids]
    child, axis, leaf, seg_inst, seg_tris = _build_instance_major(
        wv.min(axis=1), wv.max(axis=1), inst[ids], nbins)
    pr = child.shape[0]

    # depth relabel: the instance-major concatenation interleaves
    # depths; the refit walks contiguous depth ranges bottom-up
    depth = np.full((pr,), -1, np.int32)
    referenced = np.zeros(pr, bool)
    referenced[child[(child >= 0) & (child != _ABSENT_I)]] = True
    depth[~referenced] = 0
    frontier = np.nonzero(~referenced)[0]
    while len(frontier):
        nxt = []
        for i in frontier:
            for k in range(8):
                c = child[i, k]
                if c >= 0:
                    depth[c] = depth[i] + 1
                    nxt.append(c)
        frontier = np.asarray(nxt, np.int64)
    max_d = int(depth.max())
    assert (depth >= 0).all()
    perm = np.argsort(depth, kind='stable')      # new order -> old id
    remap = np.empty(pr, np.int64)               # old id -> new id
    remap[perm] = np.arange(pr)
    child = np.where(child >= 0, remap[np.maximum(child, 0)], child)[perm]
    axis = axis[perm]
    depth = depth[perm]
    assert depth[0] == 0
    ranges = []
    for d in range(max_d + 1):
        idx = np.nonzero(depth == d)[0]
        assert idx[-1] - idx[0] + 1 == len(idx)
        ranges.append((int(idx[0]), int(len(idx))))

    # leaf-order triangles (empty slots: payload -1, zero triangle,
    # instance 0)
    flat = leaf.reshape(-1)
    ok = flat >= 0
    src = ids[np.where(ok, flat, 0)]
    obj_s = np.where(ok[:, None, None], obj[src], 0.0).astype(np.float32)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return RtStaticSah(
        obj_v0=on(obj_s[:, 0]), obj_e1=on(obj_s[:, 1] - obj_s[:, 0]),
        obj_e2=on(obj_s[:, 2] - obj_s[:, 0]),
        tri_inst=on(np.where(ok, inst[src], 0).astype(np.int32)),
        payload=on(np.where(ok, src, -1).astype(np.int32)),
        child_ref=on(child.astype(np.int32)),
        node_axis=on(axis.astype(np.int32)),
        pair_keep=on(keep if keep is not None
                     else np.ones(w.shape[0], bool)),
        seg_inst=on(np.asarray(seg_inst, np.int32)),
        seg_lens=on(np.asarray(seg_tris, np.int64)),
        depth_ranges=tuple(ranges), n_mask_pairs=n_mask)


def build_rt_static_auto(scene_host, pair_inst, pair_meshlet,
                         rest_inst_world=None, mask_pair_inst=None,
                         mask_pair_meshlet=None, device=None):
    """The main RT tree's frozen topology (reference bvh_sah.py:438):
    the SAH tree with TR_RT_SAH=1, else the complete tree of
    ops/bvh.build_rt_static.  The reference builds the SAH tree only on
    the TPU, because its SAH walk is a Pallas kernel; the port takes
    that branch on every device."""
    build = (build_rt_static_sah if os.environ.get('TR_RT_SAH', '0') == '1'
             else build_rt_static)
    return build(scene_host, pair_inst, pair_meshlet, rest_inst_world,
                 mask_pair_inst=mask_pair_inst,
                 mask_pair_meshlet=mask_pair_meshlet, device=device)


def gi_sah_wanted() -> bool:
    """TR_GI_SAH: '1' (the default) builds the GI tree with SAH, any
    other value the complete tree (reference bvh_sah.py:489)."""
    return os.environ.get('TR_GI_SAH', '1') == '1'


def build_rt_static_gi(scene_host, alpha_filter: str = 'all',
                       mask_pair_inst=None, mask_pair_meshlet=None,
                       rest_inst_world=None, sah: bool | None = None,
                       device=None):
    """The GI tree's frozen topology: DDGI's probe rays are diffuse, so
    they trace the finest LOD whose triangle count fits the budget
    (TR_GI_TRIS, default 100k) on the SAH tree, while shadow rays keep
    the full-detail tree.  `sah=False` builds the complete tree
    (ops/bvh.build_rt_static) over the same pairs; `sah=None` reads
    TR_GI_SAH as the reference does (its bvh_sah.py:489: '1', the
    default, for the SAH tree, anything else for the complete one; see
    `gi_sah_wanted`).  The SAH tree is
    built on every device (the reference's accelerator branch; its CPU
    branch takes the complete tree, because its SAH walk is a Pallas
    kernel).  Returns (rt_static_gi, gi_pair_inst, gi_pair_meshlet,
    lod), the pair lists as int32 tensors on `device`."""
    from toyrenderer_tpu_torch.device import resolve_device
    from toyrenderer_tpu_torch.ops.geometry import rt_lod_pairs
    dev = resolve_device(device)
    budget = int(os.environ.get('TR_GI_TRIS', '100000'))
    g_pi, g_pm, lod = rt_lod_pairs(scene_host, alpha_filter,
                                   budget_tris=budget)
    if sah is None:
        sah = gi_sah_wanted()
    build = build_rt_static_sah if sah else build_rt_static
    rts = build(scene_host, g_pi, g_pm, rest_inst_world,
                mask_pair_inst=mask_pair_inst,
                mask_pair_meshlet=mask_pair_meshlet, device=dev)
    return (rts, torch.from_numpy(np.asarray(g_pi, np.int32)).to(dev),
            torch.from_numpy(np.asarray(g_pm, np.int32)).to(dev), lod)


# -- device: the refit --------------------------------------------------------

def refit_sah(rts: RtStaticSah, inst_world) -> BvhSah:
    """Transform the static object-space leaves by the current instance
    matrices (one matrix per instance segment), rebuild the leaf boxes,
    and reduce the node boxes bottom-up over the depth ranges (a node's
    children are strictly deeper, so each range reads only ranges
    already written).  No sort, no host sync."""
    cap = rts.tri_inst.shape[0]
    ng = cap // LEAF_TRIS
    if rts.seg_lens.numel():
        w_tri = torch.repeat_interleave(
            inst_world[rts.seg_inst.long()], rts.seg_lens, dim=0,
            output_size=cap)
        r = w_tri[:, :3, :3]

        def tf(v):
            return torch.einsum('tij,tj->ti', r, v)
        v0w = tf(rts.obj_v0) + w_tri[:, :3, 3]
        e1w = tf(rts.obj_e1)
        e2w = tf(rts.obj_e2)
    else:
        v0w, e1w, e2w = transform_leaf_tris(
            rts.tri_inst, rts.obj_v0, rts.obj_e1, rts.obj_e2, inst_world)

    leaf = torch.cat([v0w, e1w, e2w,
                      rts.payload.to(torch.float32)[:, None]], dim=1)
    leaf_rows = leaf.reshape(ng, LEAF_TRIS, 10).transpose(1, 2).reshape(
        ng, 10 * LEAF_TRIS)

    # leaf boxes (empty slots excluded)
    v1w = v0w + e1w
    v2w = v0w + e2w
    okm = (rts.payload >= 0)[:, None]
    tl = torch.where(okm, torch.minimum(torch.minimum(v0w, v1w), v2w), BIG)
    th = torch.where(okm, torch.maximum(torch.maximum(v0w, v1w), v2w), -BIG)
    leaf_lo = tl.reshape(ng, LEAF_TRIS, 3).amin(1)
    leaf_hi = th.reshape(ng, LEAF_TRIS, 3).amax(1)

    pr = rts.child_ref.shape[0]
    dev = v0w.device
    own_lo = torch.zeros((pr, 3), device=dev)
    own_hi = torch.zeros((pr, 3), device=dev)
    rows48 = torch.zeros((pr, 48), device=dev)
    for start, count in reversed(rts.depth_ranges):
        refs = rts.child_ref[start:start + count]
        absent = refs == int(_ABSENT_I)
        is_leaf = ((refs < 0) & ~absent)[..., None]
        lid = torch.clamp(-(refs.long() + 1), 0, ng - 1)
        nid = torch.clamp(refs.long(), 0, pr - 1)
        cl = torch.where(is_leaf, leaf_lo[lid], own_lo[nid])
        ch = torch.where(is_leaf, leaf_hi[lid], own_hi[nid])
        cl = torch.where(absent[..., None], BIG, cl)          # (c, 8, 3)
        ch = torch.where(absent[..., None], -BIG, ch)
        own_lo[start:start + count] = cl.amin(1)
        own_hi[start:start + count] = ch.amax(1)
        # component-major child boxes; an empty slot's inverted box is
        # inert (its ref keeps it off the stack)
        rows48[start:start + count] = torch.cat(
            [cl.transpose(1, 2).reshape(count, 24),
             ch.transpose(1, 2).reshape(count, 24)], dim=1)

    ref_f = torch.where(rts.child_ref == int(_ABSENT_I), ABSENT_REF,
                        rts.child_ref.to(torch.float32))
    node_rows = torch.cat(
        [rows48, ref_f, rts.node_axis.to(torch.float32)[:, None],
         torch.zeros((pr, 7), device=dev)], dim=1)
    return BvhSah(node_rows=node_rows.contiguous(),
                  leaf_rows=leaf_rows.contiguous(),
                  depth=len(rts.depth_ranges))
