"""State carried across from numpy: scene, frame inputs, carry.

The renderer has no learned weights; its state is the scene, the
per-frame inputs and the cross-frame carry.  These builders take the
reference package's DeviceScene / frame_inputs / carry fields as numpy
arrays (or the port's own host arrays) and return the port's tensors, so
both packages can be fed bit-identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from toyrenderer_tpu_torch.device import resolve_device
from toyrenderer_tpu_torch.ops.bvh import Bvh, RtStatic
from toyrenderer_tpu_torch.ops.bvh_sah import BvhSah, RtStaticSah
from toyrenderer_tpu_torch.scene.scenebuild import DeviceScene


def scene_from_numpy(arrays: dict, device=None) -> DeviceScene:
    """DeviceScene from a dict of the scene's fields as numpy arrays
    (DeviceScene field names, including ml_verts / ml_local_tris) plus
    the statics `node_depth`, `num_textures`, `tex_analytic` and
    `num_instances`."""
    return DeviceScene.from_arrays(
        arrays, resolve_device(device), node_depth=arrays['node_depth'],
        num_textures=arrays['num_textures'],
        tex_analytic=arrays['tex_analytic'],
        num_instances=arrays['num_instances'])


def _tensor(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    a = a.astype(np.float32) if a.dtype.kind == 'f' else a.astype(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def frame_inputs_from_numpy(frame_inputs: dict, device=None) -> dict:
    """frame_inputs (numpy arrays, e.g. from default_frame_inputs) ->
    float32 tensors on `device`."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in frame_inputs.items()}


def residency_from_numpy(overrides: dict, device=None) -> dict:
    """A streaming manager's frame_inputs overrides (tex_texels,
    tex_desc, tex_min_mip, tex_tile_table; numpy or anything numpy
    reads, e.g. the reference package's manager's) -> int32 tensors on
    `device`.  u32 texels and table entries keep their bits."""
    dev = resolve_device(device)
    out = {}
    for k, v in overrides.items():
        a = np.asarray(v)
        a = (a.view(np.int32) if a.dtype in (np.uint32, np.int32)
             else a.astype(np.int32))
        out[k] = torch.from_numpy(np.array(a)).to(dev)
    return out


def _leaves(v) -> dict:
    """The fields of a tree (either package's Bvh / BvhSah, or a dict of
    them, as a snapshot stores one) as numpy arrays or statics."""
    if isinstance(v, dict):
        return v
    return {k: getattr(v, k) for k in ('child_boxes', 'leaf_rows',
                                       'level_offset', 'num_levels',
                                       'node_rows', 'depth')
            if hasattr(v, k)}


def _tree_from_numpy(v, dev, sah_depth):
    """A cached tree (Bvh or BvhSah, of either package, or a snapshot's
    dict of its fields) -> the port's tree on `dev`; the reference's
    BvhSah has no depth: `sah_depth` gives it."""
    f = {k: (x if k in ('level_offset', 'num_levels', 'depth')
             else np.asarray(x)) for k, x in _leaves(v).items()}
    if 'node_rows' in f:
        if 'depth' not in f:
            if sah_depth is None:
                raise ValueError("an SAH tree without its depth: give "
                                 "carry_from_numpy the GI topology")
            f['depth'] = sah_depth
        return bvh_sah_from_numpy(f, dev)
    return bvh_from_numpy(f, dev)


def carry_from_numpy(carry: dict, device=None, rt_static_gi=None) -> dict:
    """Carry (prev_inst_world, prev_depth, exposure, frame_index, the
    HZB's tuple of mips under culling, the TAA and shadow histories and
    their validity, ReSTIR's reservoir dict, the DDGI probes and the
    caches: the refit trees rt_bvh_cache / gi_bvh_cache -- the reference
    package's Bvh / BvhSah, the port's (on the CPU), or a snapshot's dict
    of their fields --, the shade records gi_shade_cache, the pair tables
    gi_mt_cache (a tuple), the sun map) as numpy -> tensors on `device`
    (floats f32, integers i32).  The reference's BvhSah carries no depth:
    `rt_static_gi` (the GI topology, an RtStaticSah) gives it.  The
    result is a plain dict, with no host mirror (engine/frame.FrameCarry):
    the frame reads one from the device, every cache stale."""
    dev = resolve_device(device)
    sah_depth = (len(rt_static_gi.depth_ranges)
                 if hasattr(rt_static_gi, 'depth_ranges') else None)

    def conv(k, v):
        if k in ('rt_bvh_cache', 'gi_bvh_cache'):
            return _tree_from_numpy(v, dev, sah_depth)
        if isinstance(v, tuple):
            return tuple(_tensor(m, dev) for m in v)
        if isinstance(v, dict):
            return {k: _tensor(m, dev) for k, m in v.items()}
        return _tensor(v, dev)
    return {k: conv(k, v) for k, v in carry.items()}


def rt_static_from_numpy(arrays: dict, device=None) -> RtStatic:
    """RtStatic from its fields as numpy arrays (obj_v0, obj_e1, obj_e2,
    tri_inst, payload, pair_keep) plus the statics num_levels,
    n_real_groups and n_mask_pairs -- a static topology built by either
    package."""
    dev = resolve_device(device)

    def on(k, dtype):
        return torch.from_numpy(np.array(arrays[k], dtype=dtype)).to(dev)
    return RtStatic(
        obj_v0=on('obj_v0', np.float32), obj_e1=on('obj_e1', np.float32),
        obj_e2=on('obj_e2', np.float32), tri_inst=on('tri_inst', np.int32),
        payload=on('payload', np.int32), pair_keep=on('pair_keep', bool),
        num_levels=int(arrays['num_levels']),
        n_real_groups=int(arrays['n_real_groups']),
        n_mask_pairs=int(arrays.get('n_mask_pairs', 0)))


def bvh_from_numpy(arrays: dict, device=None) -> Bvh:
    """Bvh from child_boxes (R, 48) and leaf_rows (G, 120) as numpy plus
    the statics level_offset and num_levels -- a refitted tree of either
    package."""
    dev = resolve_device(device)
    return Bvh(
        child_boxes=torch.from_numpy(
            np.array(arrays['child_boxes'], np.float32)).to(dev),
        level_offset=tuple(int(x) for x in arrays['level_offset']),
        num_levels=int(arrays['num_levels']),
        leaf_rows=torch.from_numpy(
            np.array(arrays['leaf_rows'], np.float32)).to(dev))


def rt_static_sah_from_numpy(arrays: dict, device=None) -> RtStaticSah:
    """RtStaticSah from its fields as numpy arrays (obj_v0, obj_e1,
    obj_e2, tri_inst, payload, child_ref, node_axis, pair_keep, seg_inst,
    seg_lens) plus the statics depth_ranges and n_mask_pairs -- an SAH
    topology built by either package."""
    dev = resolve_device(device)

    def on(k, dtype):
        return torch.from_numpy(np.array(arrays[k], dtype=dtype)).to(dev)
    return RtStaticSah(
        obj_v0=on('obj_v0', np.float32), obj_e1=on('obj_e1', np.float32),
        obj_e2=on('obj_e2', np.float32), tri_inst=on('tri_inst', np.int32),
        payload=on('payload', np.int32), child_ref=on('child_ref', np.int32),
        node_axis=on('node_axis', np.int32),
        pair_keep=on('pair_keep', bool), seg_inst=on('seg_inst', np.int32),
        seg_lens=on('seg_lens', np.int64),
        depth_ranges=tuple((int(a), int(b))
                           for a, b in arrays['depth_ranges']),
        n_mask_pairs=int(arrays.get('n_mask_pairs', 0)))


def bvh_sah_from_numpy(arrays: dict, device=None) -> BvhSah:
    """BvhSah from node_rows (PR, 64) and leaf_rows (NG, 120) as numpy
    plus the static depth (node levels) -- a refitted SAH tree of either
    package."""
    dev = resolve_device(device)
    return BvhSah(
        node_rows=torch.from_numpy(
            np.array(arrays['node_rows'], np.float32)).to(dev),
        leaf_rows=torch.from_numpy(
            np.array(arrays['leaf_rows'], np.float32)).to(dev),
        depth=int(arrays['depth']))
