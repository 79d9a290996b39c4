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


def carry_from_numpy(carry: dict, device=None) -> dict:
    """Carry (prev_inst_world, prev_depth, exposure, frame_index, and the
    HZB's tuple of mips under culling) as numpy -> tensors on `device`
    (floats f32, integers i32)."""
    dev = resolve_device(device)
    return {k: tuple(_tensor(m, dev) for m in v) if isinstance(v, tuple)
            else _tensor(v, dev) for k, v in carry.items()}
