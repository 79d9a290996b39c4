"""Runtime state snapshot: save / restore the frame carry and the camera.

Counterpart of toyrenderer_tpu/engine/snapshot.py, in its file format:
an npz of the carry flattened to one array per leaf ('/' joins a dict's
keys, '#i' marks a tuple's i-th entry), '__version' (SNAPSHOT_VERSION)
and, with a View, '__cam_pos', '__cam_rot' and '__cam_frame'.  So the
port reads a snapshot that the reference package wrote.  The port also
stores the View's previous view-projection ('__cam_prev_view_proj'),
which the next frame's motion vectors read: without it (the
reference's snapshot) a camera that moved on the saved frame resumes
with motion vectors of a still camera.  A cached tree
(rt_bvh_cache, gi_bvh_cache) is stored as a dict of its fields.  The
port also stores its carry's host mirror (engine/frame.FrameCarry.host) under
'__host/...', which the reference's loader skips: the frame index, the
node transforms of the carry's frame, the scene version and the
version each cache was built at, the cached sun map's view-proj, the GI
sun signature and convergence test.  A snapshot without them (the
reference's) loads with every cache stale, and the mirror is read from
the loaded carry once.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

SNAPSHOT_VERSION = 1
_TREE_KEYS = ('rt_bvh_cache', 'gi_bvh_cache')


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten_carry(carry, prefix=""):
    flat = {}
    for k, v in carry.items():
        key = f"{prefix}{k}"
        if k in _TREE_KEYS and not prefix and not isinstance(v, dict):
            v = {f: getattr(v, f) for f in vars(v)}
        if isinstance(v, dict):
            flat.update(_flatten_carry(v, key + "/"))
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                flat[f"{key}#{i}"] = _np(x)
        else:
            flat[key] = _np(v)
    return flat


def _unflatten_carry(flat):
    carry = {}
    tuples = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = carry
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        leaf = parts[-1]
        if "#" in leaf:
            name, idx = leaf.split("#")
            tuples.setdefault((id(node), name), []).append((int(idx), v))
            node.setdefault(name, tuples[(id(node), name)])
        else:
            node[leaf] = v

    def fix(node):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                fix(v)
            elif isinstance(v, list):
                node[k] = tuple(x for _, x in sorted(v, key=lambda e: e[0]))
    fix(carry)
    return carry


def _host_entries(host) -> dict:
    """The mirror's fields as npz entries under '__host/'."""
    out = {"__host/frame_index": np.asarray(host.frame_index),
           "__host/version": np.asarray(host.version)}
    for k, v in host.built.items():
        out[f"__host/built/{k}"] = np.asarray(v)
    if host.nodes is not None:
        for i, a in enumerate(host.nodes):
            out[f"__host/nodes#{i}"] = np.asarray(a)
    if host.sun_vp is not None:
        out["__host/sun_vp"] = np.asarray(host.sun_vp)
    return out


def save_state(path, carry, view=None):
    """Write the carry (and, given a View, its camera state) to an npz."""
    flat = _flatten_carry(carry)
    extra = {"__version": np.asarray(SNAPSHOT_VERSION)}
    if view is not None:
        extra["__cam_pos"] = np.asarray(view.position)
        extra["__cam_rot"] = np.asarray(view.rotation)
        extra["__cam_frame"] = np.asarray(view.frame_index)
        prev = view._prev.get('view_proj_nojitter')
        if prev is not None:
            extra["__cam_prev_view_proj"] = np.asarray(prev)
    if getattr(carry, 'host', None) is not None:
        extra.update(_host_entries(carry.host))
    np.savez_compressed(Path(path), **flat, **extra)


def load_state(path, settings, view=None, device=None, rt_static_gi=None):
    """The carry of an npz (the port's or the reference package's) as
    tensors on `device` (weights.carry_from_numpy; `rt_static_gi` gives
    a reference SAH tree its depth), with its host mirror for `settings`;
    patches `view` in place."""
    from toyrenderer_tpu_torch.engine.frame import FrameCarry, HostMirror
    from toyrenderer_tpu_torch.weights import carry_from_numpy
    z = np.load(Path(path), allow_pickle=False)
    if int(z["__version"]) != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {int(z['__version'])}, this "
                         f"reader's {SNAPSHOT_VERSION}")
    flat = {k: z[k] for k in z.files if not k.startswith("__")}
    carry = FrameCarry(carry_from_numpy(_unflatten_carry(flat), device,
                                        rt_static_gi=rt_static_gi))
    host = HostMirror.of_carry(carry, settings)
    if "__host/version" in z.files:
        saved = _unflatten_carry({k[len("__host/"):]: z[k] for k in z.files
                                  if k.startswith("__host/")})
        if int(saved['frame_index']) != host.frame_index:
            raise ValueError("snapshot: the host mirror's frame index "
                             f"{int(saved['frame_index'])} is not the "
                             f"carry's {host.frame_index}")
        nodes = saved.get('nodes')
        host = replace(
            host, version=int(saved['version']),
            built={k: int(v) for k, v in saved.get('built', {}).items()},
            nodes=tuple(np.array(a) for a in nodes) if nodes else None,
            sun_vp=(np.array(saved['sun_vp']) if 'sun_vp' in saved
                    else None))
    carry.host = host
    if view is not None and "__cam_pos" in z.files:
        view.position = z["__cam_pos"].copy()
        view.rotation = z["__cam_rot"].copy()
        view.frame_index = int(z["__cam_frame"])
        if "__cam_prev_view_proj" in z.files:
            view._prev = dict(
                view_proj_nojitter=z["__cam_prev_view_proj"].copy())
    return carry
