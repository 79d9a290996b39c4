"""Keyframe animation playback on the host.

The port's own copy of toyrenderer_tpu/scene/animation.py (reference:
the CPU keyframe evaluation of source/Scene.cpp:377-409, Animation at
Scene.h:15-34): each frame the channels are sampled at the current time
and written into copies of the nodes' local TRS, which the frame reads
through frame_inputs (node_translation / rotation / scale); the device
then rebuilds the world matrices and refits the RT trees.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PATH_TRANSLATION = 0
PATH_ROTATION = 1
PATH_SCALE = 2
_PATHS = {"translation": PATH_TRANSLATION, "rotation": PATH_ROTATION,
          "scale": PATH_SCALE}

INTERP_LINEAR = 0
INTERP_STEP = 1


@dataclass
class AnimationData:
    """Every channel's keys in flat arrays."""
    node: np.ndarray          # (C,) i32 target node
    path: np.ndarray          # (C,) i32 PATH_*
    interp: np.ndarray        # (C,) i32 INTERP_*
    key_offset: np.ndarray    # (C+1,) i32 into times / values
    times: np.ndarray         # (K,) f32
    values: np.ndarray        # (K, 4) f32 (vec3 padded)
    duration: float = 0.0

    @property
    def num_channels(self) -> int:
        return len(self.node)


def pack_animations(channels) -> AnimationData:
    """GltfAnimationChannel list -> AnimationData."""
    node, path, interp, offsets = [], [], [], [0]
    times, values = [], []
    for ch in channels:
        node.append(ch.node)
        path.append(_PATHS[ch.path])
        interp.append(INTERP_STEP if ch.interpolation == "STEP"
                      else INTERP_LINEAR)
        times.append(ch.times.astype(np.float32))
        v = ch.values.astype(np.float32)
        if v.shape[1] == 3:
            v = np.pad(v, ((0, 0), (0, 1)))
        values.append(v[:, :4])
        offsets.append(offsets[-1] + len(ch.times))
    if not node:
        return AnimationData(
            node=np.zeros(0, np.int32), path=np.zeros(0, np.int32),
            interp=np.zeros(0, np.int32), key_offset=np.zeros(1, np.int32),
            times=np.zeros(0, np.float32),
            values=np.zeros((0, 4), np.float32))
    times_all = np.concatenate(times)
    return AnimationData(
        node=np.asarray(node, np.int32), path=np.asarray(path, np.int32),
        interp=np.asarray(interp, np.int32),
        key_offset=np.asarray(offsets, np.int32), times=times_all,
        values=np.concatenate(values),
        duration=float(times_all.max()) if len(times_all) else 0.0)


def _slerp(a: np.ndarray, b: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(a, b))
    if d < 0:
        b = -b
        d = -d
    if d > 0.9995:
        q = a + (b - a) * t
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return ((np.sin((1 - t) * th) * a + np.sin(t * th) * b)
            / np.sin(th))


class AnimationPlayer:
    """Evaluates every channel at a time and patches the node TRS."""

    def __init__(self, data: AnimationData, loop: bool = True):
        self.data = data
        self.loop = loop
        self.enabled = data.num_channels > 0

    def evaluate(self, time: float, node_t, node_r, node_s):
        """Patched COPIES of (node_translation, rotation, scale); the
        inputs themselves when there is no channel."""
        d = self.data
        if not self.enabled:
            return node_t, node_r, node_s
        if self.loop and d.duration > 0:
            time = time % d.duration
        node_t = node_t.copy()
        node_r = node_r.copy()
        node_s = node_s.copy()
        for c in range(d.num_channels):
            o0, o1 = d.key_offset[c], d.key_offset[c + 1]
            times = d.times[o0:o1]
            vals = d.values[o0:o1]
            if len(times) == 0:
                continue
            i = int(np.searchsorted(times, time, side='right') - 1)
            i = int(np.clip(i, 0, len(times) - 1))
            j = min(i + 1, len(times) - 1)
            if d.interp[c] == INTERP_STEP or i == j:
                t = 0.0
            else:
                span = max(times[j] - times[i], 1e-8)
                t = float(np.clip((time - times[i]) / span, 0.0, 1.0))
            n = d.node[c]
            if d.path[c] == PATH_ROTATION:
                node_r[n] = _slerp(vals[i], vals[j], t)
            elif d.path[c] == PATH_TRANSLATION:
                node_t[n] = vals[i, :3] * (1 - t) + vals[j, :3] * t
            else:
                node_s[n] = vals[i, :3] * (1 - t) + vals[j, :3] * t
        return node_t, node_r, node_s
