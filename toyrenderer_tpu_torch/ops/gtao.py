"""Ground-truth ambient occlusion (GTAO).

Counterpart of toyrenderer_tpu/ops/gtao.py (reference: the XeGTAO pass,
source/AmbientOcclusionRenderer.cpp): horizon-based AO from the depth
buffer and normals, the standard GTAO arc integral (Jimenez et al.
2016), consumed by deferred lighting to modulate ambient / GI.  The
frame evaluates it at half resolution and blurs it depth-aware at full
resolution (ops/denoise.depth_aware_blur).

Slice directions and step ladders are uniform across the frame and
rotate per frame through 8 quantised phases (and the phase half a wheel
away on alternate pixels of a 2x2 checkerboard), so every depth sample
is a whole-image shift with edge clamp.  The
reference picks the phase's static shifts with a device-side switch;
here the phase's integer offsets are read from a small table on the
device, and each shift is one gather, so nothing waits on the host.
The falloff radius is dithered per pixel with interleaved-gradient
noise (the reference's de-banding).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from toyrenderer_tpu_torch.ops.lighting import world_pos_from_depth
from toyrenderer_tpu_torch.ops.shadows import interleaved_gradient_noise

_N_ROT_PHASES = 8


@functools.lru_cache(maxsize=None)
def _offset_table(n_slices: int, n_steps: int, device) -> torch.Tensor:
    """(phases, slices, n_steps + 1, 2) int64 (dy, dx) pixel offsets:
    per phase and slice the step ladder (1, 2, 4, ... px along the slice
    direction, rounded) and, last, the tangent sample's +1 px step."""
    table = np.zeros((_N_ROT_PHASES, n_slices, n_steps + 1, 2), np.int64)
    for phase in range(_N_ROT_PHASES):
        base = phase * (np.pi / n_slices / _N_ROT_PHASES)
        for s in range(n_slices):
            phi = base + s * (np.pi / n_slices)
            dxu, dyu = np.cos(phi), np.sin(phi)
            for k in range(n_steps):
                r = 1 << k
                dx = int(np.round(dxu * r))
                dy = int(np.round(dyu * r))
                if dx == 0 and dy == 0:
                    dx = 1
                table[phase, s, k] = (dy, dx)
            table[phase, s, n_steps] = (int(np.round(dyu)) or 0,
                                        int(np.round(dxu)) or 1)
    return torch.from_numpy(table).to(device)


def _shift(img, rows, cols, dy, dx):
    """img[clamp(y + dy), clamp(x + dx)]: the image shifted by a device
    scalar offset, clamped at the edges."""
    h, w = img.shape[:2]
    yy = torch.clamp(rows + dy, 0, h - 1)
    xx = torch.clamp(cols + dx, 0, w - 1)
    return img[yy[:, None], xx[None, :]]


def gtao(depth, normal_world, cam_pos, inv_view_proj, frame_index,
         radius: float = 1.5, n_slices: int = 3, n_steps: int = 5,
         power: float = 1.2, radius_dither: float = 0.6):
    """AO (H, W) in [0, 1] (1 = fully open) from reverse-Z depth (H, W)
    and world normals (H, W, 3); cam_pos (3,), inv_view_proj (4, 4)
    (unjittered), frame_index an int32 tensor scalar (the per-frame
    rotation)."""
    h, w = depth.shape
    hit = depth > 0.0
    pos = world_pos_from_depth(depth, inv_view_proj, w, h)
    v = cam_pos - pos
    dist = torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                       min=1e-6)
    v = v / dist                                        # to the eye
    if radius_dither > 0.0:
        ign = interleaved_gradient_noise(h, w, frame_index + 31)
        radius_px = radius * (1.0 - 0.5 * radius_dither
                              + radius_dither * ign)
    else:
        radius_px = torch.full((h, w), radius, device=depth.device)
    args = (pos, normal_world, v, hit, radius_px, n_slices, n_steps, power)
    # 2x2-checkerboard phase mixing: adjacent pixels take slice
    # rotations half the phase wheel apart, so horizon quantisation
    # bands decorrelate at pixel scale
    ao_a = _gtao_static(frame_index, *args)
    ao_b = _gtao_static(frame_index + _N_ROT_PHASES // 2, *args)
    yy = torch.arange(h, device=depth.device)[:, None]
    xx = torch.arange(w, device=depth.device)[None, :]
    return torch.where(((xx ^ yy) & 1) == 0, ao_a, ao_b)


def _gtao_static(frame_index, pos, normal, v, hit, radius, n_slices,
                 n_steps, power):
    """GTAO of one rotation phase (frame_index % 8)."""
    h, w = pos.shape[:2]
    dev = pos.device
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    phase = torch.remainder(frame_index.long(), _N_ROT_PHASES)
    offs = _offset_table(n_slices, n_steps, dev)[phase]   # (S, steps+1, 2)
    ao = torch.zeros((h, w), device=dev)
    for s in range(n_slices):
        cos_h1 = torch.full((h, w), -1.0, device=dev)
        cos_h2 = torch.full((h, w), -1.0, device=dev)
        for k in range(n_steps):
            dy, dx = offs[s, k, 0], offs[s, k, 1]
            for sign in (1, -1):
                d = _shift(pos, rows, cols, sign * dy, sign * dx) - pos
                dl = torch.linalg.vector_norm(d, dim=-1)
                falloff = torch.clamp(1.0 - dl / radius, 0.0, 1.0)
                cos_a = torch.sum(d * v, -1) / torch.clamp(dl, min=1e-6)
                cos_a = cos_a * falloff + (-1.0) * (1.0 - falloff)
                # +1 shifts along +t, so it bounds the positive horizon
                if sign > 0:
                    cos_h2 = torch.maximum(cos_h2, cos_a)
                else:
                    cos_h1 = torch.maximum(cos_h1, cos_a)

        # the slice plane: t = the +1 px sample's direction, orthogonal
        # to v
        t = _shift(pos, rows, cols, offs[s, n_steps, 0],
                   offs[s, n_steps, 1]) - pos
        t = t - v * torch.sum(t * v, -1, keepdim=True)
        t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1,
                                                     keepdim=True),
                            min=1e-6)
        n_v = torch.sum(normal * v, -1)
        n_t = torch.sum(normal * t, -1)
        n_len = torch.sqrt(torch.clamp(n_v * n_v + n_t * n_t, min=1e-12))
        gamma = torch.atan2(n_t, torch.clamp(n_v, min=1e-6))

        h1 = -torch.arccos(torch.clamp(cos_h1, -1.0, 1.0))   # side of +t
        h2 = torch.arccos(torch.clamp(cos_h2, -1.0, 1.0))
        # clamp the horizons to the hemisphere around the normal
        h1 = gamma + torch.clamp(h1 - gamma, min=-0.5 * np.pi)
        h2 = gamma + torch.clamp(h2 - gamma, max=0.5 * np.pi)
        arc = (0.25 * (-torch.cos(2.0 * h1 - gamma) + torch.cos(gamma)
                       + 2.0 * h1 * torch.sin(gamma))
               + 0.25 * (-torch.cos(2.0 * h2 - gamma) + torch.cos(gamma)
                         + 2.0 * h2 * torch.sin(gamma)))
        ao = ao + n_len * arc
    ao = torch.clamp(ao / n_slices, 0.0, 1.0) ** power
    return torch.where(hit, ao, 1.0)
