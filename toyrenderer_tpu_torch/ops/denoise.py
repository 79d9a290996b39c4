"""Temporal + spatial denoiser for the 1-spp shadow mask.

Counterpart of toyrenderer_tpu/ops/denoise.py (the stand-in for the
reference's NRD SIGMA_SHADOW, ShadowMaskRenderer.cpp:405-532): motion-
reprojected exponential temporal accumulation with a disocclusion test,
then a depth-aware separable blur.

The history reprojection runs at half resolution through the warp
kernel (ops/warp_cuda.py, K4) with its fast-motion rejection, on every
device at min(H, W) >= 128 (the reference package's accelerator
branch); below that, through the half-resolution bilinear gather; and
at full resolution when H or W is odd.
"""

from __future__ import annotations

import numpy as np
import torch

from toyrenderer_tpu_torch.ops.taa import _sample_bilinear, pixel_prev_coords
from toyrenderer_tpu_torch.ops.texture import _avgpool2, _quad_expand
from toyrenderer_tpu_torch.ops.warp_cuda import MAX_DISP, warp_bilinear


def _blend(signal, hist, pdepth, off, depth, history_valid, blend,
           depth_tolerance):
    """History blend with the disocclusion test: the reprojected previous
    depth must match the current one within a relative tolerance
    (reverse-Z depths compared in 1/depth, ~ view distance)."""
    safe = torch.clamp(depth, min=1e-8)
    psafe = torch.clamp(pdepth, min=1e-8)
    rel = torch.abs(1.0 / safe - 1.0 / psafe) * safe
    disoccluded = (rel > depth_tolerance) | (pdepth <= 0.0) | (depth <= 0.0)
    alpha = torch.where(off | disoccluded, 0.0, blend * history_valid)
    return signal * (1.0 - alpha) + hist * alpha


def temporal_accumulate(signal, motion, history, history_valid,
                        depth, prev_depth, blend: float = 0.9,
                        depth_tolerance: float = 0.1):
    """Reproject the scalar history (H, W) along the motion vectors and
    blend it with `signal`; the reprojection resamples history and
    previous depth at half resolution and expands the result back."""
    h, w = signal.shape
    if h % 2 or w % 2:
        return _temporal_accumulate_full(
            signal, motion, history, history_valid, depth, prev_depth,
            blend, depth_tolerance)
    prev_y, prev_x = pixel_prev_coords(motion)
    pack_h = torch.stack([_avgpool2(history), _avgpool2(prev_depth)], -1)
    fast = torch.zeros((h, w), dtype=torch.bool, device=signal.device)
    if min(h, w) >= 128:
        mot_h = torch.stack([_avgpool2(motion[..., 0]) * 0.5,
                             _avgpool2(motion[..., 1]) * 0.5], -1)
        both_h = warp_bilinear(pack_h, mot_h)
        lim = 2.0 * (MAX_DISP - 1.0)     # full-res pixels of reach
        fast = ((torch.abs(motion[..., 0]) > lim)
                | (torch.abs(motion[..., 1]) > lim))
    else:
        both_h = _sample_bilinear(pack_h, (_avgpool2(prev_y) - 0.5) * 0.5,
                                  (_avgpool2(prev_x) - 0.5) * 0.5)
    both = _quad_expand(both_h)
    off = ((prev_y < 0) | (prev_y > h - 1) | (prev_x < 0)
           | (prev_x > w - 1) | fast)
    return _blend(signal, both[..., 0], both[..., 1], off, depth,
                  history_valid, blend, depth_tolerance)


def _temporal_accumulate_full(signal, motion, history, history_valid,
                              depth, prev_depth, blend, depth_tolerance):
    """Full-rate reprojection (odd dimensions)."""
    h, w = signal.shape
    prev_y, prev_x = pixel_prev_coords(motion)
    both = _sample_bilinear(torch.stack([history, prev_depth], -1),
                            prev_y, prev_x)
    off = ((prev_y < 0) | (prev_y > h - 1) | (prev_x < 0)
           | (prev_x > w - 1))
    return _blend(signal, both[..., 0], both[..., 1], off, depth,
                  history_valid, blend, depth_tolerance)


def depth_aware_blur(signal, depth, radius: int = 2,
                     depth_sigma: float = 0.05, sigma: float = 1.5):
    """Separable cross-bilateral blur weighted by depth similarity."""
    def pass_1d(x, d, dim):
        acc = torch.zeros_like(x)
        wacc = torch.zeros_like(x)
        inv_d = 1.0 / torch.clamp(d, min=1e-8)
        for k in range(-radius, radius + 1):
            xs = torch.roll(x, k, dims=dim)
            ds = torch.roll(d, k, dims=dim)
            inv_ds = 1.0 / torch.clamp(ds, min=1e-8)
            wd = torch.exp(-torch.abs(inv_d - inv_ds) * d / depth_sigma)
            wg = float(np.exp(np.float32(-0.5 * (k / sigma) ** 2)))
            # the centre tap always counts (sky pixels have depth 0 and
            # would otherwise divide by a zero weight)
            wk = wg * (wd if k == 0 else torch.where(ds > 0.0, wd, 0.0))
            acc = acc + xs * wk
            wacc = wacc + wk
        return acc / torch.clamp(wacc, min=1e-8)

    out = pass_1d(signal, depth, 1)
    return pass_1d(out, depth, 0)


def denoise_shadow(raw, motion, history, history_valid, depth, prev_depth,
                   blur_radius: int = 2):
    """Temporal accumulate, then the spatial blur.  Returns (denoised,
    new_history)."""
    acc = temporal_accumulate(raw, motion, history, history_valid,
                              depth, prev_depth)
    out = depth_aware_blur(acc, depth, radius=blur_radius)
    return torch.clamp(out, 0.0, 1.0), acc
