"""Temporal anti-aliasing.

Counterpart of toyrenderer_tpu/ops/taa.py (reference:
source/TAARenderer.cpp, which wraps DLSS/FSR): motion-vector
reprojection of the history, variance-clip neighbourhood clamping, and
an exponential blend, at display resolution.

The history resample is the warp kernel (ops/warp_cuda.py, K4) with its
fast-motion rejection -- history whose displacement exceeds the kernel's
reach is dropped -- on every device at min(H, W) >= 64, as the
reference package runs it on its accelerator; below that size, the
bilinear gather, as there.
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops.warp_cuda import MAX_DISP, warp_bilinear


def _pad_edge(img, top: int, bottom: int, left: int, right: int,
              dim: int = 0):
    """Edge-replicating pad of the row axis `dim` and the column axis
    after it."""
    h, w = img.shape[dim], img.shape[dim + 1]
    dev = img.device
    ry = torch.clamp(torch.arange(-top, h + bottom, device=dev), 0, h - 1)
    rx = torch.clamp(torch.arange(-left, w + right, device=dev), 0, w - 1)
    return img.index_select(dim, ry).index_select(dim + 1, rx)


def _sample_bilinear(img, y, x):
    """Bilinear sample img (H, W, C) at float coordinates (y, x), clamped
    to the image; the 2x2 footprint's taps are edge-clamped."""
    h, w, c = img.shape
    xp = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    yp = torch.cat([img[1:], img[-1:]], dim=0)
    xyp = torch.cat([yp[:, 1:], yp[:, -1:]], dim=1)
    pack = torch.cat([img, xp, yp, xyp], -1).reshape(h * w, 4 * c)

    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    rows = pack[y0.long() * w + x0.long()]               # (..., 4C)
    a = rows[..., 0 * c:1 * c]
    b = rows[..., 1 * c:2 * c]
    cc = rows[..., 2 * c:3 * c]
    d = rows[..., 3 * c:4 * c]
    return (a * (1 - fx) + b * fx) * (1 - fy) + (cc * (1 - fx)
                                                 + d * fx) * fy


def _neighborhood_moments(color):
    """3x3 mean and standard deviation per pixel (variance clip)."""
    p = _pad_edge(color, 1, 1, 1, 1)
    acc = torch.zeros_like(color)
    acc2 = torch.zeros_like(color)
    h, w = color.shape[:2]
    for dy in range(3):
        for dx in range(3):
            s = p[dy:dy + h, dx:dx + w]
            acc = acc + s
            acc2 = acc2 + s * s
    mean = acc / 9.0
    var = torch.clamp(acc2 / 9.0 - mean * mean, min=0.0)
    return mean, torch.sqrt(var)


def pixel_prev_coords(motion):
    """(prev_y, prev_x) (H, W): pixel centres minus motion, in the
    reference's association order."""
    h, w = motion.shape[:2]
    dev = motion.device
    py = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
          .expand(h, w) + 0.5)
    px = (torch.arange(w, dtype=torch.float32, device=dev)[None, :]
          .expand(h, w) + 0.5)
    return py - motion[..., 1] - 0.5, px - motion[..., 0] - 0.5


def taa_resolve(color, motion, history, history_valid,
                blend: float = 0.9, clip_gamma: float = 1.0):
    """One TAA step.

    color (H, W, 3) current jittered HDR frame; motion (H, W, 2) pixel
    motion (cur - prev); history (H, W, 3); history_valid a scalar
    tensor, 0 on the first frame.  Returns (output, new_history)."""
    h, w = color.shape[:2]
    prev_y, prev_x = pixel_prev_coords(motion)
    if min(h, w) >= 64:
        # the history takes the layout of the colour it was blended
        # from (channel-planar in the unculled frame); the warp reads HWC
        hist = warp_bilinear(history.contiguous(), motion.contiguous())
        fast = ((torch.abs(motion[..., 0]) > MAX_DISP - 1.0)
                | (torch.abs(motion[..., 1]) > MAX_DISP - 1.0))
    else:
        hist = _sample_bilinear(history, prev_y, prev_x)
        fast = torch.zeros((h, w), dtype=torch.bool, device=color.device)

    mean, sigma = _neighborhood_moments(color)
    lo = mean - sigma * clip_gamma
    hi = mean + sigma * clip_gamma
    hist = torch.minimum(torch.maximum(hist, lo), hi)

    off = ((prev_y < 0) | (prev_y > h - 1)
           | (prev_x < 0) | (prev_x > w - 1) | fast)
    alpha = torch.where(off[..., None], 0.0, blend * history_valid)
    out = color * (1.0 - alpha) + hist * alpha
    return out, out
