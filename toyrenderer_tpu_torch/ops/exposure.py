"""Auto-exposure: log-luminance histogram + temporal adaptation.

Counterpart of toyrenderer_tpu/ops/exposure.py (reference:
source/AdaptLuminanceRenderer.cpp + adaptluminance.hlsl:12-97, a 256-bin
log2-luminance histogram and a weighted-mean exposure adaptation).  The
adaptation uses only the histogram's weighted mean bin, so it is two
reductions over the per-pixel bin indices; both count in integers
(exactly, in any order), and the exposure stays on the device in the
frame's carry.
"""

from __future__ import annotations

import numpy as np
import torch

NUM_BINS = 256
MIN_LOG_LUM = -10.0
MAX_LOG_LUM = 6.0
LOG_LUM_RANGE = MAX_LOG_LUM - MIN_LOG_LUM


def luminance(rgb):
    return (rgb[..., 0] * 0.2127 + rgb[..., 1] * 0.7152
            + rgb[..., 2] * 0.0722)


def _bin_indices(hdr):
    lum = luminance(hdr)
    log_lum = torch.log2(torch.clamp(lum, min=1e-20))
    t = torch.clamp((log_lum - MIN_LOG_LUM) / LOG_LUM_RANGE, 0.0, 1.0)
    return torch.where(lum < 1e-8, 0,
                       (t * (NUM_BINS - 2) + 1.5).to(torch.int32))


def luminance_histogram(hdr):
    """(H, W, 3) HDR -> (256,) f32 histogram; bin 0 collects true black
    (the reference shader's convention).  Integer counts."""
    flat = _bin_indices(hdr).reshape(-1).long()
    return torch.bincount(flat, minlength=NUM_BINS).to(torch.float32)


def average_log_luminance(hist):
    """Weighted-mean log2 luminance over non-black pixels."""
    idx = torch.arange(NUM_BINS, dtype=torch.float32, device=hist.device)
    weighted = torch.sum(hist[1:] * idx[1:])
    n = torch.clamp(torch.sum(hist[1:]), min=1.0)
    mean_bin = weighted / n
    return (mean_bin - 1.0) / (NUM_BINS - 2) * LOG_LUM_RANGE + MIN_LOG_LUM


def adapt_exposure(hdr, prev_exposure, dt: float = 1.0 / 60.0,
                   adaptation_speed: float = 1.5,
                   key_value: float = 0.18,
                   min_exposure: float = 1e-4,
                   max_exposure: float = 1e4):
    """Returns (new_exposure, aux) given this frame's HDR output:
    exposure = key / average luminance, approached exponentially at
    `adaptation_speed` (the reference's eye-adaptation lerp).  The mean
    bin is the integer sum of the non-black bins over their integer
    count."""
    bins = _bin_indices(hdr)
    nonblack = bins > 0
    n = torch.clamp(torch.sum(nonblack, dtype=torch.int64), min=1)
    total = torch.sum(torch.where(nonblack, bins, 0), dtype=torch.int64)
    mean_bin = total.to(torch.float32) / n.to(torch.float32)
    avg_log = ((mean_bin - 1.0) / (NUM_BINS - 2) * LOG_LUM_RANGE
               + MIN_LOG_LUM)
    avg_lum = torch.exp2(avg_log)
    target = torch.clamp(key_value / torch.clamp(avg_lum, min=1e-8),
                         min_exposure, max_exposure)
    # f32 arithmetic on the host, as the reference evaluates it
    alpha = float(np.float32(1.0)
                  - np.exp(np.float32(-dt * adaptation_speed)))
    new_exposure = prev_exposure + (target - prev_exposure) * alpha
    return new_exposure, dict(avg_luminance=avg_lum,
                              target_exposure=target)
