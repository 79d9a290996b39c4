"""Bounded-displacement bilinear reprojection warp: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of toyrenderer_tpu/ops/warp_pallas.py.  The TPU kernel it
replaces, `_warp_kernel` (warp_pallas.py:41), becomes csrc/warp.cu,
built by nvcc into the build directory at first use and called through
ctypes.  TAA (ops/taa.py) resamples its history through it, and the
shadow denoiser (ops/denoise.py) its half-resolution history.

`warp_bilinear` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback from one to the other.
Callers reject history whose true displacement exceeds the clamp (TAA's
fast-motion rejection).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops.raster_cuda import NVCC_FLAGS, _check, nvcc_path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "warp.cu"
MAX_DISP = 8            # +-pixels of reprojection reach

# launches of the CUDA kernel since the last reset; the plain version
# never counts
launches = 0


def _reach(max_disp: int) -> float:
    """The displacement clamp, max_disp - 1e-3 rounded as f32 (the TPU
    kernel's `lim`); a Python float that is exactly that f32 value."""
    return float(np.float32(max_disp) - np.float32(1e-3))


def warp_bilinear_plain(img, motion, max_disp: int = MAX_DISP):
    """The kernel's function in plain PyTorch, on any device: img (H, W,
    C) f32 sampled bilinearly at clip(p - motion, 0, dim - 1), the
    displacement clipped to the reach, taps clamped to the edge; each
    channel summed as the kernel sums it.  Returns (H, W, C) f32."""
    h, w, c = img.shape
    dev = img.device
    lim = _reach(max_disp)
    yg = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(
        h, w)
    xg = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(
        h, w)
    dyf = torch.clamp(torch.clamp(yg - motion[..., 1], 0.0, h - 1.0) - yg,
                      -lim, lim)
    dxf = torch.clamp(torch.clamp(xg - motion[..., 0], 0.0, w - 1.0) - xg,
                      -lim, lim)
    fy = torch.floor(dyf)
    fx = torch.floor(dxf)

    def tent(d, f):
        return torch.clamp(1.0 - torch.abs(d - f), min=0.0)[..., None]
    wy0, wy1 = tent(dyf, fy), tent(dyf, fy + 1.0)
    wx0, wx1 = tent(dxf, fx), tent(dxf, fx + 1.0)
    iy = torch.arange(h, device=dev)[:, None] + fy.long()
    ix = torch.arange(w, device=dev)[None, :] + fx.long()
    y0, y1 = torch.clamp(iy, 0, h - 1), torch.clamp(iy + 1, 0, h - 1)
    x0, x1 = torch.clamp(ix, 0, w - 1), torch.clamp(ix + 1, 0, w - 1)
    flat = img.reshape(h * w, c)

    def tap(yy, xx):
        return flat[yy * w + xx]
    top = wx0 * tap(y0, x0) + wx1 * tap(y0, x1)
    bot = wx0 * tap(y1, x0) + wx1 * tap(y1, x1)
    return wy0 * top + wy1 * bot


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    so = shared_library([nvcc_path(), *NVCC_FLAGS], SOURCE, "warp.so")
    lib = ctypes.CDLL(str(so))
    fn = lib.warp_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib


def launch(img, motion, max_disp: int = MAX_DISP):
    """One launch of the CUDA kernel on the current stream; returns the
    warped (H, W, C) f32 image."""
    global launches
    if img.dim() != 3:
        raise ValueError(f"img: want (H, W, C), got {tuple(img.shape)}")
    h, w, c = img.shape
    dev = img.device
    _check(img, 'img', torch.float32, (h, w, c), dev)
    _check(motion, 'motion', torch.float32, (h, w, 2), dev)
    if motion.data_ptr() % 8:
        raise ValueError("motion: must be 8-byte aligned")
    out = torch.empty_like(img)
    err = kernel_library().warp_launch(
        img.data_ptr(), motion.data_ptr(), out.data_ptr(), h, w, c,
        _reach(max_disp), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warp kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def warp_bilinear(img, motion, max_disp: int = MAX_DISP):
    """Reproject img (H, W, C) by per-pixel motion (H, W, 2, x/y order:
    prev = cur - motion), bilinear, displacement clamped to +-max_disp
    (warp_pallas.py:83).  CUDA tensors launch the kernel, CPU tensors run
    the plain version."""
    dev = img.device
    if dev.type == 'cuda':
        return launch(img, motion, max_disp)
    if dev.type == 'cpu':
        return warp_bilinear_plain(img, motion, max_disp)
    raise ValueError(f"warp_bilinear: unsupported device {dev}")
