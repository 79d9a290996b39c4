"""The pair route's fold (K6): the CUDA kernel's wrapper and the dispatch
between it and its plain version.

Counterpart of the Pallas call in toyrenderer_tpu/ops/rt_pairs.py:348.
The TPU kernel it replaces, `_make_pairs_kernel` (rt_pairs.py:145),
becomes csrc/pairs.cu, built by nvcc into the build directory at first
use and called through ctypes; its plain version is
ops/rt_pairs.pair_fold_plain.  Each launch adds one to
bvh_cuda.launches_by_kernel['K6'].
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops import bvh_cuda
from toyrenderer_tpu_torch.ops.raster_cuda import NVCC_FLAGS, _check, nvcc_path
from toyrenderer_tpu_torch.ops.rt_pairs import (
    BLOCK, NFEAT, NSLAB, SLAB, pair_fold_plain)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pairs.cu"


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    so = shared_library([nvcc_path(), *NVCC_FLAGS], SOURCE, "pairs.so")
    lib = ctypes.CDLL(str(so))
    fn = lib.pairs_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    return lib


def launch(rays, feat, pchk, starts, n_walk):
    """One launch of the CUDA kernel on the current stream, with
    pair_fold_plain's arguments; returns (best_t, best_ord)."""
    dev = rays.device
    b = rays.shape[0]
    _check(rays, 'rays', torch.float32, (b, BLOCK, 8), dev)
    _check(feat, 'feat', torch.float32, (feat.shape[0], NFEAT, NSLAB * SLAB),
           dev)
    _check(pchk, 'pchk', torch.int32, (pchk.shape[0],), dev)
    _check(starts, 'starts', torch.int32, (b,), dev)
    _check(n_walk, 'n_walk', torch.int32, (b,), dev)
    if rays.data_ptr() % 16:
        raise ValueError("rays: must be 16-byte aligned")
    t = torch.empty(b * BLOCK, dtype=torch.float32, device=dev)
    ordi = torch.empty(b * BLOCK, dtype=torch.int32, device=dev)
    err = kernel_library().pairs_launch(
        rays.data_ptr(), feat.data_ptr(), feat.shape[0], pchk.data_ptr(),
        pchk.shape[0], starts.data_ptr(), n_walk.data_ptr(), b,
        t.data_ptr(), ordi.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs kernel launch failed: CUDA error {err}")
    bvh_cuda.launches_by_kernel['K6'] += 1
    return t, ordi


def pair_fold(rays, feat, pchk, starts, n_walk):
    """Fold each ray block's listed chunks (see pair_fold_plain): CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    dev = rays.device
    if dev.type == 'cuda':
        return launch(rays, feat, pchk, starts, n_walk)
    if dev.type == 'cpu':
        return pair_fold_plain(rays, feat, pchk, starts, n_walk)
    raise ValueError(f"pair_fold: unsupported device {dev}")
