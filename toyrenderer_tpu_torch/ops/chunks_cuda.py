"""The chunk route's fold (K8): the CUDA kernel's wrapper and the
dispatch between it and its plain version.

K8 replaces no TPU kernel: the reference's chunk route
(toyrenderer_tpu/ops/rt_chunks.py:160-214) is XLA code that fuses its
(pairs, 128, 96) dense phase, which eager PyTorch cannot hold at a
frame's ray counts.  csrc/chunks.cu is built by nvcc into the build
directory at first use and called through ctypes; its plain version is
ops/rt_chunks.chunk_fold_plain.  Each launch adds one to
bvh_cuda.launches_by_kernel['K8'].

The work split is K6's (ops/pairs_cuda.py): block b's walked pairs take
positions walk_end[b - 1] .. walk_end[b] - 1 of one line, cut into work
items of 16 positions, one CTA of 128 threads (a ray each) per item.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops import bvh_cuda
from toyrenderer_tpu_torch.ops.pairs_cuda import walk_ends
from toyrenderer_tpu_torch.ops.raster_cuda import NVCC_FLAGS, _check, nvcc_path
from toyrenderer_tpu_torch.ops.rt_chunks import (
    BLOCK, CHUNK_FLOATS, chunk_fold_plain)
from toyrenderer_tpu_torch.ops.rt_pairs import INF_KEY, unpack_keys

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "chunks.cu"


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    so = shared_library([nvcc_path(), *NVCC_FLAGS], SOURCE, "chunks.so")
    lib = ctypes.CDLL(str(so))
    fn = lib.chunks_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    return lib


def launch(rays, data, pchk, starts, n_walk):
    """One launch of the CUDA kernel on the current stream, with
    chunk_fold_plain's arguments (blocks of 128 rays); returns (best_t,
    best_pay)."""
    dev = rays.device
    b = rays.shape[0]
    _check(rays, 'rays', torch.float32, (b, BLOCK, 8), dev)
    _check(data, 'data', torch.float32, (data.shape[0], CHUNK_FLOATS), dev)
    _check(pchk, 'pchk', torch.int32, (pchk.shape[0],), dev)
    _check(starts, 'starts', torch.int32, (b,), dev)
    _check(n_walk, 'n_walk', torch.int32, (b,), dev)
    if rays.data_ptr() % 16 or data.data_ptr() % 16:
        raise ValueError("rays and data: must be 16-byte aligned")
    walk_end = walk_ends(n_walk)
    keys = torch.full((b * BLOCK,), INF_KEY, dtype=torch.int64, device=dev)
    err = kernel_library().chunks_launch(
        rays.data_ptr(), data.data_ptr(), data.shape[0], pchk.data_ptr(),
        pchk.shape[0], starts.data_ptr(), walk_end.data_ptr(), b,
        keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunks kernel launch failed: CUDA error {err}")
    bvh_cuda.launches_by_kernel['K8'] += 1
    return unpack_keys(keys)


def chunk_fold(rays, data, pchk, starts, n_walk):
    """Fold each ray block's listed chunks (see chunk_fold_plain): CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    dev = rays.device
    if dev.type == 'cuda':
        return launch(rays, data, pchk, starts, n_walk)
    if dev.type == 'cpu':
        return chunk_fold_plain(rays, data, pchk, starts, n_walk)
    raise ValueError(f"chunk_fold: unsupported device {dev}")
