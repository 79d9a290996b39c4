"""The pair route's fold (K6): the CUDA kernel's wrapper and the dispatch
between it and its plain version.

Counterpart of the Pallas call in toyrenderer_tpu/ops/rt_pairs.py:348.
The TPU kernel it replaces, `_make_pairs_kernel` (rt_pairs.py:145),
becomes csrc/pairs.cu, built by nvcc into the build directory at first
use and called through ctypes; its plain version is
ops/rt_pairs.pair_fold_plain.  Each launch adds one to
bvh_cuda.launches_by_kernel['K6'].

The kernel splits the walked pairs evenly: block b's list takes positions
walk_end[b - 1] .. walk_end[b] - 1 of one line (`walk_ends`), cut into
work items of ITEM positions, one CTA each; the CTA finds a position's
block by a binary search over walk_end (`walk_positions` is its plain
version), packs each run's live rays onto its first warps, and merges
each ray's best (t, ordinal) into a 64-bit key with atomicMin, which the
wrapper unpacks (`rt_pairs.unpack_keys`).
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
    BLOCK, INF_KEY, NFEAT, NSLAB, SLAB, pair_fold_plain, unpack_keys)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pairs.cu"
ITEM = 16                # walked positions per work item (kItem)
WARPS = BLOCK // 32      # warps of a CTA, a ray a thread


def walk_ends(n_walk) -> torch.Tensor:
    """(B,) i32 inclusive prefix sums of n_walk: block b's walked pairs
    are positions walk_end[b] - n_walk[b] .. walk_end[b] - 1 of the
    line the kernel cuts into work items."""
    return torch.cumsum(n_walk, 0, dtype=torch.int32)


def walk_positions(starts, n_walk, positions):
    """(block, pair) i64 of each position of the line (the kernel's
    block_of and its pair-list index, in plain PyTorch): the first block
    whose walk ends past it, and starts[block] + its rank in that
    block's walk."""
    ends = walk_ends(n_walk).long()
    q = positions.long()
    blk = torch.searchsorted(ends, q, right=True)
    begin = ends[blk] - n_walk.long()[blk]
    return blk, starts.long()[blk] + q - begin


def census(rays, starts, n_walk, n_list: int) -> dict:
    """What one launch on these arguments does: ray blocks with pairs,
    the largest and mean walk of those blocks, work items (and the grid,
    one CTA per ITEM entries of the pair list), runs (an item's
    positions of one block), and of the runs' warps those that skip the
    arithmetic: a run packs its block's live rays onto the first
    threads, so ceil(live / 32) warps work."""
    n_walk = n_walk.long()
    total = int(n_walk.sum())
    walking = n_walk[n_walk > 0]
    q = torch.arange(total, device=rays.device)
    blk, _ = walk_positions(starts, n_walk, q)
    first = (q % ITEM == 0) | torch.cat(
        [torch.ones(min(total, 1), dtype=torch.bool, device=rays.device),
         blk[1:] != blk[:-1]])
    busy = -(-(rays[..., 7] > 0).sum(-1) // 32)          # (B,) warps
    runs = blk[first]
    return dict(blocks_with_pairs=int(walking.numel()),
                n_walk_max=int(walking.max()) if walking.numel() else 0,
                n_walk_mean=float(walking.double().mean())
                if walking.numel() else 0.0,
                work_items=-(-total // ITEM), grid=-(-n_list // ITEM),
                runs=int(runs.numel()), warp_runs=int(runs.numel()) * WARPS,
                warp_runs_skipped=int((WARPS - busy[runs]).sum()))


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
                   + [ctypes.c_void_p] * 2)
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
    if rays.data_ptr() % 16 or feat.data_ptr() % 16:
        raise ValueError("rays and feat: must be 16-byte aligned")
    walk_end = walk_ends(n_walk)
    keys = torch.full((b * BLOCK,), INF_KEY, dtype=torch.int64, device=dev)
    err = kernel_library().pairs_launch(
        rays.data_ptr(), feat.data_ptr(), feat.shape[0], pchk.data_ptr(),
        pchk.shape[0], starts.data_ptr(), walk_end.data_ptr(), b,
        keys.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pairs kernel launch failed: CUDA error {err}")
    bvh_cuda.launches_by_kernel['K6'] += 1
    return unpack_keys(keys)


def pair_fold(rays, feat, pchk, starts, n_walk):
    """Fold each ray block's listed chunks (see pair_fold_plain): CUDA
    tensors launch the kernel, CPU tensors run the plain version."""
    dev = rays.device
    if dev.type == 'cuda':
        return launch(rays, feat, pchk, starts, n_walk)
    if dev.type == 'cpu':
        return pair_fold_plain(rays, feat, pchk, starts, n_walk)
    raise ValueError(f"pair_fold: unsupported device {dev}")
