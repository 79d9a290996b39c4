"""Dense-table visibility fill: the CUDA kernel's wrapper.

Counterpart of toyrenderer_tpu/ops/raster_pallas.py's
`fill_visibility_pallas` (:172).  The TPU kernel it replaces,
`_fill_kernel` (raster_pallas.py:66), becomes csrc/fill_dense.cu, built
by nvcc into the build directory at first use and called through ctypes.

The fill reads the dense (tiles, K) table of `raster.bin_triangles` (each
tile's first `tile_count` entries, -1 padded) and the big list, and
keeps per pixel the nearest fragment and its triangle, continuing from
init planes.  `raster.rasterize` runs it.  `fill_visibility_dense`
launches the kernel for CUDA tensors and runs its plain version,
`raster.fill_visibility` on the same arguments, for CPU tensors; there
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops.raster import RasterConfig, fill_visibility
from toyrenderer_tpu_torch.ops.raster_cuda import (
    NVCC_FLAGS, REC, TILE_WALK, _check, big_boxes, crop_image, nvcc_path,
    pack_tri_records, pad_image)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fill_dense.cu"

# launches of the CUDA kernel since the last reset; the plain version
# never counts
launches = 0


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    so = shared_library([nvcc_path(), *NVCC_FLAGS], SOURCE, "fill_dense.so",
                        headers=(TILE_WALK,))
    lib = ctypes.CDLL(str(so))
    fn = lib.fill_dense_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return lib


def launch(setup: dict, tile_table, tile_count, big_list, cfg: RasterConfig,
           init_depth=None, init_tri_id=None, emit_base: int = 0):
    """One launch of the CUDA kernel on the current stream, on
    `fill_visibility_dense`'s arguments; returns (depth (H, W), tri_id
    (H, W))."""
    global launches
    i32, f32 = torch.int32, torch.float32
    tri_rec = pack_tri_records(setup)
    dev = tri_rec.device
    t = tri_rec.shape[0]
    hp, wp = cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w
    nt, k = cfg.num_tiles, cfg.max_tris_per_tile
    if (cfg.tile_h, cfg.tile_w) != (16, 128):
        raise ValueError("the CUDA dense fill kernel is built for 16x128 "
                         "tiles")
    if nt * k >= 2 ** 31:
        raise ValueError(f"tile table of {nt} x {k} slots: the kernel "
                         "indexes it with 32-bit offsets")
    init_z = None if init_depth is None else pad_image(init_depth, cfg)
    init_id = (None if init_tri_id is None
               else pad_image(init_tri_id, cfg, fill=-1))
    _check(tri_rec, 'tri_rec', f32, (t, REC), dev)
    _check(tile_table, 'tile_table', i32, (nt, k), dev)
    _check(tile_count, 'tile_count', i32, (nt,), dev)
    _check(big_list, 'big_list', i32, (cfg.max_big_tris,), dev)
    for name, x, dtype in (('init_depth', init_z, f32),
                           ('init_tri_id', init_id, i32)):
        if x is not None:
            _check(x, name, dtype, (hp, wp), dev)
    big_box, big_tests = big_boxes(setup, big_list, cfg)
    # each tile's row is its stretch of a pair stream of stride K; the
    # heaviest tiles start first so they do not set the launch's tail
    row_start = torch.arange(nt, dtype=i32, device=dev) * k
    bighit = (big_tests > 0).to(i32)
    tile_order = torch.sort(tile_count + big_tests.to(i32), descending=True,
                            stable=True).indices.to(i32)
    z = torch.empty((hp, wp), dtype=f32, device=dev)
    tid = torch.empty((hp, wp), dtype=i32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()
    err = kernel_library().fill_dense_launch(
        tri_rec.data_ptr(), tile_table.data_ptr(), row_start.data_ptr(),
        tile_count.data_ptr(), bighit.data_ptr(), big_list.data_ptr(),
        big_box.data_ptr(), tile_order.data_ptr(), cfg.max_big_tris,
        ptr(init_z), ptr(init_id), z.data_ptr(), tid.data_ptr(), nt,
        cfg.tiles_x, wp, emit_base, 1.0 / cfg.width, 1.0 / cfg.height,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fill_dense kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return crop_image(z, cfg), crop_image(tid, cfg)


def fill_visibility_dense(setup: dict, tile_table, tile_count, big_list,
                          cfg: RasterConfig, init_depth=None,
                          init_tri_id=None, emit_base: int = 0):
    """Dense-table fill (raster_pallas.py:172): returns (depth (H, W)
    f32, tri_id (H, W) i32).  init_depth / init_tri_id continue a
    previous fill; won pixels get their triangle id + emit_base.  CUDA
    tensors launch the kernel, CPU tensors run raster.fill_visibility
    (every tile walking its table row, then the whole big list)."""
    dev = tile_table.device
    if dev.type == 'cuda':
        return launch(setup, tile_table, tile_count, big_list, cfg,
                      init_depth, init_tri_id, emit_base)
    if dev.type == 'cpu':
        return fill_visibility(setup, tile_table, big_list, cfg, init_depth,
                               init_tri_id, emit_base)
    raise ValueError(f"fill_visibility_dense: unsupported device {dev}")
