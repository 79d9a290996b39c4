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

The kernel's walk reads only those first entries, and of the big list
only the triangles whose tile bbox holds the tile; its exact pass and
the plain version read every slot.  They agree on tables laid out as
bin_triangles lays them, with records that cover no pixel outside their
triangle's bbox, as the setup's do.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops.raster import (
    RasterConfig, dense_records, fill_dense, fill_visibility)
from toyrenderer_tpu_torch.ops.raster_cuda import (
    EXACT_LIST_HEAD, NVCC_FLAGS, REGIONS, TILE_WALK, _check, big_boxes,
    check_records, crop_image, exact_units, image_to_tiles, nvcc_path,
    pad_image, tiles_to_image)

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
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return lib


@dataclass
class DenseInputs:
    """Everything one call of the kernel reads, on one device, padded to
    the tile grid (built by `dense_inputs`, consumed by `launch_inputs`
    and `fill_dense_plain`)."""
    tri_rec: torch.Tensor          # (T, 16) raster records
    table: torch.Tensor            # (tiles, K) i32
    count: torch.Tensor            # (tiles,) i32
    big_list: torch.Tensor         # (B,) i32
    big_box: torch.Tensor          # (B, 4) i32: tile bbox, tx0 tx1 ty0 ty1
    bighit: torch.Tensor           # (tiles,) i32: 1 = a big bbox holds it
    row_start: torch.Tensor        # (tiles,) i32: tile * K
    tile_order: torch.Tensor       # (tiles,) i32, heaviest first
    cfg: RasterConfig
    init_z: torch.Tensor | None    # (Hp, Wp) f32, or None: depth 0
    init_id: torch.Tensor | None   # (Hp, Wp) i32, or None: id -1
    emit_base: int


def dense_inputs(setup: dict, tile_table, tile_count, big_list,
                 cfg: RasterConfig, init_depth=None, init_tri_id=None,
                 emit_base: int = 0) -> DenseInputs:
    """Check and pad one call's arguments (`fill_visibility_dense`'s).
    Each tile's row is its stretch of a pair stream of stride K; a tile
    tests the big triangles whose tile bbox holds it, and the tiles with
    the most tests start first so they do not set the call's tail."""
    i32, f32 = torch.int32, torch.float32
    tri_rec = dense_records(setup)
    dev = tri_rec.device
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
    check_records(tri_rec, tri_rec.shape[0], dev)
    _check(tile_table, 'tile_table', i32, (nt, k), dev)
    _check(tile_count, 'tile_count', i32, (nt,), dev)
    _check(big_list, 'big_list', i32, (cfg.max_big_tris,), dev)
    for name, x, dtype in (('init_depth', init_z, f32),
                           ('init_tri_id', init_id, i32)):
        if x is not None:
            _check(x, name, dtype, (hp, wp), dev)
    big_box, big_tests = big_boxes(setup, big_list, cfg)
    return DenseInputs(
        tri_rec=tri_rec, table=tile_table, count=tile_count,
        big_list=big_list, big_box=big_box,
        bighit=(big_tests > 0).to(i32),
        row_start=torch.arange(nt, dtype=i32, device=dev) * k,
        tile_order=torch.sort(tile_count + big_tests.to(i32),
                              descending=True, stable=True).indices.to(i32),
        cfg=cfg, init_z=init_z, init_id=init_id, emit_base=emit_base)


def launch_inputs(inp: DenseInputs, exact: dict | None = None):
    """One call of the CUDA kernel on the current stream -- a check of
    the records for NaN depths, the warp walk, then its exact pass over
    the units the walk left to it (csrc/fill_dense.cu) -- returns (depth
    (H, W), tri_id (H, W)).  With `exact` (a dict), it also receives
    `units`, the units the exact pass walked, of the call's tiles x 8."""
    global launches
    cfg = inp.cfg
    dev = inp.tri_rec.device
    hp, wp = cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w
    nt = cfg.num_tiles
    z = torch.empty((hp, wp), dtype=torch.float32, device=dev)
    tid = torch.empty((hp, wp), dtype=torch.int32, device=dev)
    # the exact pass's list (csrc/tile_walk.cuh, kListHead)
    exact_list = torch.empty(nt * REGIONS + EXACT_LIST_HEAD,
                             dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()
    err = kernel_library().fill_dense_launch(
        inp.tri_rec.data_ptr(), inp.table.data_ptr(),
        inp.row_start.data_ptr(), inp.count.data_ptr(),
        inp.bighit.data_ptr(), inp.big_list.data_ptr(),
        inp.big_box.data_ptr(), inp.tile_order.data_ptr(),
        cfg.max_tris_per_tile, cfg.max_big_tris, ptr(inp.init_z),
        ptr(inp.init_id), z.data_ptr(), tid.data_ptr(),
        exact_list.data_ptr(), inp.tri_rec.shape[0], nt, cfg.tiles_x, wp,
        inp.emit_base, cfg.chunk, 1.0 / cfg.width, 1.0 / cfg.height,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fill_dense kernel launch failed: CUDA error "
                           f"{err}")
    if exact is not None:
        exact['units'] = exact_units(exact_list, nt)
    launches += 1
    return crop_image(z, cfg), crop_image(tid, cfg)


def launch(setup: dict, tile_table, tile_count, big_list, cfg: RasterConfig,
           init_depth=None, init_tri_id=None, emit_base: int = 0,
           exact: dict | None = None):
    """One call of the CUDA kernel on `dense_inputs`' arguments
    (launch_inputs); returns (depth (H, W), tri_id (H, W))."""
    return launch_inputs(dense_inputs(setup, tile_table, tile_count,
                                      big_list, cfg, init_depth,
                                      init_tri_id, emit_base), exact)


def fill_dense_plain(inp: DenseInputs):
    """The kernel's function on `inp` in plain PyTorch, on any device:
    raster.fill_dense on its records and padded planes, as
    raster.fill_visibility runs it (the reference the kernel is held
    against on the card)."""
    cfg = inp.cfg
    hp, wp = cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w
    dev = inp.table.device
    init_z = (torch.zeros((hp, wp), dtype=torch.float32, device=dev)
              if inp.init_z is None else inp.init_z)
    init_id = (torch.full((hp, wp), -1, dtype=torch.int32, device=dev)
               if inp.init_id is None else inp.init_id)
    z, tid = fill_dense(inp.tri_rec, inp.table, inp.big_list, cfg,
                        image_to_tiles(init_z, cfg),
                        image_to_tiles(init_id, cfg), inp.emit_base)
    return (crop_image(tiles_to_image(z, cfg), cfg),
            crop_image(tiles_to_image(tid, cfg), cfg))


def walked_pairs_by_tile(inp: DenseInputs):
    """(tile, triangle) i64 of every record the kernel's walk tests: each
    tile's first tile_count table entries, then the big triangles whose
    tile bbox holds it (the census of the corner reject,
    raster_cuda.pairs_census, reads them)."""
    cfg = inp.cfg
    nt, k = inp.table.shape
    dev = inp.table.device
    own = torch.arange(k, device=dev)[None, :] < inp.count[:, None]
    tiles = torch.arange(nt, device=dev)
    tx, ty = tiles % cfg.tiles_x, tiles // cfg.tiles_x
    b = inp.big_box.long()
    hit = ((inp.big_list >= 0)[None, :]
           & (tx[:, None] >= b[None, :, 0]) & (tx[:, None] <= b[None, :, 1])
           & (ty[:, None] >= b[None, :, 2]) & (ty[:, None] <= b[None, :, 3]))
    big_tile, big_at = torch.nonzero(hit, as_tuple=True)
    return (torch.cat([torch.nonzero(own, as_tuple=True)[0], big_tile]),
            torch.cat([inp.table[own].long(),
                       inp.big_list[big_at].long()]))


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
