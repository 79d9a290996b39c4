"""L-layer depth-peel fill over the tile-sorted pair stream: host glue,
the CUDA kernel's wrapper, and its plain PyTorch version.

Counterpart of toyrenderer_tpu/ops/raster_pallas.py's `fill_peel_stream`
(:942).  The TPU kernel it replaces, `_fill_peel_stream_kernel`
(raster_pallas.py:778), becomes csrc/fill_peel.cu, built by nvcc into
the build directory at first use and called through ctypes.

One pass over the pair stream keeps, per pixel, the L nearest fragments
in front of an occluder (reverse-Z: larger is nearer), nearest first, by
an insertion cascade; there is no resolve.  The alpha-masked set of the
culled frame runs it once instead of L full fill+resolve passes.

`fill_peel_stream` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no fallback from one to the
other.  Both walk exactly what K1 walks (`raster_cuda.stream_layout`:
chunk grant, pair budget, unvisited tiles keep their init planes, each
tile tests the big triangles whose tile bbox holds it).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops.raster import (
    PEEL_BOUND, RasterConfig, coverage_depth, tile_pixel_coords)
from toyrenderer_tpu_torch.ops.raster_cuda import (
    EXACT_LIST_HEAD, NVCC_FLAGS, REGIONS, TILE_WALK, _check, check_records,
    crop_image, exact_units, image_to_tiles, nvcc_path, pack_tri_records,
    pad_image, stream_layout, tiles_to_image, walk_tables)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fill_peel.cu"
MAX_LAYERS = 4                   # the kernel's register cascade depth

# launches of the CUDA kernel since the last reset; the plain version
# never counts
launches = 0


@dataclass
class PeelInputs:
    """Everything one peel fill reads, on one device, padded to the tile
    grid (built by `peel_inputs`; consumed by `launch` and
    `fill_peel_plain`)."""
    tri_rec: torch.Tensor        # (T, 16) pack_tri_records
    bins: dict                   # bin_pairs_stream output
    lay: dict                    # stream_layout output
    cfg: RasterConfig
    layers: int
    emit_base: int
    occluder: torch.Tensor | None    # (Hp, Wp) f32 seeding every layer;
    #                                  None = depth 0 (nothing in front)

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.cfg.tiles_y * self.cfg.tile_h,
                self.cfg.tiles_x * self.cfg.tile_w)


def peel_inputs(setup: dict, bins: dict, cfg: RasterConfig, layers: int = 2,
                emit_base: int = 0, occluder_depth=None) -> PeelInputs:
    """Pair accounting + the padded occluder for one peel fill."""
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"layers must be in 1..{MAX_LAYERS}, got {layers}")
    c = min(cfg.chunk, cfg.max_tris_per_tile, cfg.max_big_tris)
    occ = None
    if occluder_depth is not None:
        occ = pad_image(occluder_depth, cfg).contiguous()
    return PeelInputs(tri_rec=pack_tri_records(setup), bins=bins,
                      lay=stream_layout(setup, bins, cfg, c), cfg=cfg,
                      layers=layers, emit_base=emit_base, occluder=occ)


def init_planes(inp: PeelInputs):
    """(z (L, Hp, Wp), id (L, Hp, Wp)): the occluder (or 0) in every
    layer, id -1 -- what a pixel keeps where no fragment wins."""
    hp, wp = inp.padded_shape
    dev = inp.tri_rec.device
    occ = inp.occluder
    if occ is None:
        occ = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
    z = occ[None].expand(inp.layers, hp, wp).clone()
    tid = torch.full((inp.layers, hp, wp), -1, dtype=torch.int32,
                     device=dev)
    return z, tid


def cascade(z: list, ids: list, cz: torch.Tensor, ci: torch.Tensor):
    """Insert one fragment (depth cz, id ci) into the per-layer lists z /
    ids (nearest first), in place (raster_pallas.py:895-916).  At each
    layer a fragment within the PEEL_BOUND band at or below the layer's
    depth is dropped (coincident fragments, such as a quad's shared
    diagonal, must not take two layers); a strictly nearer one takes the
    layer and the displaced fragment carries on down."""
    for layer in range(len(z)):
        zl = z[layer]
        cz = torch.where((cz <= zl) & (cz >= zl * PEEL_BOUND), -1.0, cz)
        win = cz > zl
        z[layer] = torch.where(win, cz, zl)
        cz = torch.where(win, zl, cz)
        idl = ids[layer]
        ids[layer] = torch.where(win, ci, idl)
        ci = torch.where(win, idl, ci)


def peel_tiles(tri_rec: torch.Tensor, table: torch.Tensor,
               big_table: torch.Tensor, cfg: RasterConfig,
               init_z: torch.Tensor, emit_base: int):
    """The plain L-layer peel over whole tiles.

    table (tiles, K) / big_table (tiles, B): what each tile walks, in
    order, -1 padded (raster_cuda.walk_tables).  init_z: (L, tiles, TH,
    TW).  Returns (z, id), each (L, tiles, TH, TW): the cascade over
    every entry in stream order; depth and edge arithmetic as
    raster.fill_tiles evaluates them."""
    layers = init_z.shape[0]
    c = cfg.chunk
    ids_all = torch.cat([table, big_table], dim=1)
    lengths = (ids_all >= 0).sum(dim=1)
    z_out = init_z.clone()
    id_out = torch.full(init_z.shape, -1, dtype=torch.int32,
                        device=init_z.device)
    for b0 in range(0, table.shape[0], cfg.tile_batch):
        b1 = min(b0 + cfg.tile_batch, table.shape[0])
        tiles = torch.arange(b0, b1, device=table.device)
        pxn, pyn = tile_pixel_coords(cfg, tiles)
        pxn, pyn = pxn[:, None], pyn[:, None]            # (TB, 1, TH, TW)
        z = [z_out[layer, b0:b1] for layer in range(layers)]
        ids = [id_out[layer, b0:b1] for layer in range(layers)]
        # compact each row's entries (stream order kept) so the loop
        # stops at the batch's longest list
        rows = ids_all[b0:b1]
        order = torch.sort((rows < 0).to(torch.int8), dim=1,
                           stable=True).indices
        rows = torch.gather(rows, 1, order)
        n = int(lengths[b0:b1].max()) if b1 > b0 else 0
        for k0 in range(0, n, c):
            chunk_ids = rows[:, k0:k0 + c]                # (TB, C)
            r = tri_rec[torch.clamp(chunk_ids, min=0).long()]
            depth = torch.where((chunk_ids >= 0)[..., None, None],
                                coverage_depth(r, pxn, pyn), -1.0)
            for j in range(chunk_ids.shape[1]):
                ci = (chunk_ids[:, j] + emit_base)[:, None, None]
                cascade(z, ids, depth[:, j], ci)
        for layer in range(layers):
            z_out[layer, b0:b1] = z[layer]
            id_out[layer, b0:b1] = ids[layer]
    return z_out, id_out


def fill_peel_plain(inp: PeelInputs):
    """The kernel's function in plain PyTorch, on any device (the CPU
    path, and the reference the kernel is held against on the card).
    Returns padded (depth (L, Hp, Wp) f32, tri_id (L, Hp, Wp) i32)."""
    cfg = inp.cfg
    table, big_table = walk_tables(inp.bins, inp.lay, cfg)
    init_z, _ = init_planes(inp)
    z, tid = peel_tiles(inp.tri_rec, table, big_table, cfg,
                        image_to_tiles(init_z, cfg), inp.emit_base)
    return tiles_to_image(z, cfg), tiles_to_image(tid, cfg)


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    so = shared_library([nvcc_path(), *NVCC_FLAGS], SOURCE, "fill_peel.so",
                        headers=(TILE_WALK,))
    lib = ctypes.CDLL(str(so))
    fn = lib.fill_peel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return lib


def launch(inp: PeelInputs, exact: dict | None = None):
    """One launch of the CUDA kernel on the current stream -- the warp
    walk, then its exact pass over the units the walk left to it (an
    occluder below -1: csrc/tile_walk.cuh) -- returns padded (depth (L,
    Hp, Wp), tri_id (L, Hp, Wp)).  With `exact` (a dict), it also
    receives `units`, as raster_cuda.launch's does."""
    global launches
    dev = inp.tri_rec.device
    cfg = inp.cfg
    t = inp.tri_rec.shape[0]
    hp, wp = inp.padded_shape
    nt = cfg.num_tiles
    if (cfg.tile_h, cfg.tile_w) != (16, 128):
        raise ValueError("the CUDA peel kernel is built for 16x128 tiles")
    i32, f32 = torch.int32, torch.float32
    ints = {k: v.to(i32).contiguous() for k, v in dict(
        vals_s=inp.bins['vals_s'], offs=inp.bins['offs'][:-1],
        counts_eff=inp.lay['counts_eff'], n_chunks=inp.lay['n_chunks'],
        bighit=inp.lay['bighit'], big_list=inp.bins['big_list'],
        big_box=inp.lay['big_box'], tile_order=inp.lay['tile_order'],
        tile_len=inp.lay['tile_len']).items()}
    check_records(inp.tri_rec, t, dev)
    for k in ('offs', 'counts_eff', 'n_chunks', 'bighit', 'tile_order',
              'tile_len'):
        _check(ints[k], k, i32, (nt,), dev)
    _check(ints['vals_s'], 'vals_s', i32, ints['vals_s'].shape, dev)
    _check(ints['big_list'], 'big_list', i32, (cfg.max_big_tris,), dev)
    _check(ints['big_box'], 'big_box', i32, (cfg.max_big_tris, 4), dev)
    if inp.occluder is not None:
        _check(inp.occluder, 'occluder_depth', f32, (hp, wp), dev)
    z = torch.empty((inp.layers, hp, wp), dtype=f32, device=dev)
    tid = torch.empty((inp.layers, hp, wp), dtype=i32, device=dev)
    # the exact pass's list (csrc/tile_walk.cuh, kListHead)
    exact_list = torch.empty(nt * REGIONS + EXACT_LIST_HEAD, dtype=i32,
                             device=dev)
    err = kernel_library().fill_peel_launch(
        inp.tri_rec.data_ptr(), ints['vals_s'].data_ptr(),
        ints['offs'].data_ptr(), ints['counts_eff'].data_ptr(),
        ints['n_chunks'].data_ptr(), ints['bighit'].data_ptr(),
        ints['big_list'].data_ptr(), ints['big_box'].data_ptr(),
        ints['tile_order'].data_ptr(), ints['tile_len'].data_ptr(),
        cfg.max_big_tris,
        None if inp.occluder is None else inp.occluder.data_ptr(),
        z.data_ptr(), tid.data_ptr(), exact_list.data_ptr(),
        nt, cfg.tiles_x, wp, hp, inp.emit_base, inp.layers, cfg.chunk,
        cfg.tile_batch,
        1.0 / cfg.width, 1.0 / cfg.height, PEEL_BOUND,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fill_peel kernel launch failed: CUDA error {err}")
    if exact is not None:
        exact['units'] = exact_units(exact_list, nt)
    launches += 1
    return z, tid


def fill_peel_stream(setup: dict, bins: dict, cfg: RasterConfig,
                     layers: int = 2, emit_base: int = 0,
                     occluder_depth=None):
    """Streamed L-layer depth-peel visibility fill, no resolve
    (raster_pallas.py:942).

    occluder_depth: optional (H, W) reverse-Z depth seeding every layer:
    fragments at or behind it never take a layer.  Returns (depth (L, H,
    W) f32, tri_id (L, H, W) i32), layer 0 nearest; a layer no fragment
    reached keeps the occluder's depth and id -1.  CUDA tensors launch
    the kernel, CPU tensors run the plain version."""
    inp = peel_inputs(setup, bins, cfg, layers, emit_base, occluder_depth)
    dev = inp.tri_rec.device
    if dev.type == 'cuda':
        z, tid = launch(inp)
    elif dev.type == 'cpu':
        z, tid = fill_peel_plain(inp)
    else:
        raise ValueError(f"fill_peel_stream: unsupported device {dev}")
    return crop_image(z, cfg), crop_image(tid, cfg)
