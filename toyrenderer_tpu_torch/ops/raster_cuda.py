"""Fused fill + resolve over the tile-sorted pair stream: host glue, the
CUDA kernel's wrapper, and its plain PyTorch version.

Counterpart of toyrenderer_tpu/ops/raster_pallas.py's streamed path
(`fill_resolve_stream`, `_stream_layout`, `pack_tri_records`,
`pad_image` / `crop_image`).  The TPU kernel it replaces,
`_fill_resolve_stream_kernel` (raster_pallas.py:294), becomes
csrc/fill_resolve.cu, built by nvcc into the build directory at first
use and called through ctypes.

`fill_resolve_stream` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no fallback from one to the
other.  Both walk exactly the pairs the pair budget admits
(`stream_layout`), the same accounting the frame's drop telemetry
reports.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops.gbuffer import INTERP_C, RESOLVE_REC
from toyrenderer_tpu_torch.ops.raster import (
    PEEL_BOUND, RasterConfig, bin_pairs_stream, fill_tiles, tile_table)

REC = 16
SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fill_resolve.cu"
# the tile walks, shared with fill_peel.cu and fill_dense.cu
TILE_WALK = SOURCE.with_name("tile_walk.cuh")
# the warp walk (tile_walk.cuh): a 16x128 tile is REGIONS regions of
# REGION_W x REGION_H pixels, one per warp; a record is rejected for a
# region by the corner test below, with tile_walk.cuh's margin constants
# (their derivation is there)
REGIONS = 8
REGION_W, REGION_H = 32, 8
WALK_WARPS = 4                  # warps per block (kWalkWarps)
# the exact pass's list head (tile_walk.cuh kListHead): the count of
# units left to it, and a flag for each block of K1's record check
EXACT_LIST_HEAD = 1 + 32 * WALK_WARPS
MARGIN_SCALE = 3.6e-7
MARGIN_FLOOR = 1e-37
MARGIN_CAP = 1e30
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# launches of the CUDA kernel since the last reset (the frame's proof that
# it went through the kernel); the plain version never counts
launches = 0


def pack_tri_records(setup: dict) -> torch.Tensor:
    """(T, 16) f32 raster records: [0:9] edge equations, [9:12] / [12:15]
    the AFFINE depth numerator / denominator coefficients
    (sum_v edges[v] * zs[v] / ws[v], folded in the reference package's
    association order, raster_pallas.py:43-48), [15] the triangle id."""
    t = setup['valid'].shape[0]
    e = setup['edges']                                   # (T, 3, 3)
    zs, ws = setup['zs'], setup['ws']
    numc = e[:, 0] * zs[:, 0:1] + e[:, 1] * zs[:, 1:2] + e[:, 2] * zs[:, 2:3]
    denc = e[:, 0] * ws[:, 0:1] + e[:, 1] * ws[:, 1:2] + e[:, 2] * ws[:, 2:3]
    ids = torch.arange(t, dtype=torch.float32, device=e.device)[:, None]
    return torch.cat([e.reshape(t, 9), numc, denc, ids], dim=1).contiguous()


def pad_image(img: torch.Tensor, cfg: RasterConfig, fill=0):
    """(..., H, W) -> (..., Hpad, Wpad) padded to the tile grid."""
    hpad = cfg.tiles_y * cfg.tile_h - img.shape[-2]
    wpad = cfg.tiles_x * cfg.tile_w - img.shape[-1]
    if hpad == 0 and wpad == 0:
        return img
    return torch.nn.functional.pad(img, (0, wpad, 0, hpad), value=fill)


def crop_image(img: torch.Tensor, cfg: RasterConfig):
    """(..., Hpad, Wpad) -> (..., H, W)."""
    return img[..., :cfg.height, :cfg.width]


def image_to_tiles(img: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(..., Hp, Wp) padded image -> (..., tiles, TH, TW)."""
    th, tw = cfg.tile_h, cfg.tile_w
    lead = img.shape[:-2]
    p = img.reshape(*lead, cfg.tiles_y, th, cfg.tiles_x, tw)
    return p.transpose(-3, -2).reshape(*lead, cfg.num_tiles, th, tw)


def tiles_to_image(tiles: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(..., tiles, TH, TW) -> (..., Hp, Wp) padded image."""
    th, tw = cfg.tile_h, cfg.tile_w
    lead = tiles.shape[:-3]
    img = tiles.reshape(*lead, cfg.tiles_y, cfg.tiles_x, th, tw)
    return img.transpose(-3, -2).reshape(
        *lead, cfg.tiles_y * th, cfg.tiles_x * tw)


def stream_layout(setup: dict, bins: dict, cfg: RasterConfig,
                  chunk: int) -> dict:
    """Chunk-grid accounting of the pair stream (raster_pallas.py:695).

    Each tile wants ceil(count / chunk) chunks, at least one where a big
    triangle's bbox touches it; the global budget of ch_cap chunks is
    handed out in tile order, so late tiles may get fewer.  Returns
    ch_cap, n_chunks (tiles,) granted, chunk_base (tiles+1,),
    total_chunks, counts_eff (tiles,) the pairs each tile walks,
    counts_clamped (the binned counts before the budget), bighit, and
    big_box (B, 4) each big-list entry's tile bbox (tx0, tx1, ty0, ty1):
    a triangle covers no pixel outside it, so a tile tests only the big
    triangles whose bbox holds it; tile_order (tiles,), the tiles by
    falling (pair + big-triangle) tests, the order in which the kernel
    starts them, so that the densest tiles do not set a launch's tail;
    and tile_len (tiles,) those tests, 0 on an unvisited tile: the
    length of each tile's list in the plain fills' walk (walk_tables),
    which the kernels' exact walk reads for the chunk grid.
    """
    t = setup['valid'].shape[0]
    c = chunk
    i32 = torch.int32
    p_cap = cfg.resolve_pair_capacity(t)
    ch_cap = -(-p_cap // c) + cfg.num_tiles
    counts = bins['counts']
    big_list = bins['big_list']
    dev = counts.device

    big_box, big_tests = big_boxes(setup, big_list, cfg)
    bighit = (big_tests > 0).to(i32)
    want = torch.maximum(-(-counts // c), bighit)
    zero = torch.zeros(1, dtype=i32, device=dev)
    before = torch.cat([zero, torch.cumsum(want, 0).to(i32)])[:-1]
    n_chunks = torch.minimum(torch.clamp(ch_cap - before, min=0), want)
    counts_eff = torch.minimum(counts, n_chunks * c)
    chunk_base = torch.cat([zero, torch.cumsum(n_chunks, 0).to(i32)])
    work = torch.where(n_chunks > 0, counts_eff + big_tests, 0)
    tile_order = torch.sort(work, descending=True, stable=True).indices
    return dict(ch_cap=ch_cap, n_chunks=n_chunks, chunk_base=chunk_base,
                total_chunks=chunk_base[-1], counts_eff=counts_eff,
                counts_clamped=counts, bighit=bighit,
                big_box=big_box, tile_order=tile_order.to(i32),
                tile_len=work.to(i32))


def big_boxes(setup: dict, big_list: torch.Tensor, cfg: RasterConfig):
    """(big_box (B, 4) i32, big_tests (tiles,)): each big-list entry's
    tile bbox (tx0, tx1, ty0, ty1), and for each tile the number of
    valid entries whose bbox holds it."""
    bvalid = big_list >= 0
    bl = torch.clamp(big_list, min=0).long()
    box = torch.stack([setup['tx0'][bl], setup['tx1'][bl],
                       setup['ty0'][bl], setup['ty1'][bl]], dim=1)
    dev = big_list.device
    btx = torch.arange(cfg.tiles_x, dtype=torch.int32, device=dev)
    bty = torch.arange(cfg.tiles_y, dtype=torch.int32, device=dev)
    hit_x = ((btx[None, :] >= box[:, 0:1])
             & (btx[None, :] <= box[:, 1:2]))                # (B, TX)
    hit_y = ((bty[None, :] >= box[:, 2:3])
             & (bty[None, :] <= box[:, 3:4]))                # (B, TY)
    big_tests = torch.sum(hit_y[:, :, None] & hit_x[:, None, :]
                          & bvalid[:, None, None], dim=0).reshape(-1)
    return box.to(torch.int32).contiguous(), big_tests


def dealt_units(tile_order: torch.Tensor):
    """(tile, region), each (B, WALK_WARPS) i64: the unit warp w of
    block b of the warp walk renders (tile_walk.cuh `region_pixels`).
    Warp w of block b takes unit w * B + b of the units ordered heaviest
    tile first (tile tile_order[u // REGIONS], region u % REGIONS),
    B = tiles * REGIONS / WALK_WARPS, so the densest tile's regions go to
    the first REGIONS blocks."""
    b = tile_order.shape[0] * REGIONS // WALK_WARPS
    dev = tile_order.device
    unit = (torch.arange(WALK_WARPS, device=dev)[None, :] * b
            + torch.arange(b, device=dev)[:, None])
    return tile_order.long()[unit // REGIONS], unit % REGIONS


def region_corners(cfg: RasterConfig, tiles: torch.Tensor,
                   regions: torch.Tensor):
    """(x0, x1, y0, y1): the corner pixel centres of region `regions` of
    tiles `tiles` (region q: columns REGION_W (q % 4) .. + REGION_W - 1,
    rows REGION_H (q // 4) .. + REGION_H - 1 of the tile), rounded as
    raster.tile_pixel_coords rounds every centre."""
    tx = (tiles % cfg.tiles_x).to(torch.float32)
    ty = (tiles // cfg.tiles_x).to(torch.float32)
    c0 = ((regions % 4) * REGION_W).to(torch.float32)
    r0 = ((regions // 4) * REGION_H).to(torch.float32)

    def centre(t, size, c, n):
        return (t * size + (c + 0.5)) * (1.0 / n)
    return (centre(tx, cfg.tile_w, c0, cfg.width),
            centre(tx, cfg.tile_w, c0 + (REGION_W - 1), cfg.width),
            centre(ty, cfg.tile_h, r0, cfg.height),
            centre(ty, cfg.tile_h, r0 + (REGION_H - 1), cfg.height))


def region_rejects(rec: torch.Tensor, corners) -> torch.Tensor:
    """The warp walk's reject in plain PyTorch (tile_walk.cuh
    `region_rejects`, the same f32 operations in the same order): (N,)
    bool, True where record rec[i] (N, 16) fails one edge function (all
    four corner values below -margin) or the depth denominator (all at or
    below -margin) at the corners of region i, `corners` as
    region_corners returns them.  margin = S * MARGIN_SCALE +
    MARGIN_FLOOR, S = |a| max|x| + |b| max|y| + |c|, bounds the rounding
    of the corner and the pixel evaluations, so a rejected record covers
    no pixel of the region; a function with S above MARGIN_CAP, or with
    a NaN, rejects nothing.  Used by the tests and chip_smoke.py's
    census, not by the fills."""
    x0, x1, y0, y1 = corners
    mx = torch.maximum(x0.abs(), x1.abs())
    my = torch.maximum(y0.abs(), y1.abs())
    out = torch.zeros(rec.shape[0], dtype=torch.bool, device=rec.device)
    for f, den in ((0, False), (3, False), (6, False), (12, True)):
        a, b, c = rec[:, f], rec[:, f + 1], rec[:, f + 2]
        s = (a.abs() * mx + b.abs() * my) + c.abs()
        m = -(s * MARGIN_SCALE + MARGIN_FLOOR)
        hit = s <= MARGIN_CAP
        for x, y in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
            v = a * x + b * y + c
            hit = hit & ((v <= m) if den else (v < m))
        out = out | hit
    return out


def walked_pairs_by_tile(inp) -> tuple[torch.Tensor, torch.Tensor]:
    """(tile, triangle) i64 of every record a streamed fill walks
    (`walk_tables`: each visited tile's own pairs in stream order, then
    the big triangles whose tile bbox holds it)."""
    table, big_table = walk_tables(inp.bins, inp.lay, inp.cfg)
    both = torch.cat([table, big_table], dim=1)
    tile, col = torch.nonzero(both >= 0, as_tuple=True)
    return tile, both[tile, col].long()


def region_census(inp) -> dict:
    """What the warp walk's reject leaves of one streamed fill's input
    (FillInputs or PeelInputs): pairs_census of its walked pairs."""
    return pairs_census(*walked_pairs_by_tile(inp), inp.tri_rec, inp.cfg)


def pairs_census(tile, tri, tri_rec, cfg: RasterConfig) -> dict:
    """What the warp walk's reject leaves of the (tile, triangle) records
    a fill walks, by the plain predicate: `regions_walked` (every walked
    (record, region) pair), `regions_kept` (those not rejected: each is
    tested at the region's 256 pixels), `densest_unit_walked` /
    `densest_unit_kept` (the most records one (tile, region) unit walks /
    keeps)."""
    rec = tri_rec[tri]
    nt = cfg.num_tiles
    kept = torch.zeros((REGIONS, nt), dtype=torch.int64,
                       device=rec.device)
    for q in range(REGIONS):
        region = torch.full_like(tile, q)
        keep = ~region_rejects(rec, region_corners(cfg, tile, region))
        kept[q] = torch.bincount(tile[keep], minlength=nt)
    walked = torch.bincount(tile, minlength=nt)
    return dict(regions_walked=int(tile.numel()) * REGIONS,
                regions_kept=int(kept.sum()),
                densest_unit_walked=int(walked.max()) if nt else 0,
                densest_unit_kept=int(kept.max()) if nt else 0)


def bin_pairs_with_budget(setup: dict, cfg: RasterConfig) -> dict:
    """raster.bin_pairs_stream, its drop counters joined by the pairs the
    chunk budget of the streamed fills leaves unwalked
    (`drop_pair_budget`, the accounting of stream_layout)."""
    bins = bin_pairs_stream(setup, cfg)
    acc = stream_layout(
        setup, bins, cfg,
        min(cfg.chunk, cfg.max_tris_per_tile, cfg.max_big_tris))
    bins['drop'] = dict(
        bins['drop'], drop_pair_budget=torch.sum(
            acc['counts_clamped'] - acc['counts_eff']))
    return bins


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    so = shared_library([nvcc_path(), *NVCC_FLAGS], SOURCE, "fill_resolve.so",
                        headers=(TILE_WALK,))
    lib = ctypes.CDLL(str(so))
    fn = lib.fill_resolve_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    return lib


@dataclass
class FillInputs:
    """Everything one fill reads, on one device, padded to the tile grid
    (built by `fill_inputs`; consumed by `launch` and `fill_resolve_plain`)."""
    tri_rec: torch.Tensor        # (T, 16) pack_tri_records
    res_rec: torch.Tensor        # (T, 64) resolve records
    bins: dict                   # bin_pairs_stream output
    lay: dict                    # stream_layout output
    cfg: RasterConfig
    # where no fragment wins, the outputs keep these; None stands for
    # the first layer's constants (depth 0, id -1, planes 0), which the
    # kernel writes without reading a plane
    init_z: torch.Tensor | None      # (Hp, Wp) f32
    init_id: torch.Tensor | None     # (Hp, Wp) i32
    init_rec: torch.Tensor | None    # (INTERP_C, Hp, Wp) f32
    peel: torch.Tensor | None        # (Hp, Wp) f32 exclusive near bound
    emit_base: int

    @property
    def padded_shape(self) -> tuple[int, int]:
        return (self.cfg.tiles_y * self.cfg.tile_h,
                self.cfg.tiles_x * self.cfg.tile_w)


def fill_inputs(setup: dict, resolve_records: torch.Tensor, bins: dict,
                cfg: RasterConfig, init_depth=None, init_tri_id=None,
                init_rec=None, emit_base: int = 0, padded_io: bool = False,
                peel_depth=None) -> FillInputs:
    """Pair accounting + padded init planes for one fill (see
    fill_resolve_stream for the arguments)."""
    c = min(cfg.chunk, cfg.max_tris_per_tile, cfg.max_big_tris)
    if cfg.max_tris_per_tile % c or cfg.max_big_tris % c:
        raise ValueError("max_tris_per_tile and max_big_tris must be "
                         "multiples of the stream chunk")

    def padded(img, fill=0):
        if img is None:
            return None
        return (img if padded_io else pad_image(img, cfg, fill)).contiguous()
    return FillInputs(
        tri_rec=pack_tri_records(setup), res_rec=resolve_records, bins=bins,
        lay=stream_layout(setup, bins, cfg, c), cfg=cfg,
        init_z=padded(init_depth), init_id=padded(init_tri_id, fill=-1),
        init_rec=padded(init_rec), peel=padded(peel_depth),
        emit_base=emit_base)


def init_planes(inp: FillInputs):
    """inp's (init_z, init_id, init_rec), with the first layer's
    constants made up where they are None."""
    hp, wp = inp.padded_shape
    dev = inp.res_rec.device
    z = inp.init_z
    if z is None:
        z = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
    tid = inp.init_id
    if tid is None:
        tid = torch.full((hp, wp), -1, dtype=torch.int32, device=dev)
    rec = inp.init_rec
    if rec is None:
        rec = torch.zeros((INTERP_C, hp, wp), dtype=torch.float32,
                          device=dev)
    return z, tid, rec


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


def check_records(tri_rec: torch.Tensor, t: int, device):
    """The raster records as the warp walk reads them: (T, 16) f32,
    contiguous, 16-byte aligned (four 16-byte loads a record)."""
    _check(tri_rec, 'tri_rec', torch.float32, (t, REC), device)
    if tri_rec.data_ptr() % 16:
        raise ValueError("tri_rec: must be 16-byte aligned")


def exact_units(exact_list: torch.Tensor, num_tiles: int):
    """The (tile, region) units a launch's exact pass walked, from its
    list (csrc/tile_walk.cuh, kListHead), as a device tensor: every unit
    where a check flag is set, else the units the walk left to it."""
    return torch.where(exact_list[1:EXACT_LIST_HEAD].any(),
                       num_tiles * REGIONS, exact_list[0])


def launch(inp: FillInputs, exact: dict | None = None):
    """One launch of the CUDA kernel on the current stream -- a check of
    the records for NaN depths, the warp walk, then its exact pass over
    the units the walk left to it (off the frames' domain:
    csrc/fill_resolve.cu) -- returns padded (depth, tri_id, planes).
    With `exact` (a dict), it also receives `units`, the units the exact
    pass walked (exact_units) of the launch's tiles x 8."""
    global launches
    dev = inp.tri_rec.device
    cfg = inp.cfg
    t = inp.tri_rec.shape[0]
    hp, wp = inp.padded_shape
    nt = cfg.num_tiles
    if (cfg.tile_h, cfg.tile_w) != (16, 128):
        raise ValueError("the CUDA fill kernel is built for 16x128 tiles")
    i32, f32 = torch.int32, torch.float32
    ints = {k: v.to(i32).contiguous() for k, v in dict(
        vals_s=inp.bins['vals_s'], offs=inp.bins['offs'][:-1],
        counts_eff=inp.lay['counts_eff'], n_chunks=inp.lay['n_chunks'],
        bighit=inp.lay['bighit'], big_list=inp.bins['big_list'],
        big_box=inp.lay['big_box'], tile_order=inp.lay['tile_order'],
        tile_len=inp.lay['tile_len']).items()}
    check_records(inp.tri_rec, t, dev)
    _check(inp.res_rec, 'resolve_records', f32, (t, RESOLVE_REC), dev)
    for k in ('offs', 'counts_eff', 'n_chunks', 'bighit', 'tile_order',
              'tile_len'):
        _check(ints[k], k, i32, (nt,), dev)
    _check(ints['vals_s'], 'vals_s', i32, ints['vals_s'].shape, dev)
    _check(ints['big_list'], 'big_list', i32, (cfg.max_big_tris,), dev)
    _check(ints['big_box'], 'big_box', i32, (cfg.max_big_tris, 4), dev)
    planes_in = dict(init_depth=(inp.init_z, f32, (hp, wp)),
                     init_tri_id=(inp.init_id, i32, (hp, wp)),
                     init_rec=(inp.init_rec, f32, (INTERP_C, hp, wp)),
                     peel_depth=(inp.peel, f32, (hp, wp)))
    for name, (x, dtype, shape) in planes_in.items():
        if x is not None:
            _check(x, name, dtype, shape, dev)

    def ptr(x):
        return None if x is None else x.data_ptr()
    z = torch.empty((hp, wp), dtype=f32, device=dev)
    tid = torch.empty((hp, wp), dtype=i32, device=dev)
    planes = torch.empty((INTERP_C, hp, wp), dtype=f32, device=dev)
    # the exact pass's list (csrc/tile_walk.cuh, kListHead)
    exact_list = torch.empty(nt * REGIONS + EXACT_LIST_HEAD, dtype=i32,
                             device=dev)
    err = kernel_library().fill_resolve_launch(
        inp.tri_rec.data_ptr(), inp.res_rec.data_ptr(),
        ints['vals_s'].data_ptr(), ints['offs'].data_ptr(),
        ints['counts_eff'].data_ptr(), ints['n_chunks'].data_ptr(),
        ints['bighit'].data_ptr(), ints['big_list'].data_ptr(),
        ints['big_box'].data_ptr(), ints['tile_order'].data_ptr(),
        ints['tile_len'].data_ptr(), cfg.max_big_tris, ptr(inp.init_z),
        ptr(inp.init_id), ptr(inp.init_rec), ptr(inp.peel), z.data_ptr(),
        tid.data_ptr(), planes.data_ptr(), exact_list.data_ptr(), t,
        nt, cfg.tiles_x, wp, hp, inp.emit_base, cfg.chunk, cfg.tile_batch,
        1.0 / cfg.width, 1.0 / cfg.height, PEEL_BOUND,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fill_resolve kernel launch failed: CUDA "
                           f"error {err}")
    if exact is not None:
        exact['units'] = exact_units(exact_list, nt)
    launches += 1
    return z, tid, planes


def walk_tables(bins: dict, lay: dict, cfg: RasterConfig):
    """What each tile walks, as the kernels walk it: (tiles, K) its own
    pairs in stream order (the pairs the budget admits), and (tiles, B)
    the big triangles whose tile bbox holds it (none for unvisited
    tiles), both -1 padded."""
    table = tile_table(bins['vals_s'], bins['offs'][:-1], lay['counts_eff'],
                       cfg.max_tris_per_tile)
    tiles = torch.arange(cfg.num_tiles, device=table.device)
    tx, ty = (tiles % cfg.tiles_x)[:, None], (tiles // cfg.tiles_x)[:, None]
    box = lay['big_box']
    in_box = ((tx >= box[None, :, 0]) & (tx <= box[None, :, 1])
              & (ty >= box[None, :, 2]) & (ty <= box[None, :, 3]))
    gets_big = ((lay['n_chunks'] > 0) & (lay['bighit'] > 0))[:, None]
    return table, torch.where(gets_big & in_box, bins['big_list'][None, :],
                              -1)


def fill_resolve_plain(inp: FillInputs):
    """The kernel's function in plain PyTorch, on any device (the CPU
    path, and the reference the kernel is held against on the card):
    the same pair accounting, the chunked edge/depth loop of
    `raster.fill_tiles` (each visited tile testing the big triangles
    whose tile bbox holds it), then `gbuffer.resolve_interpolants` on
    each won pixel.  Returns padded (depth, tri_id, planes)."""
    from toyrenderer_tpu_torch.ops.gbuffer import resolve_interpolants
    cfg = inp.cfg
    table, big_table = walk_tables(inp.bins, inp.lay, cfg)
    init_z, init_id, init_rec = init_planes(inp)
    z, win = fill_tiles(
        inp.tri_rec, table, big_table, cfg, image_to_tiles(init_z, cfg),
        None if inp.peel is None else image_to_tiles(inp.peel, cfg))
    z = tiles_to_image(z, cfg)
    win = tiles_to_image(win, cfg)
    won = win >= 0
    tid = torch.where(won, win + inp.emit_base, init_id)
    planes = resolve_interpolants(inp.res_rec, z, win, cfg,
                                  screen_wh=(cfg.width, cfg.height))
    return z, tid, torch.where(won[None], planes, init_rec)


def fill_resolve_stream(setup: dict, resolve_records: torch.Tensor,
                        bins: dict, cfg: RasterConfig, init_depth=None,
                        init_tri_id=None, init_rec=None, emit_base: int = 0,
                        padded_io: bool = False, peel_depth=None):
    """Streamed fused fill + interpolant resolve (raster_pallas.py:1005).

    resolve_records: (T, 64) f32 from gbuffer.pack_resolve_records.
    init_depth / init_tri_id / init_rec continue a previous fill;
    peel_depth is an EXCLUSIVE near bound (depth peeling).  Returns
    (depth (H, W), tri_id (H, W), interp (INTERP_C, H, W)), padded to
    the tile grid when padded_io.  CUDA tensors launch the kernel, CPU
    tensors run the plain version.
    """
    inp = fill_inputs(setup, resolve_records, bins, cfg, init_depth,
                      init_tri_id, init_rec, emit_base, padded_io,
                      peel_depth)
    dev = resolve_records.device
    if dev.type == 'cuda':
        z, tid, planes = launch(inp)
    elif dev.type == 'cpu':
        z, tid, planes = fill_resolve_plain(inp)
    else:
        raise ValueError(f"fill_resolve_stream: unsupported device {dev}")
    if padded_io:
        return z, tid, planes
    return crop_image(z, cfg), crop_image(tid, cfg), crop_image(planes, cfg)
