"""Tile-binned software rasterizer: setup, binning, the plain fill.

Counterpart of toyrenderer_tpu/ops/raster.py.  The design is the
reference package's: 2D-homogeneous edge functions (no clipping stage;
triangles crossing w=0 rasterize their visible sheet), perspective-
correct barycentrics from the same edge values, reverse-Z depth.

Stages:
  1. `setup_triangles`  -- dense edge/depth setup + backface and
                           degenerate rejection
  2. `bin_pairs_stream` -- small triangles expand to (tile, tri) pairs
                           through a span-classed static slot grid; one
                           global sort by tile yields the tile-sorted
                           pair stream; triangles spanning more tiles
                           than the grid go to the big list
  3. `fill_visibility`  -- per tile, walk its triangle list in chunks
                           and keep the nearest fragment per pixel
                           (`fill_dense`: the reference's XLA fill,
                           step for step, on every input)

`rasterize` runs the three over the dense (tiles, K) table of
`bin_triangles`, its fill the dense-table kernel (ops/dense_cuda.py) on
the card; `rasterize_bruteforce` tests every triangle at every pixel, the
oracle for tiny scenes.

The sorts are stable and use the reference's exact keys: the pair order
inside a tile decides depth ties (the first fragment in stream order
wins), so the port's winners match the reference's pixel for pixel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from toyrenderer_tpu_torch.mathlib.transforms import cross


@dataclass(frozen=True)
class RasterConfig:
    width: int
    height: int
    tile_h: int = 16
    tile_w: int = 128
    max_tris_per_tile: int = 512     # K: per-tile list capacity
    chunk: int = 32                  # C: triangles processed per inner step
    bin_slots_y: int = 4             # static per-triangle tile-slot grid
    bin_slots_x: int = 2
    max_big_tris: int = 512          # B: full-screen-tested triangle budget
    tile_batch: int = 32             # TB: tiles per plain-fill step
    pair_capacity: int | None = None  # global (tile, tri) pair budget;
    #                                   None = T, clamped to tiles*K
    compact_frac: float = 0.5        # small-triangle compaction capacity
    bin_split: bool = True           # span-classed slot expansion
    short_frac: float = 0.125        # 2x1-span class capacity (frac of T)
    rest_frac: float = 0.0625        # full-grid class capacity (frac of T)

    def resolve_pair_capacity(self, t: int) -> int:
        cap = self.pair_capacity if self.pair_capacity else t
        return max(min(cap, t, self.num_tiles * self.max_tris_per_tile),
                   256)

    def compact_cap(self, t: int) -> int:
        return min(max(-(-int(t * self.compact_frac) // 8) * 8, 256), t)

    def short_cap(self, t: int) -> int:
        return min(max(-(-int(t * self.short_frac) // 8) * 8, 256), t)

    def rest_cap(self, t: int) -> int:
        return min(max(-(-int(t * self.rest_frac) // 8) * 8, 256), t)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def setup_triangles(geo: dict, cfg: RasterConfig) -> dict:
    """Clip-space triangles -> homogeneous edge equations ("setup").

    geo: output of geometry.meshlet_clip_triangles.  All arrays are
    (T, ...); invalid triangles get an empty tile bbox so they never bin.
    """
    clip = geo['clip']                              # (T, 3, 4)
    w = clip[..., 3]
    # normalized homogeneous screen coords: x in [0,1]*w, y-down
    xh = clip[..., 0] * 0.5 + 0.5 * w
    yh = 0.5 * w - clip[..., 1] * 0.5
    v = torch.stack([xh, yh, w], dim=-1)            # (T, 3, 3)

    # per-vertex positive scale normalization (projective invariant for
    # coverage; tracked via inv_scale for barycentrics)
    s = torch.clamp(torch.amax(torch.abs(v), dim=-1), min=1e-20)
    vs = v / s[..., None]
    inv_s = 1.0 / s

    n0 = cross(vs[:, 1], vs[:, 2])                  # edge opposite v0
    n1 = cross(vs[:, 2], vs[:, 0])
    n2 = cross(vs[:, 0], vs[:, 1])
    det = (vs[:, 0, 0] * n0[:, 0] + vs[:, 0, 1] * n0[:, 1]
           + vs[:, 0, 2] * n0[:, 2])                # orientation (scaled)

    # glTF CCW front faces project to det < 0 in this y-down space
    front = det < 0.0
    keep = (geo['tri_valid'] & (det != 0.0)
            & (front | geo['double_sided'])
            & torch.any(w > 1e-6, dim=-1))
    # inside iff all L_i >= 0 for either winding
    flip = torch.where(det < 0.0, -1.0, 1.0)[:, None]
    edges = torch.stack([n0, n1, n2], dim=1) * flip[..., None]

    # depth(p) = sum(L_i * zs_i) / sum(L_i * ws_i)
    zs = clip[..., 2] * inv_s
    ws = w * inv_s

    # tile bbox: NDC bbox when fully in front; else full screen (big path)
    all_front = torch.all(w > 1e-6, dim=-1)
    w_safe = torch.where(torch.abs(w) < 1e-20, 1e-20, w)
    sx = xh / w_safe
    sy = yh / w_safe
    xmin, xmax = torch.amin(sx, -1), torch.amax(sx, -1)
    ymin, ymax = torch.amin(sy, -1), torch.amax(sy, -1)
    off = all_front & ((xmax < 0) | (ymax < 0) | (xmin >= 1) | (ymin >= 1))
    keep = keep & ~off
    big = 1e9
    xmin = torch.where(all_front, xmin, 0.0)
    ymin = torch.where(all_front, ymin, 0.0)
    xmax = torch.where(all_front, xmax, big)
    ymax = torch.where(all_front, ymax, big)

    def tile_coord(x, size, tile, n, empty):
        t = torch.clamp(torch.floor(x * size / tile), 0, n - 1)
        return torch.where(keep, t, empty).to(torch.int32)
    out = dict(
        edges=edges, zs=zs, ws=ws, inv_s=inv_s,
        tx0=tile_coord(xmin, cfg.width, cfg.tile_w, cfg.tiles_x, 1.0),
        tx1=tile_coord(xmax, cfg.width, cfg.tile_w, cfg.tiles_x, 0.0),
        ty0=tile_coord(ymin, cfg.height, cfg.tile_h, cfg.tiles_y, 1.0),
        ty1=tile_coord(ymax, cfg.height, cfg.tile_h, cfg.tiles_y, 0.0),
        valid=keep, vtx_ids=geo['vtx_ids'], inst_id=geo['inst_id'],
        mat_id=geo['mat_id'],
        pair_meshlet=geo['pair_meshlet'], pair_inst=geo['pair_inst'],
    )
    return out


# Depth peeling re-rasterizes the next layer against the previous layer's
# stored depth; a fragment of the SAME surface must never pass its own
# bound, so the bound excludes a ~32-ulp relative band below the stored
# depth (reference package, raster.py:204-212).
PEEL_BOUND = 1.0 - 4e-6

# Triangles rasterize_bruteforce tests at every pixel per step.
BRUTEFORCE_CHUNK = 32


def span_classes(setup: dict, cfg: RasterConfig) -> dict:
    """(T,) bool masks of the binning classes: `big` (spans more tiles
    than the slot grid: tested by every tile its bbox holds), and the
    small triangles by tile span: `tiny` (1x1, one slot), `short` (1 x 2
    tiles, two slots) and `rest` (the full grid)."""
    spans_x = setup['tx1'] - setup['tx0'] + 1
    spans_y = setup['ty1'] - setup['ty0'] + 1
    big = setup['valid'] & ((spans_x > cfg.bin_slots_x)
                            | (spans_y > cfg.bin_slots_y))
    small = setup['valid'] & ~big
    tiny = small & (spans_x == 1) & (spans_y == 1)
    short = small & (spans_x == 1) & (spans_y == 2)
    return dict(big=big, small=small, tiny=tiny, short=short,
                rest=small & ~tiny & ~short)


def _sort_pairs(setup: dict, cfg: RasterConfig):
    """Shared binning core: expand small triangles to (tile, tri) pairs,
    sort by tile, and compact big triangles.

    Returns (vals_s sorted tri ids, offs (num_tiles+1,), counts
    (num_tiles,) i32 UNclamped, big_list (B,) i32, drop counters).
    """
    t = setup['valid'].shape[0]
    dev = setup['valid'].device
    i32 = torch.int32
    tx0, tx1 = setup['tx0'], setup['tx1']
    ty0, ty1 = setup['ty0'], setup['ty1']
    classes = span_classes(setup, cfg)
    is_big, small = classes['big'], classes['small']
    arange_t = torch.arange(t, dtype=i32, device=dev)

    def _compact_coords(mask, cap):
        """Sort-compact `mask`'s tri ids to a `cap` static prefix and
        gather their tile bboxes."""
        ckey = torch.where(mask, arange_t, t)
        order = torch.sort(ckey, stable=True).values[:cap]
        ok = order < t
        oc_ = torch.where(ok, order, 0).long()
        return oc_, ok, tx0[oc_], tx1[oc_], ty0[oc_], ty1[oc_]

    def _expand(mask, cap, sy_n, sx_n):
        """Slot-expand a span class to (cap * sy_n * sx_n) tile keys."""
        oc_, ok, tx0c, tx1c, ty0c, ty1c = _compact_coords(mask, cap)
        sy_ = torch.arange(sy_n, dtype=i32, device=dev)
        sx_ = torch.arange(sx_n, dtype=i32, device=dev)
        ty = ty0c[:, None, None] + sy_[None, :, None]   # (cap, sy, 1)
        tx = tx0c[:, None, None] + sx_[None, None, :]   # (cap, 1, sx)
        in_range = ((ty <= ty1c[:, None, None])
                    & (tx <= tx1c[:, None, None]) & ok[:, None, None])
        tile_id = ty * cfg.tiles_x + tx                  # (cap, sy, sx)
        keys_ = torch.where(in_range, tile_id, cfg.num_tiles).reshape(-1)
        vals_ = oc_.to(i32)[:, None, None].expand(tile_id.shape).reshape(-1)
        return keys_, vals_

    sy_full, sx_full = cfg.bin_slots_y, cfg.bin_slots_x
    use_split = cfg.bin_split and (sy_full * sx_full > 2)
    drop = {}

    def _class_drop(name, mask, cap):
        n = torch.sum(mask.to(i32))
        drop[name] = torch.clamp(n - cap, min=0)

    if use_split:
        # span-classed expansion: 1x1-span tris get 1 slot, 2x1 get 2,
        # only the rest pay the full Sy*Sx grid (same sorted pair set)
        tiny, short, rest = (classes[k] for k in ('tiny', 'short', 'rest'))
        _class_drop('drop_tiny', tiny, cfg.compact_cap(t))
        _class_drop('drop_short', short, cfg.short_cap(t))
        _class_drop('drop_rest', rest, cfg.rest_cap(t))
        parts = [_expand(tiny, cfg.compact_cap(t), 1, 1),
                 _expand(short, cfg.short_cap(t), 2, 1),
                 _expand(rest, cfg.rest_cap(t), sy_full, sx_full)]
        keys = torch.cat([p[0] for p in parts])
        tri_ids = torch.cat([p[1] for p in parts])
    else:
        _class_drop('drop_small', small, cfg.compact_cap(t))
        keys, tri_ids = _expand(small, cfg.compact_cap(t), sy_full, sx_full)
    tri_bits = max(t - 1, 1).bit_length()
    if tri_bits + (cfg.num_tiles + 1).bit_length() <= 31:
        # single-key sort: (tile << tri_bits) | tri
        combined = torch.sort((keys << tri_bits) | tri_ids,
                              stable=True).values
        keys_s = combined >> tri_bits
        vals_s = combined & ((1 << tri_bits) - 1)
    else:
        keys_s, order = torch.sort(keys, stable=True)
        vals_s = tri_ids[order]

    tile_range = torch.arange(cfg.num_tiles + 1, dtype=i32, device=dev)
    offs = torch.searchsorted(keys_s, tile_range, right=False).to(i32)
    counts = offs[1:] - offs[:-1]

    # big triangles: compact into fixed B slots
    b = cfg.max_big_tris
    key = torch.where(is_big, arange_t, t)
    big_sorted = torch.sort(key, stable=True).values[:min(b, t)]
    if t < b:                                       # tiny scenes
        big_sorted = torch.cat(
            [big_sorted, torch.full((b - t,), t, dtype=i32, device=dev)])
    num_big = torch.sum(is_big.to(i32))
    big_list = torch.where(
        torch.arange(b, device=dev) < torch.clamp(num_big, max=b),
        big_sorted, -1).to(i32)
    # silent-drop telemetry: every bounded path reports its overflow
    drop['drop_big'] = torch.clamp(num_big - b, min=0)
    drop['drop_tile_k'] = torch.sum(torch.clamp(
        counts - cfg.max_tris_per_tile, min=0))
    return vals_s.to(i32), offs, counts, big_list, drop


def bin_triangles(setup: dict, cfg: RasterConfig):
    """Per-tile triangle table + big list (the plain fill's input).

    Returns tile_table (num_tiles, K) i32 (-1 padded), tile_count
    (num_tiles,) clamped to K, big_list (B,), drop counters."""
    vals_s, offs, counts, big_list, drop = _sort_pairs(setup, cfg)
    table = tile_table(vals_s, offs[:-1], counts, cfg.max_tris_per_tile)
    return (table, torch.clamp(counts, max=cfg.max_tris_per_tile),
            big_list, drop)


def tile_table(vals_s, first, counts, width: int):
    """(num_tiles, width) table of each tile's first `counts` stream
    entries starting at `first`, -1 padded."""
    k_ = torch.arange(width, dtype=torch.int32, device=vals_s.device)
    idx = torch.clamp(first[:, None] + k_[None, :], 0, vals_s.shape[0] - 1)
    in_list = k_[None, :] < counts[:, None]
    return torch.where(in_list, vals_s[idx.long()], -1)


def bin_pairs_stream(setup: dict, cfg: RasterConfig) -> dict:
    """The tile-sorted pair stream consumed by fill_resolve_stream:
    vals_s sorted tri ids, offs (num_tiles+1,), counts (num_tiles,)
    clamped to K, big_list (B,), drop counters."""
    vals_s, offs, counts, big_list, drop = _sort_pairs(setup, cfg)
    return dict(vals_s=vals_s, offs=offs,
                counts=torch.clamp(counts, max=cfg.max_tris_per_tile),
                big_list=big_list, drop=drop)


def tile_pixel_coords(cfg: RasterConfig, tile_ids: torch.Tensor):
    """Normalized pixel-centre coordinates (TB, TH, TW) of tiles, with
    the reference's rounding: (tile origin + col + 0.5) * (1 / width)."""
    dev = tile_ids.device
    th, tw = cfg.tile_h, cfg.tile_w
    col = torch.arange(tw, dtype=torch.float32, device=dev) + 0.5
    row = torch.arange(th, dtype=torch.float32, device=dev) + 0.5
    tx = (tile_ids % cfg.tiles_x).to(torch.float32)
    ty = (tile_ids // cfg.tiles_x).to(torch.float32)
    pxn = (tx[:, None, None] * tw + col[None, None, :]) * (1.0 / cfg.width)
    pyn = (ty[:, None, None] * th + row[None, :, None]) * (1.0 / cfg.height)
    return (pxn.expand(-1, th, tw), pyn.expand(-1, th, tw))


def coverage_depth(rec: torch.Tensor, pxn: torch.Tensor,
                   pyn: torch.Tensor) -> torch.Tensor:
    """Reverse-Z depth of each record's triangle at the pixel centres,
    -1 where the centre is outside it or the plane faces away: the edge
    and depth arithmetic every plain fill shares (reference package,
    raster.py `_coverage_depth`).  rec (..., 16) from pack_tri_records
    gains two pixel axes that broadcast against pxn / pyn."""
    def field(f):
        return rec[..., f, None, None]
    l0 = field(0) * pxn + field(1) * pyn + field(2)
    l1 = field(3) * pxn + field(4) * pyn + field(5)
    l2 = field(6) * pxn + field(7) * pyn + field(8)
    num = field(9) * pxn + field(10) * pyn + field(11)
    den = field(12) * pxn + field(13) * pyn + field(14)
    inside = (torch.minimum(torch.minimum(l0, l1), l2) >= 0.0) & (den > 0.0)
    return torch.where(inside, num / torch.where(den == 0.0, 1.0, den), -1.0)


def fill_tiles(tri_rec: torch.Tensor, table: torch.Tensor,
               big_table: torch.Tensor, cfg: RasterConfig,
               init_z: torch.Tensor, peel: torch.Tensor | None = None):
    """The streamed fills' plain chunked walk over whole tiles (K1's and
    K2's plain versions, raster_cuda.fill_resolve_plain and
    peel_cuda.peel_tiles, on the Pallas stream kernels' grid; the dense
    fill has its own, `fill_dense`).

    tri_rec: (T, 16) from pack_tri_records.  table: (tiles, K) triangle
    ids in stream order, -1 padded; big_table: (tiles, B) the big list
    each tile tests after its own list, -1 padded.  init_z / peel:
    (tiles, TH, TW) starting depth and optional exclusive near bound.
    Returns (z, win): per-pixel depth and the winning triangle id of
    THIS fill (-1 where init_z stayed).  Depth ties keep the earlier
    stream entry: a chunk's first maximum wins inside the chunk, and a
    later chunk must be strictly nearer.
    """
    n_tiles = table.shape[0]
    c = cfg.chunk
    ids_all = torch.cat([table, big_table], dim=1)
    lengths = (ids_all >= 0).sum(dim=1)
    z_out = torch.empty_like(init_z)
    win_out = torch.empty(init_z.shape, dtype=torch.int32,
                          device=init_z.device)
    for b0 in range(0, n_tiles, cfg.tile_batch):
        b1 = min(b0 + cfg.tile_batch, n_tiles)
        tiles = torch.arange(b0, b1, device=table.device)
        pxn, pyn = tile_pixel_coords(cfg, tiles)
        pxn, pyn = pxn[:, None], pyn[:, None]           # (TB, 1, TH, TW)
        best_z = init_z[b0:b1].clone()
        best_w = torch.full_like(best_z, -1, dtype=torch.int32)
        pk = None if peel is None else peel[b0:b1, None] * PEEL_BOUND
        # the table rows are -1 padded at the end of each list segment;
        # compact each row's entries (stream order kept) so the loop
        # stops at the batch's longest list
        rows = ids_all[b0:b1]
        order = torch.sort((rows < 0).to(torch.int8), dim=1,
                           stable=True).indices
        rows = torch.gather(rows, 1, order)
        n = int(lengths[b0:b1].max()) if b1 > b0 else 0
        for k0 in range(0, n, c):
            ids = rows[:, k0:k0 + c]                     # (TB, C)
            r = tri_rec[torch.clamp(ids, min=0).long()]  # (TB, C, 16)
            depth = torch.where((ids >= 0)[..., None, None],
                                coverage_depth(r, pxn, pyn), -1.0)
            if pk is not None:
                depth = torch.where(depth < pk, depth, -1.0)
            cz, carg = torch.max(depth, dim=1)           # first max
            cw = torch.gather(ids, 1, carg.reshape(carg.shape[0], -1)
                              ).reshape(carg.shape)
            upd = cz > best_z
            best_z = torch.where(upd, cz, best_z)
            best_w = torch.where(upd, cw, best_w)
        z_out[b0:b1] = best_z
        win_out[b0:b1] = best_w
    return z_out, win_out


def chunk_starts(n: int, c: int) -> list[int]:
    """The first slot of each chunk of `c` slots over `n`: 0, c, 2c, ...,
    the last moved back to end at slot n, as the reference's
    `dynamic_slice` clamps it (c <= n)."""
    return [min(s, n - c) for s in range(0, n, c)]


def occupied_chunks(ids: torch.Tensor, starts: list[int],
                    c: int) -> torch.Tensor:
    """(rows, chunks) bool on the host: whether row r of ids (rows, n)
    holds an entry (id >= 0) in the chunk of `c` slots from starts[j]."""
    hits = torch.cumsum((ids >= 0).to(torch.int32), 1)
    hits = torch.cat([hits.new_zeros(hits.shape[0], 1), hits], 1)
    at = torch.tensor(starts, device=ids.device)
    return (hits[:, at + c] - hits[:, at] > 0).cpu()


def fill_dense(tri_rec: torch.Tensor, table: torch.Tensor,
               big_list: torch.Tensor, cfg: RasterConfig,
               init_z: torch.Tensor, init_id: torch.Tensor,
               emit_base: int = 0, peel: torch.Tensor | None = None):
    """The dense-table fill over whole tiles: the reference package's
    XLA fill (raster.py `fill_visibility`), step for step, on every
    input.

    tri_rec: (T, 16) raster records (`dense_records`).  table: (tiles,
    K) triangle ids, -1 for an empty slot; big_list: (B,).  init_z /
    init_id / peel: (tiles, TH, TW).  Each tile walks its table row from
    slot 0 in chunks of min(chunk, K) slots (`chunk_starts`), then the
    whole big list in chunks of min(chunk, B).  An empty slot (id < 0)
    scores -1 and emits its id; a triangle emits its id + emit_base.  A
    chunk's first maximum wins inside it and commits where it is
    strictly nearer than the depth so far (a NaN maximum never is).
    Returns (z, tid) (tiles, TH, TW): pixels no chunk won keep init_id.

    A chunk of empty slots scores -1 at every pixel, with its first
    slot's id: the chunk's tests run only on the rows that hold an entry
    in it, the others take that score.  Such a chunk lifts the pixels
    below -1 to -1 and changes no other; no chunk lowers a depth.  So of
    the chunks empty on every tile of a batch only the batch's first
    runs, and the result does not depend on cfg.tile_batch."""
    n_tiles, k = table.shape
    nb = big_list.shape[0]
    c, cb = min(cfg.chunk, k), min(cfg.chunk, nb)
    starts, big_starts = chunk_starts(k, c), chunk_starts(nb, cb)
    big_occupied = occupied_chunks(big_list[None, :], big_starts, cb)[0]
    z_out = torch.empty_like(init_z)
    id_out = torch.empty_like(init_id)
    for b0 in range(0, n_tiles, cfg.tile_batch):
        b1 = min(b0 + cfg.tile_batch, n_tiles)
        tiles = torch.arange(b0, b1, device=table.device)
        pxn, pyn = tile_pixel_coords(cfg, tiles)
        best_z = init_z[b0:b1].clone()
        best_id = init_id[b0:b1].clone()
        pk = None if peel is None else peel[b0:b1] * PEEL_BOUND
        rows = table[b0:b1]
        big = big_list[None, :].expand(b1 - b0, -1)
        grid = ([(rows, s, c) for s in starts]
                + [(big, s, cb) for s in big_starts])
        occupied = torch.cat([
            occupied_chunks(rows, starts, c),
            big_occupied[None, :].expand(b1 - b0, -1)], 1).T
        lifted = False
        for (src, s, n), occ in zip(grid, occupied):
            empty = src[:, s:s + 1, None]                # (TB, 1, 1)
            if not bool(occ.any()):
                if not lifted:
                    low = best_z < -1.0
                    best_z = torch.where(low, -1.0, best_z)
                    best_id = torch.where(low, empty, best_id)
                    lifted = True
                continue
            sel = (slice(None) if bool(occ.all())
                   else torch.nonzero(occ).squeeze(1).to(table.device))
            ids = src[sel, s:s + n]                      # (rows, C)
            r = tri_rec[torch.clamp(ids, min=0).long()]  # (rows, C, 16)
            depth = torch.where((ids >= 0)[..., None, None],
                                coverage_depth(r, pxn[sel, None],
                                               pyn[sel, None]), -1.0)
            if pk is not None:
                depth = torch.where(depth < pk[sel, None], depth, -1.0)
            cz, carg = torch.max(depth, dim=1)           # first max
            emit = torch.where(ids >= 0, ids + emit_base, ids)
            cid = torch.gather(emit, 1, carg.reshape(carg.shape[0], -1)
                               ).reshape(carg.shape)
            if not isinstance(sel, slice):
                cz = torch.full_like(best_z, -1.0).index_copy_(0, sel, cz)
                cid = (empty.expand_as(best_id).clone()
                       .index_copy_(0, sel, cid))
            upd = cz > best_z
            best_z = torch.where(upd, cz, best_z)
            best_id = torch.where(upd, cid, best_id)
        z_out[b0:b1] = best_z
        id_out[b0:b1] = best_id
    return z_out, id_out


def dense_records(setup: dict) -> torch.Tensor:
    """The dense fill's (T, 16) raster records: pack_tri_records, each
    triangle the setup does not keep zeroed.  A zero record covers no
    pixel (its denominator is 0), as the reference scores such a
    triangle -1 (raster.py `_coverage_depth`)."""
    from toyrenderer_tpu_torch.ops.raster_cuda import pack_tri_records
    return torch.where(setup['valid'][:, None], pack_tri_records(setup),
                       0.0).contiguous()


def fill_visibility(setup: dict, table, big_list, cfg: RasterConfig,
                    init_depth=None, init_tri_id=None, emit_base: int = 0,
                    peel_depth=None):
    """Rasterize per-tile lists -> (depth (H,W) f32, tri_id (H,W) i32).

    The reference package's XLA fill (its CPU path), `fill_dense`.
    depth is reverse-Z (0 == background); tri_id is -1 where nothing was
    drawn.  init planes continue a previous fill; peel_depth is an
    EXCLUSIVE near bound (depth peeling).
    """
    from toyrenderer_tpu_torch.ops.raster_cuda import (
        crop_image, image_to_tiles, pad_image, tiles_to_image)
    dev = table.device
    hp, wp = cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w
    if init_depth is None:
        init_z = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
        init_id = torch.full((hp, wp), -1, dtype=torch.int32, device=dev)
    else:
        init_z = pad_image(init_depth, cfg)
        init_id = pad_image(init_tri_id, cfg, fill=-1)
    peel = None
    if peel_depth is not None:
        peel = image_to_tiles(pad_image(peel_depth, cfg), cfg)
    z, tid = fill_dense(dense_records(setup), table, big_list, cfg,
                        image_to_tiles(init_z, cfg),
                        image_to_tiles(init_id, cfg), emit_base, peel)
    return (crop_image(tiles_to_image(z, cfg), cfg),
            crop_image(tiles_to_image(tid, cfg), cfg))


def rasterize(geo: dict, cfg: RasterConfig, use_pallas: bool = False,
              init_depth=None, init_tri_id=None, tri_id_base: int = 0):
    """setup + bin + fill over the dense (tiles, K) table; returns
    (setup, depth (H, W) f32, tri_id (H, W) i32).

    tri_id_base offsets the emitted triangle ids (a continuation's ids
    then index the concatenated setups); init_depth / init_tri_id
    continue a previous fill.  `use_pallas` is the reference's fill
    choice, accepted for its signature: the port has one fill, the
    dense-table kernel for CUDA tensors and `fill_visibility` for CPU
    tensors (dense_cuda.fill_visibility_dense)."""
    from toyrenderer_tpu_torch.ops.dense_cuda import fill_visibility_dense
    setup = setup_triangles(geo, cfg)
    table, count, big_list, _ = bin_triangles(setup, cfg)
    depth, tri_id = fill_visibility_dense(
        setup, table, count, big_list, cfg, init_depth=init_depth,
        init_tri_id=init_tri_id, emit_base=tri_id_base)
    return setup, depth, tri_id


def rasterize_bruteforce(geo: dict, cfg: RasterConfig):
    """Every valid triangle tested at every pixel (reference package,
    raster.py:535): the oracle for tests and tiny scenes, plain tensor
    code on any device.  Pixel centres are (i + 0.5) / size, as there;
    the triangles run in id order, BRUTEFORCE_CHUNK at a time, and a
    later one must be strictly nearer (the first wins a depth tie).  Returns
    (setup, depth (H, W) f32, tri_id (H, W) i32)."""
    from toyrenderer_tpu_torch.ops.raster_cuda import pack_tri_records
    setup = setup_triangles(geo, cfg)
    dev = setup['valid'].device
    rec = pack_tri_records(setup)
    ids = torch.nonzero(setup['valid']).flatten()
    h, w = cfg.height, cfg.width
    pxn = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5)
           / w)[None, None, :]
    pyn = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
           / h)[None, :, None]
    best_z = torch.zeros((h, w), dtype=torch.float32, device=dev)
    best_id = torch.full((h, w), -1, dtype=torch.int32, device=dev)
    for k0 in range(0, ids.shape[0], BRUTEFORCE_CHUNK):
        cid = ids[k0:k0 + BRUTEFORCE_CHUNK]
        depth = coverage_depth(rec[cid], pxn, pyn)        # (C, H, W)
        cz, carg = torch.max(depth, dim=0)                 # first max
        upd = cz > best_z
        best_z = torch.where(upd, cz, best_z)
        best_id = torch.where(upd, cid.to(torch.int32)[carg], best_id)
    return setup, best_z, best_id
