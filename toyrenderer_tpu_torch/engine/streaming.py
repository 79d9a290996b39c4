"""Virtual-texture streaming: feedback-driven texture residency.

Counterpart of toyrenderer_tpu/engine/streaming.py (reference:
source/TextureFeedbackManager.{h,cpp} + RTXTS-TTM: readback sampler
feedback -> residency decisions -> tile alloc/evict -> tile uploads ->
MinMip writes, budgeted per frame).  The host bookkeeping is the
reference package's, step for step and in the same order (best-fit
block list, heap free list, dict insertion order, round robin), so both
give the same slots, tables and stats under the same feedback.  The
device pool is ONE preallocated tensor that every update writes in
place (`index_copy_` of the pending tiles, or a slice copy for a mip):
`update` hands the frame that same tensor, so nothing re-uploads the
pool between frames.

* TextureStreamingManager: MIP granularity over a flat texel pool,
  driven by the per-texture feedback (aux 'tex_feedback').
* TileStreamingManager: 64x64-texel TILES with per-region fallback,
  LRU eviction and defrag, driven by the per-tile feedback (aux
  'vt_tile_feedback').
* TexelTileBank: a tiled texel file on disk read by a thread pool (the
  reference's on-demand DDS mip IO).

Each manager counts the bytes it wrote to the device (`uploaded_bytes`,
and `last_upload_bytes` for the last update).
"""

from __future__ import annotations

import heapq
import json
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from toyrenderer_tpu_torch.device import resolve_device
from toyrenderer_tpu_torch.scene.textures import MAX_MIPS, TextureAtlas

ALWAYS_RESIDENT_DIM = 32


def scene_atlas(scene_host) -> TextureAtlas:
    """The host TextureAtlas a built scene (SceneBuffers) carries: the
    full mip data a manager streams from."""
    return TextureAtlas(
        texels=scene_host.tex_texels, desc_offset=scene_host.tex_offset,
        desc_width=scene_host.tex_width, desc_height=scene_host.tex_height,
        num_mips=scene_host.tex_num_mips, wrap_mode=scene_host.tex_wrap,
        min_resident_mip=scene_host.tex_min_mip,
        num_textures=scene_host.num_textures)


def _host_feedback(feedback) -> np.ndarray:
    """Feedback as a host array (a device tensor is read back)."""
    if isinstance(feedback, torch.Tensor):
        return feedback.detach().cpu().numpy()
    return np.asarray(feedback)


def _int32_rows(rows: np.ndarray) -> torch.Tensor:
    """u32 texel rows as an int32 tensor, bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(rows, np.uint32)
                            .view(np.int32))


class TextureStreamingManager:
    """Host-side residency manager over a fixed device texel pool."""

    def __init__(self, atlas, pool_texels: int = 8 << 20,
                 textures_per_frame: int = 10, device=None):
        """atlas: host TextureAtlas with the FULL mip data (its texel
        buffer is the host-side backing store; the device pool on
        `device` -- default the CUDA device -- is budget-sized)."""
        self.full = atlas
        self.device = resolve_device(device)
        self.textures_per_frame = textures_per_frame
        n = atlas.desc_offset.shape[0]
        self.n_tex = n
        self.n_mips = atlas.num_mips.copy()

        # start with only the always-resident tail mips
        self.resident_min = np.zeros(n, np.int32)
        for t in range(n):
            for m in range(int(atlas.num_mips[t])):
                if max(atlas.desc_width[t, m],
                       atlas.desc_height[t, m]) <= ALWAYS_RESIDENT_DIM:
                    self.resident_min[t] = m
                    break
            else:
                self.resident_min[t] = max(int(atlas.num_mips[t]) - 1, 0)

        self.pool_size = pool_texels
        self.free: list[tuple[int, int]] = [(0, pool_texels)]  # (off, size)
        self.block_of: dict[tuple[int, int], tuple[int, int]] = {}
        self.desc_offset = np.full_like(atlas.desc_offset, -1)

        row_w = atlas.texels.shape[1]
        self.pool = torch.zeros((pool_texels, row_w), dtype=torch.int32,
                                device=self.device)           # quad rows
        self.round_robin = 0
        self.stats = dict(loads=0, evictions=0, resident_texels=0)
        self.uploaded_bytes = 0
        self.last_upload_bytes = 0

        for t in range(n):
            for m in range(self.resident_min[t], int(atlas.num_mips[t])):
                if not self._load_mip(t, m):
                    raise ValueError("pool too small for the always-"
                                     "resident mips")

    # -- block allocator (best fit + merge) ---------------------------------
    def _alloc(self, size: int) -> int | None:
        best = None
        for i, (off, sz) in enumerate(self.free):
            if sz >= size and (best is None or sz < self.free[best][1]):
                best = i
        if best is None:
            return None
        off, sz = self.free.pop(best)
        if sz > size:
            self.free.append((off + size, sz - size))
        return off

    def _free(self, off: int, size: int):
        self.free.append((off, size))
        self.free.sort()
        merged = []
        for b in self.free:
            if merged and merged[-1][0] + merged[-1][1] == b[0]:
                merged[-1] = (merged[-1][0], merged[-1][1] + b[1])
            else:
                merged.append(list(b))
        self.free = [tuple(b) for b in merged]

    def _mip_texels(self, t: int, m: int):
        src_off = int(self.full.desc_offset[t, m])
        n = int(self.full.desc_width[t, m]) * int(self.full.desc_height[t, m])
        return src_off, n

    def _load_mip(self, t: int, m: int) -> bool:
        if self.desc_offset[t, m] >= 0:
            return True
        src_off, n = self._mip_texels(t, m)
        dst = self._alloc(n)
        if dst is None:
            return False
        data = _int32_rows(self.full.texels[src_off:src_off + n])
        self.pool[dst:dst + n].copy_(data)
        self.uploaded_bytes += data.numel() * 4
        self.desc_offset[t, m] = dst
        self.block_of[(t, m)] = (dst, n)
        self.stats['loads'] += 1
        self.stats['resident_texels'] += n
        return True

    def _evict_mip(self, t: int, m: int):
        blk = self.block_of.pop((t, m), None)
        if blk is None:
            return
        self._free(*blk)
        self.desc_offset[t, m] = -1
        self.stats['evictions'] += 1
        self.stats['resident_texels'] -= blk[1]

    def update(self, feedback) -> dict:
        """One streaming step from per-texture min desired mips ((T,)
        f32, numpy or a tensor; +inf == texture unused this frame).
        Returns the frame_inputs override dict: tex_texels (the pool
        tensor itself), tex_desc, tex_min_mip."""
        before = self.uploaded_bytes
        feedback = _host_feedback(feedback)
        order = [(self.round_robin + k) % self.n_tex
                 for k in range(self.n_tex)]
        processed = 0
        for t in order:
            if processed >= self.textures_per_frame:
                break
            want = feedback[t]
            if not np.isfinite(want):
                # unused: decay toward the always-resident floor
                want = float(self.n_mips[t])
            want_mip = int(np.clip(np.floor(want), 0,
                                   self.n_mips[t] - 1))
            cur = int(self.resident_min[t])
            if want_mip < cur:
                # needs finer data: load ONE step (budgeted, like the
                # reference's gradual tile uploads)
                if self._load_mip(t, cur - 1):
                    self.resident_min[t] = cur - 1
                processed += 1
            elif want_mip > cur + 1:
                # hysteresis: evict only when 2+ mips coarser is enough
                self._evict_mip(t, cur)
                self.resident_min[t] = cur + 1
                processed += 1
        self.round_robin = (self.round_robin + max(processed, 1)) % max(
            self.n_tex, 1)
        self.last_upload_bytes = self.uploaded_bytes - before
        return dict(
            tex_texels=self.pool,
            tex_desc=torch.from_numpy(self._packed_desc()).to(self.device),
            tex_min_mip=torch.from_numpy(self.resident_min.copy()).to(
                self.device))

    def _packed_desc(self) -> np.ndarray:
        """Redirected (T*MAX_MIPS, 4) desc rows over the POOL offsets:
        each requested mip resolves to the finest resident one."""
        t = self.n_tex
        desc = np.zeros((t, MAX_MIPS, 4), np.int32)
        for ti in range(t):
            last = max(int(self.n_mips[ti]) - 1, 0)
            for m in range(MAX_MIPS):
                r = min(max(m, int(self.resident_min[ti])), last)
                while r < last and self.desc_offset[ti, r] < 0:
                    r += 1
                desc[ti, m] = (self.desc_offset[ti, r],
                               self.full.desc_width[ti, r],
                               self.full.desc_height[ti, r], 0)
        return desc.reshape(t * MAX_MIPS, 4)


# ---------------------------------------------------------------------------
# Tile-granularity streaming (64x64-texel tiles)
# ---------------------------------------------------------------------------

TILE = 64                       # texels per tile side
TILE_ROWS = TILE * TILE         # 4096 rows x 64 B = 256 KB: the 4-map
#                                 equivalent of the reference's 64 KB tile


class TileStreamingManager:
    """Per-TILE residency over a fixed pool of 64x64-texel tiles -- the
    counterpart of the reference's RTXTS tile streaming
    (TextureFeedbackManager.cpp:202-462): spatial sampler feedback at
    tile granularity, budgeted tile uploads per update, LRU eviction
    with hysteresis, and budgeted DEFRAG moves that compact the pool.

    Layout: mips with max dim <= TILE stay contiguous in a static region
    (always resident); finer mips split into tiles addressed through a
    device tile table (ops/texture._texel_index).  A non-resident tile's
    table entry redirects to the co-located tile of the coarsest tiled
    mip (always pinned), packing (mip delta << 24 | pool slot), so
    sampling never faults and refinement is per region.

    Refinement uses the device 'vt_tile_feedback' (per-tile min desired
    mip): a sampled tile whose feedback asks for a finer mip loads its 4
    child tiles; tiles unseen for `evict_after` updates are evicted.
    """

    def __init__(self, atlas, pool_tiles: int = 64,
                 tiles_per_frame: int = 16, defrag_per_frame: int = 16,
                 evict_after: int = 60, source=None, device=None):
        """source: optional TexelTileBank -- tile bytes then come from
        DISK via async reads (atlas.texels never touched; only its desc
        metadata is used).  device: the pool's (default: the CUDA
        device)."""
        self.full = atlas
        self.source = source
        self.device = resolve_device(device)
        self.tiles_per_frame = tiles_per_frame
        self.defrag_per_frame = defrag_per_frame
        self.evict_after = evict_after
        n = atlas.desc_offset.shape[0]
        self.n_tex = n
        self.n_mips = atlas.num_mips.copy()

        # -- static region: contiguous copies of mips <= TILE ------------
        static_chunks = []
        cursor = 0
        self.static_offset = np.full_like(atlas.desc_offset, -1)
        # tile grid per (tex, mip): base index into the tile table
        self.tile_base = np.full((n, atlas.desc_offset.shape[1]), -1,
                                 np.int32)
        self.grid = {}            # (t, m) -> (ht, wt)
        self.first_tiled = np.zeros(n, np.int32)   # coarsest tiled mip
        table_cursor = 0
        for t in range(n):
            ft = -1
            for m in range(int(self.n_mips[t]) - 1, -1, -1):
                w = int(atlas.desc_width[t, m])
                h = int(atlas.desc_height[t, m])
                if max(w, h) <= TILE:
                    if source is not None:
                        static_chunks.append(source.read_mip(t, m))
                    else:
                        src = int(atlas.desc_offset[t, m])
                        static_chunks.append(
                            atlas.texels[src:src + w * h])
                    self.static_offset[t, m] = cursor
                    cursor += w * h
                else:
                    wt = -(-w // TILE)
                    ht = -(-h // TILE)
                    self.tile_base[t, m] = table_cursor
                    self.grid[(t, m)] = (ht, wt)
                    table_cursor += ht * wt
                    if ft < 0:          # coarsest tiled mip (largest m)
                        ft = m
            self.first_tiled[t] = ft               # -1: nothing tiled
        self.table_size = max(table_cursor, 1)
        self.static_rows = cursor
        # pool slots start after the static region (tile-aligned)
        self.slot0 = -(-cursor // TILE_ROWS)
        self.pool_tiles = pool_tiles
        total_rows = (self.slot0 + pool_tiles) * TILE_ROWS
        row_w = atlas.texels.shape[1]

        # the one device pool: zeros, the static region uploaded once
        self.pool = torch.zeros((total_rows, row_w), dtype=torch.int32,
                                device=self.device)
        self.uploaded_bytes = 0
        self.last_upload_bytes = 0
        if static_chunks:
            sc = _int32_rows(np.concatenate(static_chunks))
            self.pool[:sc.shape[0]].copy_(sc)
            self.uploaded_bytes += sc.numel() * 4

        self.free = list(range(self.slot0, self.slot0 + pool_tiles))
        heapq.heapify(self.free)  # min-heap: low slots first
        self.slot_of = {}         # (t, m, ty, tx) -> slot
        self.tile_of_slot = {}    # slot -> (t, m, ty, tx)
        self.last_seen = {}       # (t, m, ty, tx) -> update index
        self.update_index = 0
        self.stats = dict(tile_loads=0, tile_evictions=0,
                          defrag_moves=0, resident_tiles=0)

        # O(1) / vectorized bookkeeping:
        #   tid_key: tile id -> (t, m, ty, tx)   (static inverse table)
        #   table_slot: tile id -> resident slot or -1  (incremental)
        #   fallback_entry: tile id -> packed pinned-fallback entry
        #     (static once pinned tiles exist -- defrag never moves pins)
        self.tid_key = np.zeros((self.table_size, 4), np.int32)
        for (t, m), (ht, wt) in self.grid.items():
            tb = int(self.tile_base[t, m])
            ty, tx = np.divmod(np.arange(ht * wt, dtype=np.int32), wt)
            self.tid_key[tb:tb + ht * wt, 0] = t
            self.tid_key[tb:tb + ht * wt, 1] = m
            self.tid_key[tb:tb + ht * wt, 2] = ty
            self.tid_key[tb:tb + ht * wt, 3] = tx
        self.table_slot = np.full(self.table_size, -1, np.int32)
        self.table = np.zeros(self.table_size, np.int32)
        self.pinned_slots = set()

        self._pending = []        # (slot, rows) uploads this update
        # pin the coarsest tiled mip of every texture (fallback target)
        for t in range(n):
            ft = int(self.first_tiled[t])
            if ft < 0:
                continue
            ht, wt = self.grid[(t, ft)]
            for ty in range(ht):
                for tx in range(wt):
                    if not self._load_tile(t, ft, ty, tx, pin=True):
                        raise ValueError("pool too small for the pinned "
                                         "fallback tiles")
                    self.pinned_slots.add(self.slot_of[(t, ft, ty, tx)])

        # static fallback entries: (mip delta << 24) | pinned slot
        self.fallback_entry = np.zeros(self.table_size, np.int32)
        for (t, m), (ht, wt) in self.grid.items():
            tb = int(self.tile_base[t, m])
            ft = int(self.first_tiled[t])
            fht, fwt = self.grid[(t, ft)]
            pin_grid = np.asarray(
                [[self.slot_of[(t, ft, fy, fx)] for fx in range(fwt)]
                 for fy in range(fht)], np.int32)
            d = ft - m
            ty, tx = np.divmod(np.arange(ht * wt, dtype=np.int32), wt)
            fy = np.minimum(ty >> d, fht - 1)
            fx = np.minimum(tx >> d, fwt - 1)
            self.fallback_entry[tb:tb + ht * wt] = (
                (d << 24) | pin_grid[fy, fx])
        self._flush_uploads()

    # -- tile helpers -----------------------------------------------------
    def _tile_rows(self, t, m, ty, tx, blocking=True):
        """(TILE_ROWS, 16) u32 for one tile, padded at mip edges; with
        an async source and blocking=False, may return None (read
        scheduled off-thread; the tile uploads on a later update)."""
        if self.source is not None:
            if blocking:
                return self.source.get_tile_blocking(t, m, ty, tx)
            return self.source.try_get_tile(t, m, ty, tx)
        w = int(self.full.desc_width[t, m])
        h = int(self.full.desc_height[t, m])
        src = int(self.full.desc_offset[t, m])
        y0, x0 = ty * TILE, tx * TILE
        hh = min(TILE, h - y0)
        ww = min(TILE, w - x0)
        out = np.zeros((TILE, TILE, self.full.texels.shape[1]), np.uint32)
        block = self.full.texels[src:src + w * h].reshape(
            h, w, -1)[y0:y0 + hh, x0:x0 + ww]
        out[:hh, :ww] = block
        return out.reshape(TILE_ROWS, -1)

    def _tid_of(self, t, m, ty, tx) -> int:
        wt = self.grid[(t, m)][1]
        return int(self.tile_base[t, m]) + ty * wt + tx

    def _load_tile(self, t, m, ty, tx, pin=False, blocking=True) -> bool:
        key = (t, m, ty, tx)
        if key in self.slot_of:
            self.last_seen[key] = (np.inf if pin else self.update_index)
            return True
        if not self.free:
            return False
        rows = self._tile_rows(t, m, ty, tx, blocking=blocking)
        if rows is None:
            return False          # async read in flight; retry later
        slot = heapq.heappop(self.free)
        self.slot_of[key] = slot
        self.tile_of_slot[slot] = key
        self.last_seen[key] = np.inf if pin else self.update_index
        self.table_slot[self._tid_of(t, m, ty, tx)] = slot
        self._pending.append((slot, rows))
        self.stats['tile_loads'] += 1
        self.stats['resident_tiles'] += 1
        return True

    def _evict_tile(self, key):
        slot = self.slot_of.pop(key, None)
        if slot is None:
            return
        del self.tile_of_slot[slot]
        self.last_seen.pop(key, None)
        heapq.heappush(self.free, slot)
        self.table_slot[self._tid_of(*key)] = -1
        self.stats['tile_evictions'] += 1
        self.stats['resident_tiles'] -= 1

    def _flush_uploads(self):
        """Write the pending tiles into the pool in place: ONE upload of
        their rows and one index_copy_ (a slot written twice keeps its
        last write, as sequential writes would)."""
        if not self._pending:
            return
        last = dict(self._pending)
        self._pending = []
        slots = torch.tensor(list(last), dtype=torch.int64)
        rows = _int32_rows(np.stack(list(last.values())))
        idx = (slots[:, None] * TILE_ROWS
               + torch.arange(TILE_ROWS, dtype=torch.int64)[None, :])
        self.pool.index_copy_(
            0, idx.reshape(-1).to(self.device),
            rows.reshape(-1, rows.shape[-1]).to(self.device))
        self.uploaded_bytes += rows.numel() * 4

    def _tile_key_of_id(self, tid: int):
        """Inverse of the device tile id -> (t, m, ty, tx), through the
        static tid_key table."""
        if not (0 <= tid < self.table_size):
            return None
        t, m, ty, tx = (int(x) for x in self.tid_key[tid])
        if self.tile_base[t, m] < 0:
            return None
        return t, m, ty, tx

    def update(self, tile_feedback) -> dict:
        """One streaming step from the device per-tile feedback
        ('vt_tile_feedback' aux: min desired mip per tile, +inf unused;
        numpy or a tensor).

        Returns the frame_inputs override dict: tex_texels (the pool
        tensor itself), tex_desc, tex_tile_table."""
        before = self.uploaded_bytes
        fb = _host_feedback(tile_feedback)
        self.update_index += 1
        hot = np.flatnonzero(np.isfinite(fb))
        loads = 0
        for tid in hot:
            key = self._tile_key_of_id(int(tid))
            if key is None:
                continue
            t, m, ty, tx = key
            if key in self.last_seen:
                if self.last_seen[key] != np.inf:
                    self.last_seen[key] = self.update_index
            else:
                # sampled through a fallback: load the tile itself first
                if loads < self.tiles_per_frame and self._load_tile(
                        t, m, ty, tx, blocking=False):
                    loads += 1
                    continue
            # refinement: feedback wants a finer mip -> load children
            want = int(np.floor(fb[tid]))
            if want < m and m - 1 >= 0 and self.tile_base[t, m - 1] >= 0:
                ht, wt = self.grid[(t, m - 1)]
                for cy in (2 * ty, 2 * ty + 1):
                    for cx in (2 * tx, 2 * tx + 1):
                        if cy < ht and cx < wt:
                            if loads >= self.tiles_per_frame:
                                break
                            if (t, m - 1, cy, cx) not in self.slot_of:
                                if self._load_tile(t, m - 1, cy, cx,
                                                   blocking=False):
                                    loads += 1

        # eviction with hysteresis
        for key in list(self.slot_of):
            seen = self.last_seen.get(key, 0)
            if seen != np.inf and (self.update_index - seen
                                   > self.evict_after):
                self._evict_tile(key)

        # defrag: budgeted moves of high slots into low free slots
        # (TextureFeedbackManager.cpp:351-356).  Pinned fallback tiles
        # never move (keeps fallback_entry static).
        moves = 0
        hi_candidates = sorted(
            (s for s in self.tile_of_slot if s not in self.pinned_slots),
            reverse=True)
        for hi_used in hi_candidates:
            if moves >= self.defrag_per_frame or not self.free:
                break
            low = self.free[0]                 # heap min
            if hi_used <= low:
                break
            heapq.heappop(self.free)
            key = self.tile_of_slot.pop(hi_used)
            heapq.heappush(self.free, hi_used)
            self.slot_of[key] = low
            self.tile_of_slot[low] = key
            self.table_slot[self._tid_of(*key)] = low
            self._pending.append((low, self._tile_rows(*key)))
            self.stats['defrag_moves'] += 1
            moves += 1

        self.table = np.where(self.table_slot >= 0, self.table_slot,
                              self.fallback_entry).astype(np.int32)
        self._flush_uploads()
        self.last_upload_bytes = self.uploaded_bytes - before
        return dict(
            tex_texels=self.pool,
            tex_desc=torch.from_numpy(self._packed_desc()).to(self.device),
            tex_tile_table=torch.from_numpy(self.table.copy()).to(
                self.device))

    def _packed_desc(self) -> np.ndarray:
        """Desc rows: tiled mips carry [0, w, h, tile_base] (addressing
        goes through the tile table; per-region fallback replaces mip
        redirection); static mips carry [offset, w, h, -1]."""
        t = self.n_tex
        desc = np.zeros((t, MAX_MIPS, 4), np.int32)
        for ti in range(t):
            last = max(int(self.n_mips[ti]) - 1, 0)
            for m in range(MAX_MIPS):
                r = min(m, last)
                if self.tile_base[ti, r] >= 0:
                    desc[ti, m] = (0, self.full.desc_width[ti, r],
                                   self.full.desc_height[ti, r],
                                   self.tile_base[ti, r])
                else:
                    desc[ti, m] = (self.static_offset[ti, r],
                                   self.full.desc_width[ti, r],
                                   self.full.desc_height[ti, r], -1)
        return desc.reshape(t * MAX_MIPS, 4)


# ---------------------------------------------------------------------------
# Async disk-backed tile source (TextureFeedbackManager.cpp:319-331 parity:
# the reference reads DDS mip data on demand with Taskflow silent_async;
# here a tiled texel bank file + thread pool, so tile bytes live on DISK,
# not in a fully-resident host atlas)
# ---------------------------------------------------------------------------

class TexelTileBank:
    """Flat bank file of PRE-TILED texel data: each tiled (tex, mip) is
    stored as consecutive 64x64-tile blocks (one contiguous read per
    tile); static (small) mips are stored raw.  Written once at scene
    build; read on demand."""

    MAGIC = 0x54424E4B    # 'TBNK'

    @staticmethod
    def write(atlas, path: str):
        """Serialize a host TextureAtlas into a tile bank."""
        n = atlas.desc_offset.shape[0]
        row_w = atlas.texels.shape[1]
        index = {}          # (t, m) -> (file_off, kind) kind: 0 raw 1 tiled
        with open(path, "wb") as f:
            f.write(struct.pack("<IIII", TexelTileBank.MAGIC, 1, n, row_w))
            # index written at the end; reserve cursor bookkeeping here
            blobs = []
            cursor = 0
            for t in range(n):
                for m in range(int(atlas.num_mips[t])):
                    w = int(atlas.desc_width[t, m])
                    h = int(atlas.desc_height[t, m])
                    src = int(atlas.desc_offset[t, m])
                    mip = atlas.texels[src:src + w * h].reshape(h, w, -1)
                    if max(w, h) <= TILE:
                        blob = np.ascontiguousarray(mip, np.uint32)
                        index[(t, m)] = (cursor, 0, h, w)
                    else:
                        ht, wt = -(-h // TILE), -(-w // TILE)
                        tiles = np.zeros((ht * wt, TILE, TILE, row_w),
                                         np.uint32)
                        for ty in range(ht):
                            for tx in range(wt):
                                hh = min(TILE, h - ty * TILE)
                                ww = min(TILE, w - tx * TILE)
                                tiles[ty * wt + tx, :hh, :ww] = mip[
                                    ty * TILE:ty * TILE + hh,
                                    tx * TILE:tx * TILE + ww]
                        blob = tiles
                        index[(t, m)] = (cursor, 1, ht, wt)
                    blobs.append(blob)
                    cursor += blob.nbytes
            data_start = f.tell()
            for b in blobs:
                f.write(b.tobytes())
            meta = json.dumps({f"{t},{m}": v
                               for (t, m), v in index.items()}).encode()
            f.write(meta)
            f.write(struct.pack("<QQ", data_start, len(meta)))
        return path

    def __init__(self, path: str, workers: int = 4):
        self.path = path
        with open(path, "rb") as f:
            magic, _, self.n_tex, self.row_w = struct.unpack(
                "<IIII", f.read(16))
            if magic != TexelTileBank.MAGIC:
                raise ValueError(f"{path}: not a tile bank")
            f.seek(-16, 2)
            data_start, meta_len = struct.unpack("<QQ", f.read(16))
            f.seek(-16 - meta_len, 2)
            raw = json.loads(f.read(meta_len))
        self.data_start = data_start
        self.index = {tuple(int(x) for x in k.split(',')): tuple(v)
                      for k, v in raw.items()}
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures = {}
        self.stats = dict(async_reads=0, bytes_read=0)

    def _read_tile_blocking(self, t, m, ty, tx) -> np.ndarray:
        off, kind, a, b = self.index[(t, m)]
        tile_bytes = TILE * TILE * self.row_w * 4
        with open(self.path, "rb") as f:
            if kind == 1:
                wt = b
                f.seek(self.data_start + off
                       + (ty * wt + tx) * tile_bytes)
                buf = f.read(tile_bytes)
                self.stats['bytes_read'] += len(buf)
                return np.frombuffer(buf, np.uint32).reshape(
                    TILE_ROWS, self.row_w).copy()
            # raw small mip: whole thing
            h, w = a, b
            f.seek(self.data_start + off)
            buf = f.read(h * w * self.row_w * 4)
            self.stats['bytes_read'] += len(buf)
            return np.frombuffer(buf, np.uint32).reshape(h * w,
                                                         self.row_w).copy()

    def read_mip(self, t, m) -> np.ndarray:
        """Blocking read of a full (small/static) mip -> (h*w, row_w)."""
        return self._read_tile_blocking(t, m, 0, 0)

    def try_get_tile(self, t, m, ty, tx):
        """Non-blocking: returns the tile rows if the async read is done,
        else schedules it (once) and returns None — the reference's
        silent_async ReadDDSMipData semantics."""
        key = (t, m, ty, tx)
        fut = self._futures.get(key)
        if fut is None:
            self.stats['async_reads'] += 1
            self._futures[key] = self._pool.submit(
                self._read_tile_blocking, t, m, ty, tx)
            return None
        if not fut.done():
            return None
        data = fut.result()
        del self._futures[key]
        return data

    def get_tile_blocking(self, t, m, ty, tx):
        return self._read_tile_blocking(t, m, ty, tx)
