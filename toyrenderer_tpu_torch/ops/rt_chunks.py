"""The block-pair chunk traversal: direct Moller-Trumbore over the (ray
block, triangle chunk) pairs whose boxes overlap, folded to each ray's
closest hit.

Counterpart of toyrenderer_tpu/ops/rt_chunks.py, which is plain XLA: it
lists the pairs with `nonzero` and tests each pair's 128 rays against
the chunk's 96 triangles as fused (pairs, 128, 96) elementwise work.
Eager PyTorch would build each of those intermediates in memory (tens of
GB on a 1080p frame's rays), so the dense phase and its fold are one
hand-written kernel here, K8 (csrc/chunks.cu, ops/chunks_cuda.py), which
has no TPU counterpart; `chunk_fold_plain` is its plain version, which
walks the listed pairs a batch at a time.

1. Chunks: the tree's leaf rows, 8 at a time (96 triangles), in leaf
   order; `chunk_table` lays each out component-major with its box.
2. Box phase: every live ray against every chunk box, reduced to blocks
   of 128 rays (rt_pairs._block_boxes: the reference's slab arithmetic,
   t from 0, a tile of rays at a time).
3. The pair list, block-major, capped at pair_factor * blocks (rounded
   up to 1024) without a host read (rt_pairs.pair_list).
4. K8: each listed pair of a block that fits under the cap folds to each
   ray's first least-t slot and its payload; pairs merge by the least
   (t, payload).  That is the reference's two-level tie rule: `argmin`
   over a pair's 96 slots, then the least payload among the block's
   pairs whose winner has the least t.
5. Every live ray of a block whose list reaches past the cap is traced
   again by bvh_cuda.traverse_auto on the same tree, in the asked mode
   (live-masked; the call runs whether or not a block overflowed, as in
   the reference), so the result is exact at any capacity.

The dense phase computes the closest hit in either mode; only the
fallback honours `any_hit`.  `steps` is the ray's block's pair count.
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops import bvh_cuda
from toyrenderer_tpu_torch.ops.bvh import LEAF_TRIS
from toyrenderer_tpu_torch.ops.rt_pairs import (
    _EPS_DIR, INF_KEY, PAIR_FACTOR, _block_boxes, pair_list, unpack_keys)
from toyrenderer_tpu_torch.utils.timing import profiler_range

CHUNK_ROWS = 8                          # leaf rows per chunk
CHUNK_TRIS = CHUNK_ROWS * LEAF_TRIS     # 96
CHUNK_FLOATS = 10 * CHUNK_TRIS          # v0, e1, e2 (xyz each), payload
BLOCK = 128                             # rays per block
_FOLD_ELEMS = 1 << 22                   # (pairs, rays, slots) plain batch


def chunk_table(bvh):
    """(boxes (C, 6) f32 [lo.xyz hi.xyz], data (C, 960) f32) from either
    tree flavour: only its leaf rows (NG, 120) are read, in their order,
    8 to a chunk.  data rows are component-major over the chunk's 96
    triangles: [v0x x96 | v0y | v0z | e1x | .. | e2z | payload x96];
    padding slots carry payload -1 (never hit).  Rebuilt from each
    refit: the triangles are world-space."""
    leaf = bvh.leaf_rows
    ng = leaf.shape[0]
    c = -(-ng // CHUNK_ROWS)
    pad = c * CHUNK_ROWS - ng
    if pad:
        pad_rows = torch.zeros((pad, leaf.shape[1]), device=leaf.device)
        pad_rows[:, 9 * LEAF_TRIS:10 * LEAF_TRIS] = -1.0
        leaf = torch.cat([leaf, pad_rows])
    g = leaf[:, :10 * LEAF_TRIS].reshape(c, CHUNK_ROWS, 10, LEAF_TRIS)
    data = g.transpose(1, 2).reshape(c, CHUNK_FLOATS)

    v0 = g[:, :, 0:3].transpose(2, 3)                  # (C, 8, 12, 3)
    e1 = g[:, :, 3:6].transpose(2, 3)
    e2 = g[:, :, 6:9].transpose(2, 3)
    ok = (g[:, :, 9] >= 0.0)[..., None]
    p1, p2 = v0 + e1, v0 + e2
    big = 3e37
    lo = torch.where(ok, torch.minimum(torch.minimum(v0, p1), p2), big)
    hi = torch.where(ok, torch.maximum(torch.maximum(v0, p1), p2), -big)
    boxes = torch.cat([lo.reshape(c, -1, 3).amin(1),
                       hi.reshape(c, -1, 3).amax(1)], -1)
    return boxes.contiguous(), data.contiguous()


def _walk(n_walk, starts, pchk):
    """(block, chunk) i64 of every walked pair, block by block: block b
    walks list positions starts[b] .. starts[b] + n_walk[b] - 1."""
    b = n_walk.shape[0]
    dev = n_walk.device
    n_walk = n_walk.long()
    total = int(n_walk.sum())
    blk = torch.repeat_interleave(torch.arange(b, device=dev), n_walk,
                                  output_size=total)
    rank = torch.arange(total, device=dev) - (torch.cumsum(n_walk, 0)
                                              - n_walk)[blk]
    return blk, pchk.long()[starts.long()[blk] + rank]


def chunk_fold_plain(rays, data, pchk, starts, n_walk,
                     batch_elems: int = _FOLD_ELEMS):
    """K8's function in plain PyTorch, on any device.  rays (B, block, 8)
    f32 ray slots [o, d, t_max, live]; data (C, 960) f32 (chunk_table);
    pchk (L,) i32 the chunk of each listed pair; block b walks pairs
    starts[b] .. starts[b] + n_walk[b] - 1.  Returns (best_t (B * block,)
    f32, best_pay (B * block,) i32): each live ray's least t over the
    walked chunks' triangles and, of the pairs that give it, the least
    of their winners' payloads, a pair's winner being its first slot
    with its least t (inf and -1 without a hit, and for a dead ray).

    The reference's Moller-Trumbore, operation for operation (each sum
    left to right); the walked pairs are read on the host and processed
    batch_elems / (block * 96) at a time, so no (pairs, block, 96) tensor of
    the whole list is built."""
    b, block = rays.shape[:2]
    dev = rays.device
    blk, chunk = _walk(n_walk, starts, pchk)
    best = torch.full((b * block,), INF_KEY, dtype=torch.int64, device=dev)
    step = max(1, batch_elems // (block * CHUNK_TRIS))
    lanes = torch.arange(block, device=dev)
    for s in range(0, blk.numel(), step):
        bb, cc = blk[s:s + step], chunk[s:s + step]
        m = data[cc].reshape(-1, 10, 1, CHUNK_TRIS)        # (P, 10, 1, 96)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, pay = m.unbind(1)
        r = rays[bb]                                       # (P, 128, 8)
        ox, oy, oz, dx, dy, dz, cap, live = (r[..., k:k + 1]
                                             for k in range(8))
        px = dy * e2z - dz * e2y                           # (P, 128, 96)
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = torch.where(torch.abs(det) < 1e-7, 0.0, 1.0 / det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (tt > 1e-7) & (pay >= 0.0) & (tt < cap) & (live > 0.0))
        tt = torch.where(ok, tt, torch.inf)
        j = torch.argmin(tt, -1, keepdim=True)             # first least
        t_pair = torch.gather(tt, -1, j)[..., 0]           # (P, 128)
        p_pair = torch.gather(pay.expand_as(tt), -1, j)[..., 0]
        key = torch.where(
            torch.isfinite(t_pair),
            (t_pair.view(torch.int32).long() << 32) | p_pair.long(),
            INF_KEY)
        idx = (bb[:, None] * block + lanes).reshape(-1)
        best.scatter_reduce_(0, idx, key.reshape(-1), 'amin')
    return unpack_keys(best)


def traverse_chunks(bvh, origins, directions, t_max, any_hit: bool = False,
                    live=None, block: int = BLOCK,
                    pair_factor: int = PAIR_FACTOR,
                    tables=None, fallback: bool = True,
                    stats: dict | None = None, budget=None) -> dict:
    """Trace rays through the chunk route (reference rt_chunks.py:101):
    bvh_cuda's contract -- dict(hit, t, tri, steps) -- plus u and v,
    zero as in the reference; steps is the ray's block's pair count.
    `tables`: chunk_table(bvh), built once per refit by the caller.
    `block`: rays per block; the kernel folds blocks of 128, the plain
    version any.  With `fallback` (the default), the live rays of
    overflowed blocks take bvh_cuda.traverse_auto on `bvh` in the asked
    mode; without it they keep the fold over their pairs inside the cap
    (none for a block whose list starts past it).  With `stats` (a
    dict), it also receives the per-block `counts`, `overflow` and
    `n_walk` and the list capacity `pcap`.  `budget`: these rays are a
    slice of a longer call's, whose list they continue
    (rt_pairs.pair_list)."""
    from toyrenderer_tpu_torch.ops import chunks_cuda
    n = origins.shape[0]
    dev = origins.device
    boxes, data = chunk_table(bvh) if tables is None else tables
    n_pad = -(-n // block) * block
    b = n_pad // block
    t_max, live_f = bvh_cuda._rays(origins, t_max, live)
    live_b = live_f > 0.0
    pad = n_pad - n

    def padded(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 2
                                       else (0, pad))
    o_p, d_p, cap_p, lv_p = (padded(x) for x in
                             (origins, directions, t_max, live_f))
    with profiler_range('RT(chunk boxes)'):
        sd = torch.where(torch.abs(d_p) < _EPS_DIR,
                         torch.where(d_p < 0, -_EPS_DIR, _EPS_DIR), d_p)
        ok_b = _block_boxes(o_p, 1.0 / sd, cap_p, lv_p > 0.0, boxes, block)
        pchk, counts, starts, overflow, pcap = pair_list(ok_b, pair_factor,
                                                         budget)
        # a block walks its pairs inside the cap (the reference's list)
        n_walk = torch.clamp(torch.clamp(starts + counts, max=pcap)
                             - starts, min=0)
    if stats is not None:
        stats.update(counts=counts, overflow=overflow, n_walk=n_walk,
                     pcap=pcap)

    rays = torch.cat([o_p, d_p, cap_p[:, None], lv_p[:, None]],
                     1).reshape(b, block, 8).contiguous()
    best_t, best_pay = chunks_cuda.chunk_fold(
        rays, data, pchk.contiguous(), starts.to(torch.int32).contiguous(),
        n_walk.to(torch.int32).contiguous())
    best_t, best_pay = best_t[:n], best_pay[:n]
    hit = torch.isfinite(best_t) & live_b
    zero = torch.zeros(n, device=dev)
    res = dict(hit=hit, t=torch.where(hit, best_t, t_max),
               tri=torch.where(hit, best_pay, -1),
               steps=counts.to(torch.int32).repeat_interleave(block)[:n],
               u=zero, v=zero)
    if not fallback:
        return res
    need = overflow.repeat_interleave(block)[:n] & live_b
    fb = bvh_cuda.traverse_auto(bvh, origins, directions, t_max,
                                any_hit=any_hit,
                                live=need.to(torch.float32))
    for k in ('hit', 't', 'tri', 'steps'):
        res[k] = torch.where(need, fb[k], res[k])
    return res
