"""The pair route of the ray traversal: dense Moller-Trumbore over the
(ray block, triangle chunk) pairs whose boxes overlap, folded to each
ray's closest hit.

Counterpart of toyrenderer_tpu/ops/rt_pairs.py.  The TPU kernel it
replaces, `_make_pairs_kernel` (rt_pairs.py:145, K6), becomes
csrc/pairs.cu (ops/pairs_cuda.py); `pair_fold_plain` here is its plain
version.  The DDGI probe rays take this route with TR_GI_PAIRS=1
(ops/ddgi.py), through bvh_cuda.traverse_auto(pairs=True).

Moller-Trumbore is a bank of bilinear forms.  With the ray's features
f = [1, o, d, o (x) d] (16 wide) and per-triangle coefficients (using
det[a, b, c] = a . (b x c)):

  det   = e1 . (d x e2)             -> (e2 x e1) on d
  u_num = (o - v0) . (d x e2)       -> crossmat(e2) on o(x)d, (v0 x e2) on d
  v_num = d . ((o - v0) x e1)       -> -crossmat(e1) on o(x)d, -(v0 x e1) on d
  t_num = (o - v0) . (e1 x e2)      -> (e1 x e2) on o, -v0.(e1 x e2) on 1

so each form is a 16-term sum f . m.  `mt_tables` lays the coefficients
of 8 consecutive leaf rows (a chunk of 96 triangles) out as one
(16, 4 * 128) row per chunk.  `traverse_pairs` tests every block of 128
rays against every chunk box, lists the overlapping (block, chunk)
pairs in block-major order, and folds each block's chunks with the
kernel; a ray's winner is its least t, ties to the least ordinal
chunk * 128 + lane, and the payload table resolves the ordinal.

The reference computes the forms on the TPU's matrix unit as a bf16x3
split (its `precision`, and `group`, the pairs per grid step, are TPU
knobs this port does not carry).  The port computes each form in
float32, summed over its 16 terms in order, so K6 is bit-equal to
`pair_fold_plain` and within the reference's own tolerances of the
reference.

The pair list is capped at pair_factor * B pairs (rounded up to 1024).
Blocks whose pairs reach past the cap (the reference's rule, so the
same blocks) are completed by bvh_cuda.traverse_auto on the same tree:
the reference's own overflow path, kept as part of the function (on the
card: K3, or K3-SAH on the SAH tree).
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops import bvh_cuda
from toyrenderer_tpu_torch.ops.bvh import LEAF_TRIS
from toyrenderer_tpu_torch.utils.timing import profiler_range

CHUNK_ROWS = 8                          # leaf rows per chunk
CHUNK_TRIS = CHUNK_ROWS * LEAF_TRIS     # 96
SLAB = 128                              # lanes per form slab (tris, padded)
NSLAB = 4                               # det | u_num | v_num | t_num
NFEAT = 16                              # [1, o(3), d(3), o(x)d(9)]
BLOCK = 128                             # rays per block
PAIR_FACTOR = 64                        # the list's pairs per ray block
_EPS_DIR = 1e-12
_BOX_ELEMS = 1 << 24                    # (rays, chunks) box-phase tile
_FOLD_ELEMS = 1 << 22                   # (pairs, rays, tris) plain tile
# the fold's key (float bits of t << 32) | ordinal before any hit: an
# accepted t is positive, so the keys order like (t, ordinal)
INF_KEY = (0x7F800000 << 32) | 0x7FFFFFFF


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _crossmat(w):
    """(..., 3) -> (..., 9) row-major crossmat[i, j] = sum_k eps_ijk w_k
    (so sum_ij a_i b_j crossmat[i, j] = a . (b x w))."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([z, w[..., 2], -w[..., 1],
                        -w[..., 2], z, w[..., 0],
                        w[..., 1], -w[..., 0], z], -1)


def mt_tables(bvh):
    """(boxes (C, 6) f32 [lo.xyz hi.xyz], feat (C + 1, 16, 4 * 128) f32,
    pays ((C + 1) * 128,) f32) from either tree flavour: only its leaf
    rows (NG, 120) are read, in their order, 8 to a chunk.  Rebuilt from
    each refit: the coefficients are world-space.

    feat[c, :, s * 128 + t] is form s's 16 coefficients for chunk c's
    triangle t; padding lanes are zero (det == 0 rejects them), and the
    last row is an all-zero sentinel chunk.  pays[c * 128 + t] is the
    triangle's payload (-1 in padding lanes)."""
    leaf = bvh.leaf_rows
    dev = leaf.device
    ng = leaf.shape[0]
    c = -(-ng // CHUNK_ROWS)
    pad = c * CHUNK_ROWS - ng
    if pad:
        pad_rows = torch.zeros((pad, leaf.shape[1]), device=dev)
        pad_rows[:, 9 * LEAF_TRIS:10 * LEAF_TRIS] = -1.0
        leaf = torch.cat([leaf, pad_rows])
    g = leaf[:, :10 * LEAF_TRIS].reshape(c, CHUNK_ROWS, 10, LEAF_TRIS)

    def comp(i):
        return g[:, :, i:i + 3].permute(0, 1, 3, 2).reshape(c, CHUNK_TRIS, 3)
    v0, e1, e2 = comp(0), comp(3), comp(6)
    pay = g[:, :, 9].reshape(c, CHUNK_TRIS)
    ok = (pay >= 0.0)[..., None]

    p1, p2 = v0 + e1, v0 + e2
    big = 3e37
    lo = torch.where(ok, torch.minimum(torch.minimum(v0, p1), p2), big)
    hi = torch.where(ok, torch.maximum(torch.maximum(v0, p1), p2), -big)
    boxes = torch.cat([lo.amin(1), hi.amax(1)], -1)

    z1 = torch.zeros((c, CHUNK_TRIS, 1), device=dev)
    z3 = torch.zeros((c, CHUNK_TRIS, 3), device=dev)
    z9 = torch.zeros((c, CHUNK_TRIS, 9), device=dev)
    n = _cross(e1, e2)
    v0n = (v0[..., 0] * n[..., 0] + v0[..., 1] * n[..., 1]
           + v0[..., 2] * n[..., 2])[..., None]
    forms = torch.stack([
        torch.cat([z1, z3, _cross(e2, e1), z9], -1),                  # det
        torch.cat([z1, z3, _cross(v0, e2), _crossmat(e2)], -1),       # u
        torch.cat([z1, z3, -_cross(v0, e1), -_crossmat(e1)], -1),     # v
        torch.cat([-v0n, n, z3, z9], -1)], 1)                         # t
    forms = torch.where(ok[:, None], forms, 0.0)          # (C, 4, 96, 16)
    forms = torch.nn.functional.pad(forms, (0, 0, 0, SLAB - CHUNK_TRIS))
    feat = forms.permute(0, 3, 1, 2).reshape(c, NFEAT, NSLAB * SLAB)
    feat = torch.cat([feat, torch.zeros((1, NFEAT, NSLAB * SLAB),
                                        device=dev)])
    pays = torch.nn.functional.pad(pay, (0, SLAB - CHUNK_TRIS), value=-1.0)
    pays = torch.cat([pays, torch.full((1, SLAB), -1.0, device=dev)])
    return boxes.contiguous(), feat.contiguous(), pays.reshape(-1)


def pair_fold_plain(rays, feat, pchk, starts, n_walk):
    """K6's function in plain PyTorch, on any device.  rays (B, 128, 8)
    f32 ray slots [o, d, t_max, live]; feat (C + 1, 16, 512) f32
    (mt_tables); pchk (L,) i32 the chunk of each listed pair; block b
    walks pairs starts[b] .. starts[b] + n_walk[b] - 1.  Returns
    (best_t (B * 128,) f32, best_ord (B * 128,) i32): each ray's least
    t over the walked chunks' triangles and the least ordinal
    chunk * 128 + lane that gives it (inf and -1 without a hit).

    Each form is summed over its 16 terms in order as separate
    multiplies and adds, as the kernel sums it; the pairs are processed
    a tile at a time, so no (pairs, 128, 512) tensor is built."""
    b = rays.shape[0]
    dev = rays.device
    n_walk = n_walk.long()
    total = int(n_walk.sum())
    blk = torch.repeat_interleave(torch.arange(b, device=dev), n_walk,
                                  output_size=total)
    first = torch.cumsum(n_walk, 0) - n_walk
    rank = torch.arange(total, device=dev) - first[blk]
    chunk = pchk.long()[starts.long()[blk] + rank]
    # the features [1, o, d, o (x) d], in the kernel's order
    o, d = rays[..., 0:3], rays[..., 3:6]
    f = torch.cat([torch.ones_like(o[..., :1]), o, d,
                   (o[..., :, None] * d[..., None, :]).flatten(-2)], -1)
    lanes = torch.arange(CHUNK_TRIS, device=dev)
    best = torch.full((b * BLOCK,), INF_KEY, dtype=torch.int64, device=dev)
    step = max(1, _FOLD_ELEMS // (BLOCK * CHUNK_TRIS))
    for s in range(0, total, step):
        bb, cc = blk[s:s + step], chunk[s:s + step]
        fp = f[bb][..., None]                              # (P, 128, 16, 1)
        m = feat[cc].reshape(-1, NFEAT, NSLAB, SLAB)[..., :CHUNK_TRIS]
        forms = []
        for sl in range(NSLAB):
            ms = m[:, None, :, sl]                         # (P, 1, 16, 96)
            acc = fp[:, :, 0] * ms[:, :, 0]
            for k in range(1, NFEAT):
                acc = acc + fp[:, :, k] * ms[:, :, k]
            forms.append(acc)                              # (P, 128, 96)
        det, u_n, v_n, t_n = forms
        inv_det = torch.where(torch.abs(det) < 1e-7, 0.0, 1.0 / det)
        u, v, tt = u_n * inv_det, v_n * inv_det, t_n * inv_det
        r = rays[bb]
        ok = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (tt > 1e-7) & (tt < r[..., 6:7]) & (r[..., 7:8] > 0.0))
        tt = torch.where(ok, tt, torch.inf)
        key = ((tt.view(torch.int32).long() << 32)
               | (cc[:, None, None] * SLAB + lanes))
        idx = (bb[:, None] * BLOCK
               + torch.arange(BLOCK, device=dev)).reshape(-1)
        best.scatter_reduce_(0, idx, key.amin(-1).reshape(-1), 'amin')
    return unpack_keys(best)


def unpack_keys(keys):
    """(best_t f32, best_ord i32) of the fold's int64 keys: inf and -1
    where no triangle was accepted."""
    best_t = (keys >> 32).to(torch.int32).view(torch.float32)
    best_ord = torch.where(torch.isinf(best_t), -1,
                           (keys & 0x7FFFFFFF).to(torch.int32))
    return best_t, best_ord.to(torch.int32)


def _block_boxes(o, inv, cap, live, boxes, block: int = BLOCK):
    """(n, C) bool -> reduced to blocks: (n / block, C), True where a live
    ray of the block enters chunk c's box before its t_max; one axis at
    a time, a tile of rays at a time."""
    n, c = o.shape[0], boxes.shape[0]
    rows = max(block, _BOX_ELEMS // max(c, 1) // block * block)
    out = []
    for s in range(0, n, rows):
        os_, is_ = o[s:s + rows], inv[s:s + rows]
        tn = torch.zeros((os_.shape[0], c), device=o.device)
        tf = torch.full((os_.shape[0], c), torch.inf, device=o.device)
        for k in range(3):
            t0 = (boxes[None, :, k] - os_[:, k:k + 1]) * is_[:, k:k + 1]
            t1 = (boxes[None, :, 3 + k] - os_[:, k:k + 1]) * is_[:, k:k + 1]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        ok = ((tf >= tn) & (tn <= cap[s:s + rows, None])
              & live[s:s + rows, None])
        out.append(ok.reshape(-1, block, c).any(1))
    return torch.cat(out)


def list_capacity(blocks: int, pair_factor: int) -> int:
    """The pair list's capacity for `blocks` ray blocks: pair_factor *
    blocks rounded up to 1024 (the reference's)."""
    return max(-(-pair_factor * blocks // 1024) * 1024, 1024)


def pair_list(ok_b, pair_factor: int, budget=None):
    """The (block, chunk) pair list of a (B, C) overlap matrix, without a
    host read: (pchk, counts, starts, overflow, pcap).  pchk (min(pcap,
    B * C),) i32 holds the chunk of each listed pair, the overlapping
    flat indices b * C + c in ascending order, capped at pcap =
    list_capacity(B, pair_factor) (0 past the list); counts (B,) each
    block's pairs, starts (B,) its first position in the list, overflow
    (B,) bool whether its pairs end past the cap.  budget = (offset,
    cap): these blocks are a slice of a longer call's (a sharded trace,
    bvh_cuda._traverse_sharded) whose first pair lies at position
    `offset` (an int or a device scalar) of that call's list, capped at
    `cap`; a block overflows where its pairs end past `cap` in that list,
    as in the unsharded call, and the returned pcap is cap - offset, the
    cap in this list's positions."""
    b, c = ok_b.shape
    offset, pcap = ((0, list_capacity(b, pair_factor)) if budget is None
                    else budget)
    flat = torch.arange(b * c, device=ok_b.device)
    keys = torch.where(ok_b.reshape(-1), flat, b * c)
    pidx = torch.sort(keys).values[:pcap]
    pchk = torch.where(pidx < b * c, pidx % c, 0).to(torch.int32)
    counts = ok_b.sum(1)
    ends = torch.cumsum(counts, 0)
    return pchk, counts, ends - counts, ends + offset > pcap, pcap - offset


def traverse_pairs(bvh, origins, directions, t_max, any_hit: bool = False,
                   live=None, pair_factor: int = PAIR_FACTOR, tables=None,
                   stats: dict | None = None, budget=None) -> dict:
    """Trace rays through the pair route (reference rt_pairs.py:229):
    bvh_cuda's contract -- dict(hit, t, tri, steps) -- plus u and v,
    zero as in the reference (no consumer reads RT barycentrics); steps
    is the ray's block's pair count.  `tables`: mt_tables(bvh), built
    once per refit by the caller.  any_hit runs the closest-hit fold
    (dense tests have no early exit); overflowed blocks' live rays take
    traverse_auto on `bvh` in the asked mode.  With `stats` (a dict), it
    also receives the per-block `counts`, `overflow` and `n_walk` and the
    list capacity `pcap`.  `budget`: these rays are a slice of a longer
    call's, whose list they continue (pair_list)."""
    from toyrenderer_tpu_torch.ops import pairs_cuda
    n = origins.shape[0]
    dev = origins.device
    boxes, feat, pays = mt_tables(bvh) if tables is None else tables
    c = boxes.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    b = n_pad // BLOCK
    t_max, live_f = bvh_cuda._rays(origins, t_max, live)
    live_b = live_f > 0.0
    pad = n_pad - n

    def padded(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 2
                                       else (0, pad))
    o_p, d_p, cap_p, lv_p = (padded(x) for x in
                             (origins, directions, t_max, live_f))
    # the box phase and the pair list: a profiler range of their own
    # (tools/passes.py reports it inside the pass that traces)
    with profiler_range('RT(pair boxes)'):
        sd = torch.where(torch.abs(d_p) < _EPS_DIR,
                         torch.where(d_p < 0, -_EPS_DIR, _EPS_DIR), d_p)
        ok_b = _block_boxes(o_p, 1.0 / sd, cap_p, lv_p > 0.0, boxes)

        # the pair list: the overlapping (block, chunk) flat indices in
        # ascending order, capped at pcap; a block walks its pairs that
        # lie inside the cap (the reference's rule: every pair of a block
        # whose list ends past the cap is completed by the fallback, and
        # only the block that straddles the cap walks part of its list)
        pchk, counts, starts, overflow, pcap = pair_list(ok_b, pair_factor,
                                                         budget)
        n_walk = torch.clamp(torch.clamp(starts + counts, max=pcap)
                             - starts, min=0)
    if stats is not None:
        stats.update(counts=counts, overflow=overflow, n_walk=n_walk,
                     pcap=pcap)

    rays = torch.cat([o_p, d_p, cap_p[:, None], lv_p[:, None]],
                     1).reshape(b, BLOCK, 8).contiguous()
    best_t, best_ord = pairs_cuda.pair_fold(
        rays, feat, pchk.contiguous(), starts.to(torch.int32).contiguous(),
        n_walk.to(torch.int32).contiguous())
    best_t, best_ord = best_t[:n], best_ord[:n]
    hit = torch.isfinite(best_t) & live_b
    ordi = torch.where(hit, best_ord, 0).long()
    tri = torch.where(hit, pays[ordi], -1.0).to(torch.int32)
    zero = torch.zeros(n, device=dev)
    res = dict(hit=hit, t=torch.where(hit, best_t, t_max), tri=tri,
               steps=counts.to(torch.int32).repeat_interleave(BLOCK)[:n],
               u=zero, v=zero)
    need = overflow.repeat_interleave(BLOCK)[:n] & live_b
    fb = bvh_cuda.traverse_auto(bvh, origins, directions, t_max,
                                any_hit=any_hit,
                                live=need.to(torch.float32))
    for k in ('hit', 't', 'tri', 'steps'):
        res[k] = torch.where(need, fb[k], res[k])
    return res
