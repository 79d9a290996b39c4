"""The pair fold's even split (ops/pairs_cuda.py) on the CPU.

* `walk_positions`, the plain version of the map the kernel computes by a
  binary search over `walk_ends` (each walked position to its ray block
  and its pair-list entry), against a Python loop over the blocks, on
  the list shapes the card tests use (`PAIR_LISTS`: empty blocks, lists
  that straddle work items, a pair list that ends before, at and past
  its capacity).
* `census`: its work items, runs and skipped warps (a run packs its
  block's live rays onto the first warps) against a loop.
* The contract the kernel's 25-term sums rest on: `mt_tables` leaves
  exactly 39 of the 64 (form, coefficient) rows zero, and no other.
"""

import numpy as np
import pytest
import torch

from toyrenderer_tpu_torch.ops import bvh as B
from toyrenderer_tpu_torch.ops import pairs_cuda as PRC
from toyrenderer_tpu_torch.ops import rt_pairs as RP

# per-block pair counts, and the pair list's capacity (None: all of it)
PAIR_LISTS = {
    "empty blocks": ([0, 0, 5, 0, 0, 12, 0, 0], None),
    "lists straddle items": ([5, 23, 16, 1, 40, 7, 33, 0, 17], None),
    "ends before the cap": ([10, 20, 30, 0], 128),
    "ends at the cap": ([16, 48, 0, 64], 128),
    "ends past the cap": ([50, 60, 40, 30], 128),
    "no pairs": ([0, 0, 0], None),
}
# the (form, coefficient) rows that mt_tables may fill: det on d; u_num
# and v_num on d and the off-diagonal o (x) d; t_num on 1 and o
USED_ROWS = ({(0, k) for k in (4, 5, 6)}
             | {(s, k) for s in (1, 2)
                for k in (4, 5, 6, 8, 9, 10, 12, 13, 14)}
             | {(3, k) for k in (0, 1, 2, 3)})


def pair_list(counts, cap, n_chunks: int, seed: int = 0):
    """(pchk, starts, n_walk) i32 as rt_pairs.traverse_pairs lays them
    out: each block's chunks distinct and ascending, block-major, the
    list cut at `cap` (padded with chunk 0 up to it), a block walking its
    pairs inside the cap."""
    rng = np.random.default_rng(seed)
    lists = [np.sort(rng.choice(n_chunks, c, replace=False)) for c in counts]
    flat = np.concatenate(lists + [np.zeros(0, np.int64)]).astype(np.int32)
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    cap = max(total, 1) if cap is None else cap
    pchk = np.zeros(cap, np.int32)
    pchk[:min(cap, total)] = flat[:cap]
    ends = np.cumsum(counts)
    starts = ends - counts
    n_walk = np.clip(np.minimum(ends, cap) - starts, 0, None)
    return (torch.from_numpy(pchk), torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(n_walk.astype(np.int32)))


@pytest.mark.parametrize("case", list(PAIR_LISTS))
def test_walk_positions_match_a_loop(case):
    counts, cap = PAIR_LISTS[case]
    pchk, starts, n_walk = pair_list(counts, cap, n_chunks=80)
    want = [(b, int(starts[b]) + k) for b in range(len(counts))
            for k in range(int(n_walk[b]))]
    total = int(n_walk.sum())
    assert len(want) == total
    ends = PRC.walk_ends(n_walk)
    assert ends.dtype == torch.int32 and ends.shape == n_walk.shape
    assert int(ends[-1]) == total
    blk, pair = PRC.walk_positions(starts, n_walk, torch.arange(total))
    assert [(int(b), int(p)) for b, p in zip(blk, pair)] == want
    # the walked positions fit the grid, one work item per ITEM of them
    assert total <= pchk.shape[0]
    assert -(-total // PRC.ITEM) <= -(-pchk.shape[0] // PRC.ITEM)
    if cap is not None and sum(counts) > cap:
        assert total == cap and int((n_walk < torch.tensor(
            counts, dtype=torch.int32)).sum()) >= 1


@pytest.mark.parametrize("case", list(PAIR_LISTS))
def test_census_matches_a_loop(case):
    counts, cap = PAIR_LISTS[case]
    pchk, starts, n_walk = pair_list(counts, cap, n_chunks=80, seed=1)
    g = torch.Generator().manual_seed(5)
    rays = torch.zeros(len(counts), RP.BLOCK, 8)
    rays[..., 7] = (torch.rand(len(counts), RP.BLOCK, generator=g)
                    > 0.5).float()
    rays[0, 32:96, 7] = 0.0                     # block 0 mostly dead
    got = PRC.census(rays, starts, n_walk, pchk.shape[0])
    line = [b for b in range(len(counts)) for _ in range(int(n_walk[b]))]
    runs = [b for q, b in enumerate(line)
            if q % PRC.ITEM == 0 or line[q - 1] != b]
    # the live rays packed onto the first warps: the rest skip
    skipped = sum(PRC.WARPS - -(-int((rays[b, :, 7] > 0).sum()) // 32)
                  for b in runs)
    walking = [int(n) for n in n_walk if n > 0]
    assert got == dict(
        blocks_with_pairs=len(walking),
        n_walk_max=max(walking, default=0),
        n_walk_mean=float(np.mean(walking)) if walking else 0.0,
        work_items=-(-len(line) // PRC.ITEM),
        grid=-(-pchk.shape[0] // PRC.ITEM), runs=len(runs),
        warp_runs=len(runs) * PRC.WARPS, warp_runs_skipped=skipped)


def test_mt_tables_zero_rows_are_the_kernels_contract():
    """K6 sums only the 25 rows of USED_ROWS (csrc/pairs.cu): every other
    row of every chunk is zero, and each used row holds a value that is
    not zero somewhere."""
    rng = np.random.default_rng(4)
    n = 700
    v0 = torch.from_numpy(rng.uniform(-4, 4, (n, 3)).astype(np.float32))
    v1 = v0 + torch.from_numpy(rng.normal(0, 0.7, (n, 3)).astype(np.float32))
    v2 = v0 + torch.from_numpy(rng.normal(0, 0.7, (n, 3)).astype(np.float32))
    bvh = B.build_bvh(v0, v1, v2, torch.ones(n, dtype=torch.bool))
    _, feat, _ = RP.mt_tables(bvh)
    rows = feat.reshape(feat.shape[0], RP.NFEAT, RP.NSLAB, RP.SLAB)
    for s in range(RP.NSLAB):
        for k in range(RP.NFEAT):
            nonzero = bool((rows[:, k, s] != 0).any())
            assert nonzero == ((s, k) in USED_ROWS), (s, k)
    assert len(USED_ROWS) == 25
