"""The port's chunk route (ops/rt_chunks.py; its fold K8 runs here as its
plain version, chunk_fold_plain) against the reference package's
(toyrenderer_tpu/ops/rt_chunks.py, XLA, its overflow fallback through
the Pallas traversal in interpret mode).

* `chunk_table` equal, bit for bit, on the complete tree of a random
  soup and on cornell's SAH tree (both built and refitted by the
  reference and carried across).
* `traverse_chunks` against the reference's: hit and tri equal, t
  within 1e-6 relative where both hit (the fallback's rays: within 1e-5
  absolute, the tolerance between the two packages' traversals);
  closest and any hit, with a live mask and per-ray t_max, at the
  default capacity (no block overflows) and at pair_factor=1 (some
  blocks overflow and take the fallback).
* The tie rule: within a pair the first slot with the least t wins,
  across pairs the least payload among the tied pairs' winners, as in
  the reference (rt_chunks.py:196-214).
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import rt_chunks as JC

from test_torch_raster import _one_torch_thread  # noqa: F401
from test_torch_rt_pairs import _cornell_sah, _rays, _trees
from toyrenderer_tpu_torch.ops import bvh_cuda as TBC
from toyrenderer_tpu_torch.ops import rt_chunks as TC


@pytest.mark.parametrize("tree", ["soup", "cornell sah"])
def test_chunk_table_matches_reference(tree):
    jb, tb = _trees() if tree == "soup" else _cornell_sah()
    for name, w, g in zip(("boxes", "data"), JC.chunk_table(jb),
                          TC.chunk_table(tb)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _hold(got, want, fb=None, any_hit=False):
    """hit and tri equal; t within 1e-6 relative where both hit, except
    on the fallback's rays `fb`: those come from the two packages'
    traversals (the port's K3 semantics, the reference's Pallas kernel),
    which tests/test_torch_bvh.py holds to 1e-5 absolute, and any-hit
    ones stop at the first leaf with a hit in each walk's own order, so
    only their hit is compared."""
    hr = np.asarray(want['hit'])
    fb = np.zeros_like(hr) if fb is None else fb
    np.testing.assert_array_equal(got['hit'].numpy(), hr)
    gt, wt = got['t'].numpy(), np.asarray(want['t'])
    tri_g, tri_w = got['tri'].numpy(), np.asarray(want['tri'])
    np.testing.assert_array_equal(tri_g[~fb], tri_w[~fb])
    np.testing.assert_allclose(gt[hr & ~fb], wt[hr & ~fb], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(gt[~hr], wt[~hr])
    if not any_hit:
        np.testing.assert_array_equal(tri_g[fb], tri_w[fb])
        np.testing.assert_allclose(gt[hr & fb], wt[hr & fb], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("pair_factor", [64, 1], ids=["fits", "overflows"])
def test_traverse_chunks_matches_reference(any_hit, pair_factor):
    jb, tb = _trees(4000, seed=9)
    n = 4096                       # 32 blocks
    o, d = _rays(n, seed=13, spread=3.0)
    rng = np.random.default_rng(5)
    live = (rng.uniform(size=n) > 0.2).astype(np.float32)
    t_max = rng.uniform(1.0, 8.0, n).astype(np.float32)
    want = JC.traverse_chunks(jb, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(t_max), any_hit=any_hit,
                              live=jnp.asarray(live),
                              pair_factor=pair_factor, interpret=True)
    stats = {}
    got = TC.traverse_chunks(tb, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(t_max), any_hit=any_hit,
                             live=torch.from_numpy(live),
                             pair_factor=pair_factor, stats=stats)
    over = stats['overflow'].numpy()
    if pair_factor == 1:
        assert 0 < over.sum() < over.size
    else:
        assert not over.any()
    fb = np.repeat(over, TC.BLOCK) & (live > 0)
    _hold(got, want, fb, any_hit)
    assert 0.1 < float(got['hit'].float().mean()) < 0.95
    assert not bool(got['hit'][torch.from_numpy(live) == 0].any())
    # steps: the block's pair count, except the fallback's live rays
    np.testing.assert_array_equal(got['steps'].numpy()[~fb],
                                  np.asarray(want['steps'])[~fb])
    # the routed call (the frame's entry) gives the same result; asked
    # for both routes, it takes the chunk route, as the reference's probe
    # trace does
    again = TBC.traverse_auto(tb, torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t_max), any_hit=any_hit,
                              live=torch.from_numpy(live), chunked=True,
                              pairs=True)
    if pair_factor == 64:
        for k in ('hit', 't', 'tri', 'steps'):
            assert torch.equal(again[k], got[k]), k


def _leaf_tree(slots):
    """Leaf rows (8 per chunk) holding the big triangle z = 1 at the given
    (chunk, slot) -> payload places, every other slot padding; for the
    JAX package and the port (chunk_table reads only leaf_rows)."""
    big = np.array([[-5, -5, 1], [5, -5, 1], [0, 5, 1]], np.float32)
    n_chunks = 1 + max(c for c, _ in slots)
    rows = np.zeros((n_chunks * TC.CHUNK_ROWS, 10, 12), np.float32)
    rows[:, 9] = -1.0
    for (c, s), pay in slots.items():
        r, k = c * TC.CHUNK_ROWS + s // 12, s % 12
        rows[r, 0:3, k] = big[0]
        rows[r, 3:6, k] = big[1] - big[0]
        rows[r, 6:9, k] = big[2] - big[0]
        rows[r, 9, k] = pay
    leaf = rows.reshape(-1, 120)
    return (types.SimpleNamespace(leaf_rows=jnp.asarray(leaf)),
            types.SimpleNamespace(leaf_rows=torch.from_numpy(leaf)))


@pytest.mark.parametrize("slots,want_pay", [
    ({(0, 0): 7, (0, 5): 3}, 7),
    ({(0, 0): 7, (1, 0): 3}, 3),
    ({(0, 4): 2, (1, 0): 9, (1, 1): 5}, 2),
], ids=["one chunk: first slot", "two chunks: least payload",
        "both rules"])
def test_tie_rule_matches_reference(slots, want_pay):
    """Copies of one triangle give every ray the same t.  Within a chunk
    the first slot wins, whatever its payload; across chunks the least
    payload among the pairs' winners."""
    jt, tt = _leaf_tree(slots)
    n = 256
    rng = np.random.default_rng(2)
    o = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))],
                       1).astype(np.float32)
    d = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
    want = JC.traverse_chunks(None, jnp.asarray(o), jnp.asarray(d), 100.0,
                              tables=JC.chunk_table(jt), fallback=False)
    got = TC.traverse_chunks(None, torch.from_numpy(o), torch.from_numpy(d),
                             100.0, tables=TC.chunk_table(tt),
                             fallback=False)
    _hold(got, want)
    assert bool(got['hit'].all())
    assert bool((got['tri'] == want_pay).all())
