"""The port's pair route (ops/rt_pairs.py; its fold K6 runs here as its
plain version, pair_fold_plain) against the reference package's
(toyrenderer_tpu/ops/rt_pairs.py, its Pallas kernel in interpret mode).

* `mt_tables` on the random soup of tests/test_rt_pairs.py (the
  reference's complete tree, carried across) and on cornell's SAH tree
  (the reference's host build and refit, carried across): boxes, feat
  and pays within 1e-6 relative to each table's largest entry (the
  coefficients are short sums of products that the two frameworks may
  round apart by an ulp).
* `traverse_pairs` against the reference's at its default precision
  ('high', a bf16x3 split on the matrix unit; the port sums in float32),
  with the reference test's tolerances (tests/test_rt_pairs.py:39-51):
  hit equal, t within 2e-3 where both hit, tri equal on > 98% of them;
  closest-hit and any-hit; `steps` (each ray's block's pair count) equal
  on the blocks that did not overflow.
* The live mask and t_max, as tests/test_rt_pairs.py:54-64.
* The overflow fallback at pair_factor=1 (4,000 triangles, 4,096 rays:
  8 of 32 blocks past the 1,024-pair cap): the same blocks overflow as in
  the reference (steps of their dead rays are the block's count in
  both), and the result is held to the reference at its f32-grade
  precision ('highest'), with that parametrization's tolerance of the
  reference test (t within 2e-4): at 'high' one of these 4,096 rays
  grazes a triangle that the lockstep oracle, the port and 'highest'
  all miss.  The reference completes the overflowed blocks with its
  packet kernel, the port with its traversal's plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import bvh_sah as JS
from toyrenderer_tpu.ops import rt_pairs as JR
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_bvh import _jax_inst_world
from test_torch_culling import _scene
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import bvh_cuda as TBC
from toyrenderer_tpu_torch.ops import rt_pairs as TR
from toyrenderer_tpu_torch.weights import bvh_from_numpy, bvh_sah_from_numpy


def _random_scene(n_tris=700, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    v1 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.7, (n_tris, 3)).astype(np.float32)
    return base, v1, v2


def _rays(n, seed=11, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _trees(n_tris=700, seed=3):
    v0, v1, v2 = (jnp.asarray(x) for x in _random_scene(n_tris, seed))
    jb = JB.build_bvh(v0, v1, v2, jnp.ones(v0.shape[0], bool))
    tb = bvh_from_numpy(dict(child_boxes=np.asarray(jb.child_boxes),
                             leaf_rows=np.asarray(jb.leaf_rows),
                             level_offset=jb.level_offset,
                             num_levels=jb.num_levels), 'cpu')
    return jb, tb


def _cornell_sah():
    sh, _, _ = _scene("cornell.gltf")
    pi, pm = static_meshlet_pairs(sh, 'all')
    rts = JS.build_rt_static_sah(sh, pi, pm)
    jt = JS.refit_sah(rts, jnp.asarray(_jax_inst_world(sh)))
    return jt, bvh_sah_from_numpy(dict(
        node_rows=np.asarray(jt.node_rows),
        leaf_rows=np.asarray(jt.leaf_rows),
        depth=len(rts.depth_ranges)), 'cpu')


@pytest.mark.parametrize("tree", ["soup", "cornell sah"])
def test_mt_tables_match_reference(tree):
    jb, tb = _trees() if tree == "soup" else _cornell_sah()
    want = JR.mt_tables(jb)
    got = TR.mt_tables(tb)
    for name, w, g in zip(("boxes", "feat", "pays"), want, got):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = float(np.abs(w[np.abs(w) < 1e30]).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * scale,
                                   err_msg=name)
    assert (got[2] >= 0).sum() == int((np.asarray(jb.leaf_rows)[
        :, 108:120] >= 0).sum())


def _hold(got, want, t_tol=2e-3):
    hr, hg = np.asarray(want['hit']), got['hit'].numpy()
    np.testing.assert_array_equal(hg, hr)
    np.testing.assert_allclose(got['t'].numpy()[hr], np.asarray(want['t'])[hr],
                               rtol=t_tol, atol=t_tol)
    agree = (got['tri'].numpy()[hr] == np.asarray(want['tri'])[hr]).mean()
    assert agree > 0.98, agree


@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_pairs_matches_reference(any_hit):
    jb, tb = _trees()
    o, d = _rays(640)
    want = JR.traverse_pairs(jb, jnp.asarray(o), jnp.asarray(d), t_max=100.0,
                             any_hit=any_hit, interpret=True)
    stats = {}
    got = TR.traverse_pairs(tb, torch.from_numpy(o), torch.from_numpy(d),
                            100.0, any_hit=any_hit, stats=stats)
    _hold(got, want)
    assert 0.2 < float(got['hit'].float().mean()) < 0.95
    assert not bool(stats['overflow'].any())
    np.testing.assert_array_equal(got['steps'].numpy(),
                                  np.asarray(want['steps']))
    assert not got['u'].any() and not got['v'].any()
    # the tables built once by the caller give the same result
    again = TR.traverse_pairs(tb, torch.from_numpy(o), torch.from_numpy(d),
                              100.0, any_hit=any_hit,
                              tables=TR.mt_tables(tb))
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(again[k], got[k]), k


def test_live_mask_and_tmax():
    jb, tb = _trees(300, seed=5)
    o, d = _rays(256, seed=7)
    live = (np.arange(256) % 3 == 0).astype(np.float32)
    want = JR.traverse_pairs(jb, jnp.asarray(o), jnp.asarray(d), t_max=2.5,
                             live=jnp.asarray(live), interpret=True)
    got = TR.traverse_pairs(tb, torch.from_numpy(o), torch.from_numpy(d),
                            2.5, live=torch.from_numpy(live))
    _hold(got, want)
    assert not bool(got['hit'][torch.from_numpy(live) == 0].any())
    assert bool((got['t'][~got['hit']] == 2.5).all())
    assert int(got['hit'].sum()) > 0


N_OVER = 4096          # 32 blocks: 1,344 pairs against the 1,024 cap


def test_overflow_fallback_matches_reference():
    jb, tb = _trees(4000, seed=9)
    o, d = _rays(N_OVER, seed=13, spread=3.0)
    live = np.ones(N_OVER, np.float32)
    live[::5] = 0.0
    want = JR.traverse_pairs(jb, jnp.asarray(o), jnp.asarray(d), t_max=100.0,
                             live=jnp.asarray(live), pair_factor=1,
                             precision='highest', interpret=True)
    stats = {}
    got = TR.traverse_pairs(tb, torch.from_numpy(o), torch.from_numpy(d),
                            100.0, live=torch.from_numpy(live),
                            pair_factor=1, stats=stats)
    over = stats['overflow'].numpy()
    assert 0 < over.sum() < over.size
    # the reference reports a fallback ray's steps from its packet walk,
    # a dead ray's as its block's pair count: the overflowed blocks are
    # the ones whose dead rays keep the count while the port's live rays
    # take their own walk's visits
    ws, gs = np.asarray(want['steps']), got['steps'].numpy()
    dead = live == 0
    np.testing.assert_array_equal(gs[dead], ws[dead])
    kept = ~np.repeat(over, TR.BLOCK)
    np.testing.assert_array_equal(gs[kept], ws[kept])
    np.testing.assert_array_equal(gs[dead], np.repeat(
        stats['counts'].numpy(), TR.BLOCK)[dead])
    _hold(got, want, t_tol=2e-4)
    # and the lockstep oracle agrees on the overflowed blocks' rays
    ref = TBC.traverse_plain(tb, torch.from_numpy(o), torch.from_numpy(d),
                             100.0, live=torch.from_numpy(live))
    fb = ~kept & ~dead
    assert fb.sum() > 0
    assert torch.equal(got['t'][fb], ref['t'][fb])


def test_pair_fold_plain_is_order_free():
    """The fold's winner is the least t, ties to the least ordinal: the
    same whether a block's chunks are listed ascending or reversed."""
    _, tb = _trees(400, seed=17)
    o, d = _rays(256, seed=19, spread=4.0)
    boxes, feat, _ = TR.mt_tables(tb)
    c = boxes.shape[0]
    rays = torch.cat([torch.from_numpy(o), torch.from_numpy(d),
                      torch.full((256, 1), 100.0), torch.ones(256, 1)],
                     1).reshape(2, TR.BLOCK, 8)
    chunks = torch.arange(c, dtype=torch.int32)
    pchk = torch.cat([chunks, chunks.flip(0)])
    starts = torch.tensor([0, c], dtype=torch.int32)
    n_walk = torch.tensor([c, c], dtype=torch.int32)
    t, ordi = TR.pair_fold_plain(rays, feat, pchk, starts, n_walk)
    t2, o2 = TR.pair_fold_plain(rays.flip(0), feat, pchk, starts, n_walk)
    assert torch.equal(t, torch.cat([t2[TR.BLOCK:], t2[:TR.BLOCK]]))
    assert torch.equal(ordi, torch.cat([o2[TR.BLOCK:], o2[:TR.BLOCK]]))
    assert bool(torch.isfinite(t).any()) and bool((ordi[torch.isinf(t)]
                                                   == -1).all())
