"""The port's binned traversal (bvh_cuda.traverse_binned; its seeded walk
K3-seeded runs here as its plain version, traverse_plain(seeds=)) against
the reference package's (bvh_pallas.traverse_binned, its Pallas kernel
in interpret mode), on the scene of tests/test_bvh.py:415-460: 4,000
random triangles (every 13th invalid), the reference's complete tree
carried across, 1,500 rays (not a whole number of packets).

* `_entry_nodes_complete`: boxes, seeds and level equal.
* `traverse_binned` with rounds 0, 1 and 3, closest-hit: hit equal, t
  within rtol 1e-4 / atol 1e-5 and tri equal where hit (the reference
  test's own tolerances against the lockstep traversal); any-hit: hit
  equal; the live mask: dead rays miss, the others as without it.
  Against the port's own root walk (traverse_plain): closest-hit hit
  and t bit-equal -- the winning triangle's t does not depend on the
  walk, and phase A tests the entry boxes with the kernel's slab
  arithmetic -- and any-hit hit equal.
* The seeded walk seeded at the root is the root walk; a negative seed
  is a miss.
* The SAH tree is refused, and so are seeds with grouped directions; a
  tree with no entry level below the root takes the root walk.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import bvh_pallas as JP

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import bvh_cuda as TBC
from toyrenderer_tpu_torch.ops.bvh_sah import BvhSah
from toyrenderer_tpu_torch.weights import bvh_from_numpy

T_MAX = 150.0


def _carry(jb):
    return bvh_from_numpy(dict(child_boxes=np.asarray(jb.child_boxes),
                               leaf_rows=np.asarray(jb.leaf_rows),
                               level_offset=jb.level_offset,
                               num_levels=jb.num_levels), 'cpu')


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(7)
    t = 4000
    v0 = rng.uniform(-15, 15, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.7, 0.7, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.7, 0.7, (t, 3)).astype(np.float32)
    valid = np.ones(t, bool)
    valid[::13] = False
    jb = JB.build_bvh(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                      jnp.asarray(valid))
    n = 1500
    o = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tb = _carry(jb)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    return dict(jb=jb, tb=tb, o=o, d=d, to=to, td=td,
                closest=TBC.traverse_plain(tb, to, td, T_MAX),
                any=TBC.traverse_plain(tb, to, td, T_MAX, any_hit=True))


def _jax(s, **kw):
    return JP.traverse_binned(s['jb'], jnp.asarray(s['o']),
                              jnp.asarray(s['d']), t_max=T_MAX,
                              interpret=True, **kw)


def test_entry_nodes_match_reference(scene):
    jb, tb = scene['jb'], scene['tb']
    want = JP._entry_nodes_complete(jb)
    got = TBC._entry_nodes_complete(tb)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2] == want[2] and got[0].shape[0] > 8


@pytest.mark.parametrize("rounds", [0, 1, 3])
def test_binned_matches_reference(scene, rounds):
    want = _jax(scene, rounds=rounds)
    stats = {}
    got = TBC.traverse_binned(scene['tb'], scene['to'], scene['td'], T_MAX,
                              rounds=rounds, stats=stats)
    wh = np.asarray(want['hit'])
    np.testing.assert_array_equal(got['hit'].numpy(), wh)
    np.testing.assert_allclose(got['t'].numpy()[wh], np.asarray(want['t'])[wh],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got['tri'].numpy()[wh],
                                  np.asarray(want['tri'])[wh])
    assert not got['steps'].any()
    root = scene['closest']
    assert torch.equal(got['hit'], root['hit'])
    assert torch.equal(got['t'], root['t'])
    assert 0.05 < float(got['hit'].float().mean()) < 0.95
    assert len(stats['packets']) == rounds
    if rounds:        # the rounds finish some rays before the last pass
        assert int(stats['rest']) < len(scene['o'])


def test_binned_any_hit_and_live_mask(scene):
    want = _jax(scene, any_hit=True, rounds=2)
    got = TBC.traverse_binned(scene['tb'], scene['to'], scene['td'], T_MAX,
                              any_hit=True)
    np.testing.assert_array_equal(got['hit'].numpy(), np.asarray(want['hit']))
    assert torch.equal(got['hit'], scene['any']['hit'])

    lv = np.ones(len(scene['o']), np.float32)
    lv[::3] = 0.0
    want = _jax(scene, rounds=2, live=jnp.asarray(lv))
    got = TBC.traverse_binned(scene['tb'], scene['to'], scene['td'], T_MAX,
                              live=torch.from_numpy(lv))
    wh = np.asarray(want['hit'])
    np.testing.assert_array_equal(got['hit'].numpy(), wh)
    assert not got['hit'][::3].any()
    keep = torch.from_numpy(lv > 0)
    assert torch.equal(got['hit'][keep], scene['closest']['hit'][keep])
    np.testing.assert_allclose(got['t'].numpy()[wh], np.asarray(want['t'])[wh],
                               rtol=1e-4, atol=1e-5)


def test_seeded_walk(scene):
    tb, o, d = scene['tb'], scene['to'], scene['td']
    n = o.shape[0]
    packet = 256
    p = -(-n // packet)
    root = TBC.traverse_plain(tb, o, d, T_MAX, seeds=torch.zeros(
        p, dtype=torch.int32), packet=packet)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(root[k], scene['closest'][k]), k
    seeds = torch.zeros(p, dtype=torch.int32)
    seeds[1] = -1
    got = TBC.traverse_plain(tb, o, d, T_MAX, seeds=seeds, packet=packet)
    empty = slice(packet, 2 * packet)
    assert not got['hit'][empty].any() and not got['steps'][empty].any()
    assert bool((got['t'][empty] == T_MAX).all())
    # an entry seed walks only its subtree: its hits are root hits, never
    # nearer
    boxes, eseeds, _ = TBC._entry_nodes_complete(tb)
    sub = TBC.traverse_plain(tb, o, d, T_MAX, seeds=eseeds[3:4].repeat(p),
                             packet=packet)
    assert bool((sub['t'] >= scene['closest']['t']).all())
    assert 0 < int(sub['hit'].sum()) < int(scene['closest']['hit'].sum())


def test_binned_refuses_sah_and_walks_shallow_trees(scene):
    o, d = scene['to'][:64], scene['td'][:64]
    sah = BvhSah(torch.zeros(1, 64), scene['tb'].leaf_rows, depth=1)
    with pytest.raises(ValueError, match="complete tree"):
        TBC.traverse_binned(sah, o, d, T_MAX)
    with pytest.raises(ValueError, match="per-ray directions"):
        TBC.traverse(scene['tb'], scene['to'][:128], scene['td'][:128],
                     T_MAX, group_dirs=d[:1],
                     seeds=torch.zeros(1, dtype=torch.int32), packet=128)
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    jb = JB.build_bvh(jnp.asarray(v0), jnp.asarray(v0 + 0.5),
                      jnp.asarray(v0 + [0.5, 0.0, 0.2]),
                      jnp.ones(40, bool))
    tb = _carry(jb)
    assert TBC._entry_nodes_complete(tb) is None
    got = TBC.traverse_binned(tb, o * 0.1, d, T_MAX)
    want = TBC.traverse_plain(tb, o * 0.1, d, T_MAX)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(got[k], want[k]), k
