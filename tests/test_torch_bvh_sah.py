"""The port's SAH tree (the GI tree: native build, refit) and the plain
version of its walk (K3-SAH) and of the grouped-direction walk (K5)
against the reference package's.

* The native builder (a verbatim copy of the reference's native/sah.cpp)
  on a triangle soup, and `build_rt_static_sah` on cornell and on the
  courtyard's GI pair list (`build_rt_static_gi`: the LOD under the
  100k-triangle budget, the coverage-kept masked pairs appended): every
  array equal.
* `refit_sah` of one topology (the reference's, carried across by
  weights.rt_static_sah_from_numpy) under the same instance matrices:
  node and leaf rows within 1e-6 relative (the transform's sums round in
  another order), the refs, axes and padding equal.
* `traverse_plain` on a reference SAH tree carried across by
  weights.bvh_sah_from_numpy, against the reference's Pallas kernel in
  its explicit-refs mode in interpret mode (the SAH walk has no XLA
  oracle), as tests/test_bvh_sah.py holds that kernel: `hit` equal on
  every ray, closest-hit t within 1e-5 and tri equal where both hit,
  any-hit `hit` equal.  Then an oracle that does not depend on the tree:
  the plain walk of the complete tree of the same triangles gives the
  same hit, t (bit-equal: the same leaf arithmetic on the same floats)
  and tri.
* The grouped-direction walk (one direction per 128 rays): bit-equal to
  the plain walk on the expanded directions, and `hit` equal to the
  reference's `traverse_pallas_gdir` in interpret mode, t within 1e-5
  where both hit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import bvh_sah as JS
from toyrenderer_tpu.ops import geometry as JG
from toyrenderer_tpu.ops.bvh_pallas import (
    traverse_pallas, traverse_pallas_gdir)
from toyrenderer_tpu.scene import load_scene as jax_load_scene

from test_torch_bvh import _jax_inst_world
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import bvh_cuda as TBC
from toyrenderer_tpu_torch.ops import bvh_sah as TS
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import (
    bvh_from_numpy, bvh_sah_from_numpy, rt_static_sah_from_numpy)

SAH_FIELDS = ('obj_v0', 'obj_e1', 'obj_e2', 'tri_inst', 'payload',
              'child_ref', 'node_axis', 'pair_keep', 'seg_inst')


def _soup(t=3000, seed=5):
    """Random triangles (one identity instance), every 13th invalid."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-15, 15, (t, 3)).astype(np.float32)
    v1 = c + rng.uniform(-0.7, 0.7, (t, 3)).astype(np.float32)
    v2 = c + rng.uniform(-0.7, 0.7, (t, 3)).astype(np.float32)
    valid = np.ones(t, bool)
    valid[::13] = False
    return c, v1, v2, valid


def _soup_static(v0, v1, v2, valid):
    """The reference's RtStaticSah over a soup, from the native builder
    (tests/test_bvh_sah.py builds it the same way from its numpy one)."""
    tlo = np.minimum(np.minimum(v0, v1), v2)[valid]
    thi = np.maximum(np.maximum(v0, v1), v2)[valid]
    child, axis, leaf, _ = JS._build_sah8_native(tlo, thi, JB.LEAF_TRIS, 16)
    ids = np.nonzero(valid)[0]
    flat = leaf.reshape(-1)
    ok = flat >= 0
    src = ids[np.where(ok, flat, 0)]
    obj = np.stack([v0, v1, v2], 1)
    obj_s = np.where(ok[:, None, None], obj[src], 0.0).astype(np.float32)
    pr = child.shape[0]
    depth = np.zeros(pr, np.int32)
    for i in range(pr):
        for k in range(8):
            if child[i, k] >= 0:
                depth[child[i, k]] = depth[i] + 1
    ranges = tuple((int(np.nonzero(depth == d)[0][0]),
                    int((depth == d).sum()))
                   for d in range(int(depth.max()) + 1))
    return JS.RtStaticSah(
        obj_v0=jnp.asarray(obj_s[:, 0]),
        obj_e1=jnp.asarray(obj_s[:, 1] - obj_s[:, 0]),
        obj_e2=jnp.asarray(obj_s[:, 2] - obj_s[:, 0]),
        tri_inst=jnp.zeros(len(src), jnp.int32),
        payload=jnp.asarray(np.where(ok, src, -1).astype(np.int32)),
        child_ref=jnp.asarray(child), node_axis=jnp.asarray(axis),
        depth_ranges=ranges)


def _sah_arrays(rts):
    out = {k: np.asarray(getattr(rts, k)) for k in SAH_FIELDS}
    out.update(seg_lens=np.asarray(rts.seg_lens, np.int64),
               depth_ranges=rts.depth_ranges, n_mask_pairs=rts.n_mask_pairs)
    return out


def _tree_arrays(jsah):
    return dict(node_rows=np.asarray(jsah.node_rows),
                leaf_rows=np.asarray(jsah.leaf_rows))


def test_native_builder_matches_reference():
    v0, v1, v2, valid = _soup()
    tlo = np.minimum(np.minimum(v0, v1), v2)[valid]
    thi = np.maximum(np.maximum(v0, v1), v2)[valid]
    want = JS._build_sah8_native(tlo, thi, JB.LEAF_TRIS, 16)
    got = TS._build_one(tlo, thi)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]


@pytest.fixture(scope="module")
def gi_trees():
    """Per scene: both packages' GI topologies over the reference's GI
    pair list (the courtyard's with its masked pairs)."""
    out = {}
    for name in ("cornell.gltf", "courtyard.glb"):
        jh = jax_load_scene(f"resources/{name}", use_cache=False)
        th = load_scene(f"resources/{name}", use_cache=False)
        mk_i, mk_m = JG.static_meshlet_pairs(jh, 'mask')
        kw = dict(mask_pair_inst=mk_i, mask_pair_meshlet=mk_m) \
            if len(mk_i) else {}
        filt = 'not_mask' if len(mk_i) else 'all'
        _, gpi, gpm, lod = JS.build_rt_static_gi(jh, filt, **kw)
        want = JS.build_rt_static_sah(jh, np.asarray(gpi), np.asarray(gpm),
                                      **kw)
        got, tpi, tpm, tlod = TS.build_rt_static_gi(th, filt, device='cpu',
                                                    **kw)
        out[name] = dict(jh=jh, want=want, got=got, lod=(lod, tlod),
                         pairs=((gpi, gpm), (tpi, tpm)))
    return out


@pytest.mark.parametrize("name", ["cornell.gltf", "courtyard.glb"])
def test_sah_static_topology_matches_reference(gi_trees, name):
    g = gi_trees[name]
    assert g['lod'][0] == g['lod'][1]
    for a, b in zip(*g['pairs']):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    want, got = g['want'], g['got']
    for k in SAH_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.seg_lens.tolist() == list(want.seg_lens)
    assert got.depth_ranges == want.depth_ranges
    assert got.n_mask_pairs == want.n_mask_pairs
    if name == "courtyard.glb":
        assert g['lod'][1] > 0 and got.n_mask_pairs > 0
        assert len(got.seg_lens) > 1          # the top tree is there


@pytest.mark.parametrize("name", ["cornell.gltf", "courtyard.glb"])
def test_refit_sah_matches_reference(gi_trees, name):
    g = gi_trees[name]
    iw = _jax_inst_world(g['jh'])
    want = JS.refit_sah(g['want'], jnp.asarray(iw))
    got = TS.refit_sah(rt_static_sah_from_numpy(_sah_arrays(g['want']),
                                                'cpu'),
                       torch.from_numpy(iw))
    assert got.depth == len(g['want'].depth_ranges)
    for k in ('node_rows', 'leaf_rows'):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=k)
    # refs, axis and padding are copies
    np.testing.assert_array_equal(got.node_rows[:, 48:].numpy(),
                                  np.asarray(want.node_rows)[:, 48:])


@pytest.fixture(scope="module")
def soup():
    """A soup's SAH tree (the reference's refit, carried across), the
    complete tree of the same triangles, and rays."""
    v0, v1, v2, valid = _soup()
    static = _soup_static(v0, v1, v2, valid)
    jsah = JS.refit_sah(static, jnp.eye(4)[None])
    jbvh = JB.build_bvh(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
                        jnp.asarray(valid))
    rng = np.random.default_rng(8)
    n = 1400
    o = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        jsah=jsah,
        sah=bvh_sah_from_numpy(dict(_tree_arrays(jsah),
                                    depth=len(static.depth_ranges)),
                               'cpu'),
        complete=bvh_from_numpy(dict(child_boxes=np.asarray(jbvh.child_boxes),
                                     leaf_rows=np.asarray(jbvh.leaf_rows),
                                     level_offset=jbvh.level_offset,
                                     num_levels=jbvh.num_levels), 'cpu'),
        o=o, d=d)


@pytest.mark.parametrize("any_hit", [False, True])
def test_sah_walk_matches_reference_kernel(soup, any_hit):
    o, d = soup['o'], soup['d']
    got = TBC.traverse_plain(soup['sah'], torch.from_numpy(o),
                             torch.from_numpy(d), 150.0, any_hit)
    want = traverse_pallas(soup['jsah'], jnp.asarray(o), jnp.asarray(d),
                           t_max=150.0, any_hit=any_hit, interpret=True)
    hit = got['hit'].numpy()
    np.testing.assert_array_equal(hit, np.asarray(want['hit']))
    assert 0.05 < hit.mean() < 0.95
    if not any_hit:
        np.testing.assert_allclose(got['t'].numpy()[hit],
                                   np.asarray(want['t'])[hit], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(got['tri'].numpy()[hit],
                                      np.asarray(want['tri'])[hit])
    np.testing.assert_array_equal(got['t'].numpy()[~hit],
                                  np.full((~hit).sum(), 150.0, np.float32))


def test_sah_closest_hit_equals_complete_tree(soup):
    """Closest-hit is a function of the triangles, not of the tree."""
    o, d = torch.from_numpy(soup['o']), torch.from_numpy(soup['d'])
    a = TBC.traverse_plain(soup['sah'], o, d, 150.0)
    b = TBC.traverse_plain(soup['complete'], o, d, 150.0)
    for k in ('hit', 't', 'tri'):
        assert torch.equal(a[k], b[k]), k
    # the adaptive tree visits fewer nodes here
    assert int(a['steps'].sum()) < int(b['steps'].sum())


@pytest.mark.parametrize("tree", ["sah", "complete"])
def test_grouped_directions_walk(soup, tree):
    rng = np.random.default_rng(11)
    n = 2048
    gd = rng.normal(size=(n // TBC.GROUP, 3)).astype(np.float32)
    gd /= np.linalg.norm(gd, axis=1, keepdims=True)
    gd[0, 1] = 0.0                       # an axis-parallel slab
    og = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    live = (rng.uniform(size=n) > 0.1).astype(np.float32)
    bvh = soup[tree]
    o, g, lv = (torch.from_numpy(x) for x in (og, gd, live))
    got = TBC.traverse_plain(bvh, o, None, 150.0, live=lv, group_dirs=g)
    expanded = TBC.traverse_plain(bvh, o, g.repeat_interleave(128, 0), 150.0,
                                  live=lv)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(got[k], expanded[k]), k
    if tree == "sah":
        want = traverse_pallas_gdir(soup['jsah'], jnp.asarray(og),
                                    jnp.asarray(gd), t_max=150.0,
                                    packet=1024, live=jnp.asarray(live),
                                    interpret=True)
        hit = got['hit'].numpy()
        np.testing.assert_array_equal(hit, np.asarray(want['hit']))
        assert 0.05 < hit[live > 0].mean() < 0.95
        np.testing.assert_allclose(got['t'].numpy()[hit],
                                   np.asarray(want['t'])[hit], rtol=0,
                                   atol=1e-5)


def test_traverse_auto_routes_sah_and_groups(soup):
    """CPU tensors run the plain version on either tree; group_dirs
    routes to the grouped walk on whole groups of 128 rays and is
    ignored otherwise, as in the reference."""
    rng = np.random.default_rng(3)
    o = torch.from_numpy(rng.uniform(-20, 20, (384, 3)).astype(np.float32))
    g = torch.nn.functional.normalize(torch.randn(3, 3), dim=1)
    before = dict(TBC.launches_by_kernel)
    got = TBC.traverse_auto(soup['sah'], o, torch.zeros(384, 3), 150.0,
                            group_dirs=g)
    want = TBC.traverse_plain(soup['sah'], o, g.repeat_interleave(128, 0),
                              150.0)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(got[k], want[k]), k
    d = torch.nn.functional.normalize(torch.randn(300, 3), dim=1)
    got = TBC.traverse_auto(soup['sah'], o[:300], d, 150.0,
                            group_dirs=g[:2])
    want = TBC.traverse_plain(soup['sah'], o[:300], d, 150.0)
    assert torch.equal(got['t'], want['t'])
    assert TBC.launches_by_kernel == before
    with pytest.raises(ValueError, match="grouped directions"):
        TBC.traverse_plain(soup['sah'], o, None, 150.0, group_dirs=g[:2])
