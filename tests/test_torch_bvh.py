"""The port's RT tree (static topology, refit) and its traversal's plain
version against the reference package's.

* `build_rt_static`, on cornell and on a courtyard subset (the RT pair
  list of the instances near the camera, with their alpha-masked pairs
  coverage-classified), from each package's own scene loader: order,
  payload, instance ids, coverage keep and object-space vertices equal.
* `refit_bvh` of one static topology (the reference's, carried across by
  weights.rt_static_from_numpy) under the same instance matrices: node
  and leaf rows within 1e-6 relative (the transform's sums round in
  another order), the row layout and level offsets equal.
* `traverse_plain` on a reference tree carried across by
  weights.bvh_from_numpy, against the reference's Pallas packet kernel
  in interpret mode and its XLA lockstep traversal with a step budget
  no ray reaches (max_steps 4096), closest-hit and any-hit.  A packet
  visits a leaf when any of its rays wants it, a ray of the port's walk
  only when its own slab test passes, so a ray grazing a box edge may
  hit in one and not the other: `hit` must agree on >= 99.99% of the
  live rays (the others are counted).  Closest-hit: t within 1e-5 where
  both hit, tri equal where that t is unique.  Any-hit rays stop at the
  first leaf with a hit, whose place in the walk differs between a
  packet and a ray, so only `hit` is compared there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import geometry as JG
from toyrenderer_tpu.ops.bvh_pallas import traverse_pallas
from toyrenderer_tpu.scene import load_scene as jax_load_scene

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import bvh as TB
from toyrenderer_tpu_torch.ops import bvh_cuda as TBC
from toyrenderer_tpu_torch.ops import geometry as TG
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.scenebuild import _world_matrices_host
from toyrenderer_tpu_torch.weights import bvh_from_numpy, rt_static_from_numpy

STATIC_FIELDS = ('obj_v0', 'obj_e1', 'obj_e2', 'tri_inst', 'payload',
                 'pair_keep')


def _near(host, pi, radius):
    """Pairs of instances whose bounding-sphere centre lies within
    `radius` of the scene's camera."""
    world = _world_matrices_host(host.node_parent, host.node_translation,
                                 host.node_rotation, host.node_scale)
    iw = world[np.asarray(host.inst_node)]
    centre = (np.einsum('nij,nj->ni', iw[:, :3, :3],
                        host.prim_center[host.inst_prim]) + iw[:, :3, 3])
    near = np.linalg.norm(centre - host.camera_position, axis=1) < radius
    return near[np.asarray(pi)]


@pytest.fixture(scope="module")
def scenes():
    """Per scene: the two packages' hosts and the RT pair lists (the
    courtyard's cut to the instances within 10 units of the camera)."""
    out = {}
    for name, radius in (("cornell.gltf", None), ("courtyard.glb", 10.0)):
        jh = jax_load_scene(f"resources/{name}", use_cache=False)
        th = load_scene(f"resources/{name}", use_cache=False)
        mk_i, mk_m = JG.static_meshlet_pairs(jh, 'mask')
        pi, pm, lod = JG.rt_lod_pairs(
            jh, 'not_mask' if len(mk_i) else 'all')
        if radius is not None:
            keep, mkeep = _near(jh, pi, radius), _near(jh, mk_i, radius)
            pi, pm, mk_i, mk_m = pi[keep], pm[keep], mk_i[mkeep], mk_m[mkeep]
        out[name] = dict(jh=jh, th=th, pi=pi, pm=pm, mk_i=mk_i, mk_m=mk_m,
                         lod=lod)
    return out


def _jax_static(s):
    kw = {}
    if len(s['mk_i']):
        kw = dict(mask_pair_inst=s['mk_i'], mask_pair_meshlet=s['mk_m'])
    return JB.build_rt_static(s['jh'], s['pi'], s['pm'], **kw)


def _static_arrays(rts):
    out = {k: np.asarray(getattr(rts, k)) for k in STATIC_FIELDS}
    out.update(num_levels=rts.num_levels, n_real_groups=rts.n_real_groups,
               n_mask_pairs=rts.n_mask_pairs)
    return out


def _jax_inst_world(jh):
    """Rest-pose instance matrices, from the reference package's host
    world matrices."""
    from toyrenderer_tpu.scene.scenebuild import (
        _world_matrices_host as jax_world)
    world = jax_world(jh.node_parent, jh.node_translation, jh.node_rotation,
                      jh.node_scale)
    return world[np.asarray(jh.inst_node)].astype(np.float32)


@pytest.mark.parametrize("name", ["cornell.gltf", "courtyard.glb"])
def test_rt_lod_pairs_and_static_topology_match(scenes, name):
    s = scenes[name]
    mask = len(s['mk_i']) > 0
    tpi, tpm, tlod = TG.rt_lod_pairs(s['th'], 'not_mask' if mask else 'all')
    jpi, jpm, jlod = JG.rt_lod_pairs(s['jh'], 'not_mask' if mask else 'all')
    assert tlod == jlod == s['lod'] == 0
    np.testing.assert_array_equal(tpi, jpi)
    np.testing.assert_array_equal(tpm, jpm)

    want = _jax_static(s)
    kw = dict(mask_pair_inst=s['mk_i'], mask_pair_meshlet=s['mk_m']) \
        if mask else {}
    got = TB.build_rt_static(s['th'], s['pi'], s['pm'], device='cpu', **kw)
    for k in STATIC_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert ((got.num_levels, got.n_real_groups, got.n_mask_pairs)
            == (want.num_levels, want.n_real_groups, want.n_mask_pairs))
    if mask:
        # the coverage classification drops some masked triangles
        keep = got.pair_keep.numpy()
        assert 0 < (~keep).sum() < keep.size
        assert got.n_mask_pairs == len(s['mk_i'])


def test_median8_order_and_level_sizes_match():
    rng = np.random.default_rng(0)
    cent = rng.uniform(-5, 5, size=(3001, 3)).astype(np.float32)
    valid = rng.uniform(size=3001) > 0.1
    np.testing.assert_array_equal(TB._median8_order(cent, valid),
                                  JB._median8_order(cent, valid))
    for n_tris, groups in ((1, 1), (97, 9), (5000, 400), (533_376, 36_160)):
        lv = TB.num_levels_for(n_tris)
        assert lv == JB.num_levels_for(n_tris)
        assert TB._level_sizes(lv, groups) == JB._level_sizes(lv, groups)


@pytest.fixture(scope="module")
def trees(scenes):
    """Per scene: the reference's static topology and its refit under the
    rest pose, and the port's refit of the same topology."""
    out = {}
    for name, s in scenes.items():
        rts = _jax_static(s)
        iw = _jax_inst_world(s['jh'])
        jbvh = JB.refit_bvh(rts, jnp.asarray(iw))
        tbvh = TB.refit_bvh(rt_static_from_numpy(_static_arrays(rts), 'cpu'),
                            torch.from_numpy(iw))
        out[name] = dict(rts=rts, iw=iw, jbvh=jbvh, tbvh=tbvh)
    return out


@pytest.mark.parametrize("name", ["cornell.gltf", "courtyard.glb"])
def test_refit_matches_reference(trees, name):
    tr = trees[name]
    jb, tb = tr['jbvh'], tr['tbvh']
    assert tb.level_offset == tuple(jb.level_offset)
    assert tb.num_levels == jb.num_levels
    for k in ('child_boxes', 'leaf_rows'):
        got, want = getattr(tb, k).numpy(), np.asarray(getattr(jb, k))
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=k)


def _rays(tbvh, n, seed):
    """Rays from points near the tree's triangles: half toward a sun-like
    direction (the shadow rays' case, coherent), half in random
    directions; about 10% dead."""
    rng = np.random.default_rng(seed)
    rows = tbvh.leaf_rows.numpy().reshape(-1, 10, 12).transpose(0, 2, 1)
    rows = rows.reshape(-1, 10)
    rows = rows[rows[:, 9] >= 0]
    pick = rows[rng.integers(0, len(rows), n)]
    bary = rng.dirichlet([1.0, 1.0, 1.0], size=n).astype(np.float32)
    surf = (pick[:, 0:3] + bary[:, 1:2] * pick[:, 3:6]
            + bary[:, 2:3] * pick[:, 6:9])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    sun = np.asarray([0.35, 0.85, 0.4], np.float32)
    d[: n // 2] = sun + 0.02 * d[: n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (surf + 0.05 * d + rng.normal(scale=0.02, size=(n, 3))).astype(
        np.float32)
    live = (rng.uniform(size=n) > 0.1).astype(np.float32)
    return o, d.astype(np.float32), live


@pytest.mark.parametrize("name,any_hit", [
    ("cornell.gltf", False), ("cornell.gltf", True),
    ("courtyard.glb", False), ("courtyard.glb", True)])
def test_traverse_plain_matches_reference(trees, name, any_hit):
    tr = trees[name]
    jb = tr['jbvh']
    tb = bvh_from_numpy(dict(child_boxes=np.asarray(jb.child_boxes),
                             leaf_rows=np.asarray(jb.leaf_rows),
                             level_offset=jb.level_offset,
                             num_levels=jb.num_levels), 'cpu')
    n = 2048
    o, d, live = _rays(tb, n, seed=len(name) + any_hit)
    t_max = 1e4
    got = TBC.traverse_plain(tb, torch.from_numpy(o), torch.from_numpy(d),
                             t_max, any_hit, torch.from_numpy(live))
    assert not got['hit'].numpy()[live == 0].any()
    assert (got['steps'].numpy()[live == 0] == 0).all()
    packet = traverse_pallas(jb, jnp.asarray(o), jnp.asarray(d), t_max,
                             any_hit=any_hit, live=jnp.asarray(live),
                             interpret=True)
    lockstep = JB.traverse(jb, jnp.asarray(o), jnp.asarray(d),
                           jnp.where(jnp.asarray(live) > 0, t_max, 0.0),
                           max_steps=4096, any_hit=any_hit)
    assert int(np.asarray(lockstep['steps']).max()) < 4096
    lv = live > 0
    hit = got['hit'].numpy()
    assert 0.05 < hit[lv].mean() < 0.95            # both outcomes occur
    for ref in (packet, lockstep):
        rh = np.asarray(ref['hit'])
        differ = int((rh != hit)[lv].sum())
        assert differ <= int(1e-4 * lv.sum()), differ
        if any_hit:
            continue
        both = rh & hit
        np.testing.assert_allclose(got['t'].numpy()[both],
                                   np.asarray(ref['t'])[both], rtol=0,
                                   atol=1e-5)
        ts = got['t'].numpy()
        unique = both & (np.unique(ts, return_counts=True)[1][
            np.searchsorted(np.unique(ts), ts)] == 1)
        np.testing.assert_array_equal(got['tri'].numpy()[unique],
                                      np.asarray(ref['tri'])[unique])
    miss = ~hit
    np.testing.assert_array_equal(got['t'].numpy()[miss],
                                  np.full(miss.sum(), t_max, np.float32))


def test_traverse_auto_routes():
    """CPU tensors run the plain version (no launch counted) on every
    route; an sp_mesh that is not a (Mesh, axis) pair raises."""
    rng = np.random.default_rng(1)
    v0 = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
    tris = np.stack([v0, v0 + rng.uniform(-.5, .5, (200, 3)),
                     v0 + rng.uniform(-.5, .5, (200, 3))], 1).astype(
                         np.float32)
    jb = JB.build_bvh(jnp.asarray(tris[:, 0]), jnp.asarray(tris[:, 1]),
                      jnp.asarray(tris[:, 2]), jnp.ones(200, bool))
    tb = bvh_from_numpy(dict(child_boxes=np.asarray(jb.child_boxes),
                             leaf_rows=np.asarray(jb.leaf_rows),
                             level_offset=jb.level_offset,
                             num_levels=jb.num_levels), 'cpu')
    o = torch.from_numpy(rng.uniform(-4, 4, (300, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.randn(300, 3), dim=1)
    before = dict(TBC.launches_by_kernel)
    res = TBC.traverse_auto(tb, o, d, 50.0, max_steps=1)
    assert TBC.launches_by_kernel == before
    want = TBC.traverse_plain(tb, o, d, 50.0)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(res[k], want[k]), k
    assert int(res['steps'].max()) > 1          # max_steps bounds nothing
    # group_dirs on a ray count that is not whole groups of 128: the
    # per-ray directions are traced, as in the reference
    res = TBC.traverse_auto(tb, o, d, 50.0, group_dirs=d[:2])
    assert torch.equal(res['t'], want['t'])
    # the pair route (K6's plain fold on the CPU) finds the same hits
    res = TBC.traverse_auto(tb, o, d, 50.0, pairs=True)
    assert TBC.launches_by_kernel == before
    assert torch.equal(res['hit'], want['hit'])
    # the chunk route (K8's plain fold on the CPU): the same hits, the
    # same Moller-Trumbore arithmetic
    res = TBC.traverse_auto(tb, o, d, 50.0, chunked=True)
    assert TBC.launches_by_kernel == before
    assert torch.equal(res['hit'], want['hit'])
    assert torch.equal(res['t'], want['t'])
    # sp_mesh is a (Mesh, axis) pair (tests/test_torch_parallel.py
    # traces through it); anything else raises
    with pytest.raises(TypeError, match="sp_mesh"):
        TBC.traverse_auto(tb, o, d, 50.0, sp_mesh=object())
