"""The port's multi-device raster and rays (toyrenderer_tpu_torch/
parallel/) against the reference package's (toyrenderer_tpu/parallel/)
and against the port's own single-device calls, on meshes of CPU
devices (the reference on the 8 virtual CPU devices tests/conftest.py
sets up, its Pallas fill in interpret mode, as tests/test_parallel.py
runs it).

* `raster_frame_sp` on a triangle soup made from a seed (the setup the
  reference's, handed over as numpy, the resolve records random past
  the edge slots): the port on Mesh([cpu] * 8) against the reference's
  on 8 devices -- ids on >= 99.9% of the pixels, depth (rtol 1e-5,
  atol 1e-6) where the ids agree, interpolants within 1e-3 on >= 99.9%
  of the covered pixels where they agree (tests/test_parallel.py:104-
  115), `binned_pairs` and `big_tris` equal; then the port's mesh of 1
  against its mesh of 8 and against the single fill.
* The queue-3 departures: the reference's raster_frame_sp has no
  peel_depth; the port's peeled second layer on a mesh equals the
  single fill's; the port's bands drop no pair where the reference's
  budget, max(cap // n, 256), would (the count it would drop is
  asserted > 0 and printed).
* `traverse_auto(sp_mesh=)` bit-equal to the unsharded call on every
  route -- the complete tree (K3's plain walk), the SAH tree, grouped
  directions, the pair route, the chunk route -- with N not a multiple
  of the mesh and grouped directions with N not a multiple of mesh x
  128; and, on the complete tree, against the reference's
  `_traverse_sharded` on 8 devices to tests/test_torch_bvh.py's bounds.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import raster as JR
from toyrenderer_tpu.ops.bvh_pallas import traverse_auto as jax_traverse
from toyrenderer_tpu.parallel import sp_raster as JSP

from test_torch_bvh import _rays
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine.capacity import band_config
from toyrenderer_tpu_torch.ops import bvh as TB
from toyrenderer_tpu_torch.ops import bvh_cuda as TBC
from toyrenderer_tpu_torch.ops import bvh_sah as TS
from toyrenderer_tpu_torch.ops import raster as TR
from toyrenderer_tpu_torch.ops import raster_cuda as TRC
from toyrenderer_tpu_torch.ops.gbuffer import RESOLVE_REC
from toyrenderer_tpu_torch.parallel import Mesh, raster_frame_sp
from toyrenderer_tpu_torch.parallel.sp_raster import shard_bands
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import bvh_from_numpy

W, H = 448, 256                    # tiles_y 16: meshes of 8, 4 and 2 fit
CPU = torch.device('cpu')
CFG = dict(width=W, height=H, max_tris_per_tile=512, max_big_tris=128,
           compact_frac=1.0, short_frac=0.5, rest_frac=0.5)


def _soup(n, seed):
    """n clip-space triangles in front of the eye: small ones spread over
    the screen, denser toward its top (so the bands' pair counts differ),
    a twentieth large, each a random rotation of a triangle of random
    aspect (no slivers), at random depths with gentle slopes."""
    rng = np.random.default_rng(seed)
    centre = np.stack([rng.uniform(-1.1, 1.1, n),
                       1.1 - 2.2 * rng.beta(1.0, 3.0, n)], -1)[:, None]
    size = np.where(rng.uniform(size=(n, 1, 1)) < 0.05, 0.5, 0.05)
    ang = rng.uniform(0, 2 * np.pi, (n, 1)) + np.asarray([0, 2.1, 4.2])
    aspect = rng.uniform(0.5, 2.0, (n, 1))
    xy = centre + size * np.stack([np.cos(ang) * aspect,
                                   np.sin(ang) / aspect], -1)
    w = rng.uniform(0.5, 4.0, (n, 1, 1)) * np.ones((n, 3, 1))
    z = rng.uniform(0.1, 0.9, (n, 1, 1)) + rng.uniform(-0.02, 0.02,
                                                       (n, 3, 1))
    clip = np.concatenate([xy * w, z * w, w], -1).astype(np.float32)
    return dict(clip=clip, tri_valid=np.ones(n, bool),
                double_sided=rng.uniform(size=n) < 0.5,
                vtx_ids=np.zeros((n, 3), np.int32),
                inst_id=np.zeros(n, np.int32), mat_id=np.zeros(n, np.int32),
                pair_meshlet=np.zeros(n, np.int32),
                pair_inst=np.zeros(n, np.int32))


@pytest.fixture(scope="module")
def soup():
    """The reference's setup of the soup (numpy) and resolve records:
    its edges and inverse scales in slots 0:12, the rest random."""
    geo = _soup(1000, seed=11)
    cfg = JR.RasterConfig(**CFG)
    js = JR.setup_triangles({k: jnp.asarray(v) for k, v in geo.items()},
                            cfg)
    setup = {k: np.asarray(v) for k, v in js.items()}
    rng = np.random.default_rng(12)
    t = len(geo['clip'])
    rec = rng.uniform(-1.0, 1.0, (t, RESOLVE_REC)).astype(np.float32)
    rec[:, 0:9] = setup['edges'].reshape(t, 9)
    rec[:, 9:12] = setup['inv_s']
    tsetup = {k: torch.from_numpy(v.copy()) for k, v in setup.items()}
    return dict(js=js, jrec=jnp.asarray(rec), setup=tsetup,
                rec=torch.from_numpy(rec), cfg=TR.RasterConfig(**CFG),
                jcfg=cfg)


@pytest.fixture(scope="module")
def port_sp8(soup):
    return raster_frame_sp(soup['setup'], soup['rec'], soup['cfg'],
                           Mesh([CPU] * 8, ('sp',)))


def _agree(a, b):
    """(ids equal, depth, interpolant) checks of tests/test_parallel.py;
    returns the id agreement share."""
    z1, id1, r1 = (np.asarray(x) for x in a[:3])
    z2, id2, r2 = (np.asarray(x) for x in b[:3])
    agree = id1 == id2
    assert agree.mean() > 0.999, agree.mean()
    assert np.allclose(z1[agree], z2[agree], rtol=1e-5, atol=1e-6)
    m = agree & (id1 >= 0)
    ok = np.isclose(r1[:, m], r2[:, m], rtol=1e-3, atol=1e-3)
    assert ok.mean() > 0.999, ok.mean()
    return agree.mean()


def test_sp_raster_matches_reference(soup, port_sp8):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    want = JSP.raster_frame_sp(soup['js'], soup['jrec'], soup['jcfg'], mesh,
                               interpret=True)
    got = port_sp8
    assert (np.asarray(got[1]) >= 0).mean() > 0.3
    _agree(got, want)
    for k in ('binned_pairs', 'big_tris', 'tris'):
        assert int(got[3][k]) == int(want[3][k]), k
    assert int(got[3]['dropped']) == 0


def test_sp_raster_one_band_and_single_fill(soup, port_sp8):
    """A mesh of 1 (the mesh branch, one band) and the single fill give
    what the mesh of 8 gives; the mesh of 1 is the single fill exactly."""
    s, rec, cfg = soup['setup'], soup['rec'], soup['cfg']
    one = raster_frame_sp(s, rec, cfg, Mesh([CPU], ('sp',)))
    single = TRC.fill_resolve_stream(s, rec, TRC.bin_pairs_with_budget(
        s, cfg), cfg)
    for a, b in zip(one[:3], single):
        assert torch.equal(a, b)
    _agree(one, port_sp8)
    assert int(one[3]['binned_pairs']) <= int(port_sp8[3]['binned_pairs'])


def test_one_band_is_the_single_fill_at_any_height():
    """At a height that is not a whole number of tile rows (250: the
    padded grid is 256 rows), a mesh of 1 is still the single fill bit
    for bit: its one band is the frame (capacity.band_config)."""
    cfg = TR.RasterConfig(**dict(CFG, height=250))
    geo = {k: torch.from_numpy(np.asarray(v)) for k, v in
           _soup(400, seed=5).items()}
    s = TR.setup_triangles(geo, cfg)
    rng = np.random.default_rng(6)
    t = s['valid'].shape[0]
    rec = torch.from_numpy(rng.uniform(-1, 1, (t, RESOLVE_REC)).astype(
        np.float32))
    rec[:, 0:9] = s['edges'].reshape(t, 9)
    rec[:, 9:12] = s['inv_s']
    one = raster_frame_sp(s, rec, cfg, Mesh([CPU], ('sp',)))
    single = TRC.fill_resolve_stream(s, rec, TRC.bin_pairs_with_budget(
        s, cfg), cfg)
    assert (single[1] >= 0).float().mean() > 0.3
    for a, b in zip(one[:3], single):
        assert torch.equal(a, b)
    assert band_config(cfg, 1) is cfg


@pytest.mark.parametrize("n", [2, 4])
def test_sp_raster_meshes_agree(soup, port_sp8, n):
    got = raster_frame_sp(soup['setup'], soup['rec'], soup['cfg'],
                          Mesh([CPU] * n, ('sp',)))
    _agree(got, port_sp8)
    assert int(got[3]['dropped']) == 0


def test_reference_sp_raster_has_no_peel_depth():
    """ROADMAP queue 3: the reference's sharded raster cannot peel (its
    frame's masked and OIT layers on a mesh re-render layer 0)."""
    params = inspect.signature(JSP.raster_frame_sp).parameters
    assert 'peel_depth' not in params
    from toyrenderer_tpu_torch.parallel import sp_raster
    assert 'peel_depth' in inspect.signature(
        sp_raster.raster_frame_sp).parameters


def test_sp_raster_peels_every_band(soup):
    """The second layer on a mesh of 8, peeled behind the mesh's own
    first layer, is the single fill's second layer."""
    s, rec, cfg = soup['setup'], soup['rec'], soup['cfg']
    mesh = Mesh([CPU] * 8, ('sp',))
    bins = TRC.bin_pairs_with_budget(s, cfg)
    z1, _, _ = TRC.fill_resolve_stream(s, rec, bins, cfg)
    want = TRC.fill_resolve_stream(s, rec, bins, cfg, peel_depth=z1)
    first = raster_frame_sp(s, rec, cfg, mesh)
    got = raster_frame_sp(s, rec, cfg, mesh, peel_depth=first[0])
    assert (want[1] >= 0).float().mean() > 0.05
    assert not torch.equal(want[1], first[1])
    _agree(got, want)


def test_band_budget_drops_nothing_the_single_fill_keeps(soup):
    """ROADMAP queue 3: a budget that holds the frame's pairs; the bands
    under the port's budget (the frame's, capacity.band_config) drop
    none, under the reference's max(cap // n, 256) some band drops."""
    s, rec = soup['setup'], soup['rec']
    probe = TR.RasterConfig(**CFG)
    pairs = int(TRC.bin_pairs_stream(s, probe)['counts'].sum())
    cap = pairs + 16
    cfg = TR.RasterConfig(**CFG, pair_capacity=cap)
    n = 8
    single = TRC.bin_pairs_with_budget(s, cfg)
    assert int(single['drop']['drop_pair_budget']) == 0
    bands = shard_bands(s, rec, cfg, Mesh([CPU] * n, ('sp',)))
    per_band = [int(b.bins['counts'].sum()) for b in bands]
    assert max(per_band) > max(cap // n, 256), per_band
    assert all(b.cfg.pair_capacity == cap for b in bands)
    assert sum(int(b.bins['drop']['drop_pair_budget']) for b in bands) == 0
    ref_cfg = band_config(cfg, n)
    import dataclasses
    ref_cfg = dataclasses.replace(ref_cfg, pair_capacity=max(cap // n, 256))
    ref_drop = sum(int(TRC.bin_pairs_with_budget(b.setup, ref_cfg)[
        'drop']['drop_pair_budget']) for b in bands)
    print(f"[queue 3] bands' pairs {per_band}, budget {cap}: the "
          f"reference's per-band budget {max(cap // n, 256)} drops "
          f"{ref_drop} pairs, the port's 0")
    assert ref_drop > 0
    got = raster_frame_sp(s, rec, cfg, Mesh([CPU] * n, ('sp',)),
                          bands=bands)
    _agree(got, TRC.fill_resolve_stream(s, rec, single, cfg))


def test_band_config_validates_the_mesh():
    with pytest.raises(ValueError, match="tiles_y"):
        band_config(TR.RasterConfig(**CFG), 3)


# -- rays ------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """The port's complete and SAH trees of Cornell (rest pose), and the
    reference's complete tree of the same topology."""
    from test_torch_bvh import _jax_inst_world, _static_arrays
    from toyrenderer_tpu.ops import geometry as JG
    from toyrenderer_tpu.scene import load_scene as jax_load_scene
    from toyrenderer_tpu_torch.weights import rt_static_from_numpy
    jh = jax_load_scene("resources/cornell.gltf", use_cache=False)
    th = load_scene("resources/cornell.gltf", use_cache=False)
    pi, pm = JG.static_meshlet_pairs(jh, 'all')
    rts = JB.build_rt_static(jh, pi, pm)
    iw = _jax_inst_world(jh)
    jbvh = JB.refit_bvh(rts, jnp.asarray(iw))
    tbvh = TB.refit_bvh(rt_static_from_numpy(_static_arrays(rts), 'cpu'),
                        torch.from_numpy(iw))
    sah = TS.refit_sah(TS.build_rt_static_sah(th, pi, pm, device='cpu'),
                       torch.from_numpy(iw))
    return dict(jbvh=jbvh, tbvh=tbvh, sah=sah)


ROUTES = {
    'complete': dict(),
    'sah': dict(tree='sah'),
    'grouped': dict(grouped=True),
    'grouped-sah': dict(tree='sah', grouped=True),
    'pairs': dict(pairs=True),
    'chunks': dict(chunked=True),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("any_hit", [False, True])
def test_sharded_rays_bit_equal(trees, route, any_hit):
    r = dict(ROUTES[route])
    tree = trees['sah'] if r.pop('tree', None) == 'sah' else trees['tbvh']
    grouped = r.pop('grouped', False)
    n = 128 * 13 if grouped else 1003       # neither a multiple of 8 x 128
    o, d, live = (torch.from_numpy(x) for x in _rays(
        trees['tbvh'], n, seed=5 + any_hit))
    if grouped:
        g = d.reshape(-1, 128, 3)[:, 0].contiguous()
        d = g.repeat_interleave(128, 0).contiguous()
        r['group_dirs'] = g
    want = TBC.traverse_auto(tree, o, d, 1e4, any_hit=any_hit, live=live,
                             **r)
    for nsp in (8, 3):
        got = TBC.traverse_auto(tree, o, d, 1e4, any_hit=any_hit, live=live,
                                sp_mesh=(Mesh([CPU] * nsp, ('sp',)), 'sp'),
                                **r)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (route, nsp, k)
    assert 0.02 < float(want['hit'][live > 0].float().mean()) < 0.98


@pytest.mark.parametrize("any_hit", [False, True])
def test_sharded_rays_match_reference(trees, any_hit):
    """The port's sharded complete-tree walk against the reference's
    _traverse_sharded on 8 devices (its XLA lockstep walk on the CPU):
    hit on >= 99.99% of the live rays, closest-hit t within 1e-5 where
    both hit (tests/test_torch_bvh.py's bounds)."""
    n = 2003
    o, d, live = _rays(trees['tbvh'], n, seed=9 + any_hit)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    ref = jax_traverse(trees['jbvh'], jnp.asarray(o), jnp.asarray(d), 1e4,
                       any_hit=any_hit, max_steps=4096,
                       live=jnp.asarray(live), sp_mesh=(mesh, 'sp'))
    tb = bvh_from_numpy(dict(child_boxes=np.asarray(trees['jbvh']
                                                    .child_boxes),
                             leaf_rows=np.asarray(trees['jbvh'].leaf_rows),
                             level_offset=trees['jbvh'].level_offset,
                             num_levels=trees['jbvh'].num_levels), 'cpu')
    got = TBC.traverse_auto(tb, torch.from_numpy(o), torch.from_numpy(d),
                            1e4, any_hit=any_hit,
                            live=torch.from_numpy(live),
                            sp_mesh=(Mesh([CPU] * 8, ('sp',)), 'sp'))
    lv = live > 0
    hit, rh = got['hit'].numpy(), np.asarray(ref['hit'])
    assert int((hit != rh)[lv].sum()) <= int(1e-4 * lv.sum())
    if not any_hit:
        both = hit & rh
        np.testing.assert_allclose(got['t'].numpy()[both],
                                   np.asarray(ref['t'])[both], rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def dense_tree():
    """The port's complete tree of the courtyard's opaque pairs within 6
    units of the camera (38,176 triangles): enough chunks that 3,000
    rays' pair list overflows its capacity."""
    from test_torch_bvh import _near
    from toyrenderer_tpu_torch.ops import geometry as TG
    from toyrenderer_tpu_torch.scene.scenebuild import _world_matrices_host
    h = load_scene("resources/courtyard.glb")
    pi, pm = TG.static_meshlet_pairs(h, 'not_mask')
    keep = _near(h, pi, 6.0)
    rts = TB.build_rt_static(h, pi[keep], pm[keep], device='cpu')
    world = _world_matrices_host(h.node_parent, h.node_translation,
                                 h.node_rotation, h.node_scale)
    return TB.refit_bvh(rts, torch.from_numpy(
        world[np.asarray(h.inst_node)].astype(np.float32)))


@pytest.mark.parametrize("route", ["pairs", "chunked"])
def test_sharded_pair_list_overflows_as_unsharded(dense_tree, route):
    """The pair and chunk routes cap their pair list for the whole call;
    each slice continues the list of the slices before it, so the same
    blocks overflow to the per-ray fallback and the result is bit-equal
    to the unsharded call.  Capping each slice's list on its own, as the
    reference's shard_map does (ROADMAP queue 3), sends other blocks to
    the fallback, whose t differs from the fold's in the last bits."""
    from toyrenderer_tpu_torch.ops import rt_chunks, rt_pairs
    tree = dense_tree
    o, d, live = (torch.from_numpy(x) for x in _rays(tree, 3000, seed=3))
    fn = (rt_pairs.traverse_pairs if route == "pairs"
          else rt_chunks.traverse_chunks)
    st = {}
    want = fn(tree, o, d, 1e4, live=live, stats=st)
    over = int(st['overflow'].sum())
    assert 0 < over < st['overflow'].numel(), over
    for nsp in (4, 3):
        got = TBC.traverse_auto(tree, o, d, 1e4, live=live,
                                sp_mesh=(Mesh([CPU] * nsp, ('sp',)), 'sp'),
                                **{route: True})
        for k in want:
            assert torch.equal(got[k], want[k]), (nsp, k)
    # each quarter capped on its own: other blocks overflow
    own_over = 0
    for i in range(4):
        sl = slice(i * 768, (i + 1) * 768)
        st_i = {}
        fn(tree, o[sl], d[sl], 1e4, live=live[sl], stats=st_i)
        own_over += int(st_i['overflow'].sum())
    print(f"[queue 3] {route}: {over} of {st['overflow'].numel()} blocks "
          f"overflow in the whole call, {own_over} with a cap per slice")
    assert own_over != over


def test_mesh_axes():
    mesh = Mesh(np.asarray([[CPU] * 2] * 4, object), ('dp', 'sp'))
    assert mesh.shape == {'dp': 4, 'sp': 2}
    assert mesh.sub('sp', dp=3).shape == {'sp': 2}
    assert mesh.along('dp', sp=1) == [CPU] * 4
    with pytest.raises(ValueError):
        Mesh([CPU] * 4, ('dp', 'sp'))
