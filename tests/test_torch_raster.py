"""The port's math, geometry and raster front end against the reference
package, on the courtyard scene at 384x216.

Host-side numpy code (View, jitter, frustum, sun matrix, frame inputs)
is the same arithmetic in both packages and is compared exactly.  Tensor
math is compared to rtol 1e-5 / 1e-6: XLA on the CPU fuses some
multiply-adds the port rounds twice, moving results by an ulp.  Binning
is integer work and is compared exactly, on the SAME setup (the
reference's, handed over as numpy) so that ulp-level setup differences
cannot move a triangle across a tile edge.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine.frame import (
    default_frame_inputs as jax_frame_inputs)
from toyrenderer_tpu.mathlib import transforms as JT
from toyrenderer_tpu.mathlib.halton import halton_jitter_sequence as jhalton
from toyrenderer_tpu.ops import gbuffer as JGB
from toyrenderer_tpu.ops import geometry as JG
from toyrenderer_tpu.ops import raster as JR
from toyrenderer_tpu.ops.raster_pallas import pack_tri_records as jpack
from toyrenderer_tpu.ops.shadowmap import sun_ortho_matrix as jsun
from toyrenderer_tpu.scene import load_scene as jax_load_scene

from toyrenderer_tpu_torch.engine import View, default_frame_inputs
from toyrenderer_tpu_torch.mathlib import transforms as TT
from toyrenderer_tpu_torch.mathlib.halton import halton_jitter_sequence
from toyrenderer_tpu_torch.ops import gbuffer as TGB
from toyrenderer_tpu_torch.ops import geometry as TG
from toyrenderer_tpu_torch.ops import raster as TR
from toyrenderer_tpu_torch.ops.raster_cuda import pack_tri_records
from toyrenderer_tpu_torch.ops.shadowmap import sun_ortho_matrix
from toyrenderer_tpu_torch.weights import (
    frame_inputs_from_numpy, scene_from_numpy)

W, H = 384, 216
CFG = dict(width=W, height=H, max_tris_per_tile=512, max_big_tris=512,
           bin_slots_y=8, bin_slots_x=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test lane runs several workers on a few
    cores, and the plain fills' many small ops would otherwise wait at
    every OpenMP barrier for descheduled threads (tens of times
    slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def scene_arrays(js) -> dict:
    """A reference DeviceScene's fields as numpy, for scene_from_numpy."""
    out = {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__
           if isinstance(getattr(js, f), jnp.ndarray)}
    out.update(node_depth=js.node_depth, num_textures=js.num_textures,
               tex_analytic=js.tex_analytic, num_instances=js.num_instances)
    return out


@pytest.fixture(scope="module")
def courtyard():
    sh = jax_load_scene("resources/courtyard.glb", use_cache=False)
    js = sh.to_device()
    view = JView.from_scene(sh, W, H)
    fi = jax_frame_inputs(sh, view.matrices())
    return dict(sh=sh, js=js, fi=fi, ts=scene_from_numpy(scene_arrays(js),
                                                         "cpu"),
                tfi=frame_inputs_from_numpy(fi, "cpu"))


def test_transforms_match_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    tr = rng.normal(size=(16, 3)).astype(np.float32)
    sc = rng.uniform(0.2, 3.0, size=(16, 3)).astype(np.float32)
    m = np.asarray(JT.compose_trs(jnp.asarray(tr), jnp.asarray(q),
                                  jnp.asarray(sc)))
    np.testing.assert_allclose(
        TT.compose_trs(t(tr), t(q), t(sc)).numpy(), m, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TT.adjugate3(t(m)).numpy(), np.asarray(JT.adjugate3(jnp.asarray(m))),
        rtol=1e-5, atol=1e-5)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(TT.normalize(t(v)).numpy(),
                               np.asarray(JT.normalize(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)
    vp = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(TT.frustum_planes_world(vp),
                                  JT.frustum_planes_world(vp))
    np.testing.assert_array_equal(
        TT.perspective_reverse_z_infinite(1.1, 16 / 9, 0.1),
        JT.perspective_reverse_z_infinite(1.1, 16 / 9, 0.1))


def test_halton_and_view_match_reference(courtyard):
    np.testing.assert_array_equal(halton_jitter_sequence(16), jhalton(16))
    sh = courtyard['sh']
    jv, tv = JView.from_scene(sh, W, H), View.from_scene(sh, W, H)
    for step in range(3):
        jm, tm = jv.matrices(), tv.matrices()
        assert jm.keys() == tm.keys()
        for k in jm:
            np.testing.assert_array_equal(np.asarray(tm[k]),
                                          np.asarray(jm[k]), err_msg=k)
        jv.advance(jm)
        tv.advance(tm)
        for v in (jv, tv):
            v.rotate_yaw_pitch(0.1 * step, -0.05)
            v.move(forward=0.3, right=0.1)
    np.testing.assert_array_equal(
        sun_ortho_matrix(sh.world_aabb, sh.sun_direction),
        jsun(sh.world_aabb, sh.sun_direction))
    want = courtyard['fi']
    got = default_frame_inputs(sh, JView.from_scene(sh, W, H).matrices())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_geometry_matches_reference(courtyard):
    js, fi, ts, tfi = (courtyard[k] for k in ('js', 'fi', 'ts', 'tfi'))
    sh = courtyard['sh']
    world = JG.node_world_matrices(
        js, jnp.asarray(fi['node_translation']),
        jnp.asarray(fi['node_rotation']), jnp.asarray(fi['node_scale']))
    tworld = TG.node_world_matrices(ts, tfi['node_translation'],
                                    tfi['node_rotation'], tfi['node_scale'])
    np.testing.assert_allclose(tworld.numpy(), np.asarray(world),
                               rtol=1e-6, atol=1e-6)
    iw, adj = JG.instance_transforms(js, world)
    tiw, tadj = TG.instance_transforms(ts, tworld)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(adj), rtol=1e-5,
                               atol=1e-5)
    for filt in ('not_mask', 'mask'):
        pi, pm = JG.static_meshlet_pairs(sh, filt)
        tpi, tpm = TG.static_meshlet_pairs(sh, filt)
        np.testing.assert_array_equal(tpi, pi)
        np.testing.assert_array_equal(tpm, pm)
        geo = JG.meshlet_clip_triangles(js, iw, jnp.asarray(fi['view_proj']),
                                        jnp.asarray(pi), jnp.asarray(pm))
        # identical instance matrices: only the clip transform differs
        tgeo = TG.meshlet_clip_triangles(ts, t(iw), tfi['view_proj'], t(pi),
                                         t(pm))
        for k in ('vtx_ids', 'inst_id', 'mat_id', 'double_sided',
                  'tri_valid', 'pair_meshlet', 'pair_inst'):
            np.testing.assert_array_equal(tgeo[k].numpy(),
                                          np.asarray(geo[k]), err_msg=k)
        np.testing.assert_allclose(tgeo['clip'].numpy(),
                                   np.asarray(geo['clip']), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("split", [True, False])
def test_setup_and_binning_match_reference(courtyard, split):
    js, fi = courtyard['js'], courtyard['fi']
    sh = courtyard['sh']
    cfg = JR.RasterConfig(**CFG, bin_split=split)
    tcfg = TR.RasterConfig(**CFG, bin_split=split)
    world = JG.node_world_matrices(
        js, jnp.asarray(fi['node_translation']),
        jnp.asarray(fi['node_rotation']), jnp.asarray(fi['node_scale']))
    iw, adj = JG.instance_transforms(js, world)
    pi, pm = JG.static_meshlet_pairs(sh, 'not_mask')
    geo = JG.meshlet_clip_triangles(js, iw, jnp.asarray(fi['view_proj']),
                                    jnp.asarray(pi), jnp.asarray(pm))
    setup = JR.setup_triangles(geo, cfg)
    tsetup = TR.setup_triangles({k: t(v) for k, v in geo.items()}, tcfg)
    for k in ('zs', 'ws', 'inv_s'):
        np.testing.assert_allclose(tsetup[k].numpy(), np.asarray(setup[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # edges: a near-degenerate triangle (|det| at rounding level) may flip
    # orientation, negating its whole edge set -- bound how many do
    close = np.isclose(tsetup['edges'].numpy(), np.asarray(setup['edges']),
                       rtol=1e-5, atol=1e-6)
    assert close.mean() > 0.999, close.mean()
    # keep / tile bbox: equal but for triangles whose determinant (the
    # sub-pixel ones of the distance) or bbox edge sits within an ulp of
    # a decision
    for k in ('valid', 'tx0', 'tx1', 'ty0', 'ty1'):
        ne = (tsetup[k].numpy() != np.asarray(setup[k])).mean()
        assert ne < 1e-3, (k, ne)

    # binning on the SAME setup is integer-exact, drop counters included
    same = {k: t(v) for k, v in setup.items()}
    bins = JR.bin_pairs_stream(setup, cfg)
    tbins = TR.bin_pairs_stream(same, tcfg)
    for k in ('vals_s', 'offs', 'counts', 'big_list'):
        np.testing.assert_array_equal(tbins[k].numpy(), np.asarray(bins[k]),
                                      err_msg=k)
    assert {k: int(v) for k, v in tbins['drop'].items()} == \
        {k: int(v) for k, v in bins['drop'].items()}
    assert int(tbins['drop']['drop_tile_k']) > 0    # overflow is exercised

    np.testing.assert_allclose(pack_tri_records(same).numpy(),
                               np.asarray(jpack(setup)), rtol=1e-6,
                               atol=1e-7)
    recs = JGB.pack_resolve_records(
        setup, js, iw, adj, iw, jnp.asarray(fi['prev_view_proj_nojitter']))
    trecs = TGB.pack_resolve_records(
        same, courtyard['ts'], t(iw), t(adj), t(iw),
        courtyard['tfi']['prev_view_proj_nojitter'])
    np.testing.assert_allclose(trecs.numpy(), np.asarray(recs), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("aniso", [1, 4])
def test_texture_sampling_matches_reference(courtyard, aniso):
    """Per-pixel and quad-shared sampling of the courtyard atlas on the
    same random lookups: the same texels, weights to float rounding."""
    from toyrenderer_tpu.ops import texture as JTX
    from toyrenderer_tpu_torch.ops import texture as TTX
    js, ts = courtyard['js'], courtyard['ts']
    rng = np.random.default_rng(3)
    h, w = 32, 48
    n = js.num_textures
    ent = rng.integers(-1, n, size=(h, w)).astype(np.int32)
    ent[:, ::2] = ent[:, 1::2]                      # quads share a texture
    uv = rng.uniform(-2, 3, size=(h, w, 2)).astype(np.float32)
    dx = rng.normal(0, 0.01, size=(h, w, 2)).astype(np.float32)
    dy = rng.normal(0, 0.01, size=(h, w, 2)).astype(np.float32)
    safe = np.maximum(ent, 0)
    offs = np.asarray(js.tex_offset)[safe, 0]
    base_rows = np.where(ent >= 0, offs, 0).astype(np.int32)
    w0 = np.asarray(js.tex_width)[safe, 0].astype(np.float32)
    h0 = np.asarray(js.tex_height)[safe, 0].astype(np.float32)
    wrap = np.asarray(js.tex_wrap)[safe].astype(np.int32)
    atlas = js.atlas_dict()
    for quad in (False, True):
        if quad and aniso > 1:
            continue
        args = (ent, uv, dx, dy)
        if quad:
            want = JTX.sample_material_maps_quad(
                atlas, *map(jnp.asarray, args), wrap=jnp.asarray(wrap),
                base_wh=(jnp.asarray(w0), jnp.asarray(h0)),
                base_rows=jnp.asarray(base_rows))
            got = TTX.sample_material_maps_quad(
                dict(tex_texels=ts.tex_texels), *map(t, args), t(wrap),
                (t(w0), t(h0)), t(base_rows))
        else:
            want = JTX.sample_material_maps(
                atlas, *map(jnp.asarray, args), wrap=jnp.asarray(wrap),
                base_wh=(jnp.asarray(w0), jnp.asarray(h0)), aniso=aniso,
                base_rows=jnp.asarray(base_rows))
            got = TTX.sample_material_maps(
                dict(tex_texels=ts.tex_texels), *map(t, args), t(wrap),
                (t(w0), t(h0)), t(base_rows), aniso=aniso)
        for k in ('base', 'normal', 'mr', 'emissive', 'desired'):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_shading_and_sky_match_reference(courtyard):
    """BRDF, Hosek and Preetham sky, view rays and the final compose on
    random inputs.  rtol 1e-4 for the BRDF and sky: exp / pow / acos are
    different implementations in XLA and PyTorch, a few ulp apart, and
    the Hosek formula exponentiates; the u8 image within 1."""
    from toyrenderer_tpu.ops import brdf as JB
    from toyrenderer_tpu.ops import postprocess as JP
    from toyrenderer_tpu.ops import sky as JS
    from toyrenderer_tpu_torch.ops import brdf as TB
    from toyrenderer_tpu_torch.ops import postprocess as TP
    from toyrenderer_tpu_torch.ops import sky as TS
    rng = np.random.default_rng(5)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    nrm, view, light = unit(512), unit(512), unit(512)
    alb = rng.uniform(size=(512, 3)).astype(np.float32)
    rough, metal = (rng.uniform(size=512).astype(np.float32)
                    for _ in range(2))
    np.testing.assert_allclose(
        TB.shade_directional(*map(t, (nrm, view, light, alb, rough,
                                      metal))).numpy(),
        np.asarray(JB.shade_directional(*map(jnp.asarray, (
            nrm, view, light, alb, rough, metal)))), rtol=1e-4, atol=1e-6)
    sun = courtyard['sh'].sun_direction
    params = JS.hosek_sky_params(2.5, -sun)
    np.testing.assert_array_equal(TS.hosek_sky_params(2.5, -sun), params)
    dirs = unit(4096)
    to_sun = (-sun).astype(np.float32)
    np.testing.assert_allclose(
        TS.sky_radiance_hosek(t(dirs), t(to_sun), t(params),
                              sun_intensity=3.0).numpy(),
        np.asarray(JS.sky_radiance_hosek(jnp.asarray(dirs),
                                         jnp.asarray(to_sun),
                                         jnp.asarray(params),
                                         sun_intensity=3.0)),
        rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        TS.sky_radiance(t(dirs), t(to_sun), sun_intensity=3.0).numpy(),
        np.asarray(JS.sky_radiance(jnp.asarray(dirs), jnp.asarray(to_sun),
                                   sun_intensity=3.0)),
        rtol=1e-4, atol=1e-6)
    ivp = courtyard['fi']['inv_view_proj']
    np.testing.assert_allclose(TS.view_rays(t(ivp), 64, 48).numpy(),
                               np.asarray(JS.view_rays(jnp.asarray(ivp),
                                                       64, 48)),
                               rtol=1e-5, atol=1e-6)
    hdr = rng.uniform(0, 8, size=(48, 64, 3)).astype(np.float32)
    got = TP.compose_final(t(hdr), exposure=0.25).numpy().astype(int)
    want = np.asarray(JP.compose_final(jnp.asarray(hdr), exposure=0.25))
    assert np.abs(got - want.astype(int)).max() <= 1


def test_tile_pair_counts_size_the_list(courtyard):
    """engine/capacity.py against the reference's binning of the same
    view at an unbounded K: big-list length and class-cap drops exact;
    the densest tile's count and the pairs over K=512 within 0.1%, since
    the two setups' tile bboxes differ by ulp-level flips on < 0.1% of
    triangles (see test_setup_and_binning_match_reference).  The sized K
    covers the densest tile of either set."""
    from toyrenderer_tpu_torch.engine import RenderSettings
    from toyrenderer_tpu_torch.engine.capacity import (
        sized_settings, tile_pair_counts)
    js, fi, sh = courtyard['js'], courtyard['fi'], courtyard['sh']
    settings = RenderSettings(width=W, height=H, max_tris_per_tile=512,
                              max_big_tris=512)
    sets = {f: JG.static_meshlet_pairs(sh, f) for f in ('not_mask', 'mask')}
    got = tile_pair_counts(courtyard['ts'], courtyard['tfi'], settings,
                           {f: (t(a), t(b)) for f, (a, b) in sets.items()})
    cfg = JR.RasterConfig(**dict(CFG, max_tris_per_tile=1 << 30))
    world = JG.node_world_matrices(
        js, jnp.asarray(fi['node_translation']),
        jnp.asarray(fi['node_rotation']), jnp.asarray(fi['node_scale']))
    iw, _ = JG.instance_transforms(js, world)
    for f, (pi, pm) in sets.items():
        geo = JG.meshlet_clip_triangles(js, iw, jnp.asarray(fi['view_proj']),
                                        jnp.asarray(pi), jnp.asarray(pm))
        bins = JR.bin_pairs_stream(JR.setup_triangles(geo, cfg), cfg)
        want = int(np.asarray(bins['counts']).max())
        assert abs(got[f]["max_tile_pairs"] - want) <= 1e-3 * want, f
        over = int(np.maximum(np.asarray(bins['counts']) - 512, 0).sum())
        assert abs(got[f]['over_k'] - over) <= 1e-3 * max(over, 1), f
        assert got[f]['big_tris'] == int((np.asarray(bins['big_list'])
                                          >= 0).sum()), f
        for k, v in got[f]['drop'].items():
            assert v == int(bins["drop"][k]), (f, k, v)
    assert got['not_mask']['max_tile_pairs'] > 512     # K=512 overflows

    sized = sized_settings(settings, got)
    k = sized.max_tris_per_tile
    assert k % sized.raster_chunk == 0
    assert k >= max(v['max_tile_pairs'] for v in got.values()) > k - 32
    assert sized_settings(sized, got) == sized          # never lowered
