"""The sun shadow map (ops/shadowmap.py) against the reference package's:
its raster (the plain version of the one-layer peel fill, K2) on the
Cornell box and on a courtyard caster subset, its quad expansion, and
its two samplers.

The reference renders through its accelerator branch
(`render_shadow_map(use_pallas=True)`: streamed caps, the pair stream,
its Pallas peel kernel in interpret mode), the branch the port takes on
every device.  Both get the same scene arrays, instance matrices and
sun matrix; the depth tolerances are stated at each test.  Drop
counters equal (none in these casters).  The samplers get
the same map and points: visibility within 1e-5 on >= 99.9% of the taps
(measured: all) -- a tap's position rounds like the reference's, but a
tap within an ulp of a texel's depth, or of a texel edge, would compare
or weigh the other way if the two packages' 4x4 products rounded apart.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from toyrenderer_tpu.ops import geometry as JG
from toyrenderer_tpu.ops import raster as JR
from toyrenderer_tpu.ops import shadowmap as JSM
from toyrenderer_tpu.ops.geometry import (
    instance_transforms, node_world_matrices, static_meshlet_pairs)

from test_torch_culling import _scene
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import peel_cuda
from toyrenderer_tpu_torch.ops import shadowmap as TSM
from toyrenderer_tpu_torch.ops.peel_cuda import fill_peel_stream


@functools.lru_cache(maxsize=None)
def _casters(name, res, every=None):
    """A scene's opaque casters (the pairs of every `every`-th instance
    when given), its instance matrices and sun matrix, and the
    reference's map of them (`_reference_map`)."""
    sh, js, ts = _scene(name)
    pi, pm = static_meshlet_pairs(sh, 'not_mask')
    if every is not None:
        keep = pi % every == 0
        pi, pm = pi[keep], pm[keep]
    world = node_world_matrices(
        js, jnp.asarray(sh.node_translation), jnp.asarray(sh.node_rotation),
        jnp.asarray(sh.node_scale))
    iw, _ = instance_transforms(js, world)
    svp = JSM.sun_ortho_matrix(sh.world_aabb, sh.sun_direction)
    c = dict(sh=sh, js=js, ts=ts, pi=pi, pm=pm, iw=np.array(iw), svp=svp,
             res=res)
    c['ref'] = _reference_map(c)
    return c


def _reference_map(c):
    """The reference's map through its accelerator branch, and the setup
    and pair stream that branch rasterizes (for the fill-only
    comparison)."""
    geo = JG.meshlet_clip_triangles(
        c['js'], jnp.asarray(c['iw']), jnp.asarray(c['svp']),
        jnp.asarray(c['pi']), jnp.asarray(c['pm']))
    geo = dict(geo, double_sided=jnp.ones_like(geo['double_sided']))
    cfg = JSM._content_caps(JSM.shadow_map_config(c['res']),
                            geo['tri_valid'].shape[0], True)
    setup = JR.setup_triangles(geo, cfg)
    bins = JR.bin_pairs_stream(setup, cfg)
    with pltpu.force_tpu_interpret_mode():
        z, drop = JSM.render_shadow_map(
            c['js'], jnp.asarray(c['iw']), jnp.asarray(c['pi']),
            jnp.asarray(c['pm']), jnp.asarray(c['svp']),
            JSM.shadow_map_config(c['res']), use_pallas=True)
    return dict(z=np.asarray(z), drop=int(drop), setup=setup, bins=bins)


@pytest.fixture(scope="module", params=[("cornell.gltf", 256, None),
                                        ("courtyard.glb", 256, 25)],
                ids=["cornell", "courtyard-every-25th-instance"])
def casters(request):
    """Cornell's casters, and the courtyard's pairs of every 25th
    instance (14 instances spread over the scene, 16,977 binned pairs: a
    subset whose sun-view density is near the mean, which the content
    caps hold without a drop -- the 6-unit neighbourhood of the camera
    drops 10,433 pairs over K in both packages)."""
    return _casters(*request.param)


def test_render_shadow_map_matches_reference(casters):
    """The whole map.  Each package computes its own clip coordinates,
    which round an ulp apart (~6e-8, ROADMAP queue 3: geometry rounding);
    the orthographic map's depth is a ratio of sums over the edge
    functions whose terms cancel, so those ulps grow to up to 2.5e-6
    (Cornell), and on the courtyard's small casters an edge texel may
    change triangle.  So: depth within atol 1e-5 (the reference's own
    bound of its binned fill against its bruteforce, tests/
    test_raster.py:141-144) on >= 99% of the texels (measured: Cornell
    100%, the courtyard subset 99.52%), and within rtol 1e-6, atol 1e-7
    on >= 98% (Cornell 99.64%, the courtyard subset 98.28%)."""
    c, ref = casters, casters['ref']
    peel_cuda.launches = 0
    z, drop = TSM.render_shadow_map(
        c['ts'], torch.from_numpy(c['iw']), torch.from_numpy(c['pi']),
        torch.from_numpy(c['pm']), torch.from_numpy(c['svp']),
        TSM.shadow_map_config(c['res']))
    assert peel_cuda.launches == 0      # CPU tensors ran the plain version
    assert int(drop) == ref['drop'] == 0
    z = z.numpy()
    near = np.isclose(z, ref['z'], rtol=0.0, atol=1e-5).mean()
    tight = np.isclose(z, ref['z'], rtol=1e-6, atol=1e-7).mean()
    assert near >= 0.99 and tight >= 0.98, (near, tight)
    assert 0.01 < float((z > 0).mean()) <= 1.0


def test_shadow_map_fill_matches_reference_kernel(casters):
    """The map's raster alone (the one-layer peel fill under the content
    caps) on the reference's own setup and pair stream, against its
    Pallas kernel: depth within rtol 1e-6, atol 1e-7 on >= 99.99% of the
    texels and within atol 1e-6 on all (measured: one courtyard texel
    4.2e-7 off).  The port's raster records fold the depth coefficients
    in the reference's order but round each product, where XLA may fuse
    a multiply-add, and the cancelling interpolation grows that ulp."""
    ref = casters['ref']
    tsetup = {k: torch.from_numpy(np.array(v)) for k, v in
              ref['setup'].items()}
    tbins = {k: v if isinstance(v, dict) else torch.from_numpy(np.array(v))
             for k, v in ref['bins'].items()}
    cfg = TSM._content_caps(TSM.shadow_map_config(casters['res']),
                            tsetup['valid'].shape[0])
    z = fill_peel_stream(tsetup, tbins, cfg, layers=1)[0][0].numpy()
    np.testing.assert_allclose(z, ref['z'], rtol=0.0, atol=1e-6)
    tight = np.isclose(z, ref['z'], rtol=1e-6, atol=1e-7).mean()
    assert tight >= 0.9999, tight


def test_content_caps_match_reference():
    """The streamed fill's caps (the reference's accelerator branch)."""
    cfg = JSM.shadow_map_config(1024)
    tcfg = TSM.shadow_map_config(1024)
    for n in (384, 523_584, 4_000_000, 40_000_000):
        want = JSM._content_caps(cfg, n, True)
        got = TSM._content_caps(tcfg, n)
        assert (got.max_tris_per_tile, got.max_big_tris) == (
            want.max_tris_per_tile, want.max_big_tris)


def test_quad_expand_map_matches_reference():
    rng = np.random.default_rng(11)
    d = rng.uniform(0, 1, size=(37, 37)).astype(np.float32)
    np.testing.assert_array_equal(
        TSM.quad_expand_map(torch.from_numpy(d)).numpy(),
        np.asarray(JSM.quad_expand_map(jnp.asarray(d))))


@pytest.fixture(scope="module")
def cornell_map():
    """The reference's Cornell sun map at 256 texels, and world points
    on and above the box's surfaces (every tap case: lit, shadowed,
    outside the map)."""
    c = _casters("cornell.gltf", 256)
    lo, hi = (np.asarray(x, np.float32) for x in c['sh'].world_aabb)
    rng = np.random.default_rng(5)
    h, w = 64, 96
    pts = lo + rng.uniform(-0.1, 1.1, size=(h, w, 3)).astype(np.float32) * (
        hi - lo)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(quads=np.asarray(JSM.quad_expand_map(
        jnp.asarray(c['ref']['z']))), svp=c['svp'],
                sun=-np.asarray(c['sh'].sun_direction, np.float32),
                pts=pts, n=n, hit=rng.uniform(size=(h, w)) < 0.8)


def _agree(got, want, what):
    close = np.abs(got - want) <= 1e-5
    assert close.mean() >= 0.999, (what, close.mean(), (~close).sum())


def test_sample_shadow_map_points_matches_reference(cornell_map):
    m = cornell_map
    pts = m['pts'].reshape(-1, 3)
    want = np.asarray(JSM.sample_shadow_map_points(
        jnp.asarray(m['quads']), 256, jnp.asarray(m['svp']),
        jnp.asarray(pts)))
    got = TSM.sample_shadow_map_points(
        torch.from_numpy(m['quads']), 256, torch.from_numpy(m['svp']),
        torch.from_numpy(pts)).numpy()
    _agree(got, want, "points")
    assert 0.0 < got.mean() < 1.0 and (got == 1.0).any() and (got == 0).any()


@pytest.mark.parametrize("h,w", [(64, 96), (63, 95)],
                         ids=["quad-rate", "odd"])
def test_sample_shadow_map_matches_reference(cornell_map, h, w):
    m = cornell_map
    args = (m['pts'][:h, :w], m['n'][:h, :w], m['sun'], m['hit'][:h, :w])
    for frame in (0, 5):
        want = np.asarray(JSM.sample_shadow_map(
            jnp.asarray(m['quads']), 256, jnp.asarray(m['svp']),
            *(jnp.asarray(a) for a in args),
            jnp.asarray(frame, jnp.int32)))
        got = TSM.sample_shadow_map(
            torch.from_numpy(m['quads']), 256, torch.from_numpy(m['svp']),
            *(torch.from_numpy(np.asarray(a)) for a in args),
            torch.tensor(frame, dtype=torch.int32)).numpy()
        _agree(got, want, frame)
        assert 0.0 < got[m['hit'][:h, :w]].mean() < 1.0
