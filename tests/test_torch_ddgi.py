"""The port's DDGI pieces and their codecs against the reference
package's, on inputs made from a seed with numpy.

* Codecs (ops/packing.py).  f16 pairs: bit-equal both ways.  Octahedral
  encode and decode: equal.  RGB9E5: the packed codes equal on >= 99.99%
  of random colours; the others differ by one in one mantissa.  The
  reference's scale 2^(e - 24) comes from XLA's exp2, which on the CPU
  is not exact at integer exponents (up to 5.4e-7 relative off for
  e < 12), so its quotient c / scale can land on the other side of a
  rounding tie; the port builds the power of two from its bits.
  Unpacked, the port's values are exactly m * 2^(e - 24), the
  reference's within 6e-7 relative.
* The volume, the initial probes and the ray layouts (Fibonacci
  directions, cone order, cone blocking, brick size): equal.
* `build_shade_records` over the courtyard's GI pairs, from
  `bvh.world_triangles` (within 1e-6): albedo and emissive equal, the
  face normals within 1e-5 (a thin triangle's cross product cancels, and
  XLA fuses its products into multiply-adds), except on collapsed LOD
  triangles, whose normal is rounding noise.
* `update_probe_block` with the lifecycle, as the frame's interval mode
  calls it and as a phased block, and the unphased `update_probes`:
  textures within 1e-5 relative to
  their largest value (small matrix products summed in another order),
  offsets and states equal, the variability within 1e-5 relative.
* `sample_irradiance_visibility` with relocation offsets and
  vis_pool=2, and `sample_irradiance`: within 1e-4 relative to the
  largest value on >= 99.9% of the points, 1% everywhere (the texel and
  RGB9E5 quantisation turn an ulp into a step on a rare point).
* `trace_probe_block` on cornell's complete tree (the reference's,
  carried across) in the cone layout and in the gdir layout
  (TR_GI_GDIR=1; the reference traces the same rays per ray on the CPU),
  a phased block with relocated and inactive probes: radiance within
  1e-4, distances within 1e-5, hits and the lifecycle's inputs equal.
  The reference's lockstep traversal gets a step budget no ray reaches.
* The opt-in routes, with those tolerances: the unphased `trace_probes`,
  the sampler with TR_GI_VIS_PACK=1 and the probe block with
  TR_RT_CHUNKS=1 (the chunk route in both packages).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import ddgi as JD
from toyrenderer_tpu.ops import packing as JP
from toyrenderer_tpu.ops.bvh_sah import build_rt_static_gi as jax_gi_static
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_bvh import _jax_inst_world
from test_torch_culling import _scene, t
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import bvh as TB
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.ops import packing as TP
from toyrenderer_tpu_torch.weights import bvh_from_numpy

PROBES = dict(max_probes_axis=4, rays_per_probe=64)


def _u32(x):
    return np.asarray(x).view(np.uint32)


def test_codecs_match_reference():
    rng = np.random.default_rng(0)
    n = 100_000
    c = np.abs(rng.standard_normal((n, 3))
               * np.exp(rng.uniform(-20, 12, (n, 1)))).astype(np.float32)
    c[:4] = ([0, 0, 0], [65408, 1, 0], [1e9, 0, 0], [0.5, 0.25, 1.0])
    want = np.asarray(JP.pack_rgb9e5_u32(jnp.asarray(c)))
    got = _u32(TP.pack_rgb9e5_u32(torch.from_numpy(c)).numpy())
    differ = got != want
    assert differ.mean() <= 1e-4, differ.mean()
    for sh in (0, 9, 18):
        dm = ((got[differ] >> sh) & 511).astype(int) - (
            (want[differ] >> sh) & 511)
        assert (np.abs(dm) <= 1).all()
    assert ((got >> 27) == (want >> 27))[differ].all()
    un = TP.unpack_rgb9e5_u32(
        torch.from_numpy(want.view(np.int32).copy())).numpy()
    e = (want >> 27).astype(np.float64)
    for i, sh in enumerate((0, 9, 18)):
        exact = (((want >> sh) & 511) * np.exp2(e - 24)).astype(np.float32)
        np.testing.assert_array_equal(un[:, i], exact)
    np.testing.assert_allclose(
        un, np.asarray(JP.unpack_rgb9e5_u32(jnp.asarray(want))), rtol=6e-7,
        atol=0)

    v = (rng.standard_normal((n, 2))
         * np.exp(rng.uniform(-20, 12, (n, 1)))).astype(np.float32)
    v[:3] = ([0.0, -0.0], [np.inf, -np.inf], [65520.0, 1e-8])
    want = np.asarray(JP.pack_half2_u32(jnp.asarray(v)))
    got = _u32(TP.pack_half2_u32(torch.from_numpy(v)).numpy())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TP.unpack_half2_u32(
            torch.from_numpy(want.view(np.int32).copy())).numpy(),
        np.asarray(JP.unpack_half2_u32(jnp.asarray(want))))

    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    uv = np.array(JP.oct_encode(jnp.asarray(d)))
    np.testing.assert_array_equal(TP.oct_encode(torch.from_numpy(d)).numpy(),
                                  uv)
    np.testing.assert_array_equal(TP.oct_decode(torch.from_numpy(uv)).numpy(),
                                  np.asarray(JP.oct_decode(jnp.asarray(uv))))


@pytest.fixture(scope="module")
def cornell():
    sh, js, ts = _scene("cornell.gltf")
    jvol = JD.volume_from_aabb(*sh.world_aabb, **PROBES)
    tvol = TD.volume_from_aabb(*sh.world_aabb, **PROBES)
    return dict(sh=sh, js=js, ts=ts, jvol=jvol, tvol=tvol)


def test_volume_probes_and_layouts_match(cornell):
    jvol, tvol = cornell['jvol'], cornell['tvol']
    assert tvol == TD.DdgiVolume(**jvol.__dict__)
    np.testing.assert_array_equal(tvol.probe_positions().numpy(),
                                  np.asarray(jvol.probe_positions()))
    for box in (([-3, 0, -60], [40, 7, 5]), ([0, 0, 0], [1, 1, 1e-5])):
        assert (TD.volume_from_aabb(*box, 12, 128)
                == TD.DdgiVolume(**JD.volume_from_aabb(*box, 12,
                                                       128).__dict__))
    want = JD.init_probes(jvol)
    got = TD.init_probes(tvol)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for r in (64, 256):
        np.testing.assert_array_equal(TD._fibonacci_sphere(r),
                                      JD._fibonacci_sphere(r))
        np.testing.assert_array_equal(TD._cone_order(r), JD._cone_order(r))
    for pb in (1, 40, 90, 360, 700):
        assert TD._brick_for(pb) == JD._brick_for(pb)
    x = np.arange(256 * 192 * 3, dtype=np.float32).reshape(-1, 3)
    blk = np.asarray(JD._cone_block(jnp.asarray(x), 256, 192, 64, 16))
    np.testing.assert_array_equal(
        TD._cone_block(torch.from_numpy(x), 256, 192, 64, 16).numpy(), blk)
    np.testing.assert_array_equal(
        TD._cone_unblock(torch.from_numpy(blk), 256, 192, 64, 16).numpy(), x)
    for f in (0, 7, 1234):
        np.testing.assert_allclose(
            TD._frame_rotation(torch.tensor(f, dtype=torch.int32)).numpy(),
            np.asarray(JD._frame_rotation(jnp.asarray(f, jnp.int32))),
            rtol=0, atol=2e-6)
    np.testing.assert_allclose(TD._oct_texel_dirs(16, 'cpu').numpy(),
                               np.asarray(JD._oct_texel_dirs(16)), atol=1e-7)


def test_shade_records_match_reference():
    sh, js, ts = _scene("courtyard.glb")
    mk_i, mk_m = static_meshlet_pairs(sh, 'mask')
    _, gpi, gpm, lod = jax_gi_static(sh, 'not_mask', mask_pair_inst=mk_i,
                                     mask_pair_meshlet=mk_m)
    gpi = np.concatenate([np.asarray(gpi), mk_i])[::7]
    gpm = np.concatenate([np.asarray(gpm), mk_m])[::7]
    iw = _jax_inst_world(sh)
    jv = JB.world_triangles(js, jnp.asarray(iw), jnp.asarray(gpi),
                            jnp.asarray(gpm))
    tv = TB.world_triangles(ts, torch.from_numpy(iw), t(gpi), t(gpm))
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    want = np.asarray(JD.build_shade_records(js, jnp.asarray(gpi),
                                             jnp.asarray(gpm), *jv[:3]))
    got = TD.build_shade_records(
        ts, t(gpi), t(gpm), *(torch.from_numpy(np.asarray(x))
                              for x in jv[:3])).numpy()
    # collapsed LOD triangles (two equal vertices) have no face normal:
    # its direction is rounding noise
    e1 = np.asarray(jv[1]) - np.asarray(jv[0])
    e2 = np.asarray(jv[2]) - np.asarray(jv[0])
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    keep = np.asarray(jv[3]) & (area2 > 1e-5 * np.maximum(
        np.sum(e1 * e1, -1), np.sum(e2 * e2, -1)))
    assert keep.mean() > 0.5
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])
    assert lod > 0


def _probe_state(vol, seed):
    rng = np.random.default_rng(seed)
    p = vol.num_probes
    sp = np.asarray(vol.spacing, np.float32)
    irr = rng.uniform(0, 4, (p, 64, 3)).astype(np.float32)
    md = rng.uniform(0.1, 3, (p, 256)).astype(np.float32)
    dist = np.stack([md, md * md + rng.uniform(0, 0.5, (p, 256))],
                    -1).astype(np.float32)
    off = (rng.uniform(-0.3, 0.3, (p, 3)) * sp).astype(np.float32)
    state = (rng.uniform(size=p) > 0.25).astype(np.float32)
    return irr, dist, off, state


def _both(fn_j, fn_t, *arrays):
    return (fn_j(*(jnp.asarray(a) for a in arrays)),
            fn_t(*(torch.from_numpy(np.array(a)) for a in arrays)))


@pytest.mark.parametrize("num_phases,cycle_end", [(1, True), (3, False)])
def test_update_probe_block_matches_reference(cornell, num_phases, cycle_end):
    jvol, tvol = cornell['jvol'], cornell['tvol']
    rng = np.random.default_rng(num_phases)
    p = jvol.num_probes
    pb = -(-p // num_phases)
    r = jvol.rays_per_probe
    irr, dist, off, state = _probe_state(jvol, 3)
    carry = dict(ddgi_irradiance=irr, ddgi_distance=dist, ddgi_offset=off,
                 ddgi_state=state,
                 ddgi_variability=np.float32(0.3),
                 ddgi_var_ring=rng.uniform(0, 1, 16).astype(np.float32),
                 ddgi_var_samples=np.float32(21.0),
                 ddgi_var_accum=np.float32(0.05))
    dirs = rng.standard_normal((r, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radiance = rng.uniform(0, 3, (pb, r, 3)).astype(np.float32)
    ray_dist = rng.uniform(0.05, 20, (pb, r)).astype(np.float32)
    life = dict(frac_back=rng.uniform(0, 0.5, pb).astype(np.float32),
                closest_back_t=rng.uniform(0, 2, pb).astype(np.float32),
                closest_back_dir=dirs[rng.integers(0, r, pb)],
                closest_front_t=rng.uniform(0, 30, pb).astype(np.float32))
    start = p - pb + 2 if num_phases > 1 else 0     # clamped to p - pb
    kw = dict(first_frame=False, cycle_end=cycle_end, num_phases=num_phases)
    want = JD.update_probe_block(
        jvol, {k: jnp.asarray(v) for k, v in carry.items()},
        jnp.asarray(radiance), jnp.asarray(ray_dist), jnp.asarray(dirs),
        jnp.asarray(start), lifecycle={k: jnp.asarray(v)
                                       for k, v in life.items()}, **kw)
    got = TD.update_probe_block(
        tvol, {k: torch.tensor(v) for k, v in carry.items()},
        torch.from_numpy(radiance), torch.from_numpy(ray_dist),
        torch.from_numpy(dirs), torch.tensor(start),
        lifecycle={k: torch.from_numpy(np.array(v))
                   for k, v in life.items()},
        first_frame=torch.tensor(False), cycle_end=torch.tensor(cycle_end),
        num_phases=num_phases)
    assert got.keys() == want.keys()
    for k in ('ddgi_irradiance', 'ddgi_distance'):
        a, b = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * float(np.abs(b).max()))
    for k in ('ddgi_offset', 'ddgi_state'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert 0 < got['ddgi_state'].numpy().mean() < 1
    for k in ('ddgi_variability', 'ddgi_var_ring', 'ddgi_var_accum'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


def test_update_probes_matches_reference(cornell):
    """The unphased blend of a whole-volume trace."""
    jvol, tvol = cornell['jvol'], cornell['tvol']
    rng = np.random.default_rng(4)
    p, r = jvol.num_probes, jvol.rays_per_probe
    irr, dist, _, _ = _probe_state(jvol, 8)
    dirs = rng.standard_normal((r, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radiance = rng.uniform(0, 3, (p, r, 3)).astype(np.float32)
    ray_dist = rng.uniform(0.05, 20, (p, r)).astype(np.float32)
    for first in (False, True):
        want = JD.update_probes(
            jvol, dict(ddgi_irradiance=jnp.asarray(irr),
                       ddgi_distance=jnp.asarray(dist)),
            jnp.asarray(radiance), jnp.asarray(ray_dist),
            jnp.asarray(dirs), first)
        got = TD.update_probes(
            tvol, dict(ddgi_irradiance=torch.from_numpy(irr),
                       ddgi_distance=torch.from_numpy(dist)),
            torch.from_numpy(radiance), torch.from_numpy(ray_dist),
            torch.from_numpy(dirs), first)
        for k in want:
            b = np.asarray(want[k])
            np.testing.assert_allclose(got[k].numpy(), b, rtol=0,
                                       atol=1e-5 * float(np.abs(b).max()))


@pytest.mark.parametrize("vis", [True, False])
def test_sampling_matches_reference(cornell, vis, vis_pack=False):
    jvol, tvol = cornell['jvol'], cornell['tvol']
    irr, dist, off, _ = _probe_state(jvol, 5)
    rng = np.random.default_rng(9)
    lo = np.asarray(jvol.origin)
    hi = lo + np.asarray(jvol.spacing) * (np.asarray(jvol.counts) - 1)
    wp = rng.uniform(lo, hi, (48, 64, 3)).astype(np.float32)
    n = rng.standard_normal((48, 64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if vis:
        want = np.asarray(JD.sample_irradiance_visibility(
            jvol, *(jnp.asarray(a) for a in (irr, dist, wp, n)),
            probe_offset=jnp.asarray(off), vis_pool=2, vis_pack=vis_pack))
        got = TD.sample_irradiance_visibility(
            tvol, *(torch.from_numpy(a) for a in (irr, dist, wp, n)),
            probe_offset=torch.from_numpy(off), vis_pool=2,
            vis_pack=vis_pack).numpy()
    else:
        want = np.asarray(JD.sample_irradiance(
            jvol, jnp.asarray(irr), jnp.asarray(wp).reshape(-1, 3),
            jnp.asarray(n).reshape(-1, 3)))
        got = TD.sample_irradiance(
            tvol, torch.from_numpy(irr), torch.from_numpy(wp).reshape(-1, 3),
            torch.from_numpy(n).reshape(-1, 3)).numpy()
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert (diff <= 1e-4 * scale).mean() >= 0.999
    assert diff.max() <= 1e-2 * scale
    assert want.shape == got.shape and want.std() > 0.01 * scale


def _sky_j(d):
    return (d * 0.5 + 0.5) * jnp.asarray([0.4, 0.6, 1.2])


def _sky_t(d):
    return (d * 0.5 + 0.5) * torch.tensor([0.4, 0.6, 1.2])


def _gi_trees(cornell):
    """(reference tree, port tree, shade records): cornell's GI tree (the
    reference's complete tree on the CPU), carried across."""
    sh, js = cornell['sh'], cornell['js']
    rts, gpi, gpm, _ = jax_gi_static(sh, 'all')
    iw = _jax_inst_world(sh)
    jbvh = JB.refit_bvh(rts, jnp.asarray(iw))
    tbvh = bvh_from_numpy(dict(child_boxes=np.asarray(jbvh.child_boxes),
                               leaf_rows=np.asarray(jbvh.leaf_rows),
                               level_offset=jbvh.level_offset,
                               num_levels=jbvh.num_levels), 'cpu')
    v = JB.world_triangles(js, jnp.asarray(iw), gpi, gpm)
    return jbvh, tbvh, JD.build_shade_records(js, gpi, gpm, *v[:3])


SUN = (np.asarray([0.3, 0.8, 0.52], np.float32)
       / np.linalg.norm(np.asarray([0.3, 0.8, 0.52], np.float32)))
SUN_COL = np.asarray([1.0, 0.95, 0.9], np.float32)
SUN_INT = np.asarray([3.0], np.float32)


def _hold_probe_trace(got, want):
    """radiance within 1e-4, distances within 1e-5, hits equal."""
    w_dist = np.asarray(want[1])
    hit = w_dist < 1e4
    np.testing.assert_array_equal(got[1].numpy() < 1e4, hit)
    assert 0.05 < hit.mean() < 0.99
    np.testing.assert_allclose(got[1].numpy(), w_dist, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=2e-6)


def hold_probe_block(cornell, frame=5):
    """trace_probe_block of both packages on one phased block with
    relocated and inactive probes (as the switches in the environment and
    the reference module's attributes stand); returns the port's
    result."""
    jvol, tvol = cornell['jvol'], cornell['tvol']
    jbvh, tbvh, shade = _gi_trees(cornell)
    irr, _, off, state = _probe_state(jvol, 7)
    num_phases = 2
    want = JD.trace_probe_block(
        jvol, jbvh, shade, jnp.asarray(irr), jnp.asarray(SUN),
        jnp.asarray(SUN_COL), jnp.asarray(SUN_INT),
        jnp.asarray(frame, jnp.int32), _sky_j, num_phases, max_steps=4096,
        probe_offset=jnp.asarray(off), probe_state=jnp.asarray(state))
    got = TD.trace_probe_block(
        tvol, tbvh, torch.from_numpy(np.asarray(shade)),
        torch.from_numpy(irr), torch.from_numpy(SUN),
        torch.from_numpy(SUN_COL), torch.from_numpy(SUN_INT),
        torch.tensor(frame, dtype=torch.int32), _sky_t, num_phases,
        probe_offset=torch.from_numpy(off),
        probe_state=torch.from_numpy(state))
    _hold_probe_trace(got, want)
    assert int(got[3]) == int(want[3])
    for k, v_ in got[4].items():
        np.testing.assert_allclose(v_.numpy(), np.asarray(want[4][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    return got


@pytest.mark.parametrize("gdir", [False, True])
def test_trace_probe_block_matches_reference(cornell, gdir, monkeypatch):
    monkeypatch.setenv('TR_GI_GDIR', '1' if gdir else '0')
    hold_probe_block(cornell)


def hold_trace_probes(cornell):
    """The unphased trace_probes of both packages on cornell's GI tree
    (the reference's lockstep traversal with a step budget no ray
    reaches); returns the port's result."""
    jvol, tvol = cornell['jvol'], cornell['tvol']
    jbvh, tbvh, shade = _gi_trees(cornell)
    irr, _, _, _ = _probe_state(jvol, 3)
    want = JD.trace_probes(
        jvol, jbvh, shade, jnp.asarray(irr), jnp.asarray(SUN),
        jnp.asarray(SUN_COL), jnp.asarray(SUN_INT),
        jnp.asarray(4, jnp.int32), _sky_j, max_steps=4096)
    got = TD.trace_probes(
        tvol, tbvh, torch.from_numpy(np.asarray(shade)),
        torch.from_numpy(irr), torch.from_numpy(SUN),
        torch.from_numpy(SUN_COL), torch.from_numpy(SUN_INT),
        torch.tensor(4, dtype=torch.int32), _sky_t)
    _hold_probe_trace(got, want)
    assert got[0].shape == (tvol.num_probes, tvol.rays_per_probe, 3)
    return got


@pytest.mark.parametrize("route", ["trace_probes", "vis_pack", "chunks"])
def test_opt_in_routes_match_reference(cornell, monkeypatch, route):
    """The reference's opt-in probe paths: the unphased `trace_probes`,
    the corner-packed visibility fetch (TR_GI_VIS_PACK=1, read by the
    sampler in both packages; the tolerances of
    test_sampling_matches_reference) and the chunk route's probe block
    (TR_RT_CHUNKS=1)."""
    if route == "trace_probes":
        hold_trace_probes(cornell)
    elif route == "vis_pack":
        monkeypatch.setenv('TR_GI_VIS_PACK', '1')
        test_sampling_matches_reference(cornell, True, vis_pack=None)
    else:
        monkeypatch.setenv('TR_RT_CHUNKS', '1')
        hold_probe_block(cornell)
