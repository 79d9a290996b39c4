"""The descriptor-row texture path against the reference package's.

The port's ops/texture.py on the same numpy inputs as
toyrenderer_tpu/ops/texture.py: `_texel_index` on a hand-built tile
table (resident entries, fallbacks with delta > 0, untiled rows with
tile base < 0), the desc-gather samplers (per pixel with aniso 1 and 4,
and quad-shared) on an atlas of 70 small textures (>= 64: no analytic
descriptors), on the courtyard's analytic atlas read through its desc
rows, and on the stress scene's atlas streamed into a tile pool;
`sample_texture`, `texture_feedback` with 3 and with 70 textures (the
reference's masked-reduction and segment-min branches) and
`vt_tile_feedback`.

Tolerances: colours within rtol 1e-5 / atol 1e-6 (the same texels,
bilinear weights to float rounding); texel indices, tile ids and the
feedback exact (integer arithmetic, and a minimum of the same floats).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.engine.streaming import (
    TileStreamingManager as JaxTileManager)
from toyrenderer_tpu.ops import texture as JT
from toyrenderer_tpu.scene import load_scene as jax_load_scene
from toyrenderer_tpu.scene import textures as JX
from toyrenderer_tpu.scene.procedural import make_stress_scene

from test_torch_raster import _one_torch_thread, scene_arrays  # noqa: F401
from toyrenderer_tpu_torch.engine.streaming import scene_atlas
from toyrenderer_tpu_torch.ops import texture as TT
from toyrenderer_tpu_torch.scene import procedural as TP
from toyrenderer_tpu_torch.scene import textures as TX
from toyrenderer_tpu_torch.weights import residency_from_numpy

MAPS = ('base', 'normal', 'mr', 'emissive', 'desired')


def t(x):
    return torch.from_numpy(np.array(x))


def _small_images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (int(rng.integers(1, 48)),
                                  int(rng.integers(1, 48)), 4),
                         dtype=np.uint8) for _ in range(n)]


def _ref_atlas_of(host):
    return JX.TextureAtlas(
        texels=host.tex_texels, desc_offset=host.tex_offset,
        desc_width=host.tex_width, desc_height=host.tex_height,
        num_mips=host.tex_num_mips, wrap_mode=host.tex_wrap,
        min_resident_mip=host.tex_min_mip, num_textures=host.num_textures)


def _atlases(name):
    """(reference atlas dict, port atlas dict, texture count) of one of
    the test atlases."""
    if name == 'seventy':
        imgs = _small_images(70, 1)
        wraps = [i % 2 for i in range(70)]
        ja = JX.build_atlas(images=imgs, wrap_modes=wraps)
        ta = TX.build_atlas(images=imgs, wrap_modes=wraps)
        np.testing.assert_array_equal(ta.texels, ja.texels)
        np.testing.assert_array_equal(ta.packed_desc(), ja.packed_desc())
        return ja.to_device(), ta.to_device("cpu"), 70
    if name == 'courtyard':
        js = jax_load_scene("resources/courtyard.glb",
                            use_cache=False).to_device()
        ref = dict(js.atlas_dict(), _analytic=False)
        port = {k: t(np.asarray(v).view(np.int32)
                     if np.asarray(v).dtype == np.uint32 else v)
                for k, v in ref.items() if not k.startswith('_')}
        return ref, port, js.num_textures
    # the stress scene's atlas streamed into a tile pool, after one
    # update with feedback on part of its tiles
    host = make_stress_scene(n_objects=4, sphere_res=6, textured=True)
    mgr = JaxTileManager(_ref_atlas_of(host), pool_tiles=40,
                         tiles_per_frame=12)
    mgr.update(np.full(mgr.table_size, np.inf))
    fb = np.full(mgr.table_size, np.inf, np.float32)
    fb[::3] = 0.0
    ov = mgr.update(fb)
    ref = dict(_ref_atlas_of(host).to_device(), **ov)
    port_host = TP.make_stress_scene(n_objects=4, sphere_res=6,
                                     textured=True)
    port = dict(scene_atlas(port_host).to_device("cpu"),
                **residency_from_numpy(ov, "cpu"))
    return ref, port, host.num_textures


def _lookups(n_tex, seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    ent = rng.integers(-1, n_tex, size=(h, w)).astype(np.int32)
    ent[:, ::2] = ent[:, 1::2]                      # quads share a texture
    uv = rng.uniform(-2, 3, size=(h, w, 2)).astype(np.float32)
    # footprints from about a texel of a 512-px mip 0 to a few hundred
    scale = np.exp(rng.uniform(np.log(1e-3), np.log(0.3), size=(h, w, 1)))
    dx = (rng.normal(size=(h, w, 2)) * scale).astype(np.float32)
    dy = (rng.normal(size=(h, w, 2)) * scale).astype(np.float32)
    return ent, uv, dx, dy


def test_texel_index_matches_reference():
    """Resident tiles, fallbacks to a 2^delta coarser pinned tile and
    untiled desc rows, each at coordinates across its tile grid."""
    rng = np.random.default_rng(2)
    n = 4096
    rows = np.zeros((n, 4), np.int32)
    kind = rng.integers(0, 3, n)
    mw = rng.integers(1, 600, n).astype(np.int32)
    rows[:, 0] = rng.integers(0, 1 << 20, n)
    rows[:, 1] = mw
    rows[:, 2] = rng.integers(1, 600, n)
    rows[:, 3] = np.where(kind == 0, -1, rng.integers(0, 40, n))
    table = np.where(rng.uniform(size=64) < 0.5,
                     rng.integers(3, 200, 64),                # resident
                     (rng.integers(1, 4, 64) << 24)           # fallback
                     | rng.integers(3, 200, 64)).astype(np.int32)
    x = rng.integers(0, mw).astype(np.int32)
    y = rng.integers(0, rows[:, 2]).astype(np.int32)
    for with_table in (True, False):
        ref = {'tex_tile_table': jnp.asarray(table)} if with_table else {}
        port = {'tex_tile_table': t(table)} if with_table else {}
        want_idx, want_tid = JT._texel_index(ref, jnp.asarray(rows),
                                             jnp.asarray(x), jnp.asarray(y),
                                             jnp.asarray(mw))
        got_idx, got_tid = TT._texel_index(port, t(rows), t(x), t(y), t(mw))
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        if with_table:
            np.testing.assert_array_equal(got_tid.numpy(),
                                          np.asarray(want_tid))
            assert (got_tid.numpy() == -1).sum() == (kind == 0).sum()
            assert (np.asarray(want_tid) > 63).any()    # clamped lookups
        else:
            assert got_tid is None and want_tid is None


@pytest.mark.parametrize("name", ["seventy", "courtyard", "stress-tiled"])
def test_desc_samplers_match_reference(name):
    """Per-pixel (aniso 1 and 4) and quad-shared sampling through the
    descriptor rows (and the tile table), per-pixel wrap / base sizes
    gathered or given as the GBuffer gives them."""
    ref, port, n_tex = _atlases(name)
    ent, uv, dx, dy = _lookups(n_tex, 4)
    jargs = [jnp.asarray(a) for a in (ent, uv, dx, dy)]
    targs = [t(a) for a in (ent, uv, dx, dy)]
    tiled = 'tex_tile_table' in ref
    for aniso in (1, 4):
        want = JT.sample_material_maps(ref, *jargs, aniso=aniso)
        got = TT.sample_material_maps(port, *targs, aniso=aniso)
        for k in MAPS:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert ('tile_id' in got) == ('tile_id' in want) == tiled
        if tiled:
            np.testing.assert_array_equal(got['tile_id'].numpy(),
                                          np.asarray(want['tile_id']))
            assert (got['tile_id'].numpy() >= 0).mean() > 0.2
    safe = np.maximum(ent, 0)
    desc0 = np.asarray(ref['tex_desc']).reshape(-1, 11, 4)[safe, 0]
    wrap = np.asarray(ref['tex_wrap'])[safe].astype(np.int32)
    w0, h0 = (desc0[..., i].astype(np.float32) for i in (1, 2))
    want = JT.sample_material_maps_quad(
        ref, *jargs, wrap=jnp.asarray(wrap),
        base_wh=(jnp.asarray(w0), jnp.asarray(h0)))
    got = TT.sample_material_maps_quad(port, *targs, t(wrap),
                                       (t(w0), t(h0)))
    for k in MAPS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if tiled:
        np.testing.assert_array_equal(got['tile_id'].numpy(),
                                      np.asarray(want['tile_id']))


def test_sample_texture_matches_reference():
    ref, port, n_tex = _atlases('seventy')
    ent, uv, dx, dy = _lookups(n_tex, 6, h=8, w=64)
    want, want_mip = JT.sample_texture(
        ref, jnp.asarray(ent), jnp.asarray(uv), jnp.asarray(dx),
        jnp.asarray(dy), feedback=True)
    got, got_mip = TT.sample_texture(port, t(ent), t(uv), t(dx), t(dy),
                                     feedback=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_mip.numpy(), np.asarray(want_mip),
                               rtol=1e-5, atol=1e-6)
    # mip 0 without derivatives
    np.testing.assert_allclose(
        TT.sample_texture(port, t(ent), t(uv)).numpy(),
        np.asarray(JT.sample_texture(ref, jnp.asarray(ent),
                                     jnp.asarray(uv))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_tex", [3, 70])
def test_texture_feedback_matches_reference(n_tex):
    """Both of the reference's branches (<= 64 textures: masked
    reductions; more: segment min); ids past the count and -1 ignored,
    +inf for unused textures."""
    rng = np.random.default_rng(n_tex)
    ids = rng.integers(-1, n_tex + 3, size=(40, 56)).astype(np.int32)
    ids[ids == 1] = 2                               # texture 1 unused
    des = rng.normal(2.0, 3.0, size=(40, 56)).astype(np.float32)
    want = np.asarray(JT.texture_feedback(jnp.asarray(ids),
                                          jnp.asarray(des), n_tex))
    got = TT.texture_feedback(t(ids), t(des), n_tex).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[1]) and np.isfinite(got).sum() == n_tex - 1


def test_vt_tile_feedback_matches_reference():
    rng = np.random.default_rng(9)
    n = 300
    tid = rng.integers(-1, n, size=(64, 96)).astype(np.int32)
    tid[tid % 7 == 3] = -1                          # untouched tiles
    des = rng.normal(1.0, 2.0, size=(64, 96)).astype(np.float32)
    want = np.asarray(JT.vt_tile_feedback(jnp.asarray(tid), jnp.asarray(des),
                                          n))
    got = TT.vt_tile_feedback(t(tid), t(des), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got).sum() >= n // 7 and np.isfinite(got).any()
