"""The streamed frame: the port's render_frame against the reference
package's, both fed the same residency overrides.

The reference's streaming manager runs on the reference's host atlas;
its overrides go to the reference frame as they are and to the port's
through `weights.residency_from_numpy` (u32 texels and table entries as
int32, bit for bit).  Each frame's feedback (the reference's) drives the
next update, as the render CLI and the bench chain do:

* the culled courtyard (the bench's deferred configuration, as
  tests/test_torch_culled_courtyard.py runs it) at 384x216 with the tile
  manager on a small pool (80 tiles: the 72 pinned fallbacks and 8
  more), two frames across two updates;
* the culled stress scene at 192x96 (tests/test_torch_culling.py's
  caps) with the mip manager, two frames across two updates, with its
  records encoded (the analytic atlas read through the managers' desc
  rows) and with `tex_analytic=False` forced on both scenes
  (unencoded records: the path of atlases with >= 64 entries).

Tolerances as tests/test_torch_frame.py holds frames: ids equal on
>= 99.95% of the pixels, the u8 image within 1 on >= 99.9%.  The
feedback (tex_feedback, vt_tile_feedback) is +inf at the same entries
and within 3e-3 mips where finite.  The feedback functions themselves
are exact on the same inputs (tests/test_torch_texture_desc.py), but in
a frame their input, the desired mip, is half the log2 of the squared
UV-derivative footprint, and the derivative planes differ between the
packages by up to 2e-3 relative: the reference's Pallas fill fetches
the records through hi/lo bf16 products and the derivatives subtract
near-equal interpolants (tests/test_torch_fill.py holds those planes to
2e-3, as tests/test_raster.py holds the reference's own two fills).
1.44 x 2e-3 mips (1 / ln 2 per relative unit) is under 3e-3.  Measured:
up to 3.3e-4 on the stress scene.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine import streaming as JS
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.engine.frame import render_frame as jax_render
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu.scene import textures as JX
from toyrenderer_tpu.scene.procedural import make_stress_scene

from test_torch_culling import _scene, t
from test_torch_raster import _one_torch_thread, scene_arrays  # noqa: F401
from toyrenderer_tpu_torch.engine import RenderSettings, make_render_fn
from toyrenderer_tpu_torch.engine.capacity import (
    culled_pair_counts, sized_culled_settings)
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, frame_inputs_from_numpy, residency_from_numpy,
    scene_from_numpy)


def _host_atlas(sh):
    return JX.TextureAtlas(
        texels=sh.tex_texels, desc_offset=sh.tex_offset,
        desc_width=sh.tex_width, desc_height=sh.tex_height,
        num_mips=sh.tex_num_mips, wrap_mode=sh.tex_wrap,
        min_resident_mip=sh.tex_min_mip, num_textures=sh.num_textures)


def _close_feedback(got, want, key):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, key
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=key)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want),
                                  err_msg=key)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=3e-3,
                               err_msg=key)
    return int(fin.sum())


def _stream_both(sh, js, ts, jst, st, pairs, mask, mgr, fb_key, view,
                 frames=2):
    """`frames` frames of `view` in both packages on the reference
    manager's overrides, each frame's reference feedback driving the
    next update.  Returns the per-frame (finite feedback entries,
    manager stats)."""
    pi, pm = pairs
    n_fb = mgr.table_size if fb_key == 'vt_tile_feedback' else js.num_textures
    ov = mgr.update(np.full(n_fb, np.inf))
    jc = jax_init_carry(js, jst)
    tc = carry_from_numpy({k: tuple(map(np.asarray, v))
                           if isinstance(v, tuple) else np.asarray(v)
                           for k, v in jc.items()}, "cpu")
    jframe = jax.jit(lambda s, a, b, f, c, m: jax_render(
        s, a, b, f, c, settings=jst, **m))
    render = make_render_fn(st, device="cpu")
    jmask = {k: jnp.asarray(v) for k, v in mask.items()}
    tmask = {k: t(v) for k, v in mask.items()}
    out = []
    for _ in range(frames):
        mats = view.matrices()
        fi = jax_fi(sh, mats)
        jfi = dict(fi, **{k: jnp.asarray(v) for k, v in ov.items()})
        tfi = dict(frame_inputs_from_numpy(fi, "cpu"),
                   **residency_from_numpy(ov, "cpu"))
        jimg, jc, jaux = jframe(js, jnp.asarray(pi), jnp.asarray(pm), jfi,
                                jc, jmask)
        img, tc, aux = render(ts, t(pi), t(pm), tfi, tc, **tmask)
        view.advance(mats)
        ids_eq = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
        assert ids_eq >= 0.9995, ids_eq
        diff = np.abs(img.numpy().astype(int)
                      - np.asarray(jimg).astype(int)).max(-1)
        assert (diff <= 1).mean() >= 0.999, (diff <= 1).mean()
        assert ('vt_tile_feedback' in aux) == ('vt_tile_feedback' in jaux)
        n_fin = {k: _close_feedback(aux[k], jaux[k], k)
                 for k in ('tex_feedback', 'vt_tile_feedback') if k in jaux}
        ov = mgr.update(np.asarray(jaux[fb_key]))
        out.append((n_fin, dict(mgr.stats)))
    return out


def test_streamed_courtyard_matches_reference():
    """The culled courtyard seen from near the floor (the camera 0.8
    lower and pitched 0.6 rad down, so the floor's textures want their
    tiled mips 0 and 1) on a tile pool of 80 (72 pinned): the first
    feedback loads the 8 free slots' tiles, the second frame samples
    them."""
    sh, js, ts = _scene("courtyard.glb")
    w, h = 384, 216
    view = JView.from_scene(sh, w, h)
    view.rotate_yaw_pitch(0.0, -0.6)
    view.move(up=-0.8)
    mk_i, mk_m = static_meshlet_pairs(sh, 'mask')
    pi, pm = static_meshlet_pairs(sh, 'not_mask')
    cap = max(int(len(pi) * 0.6), 256)
    pi, pm = pi[:cap], pm[:cap]
    bench_kw = dict(width=w, height=h, manual_exposure=0.25,
                    enable_culling=True, peel_merge_frac=0.10)
    bench = RenderSettings(**bench_kw)
    tfi = frame_inputs_from_numpy(jax_fi(sh, dataclasses.replace(
        view).matrices()), "cpu")
    st = sized_culled_settings(bench, culled_pair_counts(
        ts, tfi, bench, cap, (t(mk_i), t(mk_m))))
    jst = JaxSettings(**bench_kw, use_pallas_fill=True, **{
        k: getattr(st, k)
        for k in ('max_tris_per_tile', 'max_big_tris', 'pair_capacity')})
    mgr = JS.TileStreamingManager(_host_atlas(sh), pool_tiles=80)
    assert mgr.stats['resident_tiles'] == 72
    rows = _stream_both(sh, js, ts, jst, st, (pi, pm),
                        dict(mask_pair_inst=mk_i, mask_pair_meshlet=mk_m),
                        mgr, 'vt_tile_feedback', view)
    (fin0, stats0), (fin1, _) = rows
    assert fin0['vt_tile_feedback'] > 0 and fin1['tex_feedback'] > 0
    assert stats0['tile_loads'] == 80                # refinement happened


@pytest.mark.parametrize("analytic", [True, False],
                         ids=["encoded", "unencoded"])
def test_streamed_stress_matches_reference(analytic):
    sh = make_stress_scene(n_objects=16, sphere_res=10, seed=5,
                           textured=True)
    js = sh.to_device()
    ts = scene_from_numpy(scene_arrays(js), "cpu")
    if not analytic:
        js = dataclasses.replace(js, tex_analytic=False)
        ts = dataclasses.replace(ts, tex_analytic=False)
    assert js.num_textures == 3
    pi, pm = static_meshlet_pairs(sh)
    common = dict(width=192, height=96, manual_exposure=0.1,
                  enable_culling=True, max_tris_per_tile=256,
                  max_big_tris=64, tile_batch=4)
    mgr = JS.TextureStreamingManager(_host_atlas(sh), pool_texels=1 << 17,
                                     textures_per_frame=2)
    rows = _stream_both(sh, js, ts, JaxSettings(**common,
                                                use_pallas_fill=True),
                        RenderSettings(**common), (pi, pm), {}, mgr,
                        'tex_feedback', JView.from_scene(sh, 192, 96))
    assert rows[0][0]['tex_feedback'] > 0
    assert rows[-1][1]['loads'] > rows[0][1]['loads'] - 1
