"""The port's RT sun shadows (noise, cone sampling, the shadow rays, the
checkerboard half-grid, the frame's half-resolution ray setup) and the
shadow denoiser against the reference package's.

The inputs are a real surface: the cornell box's and a courtyard
subset's depth and normals, ray-cast from the scene's camera through the
port's own traversal (closest hit), handed to both packages as numpy.
Both trace through one tree, the reference's refit carried across.  On
the CPU the reference traces with its XLA lockstep traversal; its step
budget is raised to 4096, which no ray reaches, so that no ray of its
is cut short and reported lit (the port's kernel, like the reference's,
has no budget).

Tolerances: the noise and the sample directions to 1e-6 (the same f32
operations; sin, cos and the norm may round an ulp apart); the shadow
rays' lit/shadowed values equal on >= 99.9% of the pixels, because a ray
whose direction moved by an ulp may graze past an edge in one package
and not the other (counted; measured: 0 pixels differ in every case);
the denoised mask within 2e-5, both packages given the same traced
mask.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.mathlib.transforms import normalize as jnormalize
from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import denoise as JD
from toyrenderer_tpu.ops import geometry as JG
from toyrenderer_tpu.ops import shadows as JS
from toyrenderer_tpu.ops.lighting import world_pos_from_depth as jwp
from toyrenderer_tpu.ops.texture import _quad_expand_ch
from toyrenderer_tpu.scene import load_scene as jax_load_scene

from test_torch_bvh import _jax_inst_world, _near
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import RenderSettings
from toyrenderer_tpu_torch.engine.frame import _shadow_raw
from toyrenderer_tpu_torch.ops import bvh_cuda as TBC
from toyrenderer_tpu_torch.ops import denoise as TD
from toyrenderer_tpu_torch.ops import shadows as TS
from toyrenderer_tpu_torch.weights import bvh_from_numpy

W, H = 192, 128


def t(x):
    return torch.from_numpy(np.array(x))


def _surface(jh, radius):
    """(reference tree, port tree, frame inputs, depth (H, W), normal
    (H, W, 3)): the scene's RT tree under the rest pose, and the depth
    and geometric normals the camera sees, ray-cast through that tree."""
    mk_i, mk_m = JG.static_meshlet_pairs(jh, 'mask')
    pi, pm = JG.static_meshlet_pairs(jh, 'not_mask' if len(mk_i) else 'all')
    kw = {}
    if radius is not None:
        keep, mkeep = _near(jh, pi, radius), _near(jh, mk_i, radius)
        pi, pm = pi[keep], pm[keep]
        kw = dict(mask_pair_inst=mk_i[mkeep], mask_pair_meshlet=mk_m[mkeep])
    rts = JB.build_rt_static(jh, pi, pm, **kw)
    jb = JB.refit_bvh(rts, jnp.asarray(_jax_inst_world(jh)))
    tb = bvh_from_numpy(dict(child_boxes=np.asarray(jb.child_boxes),
                             leaf_rows=np.asarray(jb.leaf_rows),
                             level_offset=jb.level_offset,
                             num_levels=jb.num_levels), 'cpu')
    fi = jax_fi(jh, JView.from_scene(jh, W, H).matrices())
    inv_vp, vp = fi['inv_view_proj'], fi['view_proj_nojitter']
    py, px = np.mgrid[0:H, 0:W].astype(np.float32) + 0.5
    ndc = np.stack([px / W * 2 - 1, (0.5 - py / H) * 2,
                    np.ones_like(px), np.ones_like(px)], -1)
    far = ndc @ inv_vp.T
    far = far[..., :3] / far[..., 3:]
    cam = fi['cam_pos']
    d = far - cam
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(cam, d.shape).reshape(-1, 3).astype(np.float32)
    res = TBC.traverse_plain(tb, t(o), t(d.reshape(-1, 3)), 1e4)
    hit = res['hit'].numpy().reshape(H, W)
    p = cam + d * res['t'].numpy().reshape(H, W, 1)
    clip = np.concatenate([p, np.ones_like(p[..., :1])], -1) @ vp.T
    depth = np.where(hit, clip[..., 2] / clip[..., 3], 0.0).astype(
        np.float32)
    rows = tb.leaf_rows.numpy().reshape(-1, 10, 12).transpose(0, 2, 1)
    rows = rows.reshape(-1, 10)
    by_pay = dict(zip(rows[:, 9].astype(int), range(len(rows))))
    slot = np.asarray([by_pay.get(k, 0) for k in res['tri'].numpy()])
    n = np.cross(rows[slot, 3:6], rows[slot, 6:9]).reshape(H, W, 3)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = np.where((n * d).sum(-1, keepdims=True) > 0, -n, n)   # face camera
    n = np.where(hit[..., None], n, 0.0).astype(np.float32)
    return jb, tb, fi, depth, n


@pytest.fixture(scope="module", params=[("cornell.gltf", None),
                                        ("courtyard.glb", 12.0)],
                ids=["cornell", "courtyard"])
def surface(request):
    name, radius = request.param
    return _surface(jax_load_scene(f"resources/{name}", use_cache=False),
                    radius)


def test_noise_and_cone_sampling_match_reference():
    for f in (0, 1, 17, 63, 64, 201):
        want = np.asarray(JS.interleaved_gradient_noise(
            48, 80, jnp.asarray(f, jnp.int32)))
        got = TS.interleaved_gradient_noise(
            48, 80, torch.tensor(f, dtype=torch.int32)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:5, 2] = -1.0                            # the basis's z < 0 branch
    r1, r2 = (rng.uniform(size=500).astype(np.float32) for _ in range(2))
    for half in (TS.SUN_ANGULAR_RADIUS, 0.2):
        want = np.asarray(JS.cone_sample(jnp.asarray(d), jnp.asarray(r1),
                                         jnp.asarray(r2), half))
        got = TS.cone_sample(t(d), t(r1), t(r2), half).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_checkerboard_pack_unpack_match_reference():
    rng = np.random.default_rng(3)
    imgs = (rng.uniform(size=(6, 10)).astype(np.float32),
            rng.uniform(size=(6, 10, 3)).astype(np.float32))
    for par in (0, 1):
        jp = JS.checkerboard_pack(tuple(map(jnp.asarray, imgs)),
                                  jnp.int32(par))
        tp = TS.checkerboard_pack(tuple(map(t, imgs)),
                                  torch.tensor(par, dtype=torch.int32))
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        traced = np.asarray(jp[0])
        np.testing.assert_array_equal(
            TS.checkerboard_unpack(t(traced), torch.tensor(
                par, dtype=torch.int32)).numpy(),
            np.asarray(JS.checkerboard_unpack(jnp.asarray(traced),
                                              jnp.int32(par))))


def _agree(got, want, min_share=0.999):
    same = np.isclose(got, want, rtol=0, atol=1e-6)
    assert same.mean() >= min_share, (same.mean(), int((~same).sum()))
    return same


def test_trace_shadow_mask_matches_reference(surface):
    jb, tb, fi, depth, n = surface
    wp = np.asarray(jwp(jnp.asarray(depth), fi['inv_view_proj'], W, H))
    to_light = -fi['sun_direction']
    for frame in (0, 5):
        want = np.asarray(JS.trace_shadow_mask(
            jb, jnp.asarray(wp), jnp.asarray(n), jnp.asarray(depth > 0),
            jnp.asarray(to_light), jnp.asarray(frame, jnp.int32),
            max_steps=4096))
        got = TS.trace_shadow_mask(
            tb, t(wp), t(n), t(depth > 0), t(to_light),
            torch.tensor(frame, dtype=torch.int32)).numpy()
        _agree(got, want)
        lit_side = (depth > 0) & ((n * to_light).sum(-1) > 0)
        assert 0.0 < got[lit_side].mean() < 1.0    # some lit, some shadowed
    # the strip layout (TR_SHADOW_GDIR=1: one cone sample per 64x2 strip,
    # traced through the grouped-direction route) against the
    # reference's, read from the switch in both packages
    mp = pytest.MonkeyPatch()
    mp.setenv("TR_SHADOW_GDIR", "1")
    try:
        want = np.asarray(JS.trace_shadow_mask(
            jb, jnp.asarray(wp), jnp.asarray(n), jnp.asarray(depth > 0),
            jnp.asarray(to_light), jnp.asarray(3, jnp.int32),
            max_steps=4096))
        got = TS.trace_shadow_mask(
            tb, t(wp), t(n), t(depth > 0), t(to_light),
            torch.tensor(3, dtype=torch.int32)).numpy()
    finally:
        mp.undo()
    _agree(got, want)
    per_px = TS.trace_shadow_mask(tb, t(wp), t(n), t(depth > 0), t(to_light),
                                  torch.tensor(3, dtype=torch.int32),
                                  gdir=False).numpy()
    # the reference's own bound (tests/test_shadows.py:185-191): the
    # strip noise moves < 5% of the pixels against the per-pixel cone
    assert (got != per_px).mean() < 0.05
    # at half_angle=0 both layouts trace the sun direction itself
    flat = [TS.trace_shadow_mask(tb, t(wp), t(n), t(depth > 0), t(to_light),
                                 torch.tensor(3, dtype=torch.int32),
                                 half_angle=0.0, gdir=g).numpy()
            for g in (False, True)]
    np.testing.assert_array_equal(flat[0], flat[1])


def _jax_half_res_raw(jb, fi, depth, n, frame, checkerboard):
    """The reference frame's half-resolution ray setup (frame.py:830-880):
    quad max depth, quad mean normal, the checkerboard half-grid, the
    trace, the expansion back."""
    sc = 2
    d_h = jax.lax.reduce_window(jnp.asarray(depth), -jnp.inf, jax.lax.max,
                                (sc, sc), (sc, sc), 'VALID')
    wp_h = jwp(d_h, fi['inv_view_proj'], W // sc, H // sc)
    n_h = jnormalize(jax.lax.reduce_window(
        jnp.asarray(n), 0.0, jax.lax.add, (sc, sc, 1), (sc, sc, 1),
        'VALID') * (1.0 / (sc * sc)))
    fidx = jnp.asarray(frame, jnp.int32)
    to_light = jnp.asarray(-fi['sun_direction'])
    if checkerboard:
        par = (fidx % 2).astype(jnp.int32)
        d_c, wp_c, n_c = JS.checkerboard_pack((d_h, wp_h, n_h), par)
        raw_h = JS.checkerboard_unpack(JS.trace_shadow_mask(
            jb, wp_c, n_c, d_c > 0.0, to_light, fidx, max_steps=4096), par)
    else:
        raw_h = JS.trace_shadow_mask(jb, wp_h, n_h, d_h > 0.0, to_light,
                                     fidx, max_steps=4096)
    return np.asarray(_quad_expand_ch(raw_h[..., None])[..., 0])


@pytest.mark.parametrize("checkerboard", [True, False])
def test_half_res_shadow_rays_match_reference(surface, checkerboard):
    """The frame's ray setup at shadow_ray_scale 2, checkerboard on and
    off, both frame parities."""
    jb, tb, fi, depth, n = surface
    st = RenderSettings(width=W, height=H, enable_shadows=True,
                        shadow_checkerboard=checkerboard)
    tfi = {k: t(fi[k]) for k in ('inv_view_proj', 'sun_direction')}
    for frame in (0, 1):
        want = _jax_half_res_raw(jb, fi, depth, n, frame, checkerboard)
        got = _shadow_raw(tb, t(n), t(depth),
                          tfi, dict(frame_index=torch.tensor(
                              frame, dtype=torch.int32)), st).numpy()
        assert got.shape == (H, W)
        _agree(got, want)


def test_denoise_shadow_matches_reference(surface):
    """The denoiser on a traced mask, with the camera's depth and a
    previous depth a pixel to the side (real disocclusion edges)."""
    jb, tb, fi, depth, n = surface
    wp = np.asarray(jwp(jnp.asarray(depth), fi['inv_view_proj'], W, H))
    raw = TS.trace_shadow_mask(tb, t(wp), t(n), t(depth > 0),
                               t(-fi['sun_direction']),
                               torch.tensor(3, dtype=torch.int32)).numpy()
    rng = np.random.default_rng(4)
    hist = rng.uniform(size=(H, W)).astype(np.float32)
    prev = np.roll(depth, 1, axis=1)
    mot = np.zeros((H, W, 2), np.float32)
    mot[..., 0] = 1.0
    mot[..., 1] = rng.uniform(-0.5, 0.5, size=(H, W))
    for valid in (0.0, 1.0):
        jw, jh = JD.denoise_shadow(
            jnp.asarray(raw), jnp.asarray(mot), jnp.asarray(hist),
            jnp.float32(valid), jnp.asarray(depth), jnp.asarray(prev))
        tw, th = TD.denoise_shadow(t(raw), t(mot), t(hist),
                                   torch.tensor(valid), t(depth), t(prev))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=2e-5)
