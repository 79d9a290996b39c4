"""The slice's whole frame -- RT sun shadows (the tree refit every frame,
half-resolution checkerboard rays, the denoiser), bloom, auto-exposure
and TAA -- against the reference package's frame, three frames of a slow
camera pan with the carry threaded.

* Cornell at 448x256, unculled (the reference's XLA fill path).
* The courtyard at 384x216, culled (the bench's configuration: 2-phase
  culling, the compact masked merge, the early list cut to 60% of LOD0,
  capacities from the port's probe), the reference through its Pallas
  fills in interpret mode.  Its RT tree holds the instances within 12
  units of the camera (with their masked pairs): the whole courtyard's
  tree is too slow to trace on a CPU in a test.

Both packages get the same scene arrays, frame inputs, initial carry and
static RT topology (the reference's, carried across by
weights.rt_static_from_numpy).  On the CPU the reference traces with its
XLA lockstep traversal, given a step budget (4096) no ray reaches, and
resamples TAA and denoiser history with its bilinear gather; the port
runs its kernels' semantics (the warp, its fast-motion rejection).  The
pan moves pixels by ~2 px a frame, where the two resamples agree.

Tolerances.  Cornell: the u8 image within 1 on >= 99.9% of the pixels,
ids on >= 99.95%, the denoised shadow mask within 1e-3 on >= 99.9%,
exposure and its target within 1e-5 relative.  The courtyard: ids on
>= 99.95% as tests/test_torch_frame.py holds them; the image within 1 on
>= 99.7% and the shadow mask within 1e-3 on >= 99%, exposure within
1e-3 relative (measured over the 3 frames: image 99.80-99.88%, shadow
99.37-99.92%, exposure 1.7e-4).  Two sources, both outside this slice's
code, which tests/test_torch_shadows.py holds exact on identical inputs
(no traced pixel differs):
* the geometry stage's 4x4 products round differently in the two
  packages (XLA fuses multiply-adds, PyTorch does not), so depth, and
  the world position rebuilt from it, differ by ~1e-6 relative; a shadow
  ray whose origin moved that much may pass on the other side of a leaf
  or a cornice edge (the foliage's shadows have many edges).  One flipped
  half-resolution ray is 2x2 pixels, which the 5-tap blur spreads to
  ~30, and the exposure of frame 0 follows the HDR it sees;
* the textured quad sampler differs on ~0.05% of the pixels (ROADMAP
  queue 3, the silhouette planes).
TAA and the denoiser's histories then carry both into the next frames.
No drops, in either scene.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.engine.frame import render_frame as jax_render
from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_bvh import _near, _static_arrays
from test_torch_culling import _scene, t
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, init_carry, make_render_fn)
from toyrenderer_tpu_torch.engine.capacity import (
    culled_pair_counts, sized_culled_settings)
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, frame_inputs_from_numpy, rt_static_from_numpy)

FRAMES = 3
POST = dict(manual_exposure=0.25, enable_shadows=True, enable_taa=True,
            enable_bloom=True, enable_auto_exposure=True)


def _run(name, w, h, culled, yaw):
    sh, js, ts = _scene(name)
    mk_i, mk_m = static_meshlet_pairs(sh, 'mask')
    pi, pm = static_meshlet_pairs(sh, 'not_mask' if len(mk_i) else 'all')
    rt_pi, rt_pm, rt_mi, rt_mm = pi, pm, mk_i, mk_m
    if culled:
        keep, mkeep = _near(sh, pi, 12.0), _near(sh, mk_i, 12.0)
        rt_pi, rt_pm, rt_mi, rt_mm = pi[keep], pm[keep], mk_i[mkeep], \
            mk_m[mkeep]
        cap = max(int(len(pi) * 0.6), 256)
        pi, pm = pi[:cap], pm[:cap]
    rts = JB.build_rt_static(sh, rt_pi, rt_pm, mask_pair_inst=rt_mi,
                             mask_pair_meshlet=rt_mm)
    kw = dict(width=w, height=h, **POST)
    if culled:
        kw.update(enable_culling=True, peel_merge_frac=0.10)
    st = RenderSettings(**kw)
    view = JView.from_scene(sh, w, h)
    if culled:
        fi0 = jax_fi(sh, JView.from_scene(sh, w, h).matrices())
        counts = culled_pair_counts(ts, frame_inputs_from_numpy(fi0, "cpu"),
                                    st, len(pi), (t(mk_i), t(mk_m)))
        st = sized_culled_settings(st, counts)
        for c in counts.values():
            assert not any(c['drop'].values()), c['drop']
        jst = JaxSettings(**kw, use_pallas_fill=True, shadow_max_steps=4096,
                          **{k: getattr(st, k) for k in (
                              'max_tris_per_tile', 'max_big_tris',
                              'pair_capacity')})
    else:
        jst = JaxSettings(**kw, shadow_max_steps=4096)

    mask = dict(mask_pair_inst=jnp.asarray(mk_i),
                mask_pair_meshlet=jnp.asarray(mk_m))
    jframe = jax.jit(lambda s, a, b, f, c, m, r: jax_render(
        s, a, b, f, c, settings=jst, rt_static=r, **m))
    jc = jax_init_carry(js, jst)
    tc = carry_from_numpy({k: tuple(map(np.asarray, v))
                           if isinstance(v, tuple) else np.asarray(v)
                           for k, v in jc.items()}, "cpu")
    render = make_render_fn(st, device="cpu")
    trs = rt_static_from_numpy(_static_arrays(rts), "cpu")
    out = []
    for _ in range(FRAMES):
        mats = view.matrices()
        fi = jax_fi(sh, mats)
        jimg, jc, jaux = jframe(js, jnp.asarray(pi), jnp.asarray(pm), fi, jc,
                                mask, rts)
        img, tc, aux = render(ts, t(pi), t(pm), fi, tc,
                              mask_pair_inst=t(mk_i),
                              mask_pair_meshlet=t(mk_m), rt_static=trs)
        out.append((np.asarray(jimg), jaux, float(jc['exposure']),
                    img.numpy(), aux, float(tc['exposure'])))
        view.advance(mats)
        view.rotate_yaw_pitch(yaw, 0.0)
    return out


@pytest.mark.parametrize("name,w,h,culled,yaw,img_share,shadow_share,exp_tol", [
    ("cornell.gltf", 448, 256, False, 0.006, 0.999, 0.999, 1e-5),
    ("courtyard.glb", 384, 216, True, 0.008, 0.997, 0.99, 1e-3),
])
def test_shadowed_frame_matches_reference(name, w, h, culled, yaw,
                                          img_share, shadow_share, exp_tol):
    frames = _run(name, w, h, culled, yaw)
    for i, (jimg, jaux, jexp, img, aux, exp) in enumerate(frames):
        diff = np.abs(img.astype(int) - jimg.astype(int)).max(-1)
        assert (diff <= 1).mean() >= img_share, (i, (diff <= 1).mean())
        ids = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
        assert ids >= 0.9995, (i, ids)
        sd = np.abs(aux['shadow'].numpy() - np.asarray(jaux['shadow']))
        assert (sd <= 1e-3).mean() >= shadow_share, (i, (sd <= 1e-3).mean())
        np.testing.assert_allclose(exp, jexp, rtol=exp_tol)
        np.testing.assert_allclose(float(aux['target_exposure']),
                                   float(jaux['target_exposure']),
                                   rtol=exp_tol)
        drops = {k: int(v) for k, v in aux.items() if k.endswith('dropped')}
        assert drops and not any(drops.values()), drops
        # the shadow term does work: the lit side is neither all lit nor
        # all dark; after the first frame (whose carry holds identity
        # instance matrices, so its history is not used) the motion stays
        # where the two history resamples agree
        sh = aux['shadow'].numpy()[aux['depth'].numpy() > 0]
        assert 0.02 < sh.mean() < 0.98, sh.mean()
        if i > 0:
            assert 0.5 < float(aux['motion'].abs().max()) < 6.0
        assert aux['bloom'].shape == (h, w, 3)


def test_init_carry_matches_reference():
    """The carry of the slice's settings: TAA and shadow histories, their
    validity, the HZB, the exposure."""
    sh, js, ts = _scene("cornell.gltf")
    kw = dict(width=64, height=32, enable_culling=True, **POST)
    want = jax_init_carry(js, JaxSettings(**kw))
    got = init_carry(ts, RenderSettings(**kw))
    assert got.keys() == want.keys()
    for k in want:
        if k == 'hzb':
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_shadows_need_the_static_tree():
    """RT shadows without a static topology: the frame rebuilds the tree
    every frame (bvh.build_bvh, the reference's per-frame morton path)
    instead of refitting one, and matches the reference's frame, which
    does the same (Cornell at 128x64, 2 frames of the pan; the
    tolerances of the Cornell case above)."""
    sh, js, ts = _scene("cornell.gltf")
    pi, pm = static_meshlet_pairs(sh, 'all')
    w, h = 128, 64
    kw = dict(width=w, height=h, **POST)
    jst = JaxSettings(**kw, shadow_max_steps=4096)
    jframe = jax.jit(lambda s, a, b, f, c: jax_render(s, a, b, f, c,
                                                      settings=jst))
    jc = jax_init_carry(js, jst)
    tc = carry_from_numpy({k: np.asarray(v) for k, v in jc.items()}, "cpu")
    render = make_render_fn(RenderSettings(**kw), device="cpu")
    view = JView.from_scene(sh, w, h)
    for i in range(2):
        mats = view.matrices()
        fi = jax_fi(sh, mats)
        jimg, jc, jaux = jframe(js, jnp.asarray(pi), jnp.asarray(pm), fi, jc)
        img, tc, aux = render(ts, t(pi), t(pm), fi, tc)
        view.advance(mats)
        view.rotate_yaw_pitch(0.006, 0.0)
        diff = np.abs(img.numpy().astype(int)
                      - np.asarray(jimg).astype(int)).max(-1)
        assert (diff <= 1).mean() >= 0.999, (i, (diff <= 1).mean())
        sd = np.abs(aux['shadow'].numpy() - np.asarray(jaux['shadow']))
        assert (sd <= 1e-3).mean() >= 0.999, (i, (sd <= 1e-3).mean())
        sh_lit = aux['shadow'].numpy()[aux['depth'].numpy() > 0]
        assert 0.02 < sh_lit.mean() < 0.98, sh_lit.mean()
