"""Frames through the sun shadow map against the reference package's, on
the Cornell box at 384x216, the carry threaded over a slow camera pan:

* the map-shadowed frame (`shadow_technique='map'`, the bench's
  `shadowed_frame_ms` technique) with TAA, bloom and auto-exposure, and
  no static RT topology (the map needs none);
* the all-on frame with `gi_sun_technique='map'`: RT shadows, GTAO and
  DDGI (gi_update_phases 4, interval mode), its probe hits' sun taps
  read from the map instead of any-hit rays, four frames so that the
  fourth updates the probes (the port renders the map on that frame
  only: the hold frames read no sun tap).

Both packages get the same scene arrays, frame inputs and initial carry
(and in the all-on frame the same static RT and GI topologies, the
complete trees, as tests/test_torch_allon_frame.py gives them).  On the
CPU the reference renders its sun map through its dense XLA fill (caps
clamped at K = 1024), the port through the streamed caps and the peel
fill (the reference's accelerator branch); Cornell drops no caster on
either.  Tolerances: those of tests/test_torch_shadowed_frame.py and
tests/test_torch_allon_frame.py for the same frames -- the image within
1 on >= 99.9% of the pixels, ids on >= 99.95%, the shadow mask within
1e-3 on >= 99.9%, exposure within 1e-5 relative, AO within 1e-3 on
>= 99.9%, after the update the probe irradiance and distance within 1e-3
of their largest value on >= 99.5% of the texels.
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
from toyrenderer_tpu.ops import bvh_sah as JS
from toyrenderer_tpu.ops import ddgi as JD
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_bvh import _static_arrays
from test_torch_culling import _scene, t
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import RenderSettings, make_render_fn
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.ops import peel_cuda
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, rt_static_from_numpy)

W, H = 384, 216
YAW = 0.006
MAP = dict(width=W, height=H, manual_exposure=0.25, enable_shadows=True,
           shadow_technique='map', enable_taa=True, enable_bloom=True,
           enable_auto_exposure=True)
ALLON_MAP = dict(width=W, height=H, manual_exposure=0.25,
                 enable_shadows=True, enable_ao=True, enable_gi=True,
                 gi_update_phases=4, gi_sun_technique='map', enable_taa=True,
                 enable_bloom=True, enable_auto_exposure=True)
PROBES = dict(max_probes_axis=4, rays_per_probe=64)


@pytest.fixture(scope="module")
def cornell():
    sh, js, ts = _scene("cornell.gltf")
    pi, pm = static_meshlet_pairs(sh, 'all')
    return dict(sh=sh, js=js, ts=ts, pi=pi, pm=pm)


def _frames(c, kw, frames, jax_kw, port_kw):
    """`frames` frames of the pan in both packages: (reference image,
    aux, carry; port image, aux, carry) per frame."""
    jst = JaxSettings(**kw, shadow_max_steps=4096, gi_max_steps=4096)
    vol = jax_kw.pop('ddgi_volume', None)
    jframe = jax.jit(lambda s, a, b, f, cc, k: jax_render(
        s, a, b, f, cc, settings=jst, ddgi_volume=vol, **k))
    jc = jax_init_carry(c['js'], jst, vol)
    tc = carry_from_numpy({k: np.asarray(v) for k, v in jc.items()}, "cpu")
    render = make_render_fn(RenderSettings(**kw), device="cpu")
    view = JView.from_scene(c['sh'], W, H)
    out = []
    for _ in range(frames):
        mats = view.matrices()
        fi = jax_fi(c['sh'], mats)
        jimg, jc, jaux = jframe(c['js'], jnp.asarray(c['pi']),
                                jnp.asarray(c['pm']), fi, jc, jax_kw)
        img, tc, aux = render(c['ts'], t(c['pi']), t(c['pm']), fi, tc,
                              **port_kw)
        out.append((np.asarray(jimg), jaux, jc, img.numpy(), aux, tc))
        view.advance(mats)
        view.rotate_yaw_pitch(YAW, 0.0)
    return out


def _check_common(i, jimg, jaux, jc, img, aux, tc, map_drawn=True):
    diff = np.abs(img.astype(int) - jimg.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.999, (i, (diff <= 1).mean())
    ids = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
    assert ids >= 0.9995, (i, ids)
    sd = np.abs(aux['shadow'].numpy() - np.asarray(jaux['shadow']))
    assert (sd <= 1e-3).mean() >= 0.999, (i, (sd <= 1e-3).mean())
    np.testing.assert_allclose(float(tc['exposure']), float(jc['exposure']),
                               rtol=1e-5)
    # the port renders the sun map only on the frames that read it
    assert ('shadow_map_dropped' in aux) == map_drawn, i
    if map_drawn:
        assert int(aux['shadow_map_dropped']) == int(
            jaux['shadow_map_dropped']) == 0
    drops = {k: int(v) for k, v in aux.items() if k.endswith('dropped')}
    assert not any(drops.values()), drops


def test_map_shadowed_frame_matches_reference(cornell):
    peel_cuda.launches = 0
    frames = _frames(cornell, MAP, 3, {}, {})
    for i, (jimg, jaux, jc, img, aux, tc) in enumerate(frames):
        _check_common(i, jimg, jaux, jc, img, aux, tc)
        sh = aux['shadow'].numpy()[aux['depth'].numpy() > 0]
        assert 0.02 < sh.mean() < 0.98, sh.mean()
        if i > 0:
            assert 0.5 < float(aux['motion'].abs().max()) < 6.0
    assert peel_cuda.launches == 0      # CPU tensors ran the plain version


def test_allon_map_taps_frame_matches_reference(cornell):
    c = cornell
    rts = JB.build_rt_static(c['sh'], c['pi'], c['pm'])
    gi_rts, gpi, gpm, _ = JS.build_rt_static_gi(c['sh'], 'all')
    assert isinstance(gi_rts, JB.RtStatic)        # the CPU's complete tree
    jvol = JD.volume_from_aabb(*c['sh'].world_aabb, **PROBES)
    tvol = TD.volume_from_aabb(*c['sh'].world_aabb, **PROBES)
    jax_kw = dict(ddgi_volume=jvol, rt_static=rts, rt_static_gi=gi_rts,
                  gi_pair_inst=jnp.asarray(gpi), gi_pair_meshlet=jnp.asarray(
                      gpm))
    port_kw = dict(
        ddgi_volume=tvol,
        rt_static=rt_static_from_numpy(_static_arrays(rts), "cpu"),
        rt_static_gi=rt_static_from_numpy(_static_arrays(gi_rts), "cpu"),
        gi_pair_inst=t(np.asarray(gpi)), gi_pair_meshlet=t(np.asarray(gpm)))
    frames = _frames(c, ALLON_MAP, 4, jax_kw, port_kw)
    for i, (jimg, jaux, jc, img, aux, tc) in enumerate(frames):
        _check_common(i, jimg, jaux, jc, img, aux, tc, map_drawn=i == 3)
        d = np.abs(aux['ao'].numpy() - np.asarray(jaux['ao']))
        assert (d <= 1e-3).mean() >= 0.999, (i, (d <= 1e-3).mean())
        assert aux['ddgi_updated'] == (i == 3)
    _, _, jc, _, _, tc = frames[-1]
    for k in ('ddgi_irradiance', 'ddgi_distance'):
        a, b = tc[k].numpy(), np.asarray(jc[k])
        scale = max(float(np.abs(b).max()), 1e-6)
        assert (np.abs(a - b) <= 1e-3 * scale).mean() >= 0.995, k
    irr = tc['ddgi_irradiance'].numpy()
    assert np.isfinite(irr).all() and irr.max() > 0
