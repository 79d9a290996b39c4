"""The bench's all-on frame -- RT sun shadows, GTAO, DDGI on its own GI
tree (gi_update_phases 4, interval mode, the probe-hit sun taps by
any-hit rays), TAA, bloom, auto-exposure -- against the reference
package's frame: cornell at 448x256, four frames of a slow camera pan
with the carry threaded, so that the fourth updates the probes.

Both packages get the same scene arrays, frame inputs, initial carry,
static RT topology and static GI topology: the complete tree
(bvh_sah.build_rt_static_gi(sah=False); the reference's, carried across
by weights.rt_static_from_numpy), because the reference's SAH walk runs
only as a Pallas kernel.  On the CPU the reference traces with its XLA
lockstep traversal, given a step budget (4096) no ray reaches.  A small
probe grid (4 probes on the longest side, 64 rays per probe).

Tolerances.  The image within 1 on >= 99.9% of the pixels, ids on
>= 99.95%, the shadow mask within 1e-3 on >= 99.9% (as
tests/test_torch_shadowed_frame.py holds the same frame without AO and
GI); AO within 1e-3 on >= 99.9% of the pixels (tests/test_torch_gtao.py
bounds the pass itself); after the update, the probe irradiance and
distance moments within 1e-3 relative to their largest value on
>= 99.5% of the texels, the offsets and states equal, the variability
within 1e-4 relative.  The probe values are sums over 64 rays each, so
one ray whose hit moves between the packages (the geometry's rounding,
see test_torch_shadowed_frame.py) moves a probe's texels.

Then the port's frame on the SAH GI tree against its own frame on the
complete tree of the same pairs: closest-hit is a function of the
triangles, not of the tree (tests/test_torch_bvh_sah.py), so the two
frames are equal, image and probes.
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
from toyrenderer_tpu_torch.engine import (
    RenderSettings, init_carry, make_render_fn)
from toyrenderer_tpu_torch.ops import bvh_sah as TS
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, rt_static_from_numpy)

W, H = 448, 256
FRAMES = 4
YAW = 0.006
ALLON = dict(width=W, height=H, manual_exposure=0.25, enable_shadows=True,
             enable_ao=True, enable_gi=True, gi_update_phases=4,
             enable_taa=True, enable_bloom=True, enable_auto_exposure=True)
PROBES = dict(max_probes_axis=4, rays_per_probe=64)
GI_KEYS = ('ddgi_irradiance', 'ddgi_distance', 'ddgi_offset', 'ddgi_state',
           'ddgi_variability', 'ddgi_var_ring', 'ddgi_var_accum',
           'ddgi_var_samples')


@pytest.fixture(scope="module")
def cornell():
    sh, js, ts = _scene("cornell.gltf")
    pi, pm = static_meshlet_pairs(sh, 'all')
    rts = JB.build_rt_static(sh, pi, pm)
    gi_rts, gpi, gpm, lod = JS.build_rt_static_gi(sh, 'all')
    assert isinstance(gi_rts, JB.RtStatic)        # the CPU's complete tree
    return dict(sh=sh, js=js, ts=ts, pi=pi, pm=pm, rts=rts, gi_rts=gi_rts,
                gpi=np.asarray(gpi), gpm=np.asarray(gpm), lod=lod,
                jvol=JD.volume_from_aabb(*sh.world_aabb, **PROBES),
                tvol=TD.volume_from_aabb(*sh.world_aabb, **PROBES))


def _views(sh):
    view = JView.from_scene(sh, W, H)
    out = []
    for _ in range(FRAMES):
        mats = view.matrices()
        out.append(jax_fi(sh, mats))
        view.advance(mats)
        view.rotate_yaw_pitch(YAW, 0.0)
    return out


def _port_frames(c, gi_static, gi_pairs):
    st = RenderSettings(**ALLON)
    render = make_render_fn(st, device="cpu")
    jc = jax_init_carry(c['js'], JaxSettings(**ALLON), c['jvol'])
    tc = carry_from_numpy({k: np.asarray(v) for k, v in jc.items()}, "cpu")
    out = []
    for fi in _views(c['sh']):
        img, tc, aux = render(
            c['ts'], t(c['pi']), t(c['pm']), fi, tc,
            rt_static=rt_static_from_numpy(_static_arrays(c['rts']), "cpu"),
            ddgi_volume=c['tvol'], rt_static_gi=gi_static,
            gi_pair_inst=gi_pairs[0], gi_pair_meshlet=gi_pairs[1])
        out.append((img.numpy(), aux, {k: tc[k].numpy() for k in GI_KEYS},
                    float(tc['exposure'])))
    return out


@pytest.fixture(scope="module")
def port_complete(cornell):
    c = cornell
    return _port_frames(c, rt_static_from_numpy(_static_arrays(c['gi_rts']),
                                                "cpu"),
                        (t(c['gpi']), t(c['gpm'])))


def test_init_carry_matches_reference(cornell):
    want = jax_init_carry(cornell['js'], JaxSettings(**ALLON),
                          cornell['jvol'])
    got = init_carry(cornell['ts'], RenderSettings(**ALLON), cornell['tvol'])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_allon_frame_matches_reference(cornell, port_complete):
    c = cornell
    jst = JaxSettings(**ALLON, shadow_max_steps=4096, gi_max_steps=4096)
    jframe = jax.jit(lambda s, a, b, f, cc, r, g, gi, gm: jax_render(
        s, a, b, f, cc, settings=jst, ddgi_volume=c['jvol'], rt_static=r,
        rt_static_gi=g, gi_pair_inst=gi, gi_pair_meshlet=gm))
    jc = jax_init_carry(c['js'], jst, c['jvol'])
    for i, fi in enumerate(_views(c['sh'])):
        jimg, jc, jaux = jframe(c['js'], jnp.asarray(c['pi']),
                                jnp.asarray(c['pm']), fi, jc, c['rts'],
                                c['gi_rts'], jnp.asarray(c['gpi']),
                                jnp.asarray(c['gpm']))
        img, aux, probes, exp = port_complete[i]
        diff = np.abs(img.astype(int) - np.asarray(jimg).astype(int)).max(-1)
        assert (diff <= 1).mean() >= 0.999, (i, (diff <= 1).mean())
        ids = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
        assert ids >= 0.9995, (i, ids)
        for k, share in (('shadow', 0.999), ('ao', 0.999)):
            d = np.abs(aux[k].numpy() - np.asarray(jaux[k]))
            assert (d <= 1e-3).mean() >= share, (i, k, (d <= 1e-3).mean())
        np.testing.assert_allclose(exp, float(jc['exposure']), rtol=1e-5)
        # interval mode: frames 0-2 hold the dark probes, frame 3 updates
        assert aux['ddgi_updated'] == (i == FRAMES - 1)
        assert not bool(aux['ddgi_converged'])
        for k in ('ddgi_irradiance', 'ddgi_distance'):
            a, b = probes[k], np.asarray(jc[k])
            scale = max(float(np.abs(b).max()), 1e-6)
            close = np.abs(a - b) <= 1e-3 * scale
            assert close.mean() >= 0.995, (i, k, close.mean())
        for k in ('ddgi_offset', 'ddgi_state', 'ddgi_var_samples',
                  'ddgi_var_accum'):
            np.testing.assert_array_equal(probes[k], np.asarray(jc[k]),
                                          err_msg=k)
        np.testing.assert_allclose(probes['ddgi_variability'],
                                   np.asarray(jc['ddgi_variability']),
                                   rtol=1e-4)
        np.testing.assert_allclose(probes['ddgi_var_ring'],
                                   np.asarray(jc['ddgi_var_ring']),
                                   rtol=1e-4)
        drops = {k: int(v) for k, v in aux.items() if k.endswith('dropped')}
        assert drops and not any(drops.values()), drops
    irr = port_complete[-1][2]['ddgi_irradiance']
    assert np.isfinite(irr).all() and irr.max() > 0
    ao = port_complete[-1][1]['ao'].numpy()
    assert 0.0 <= ao.min() and ao.max() <= 1.0 and 0 < ao.mean() < 1


def test_sah_tree_frame_equals_complete_tree_frame(cornell, port_complete):
    c = cornell
    sah, gpi, gpm, lod = TS.build_rt_static_gi(c['sh'], 'all', device="cpu")
    assert isinstance(sah, TS.RtStaticSah) and lod == c['lod']
    np.testing.assert_array_equal(gpi.numpy(), c['gpi'])
    frames = _port_frames(c, sah, (gpi, gpm))
    for (img, aux, probes, exp), (img_c, aux_c, probes_c, exp_c) in zip(
            frames, port_complete):
        np.testing.assert_array_equal(img, img_c)
        for k in GI_KEYS:
            np.testing.assert_array_equal(probes[k], probes_c[k], err_msg=k)
        assert exp == exp_c

