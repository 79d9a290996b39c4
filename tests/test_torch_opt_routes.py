"""The reference's opt-in ray paths in the port, against the reference
package on the same inputs.

* Cone layouts (TR_CONE_DIRS / TR_CONE_BRICK): the reference reads them
  once, at import, so its module attributes CONE_DIRS / CONE_BRICK are
  set here (its trace_probe_block reads them at call time) and the
  port's switches in the environment.  The probe block of
  tests/test_torch_ddgi.py (its tolerances: radiance 1e-4, distances
  1e-5, hits and the lifecycle's inputs equal) at 32 and 8 directions,
  bricks of 128 and 64 probes, and 24 directions (64 rays are not whole
  cones of 24: the directions are not cone-ordered).  Where the rays
  are whole cones, a layout moves only slots, so the port's block is
  bit-equal to its default layout's.
* The chunk route (TR_RT_CHUNKS=1) in the unphased `trace_probes` and in
  the probe block at a cone layout.
* The SAH main tree (TR_RT_SAH=1): the render CLI's topology call
  (bvh_sah.build_rt_static_auto) gives the SAH topology, equal to the
  reference's `build_rt_static_sah`; a Cornell 96x64 frame with RT
  shadows, ReSTIR and GI on the main tree, two frames, against the
  reference's frame given that topology (its SAH walk is its Pallas
  kernel, in interpret mode: TR_INTERPRET=1): the u8 image within 1 on
  >= 99.5% of the pixels, the denoised shadow mask within 1e-3 on
  >= 99% (frame 0: every pixel; frame 1: 57 of 6,144 pixels differ, the
  same 57 when both packages are given the complete tree, so not the
  SAH walk: the denoiser's history at this size, which
  tests/test_torch_shadowed_frame.py holds at 448x256), exposure within
  1e-4 relative.  Then a snapshot of the port's cached
  chain on that tree resumes bit-equal for 3 frames.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.engine.frame import render_frame as jax_render
from toyrenderer_tpu.ops import bvh_sah as JS
from toyrenderer_tpu.ops import ddgi as JD
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_culling import _scene, t
from test_torch_ddgi import (  # noqa: F401
    cornell, hold_probe_block, hold_trace_probes)
from test_torch_raster import _one_torch_thread  # noqa: F401
from test_torch_snapshot import _run as run_chain
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, init_carry, make_render_fn)
from toyrenderer_tpu_torch.engine.snapshot import load_state, save_state
from toyrenderer_tpu_torch.ops import bvh_sah as TS
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.weights import carry_from_numpy


def _layout(monkeypatch, dirs, brick):
    monkeypatch.setattr(JD, 'CONE_DIRS', dirs)
    monkeypatch.setattr(JD, 'CONE_BRICK', brick)
    monkeypatch.setenv('TR_CONE_DIRS', str(dirs))
    monkeypatch.setenv('TR_CONE_BRICK', str(brick))


@pytest.mark.parametrize("dirs,brick", [(32, 256), (8, 256), (16, 128),
                                        (16, 64), (24, 256)],
                         ids=["dirs32", "dirs8", "brick128", "brick64",
                              "dirs24-not-cones"])
def test_probe_block_cone_layouts_match_reference(cornell, monkeypatch, dirs,
                                                  brick):
    default = hold_probe_block(cornell)
    _layout(monkeypatch, dirs, brick)
    assert TD.cone_layout() == (dirs, brick)
    got = hold_probe_block(cornell)
    if cornell['tvol'].rays_per_probe % dirs == 0:
        for a, b in zip(got[:3], default[:3]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("call", ["trace_probes", "probe block dirs32"])
def test_chunk_route_probe_traces_match_reference(cornell, monkeypatch, call):
    monkeypatch.setenv('TR_RT_CHUNKS', '1')
    if call == "trace_probes":
        hold_trace_probes(cornell)
    else:
        _layout(monkeypatch, 32, 256)
        hold_probe_block(cornell)


W, H = 96, 64
SAH_FRAME = dict(width=W, height=H, manual_exposure=0.02,
                 enable_shadows=True, enable_restir=True, enable_gi=True,
                 enable_auto_exposure=True, gi_update_phases=1)


@pytest.fixture(scope="module")
def sah_main():
    sh, js, ts = _scene("cornell.gltf")
    pi, pm = static_meshlet_pairs(sh, 'all')
    mp = pytest.MonkeyPatch()
    mp.setenv('TR_RT_SAH', '1')
    try:
        trs = TS.build_rt_static_auto(sh, pi, pm, device="cpu")
    finally:
        mp.undo()
    jrs = JS.build_rt_static_sah(sh, pi, pm)
    assert isinstance(trs, TS.RtStaticSah)
    for k in ('obj_v0', 'payload', 'child_ref', 'node_axis', 'seg_inst'):
        np.testing.assert_array_equal(getattr(trs, k).numpy(),
                                      np.asarray(getattr(jrs, k)), err_msg=k)
    return sh, js, ts, pi, pm, trs, jrs


def test_sah_main_tree_frame_matches_reference(sah_main, monkeypatch):
    sh, js, ts, pi, pm, trs, jrs = sah_main
    vol_kw = dict(max_probes_axis=4, rays_per_probe=32)
    jvol = JD.volume_from_aabb(*sh.world_aabb, **vol_kw)
    tvol = TD.volume_from_aabb(*sh.world_aabb, **vol_kw)
    jst = JaxSettings(**SAH_FRAME, shadow_max_steps=4096, gi_max_steps=4096)
    st = RenderSettings(**SAH_FRAME)
    monkeypatch.setenv('TR_INTERPRET', '1')
    jframe = jax.jit(lambda s, a, b, f, c: jax_render(
        s, a, b, f, c, settings=jst, rt_static=jrs, ddgi_volume=jvol))
    jc = jax_init_carry(js, jst, jvol)
    tc = carry_from_numpy(jax.tree_util.tree_map(np.asarray, dict(jc)),
                          "cpu")
    render = make_render_fn(st, device="cpu")
    view = JView.from_scene(sh, W, H)
    for i in range(2):
        mats = view.matrices()
        fi = jax_fi(sh, mats)
        jimg, jc, jaux = jframe(js, jnp.asarray(pi), jnp.asarray(pm), fi, jc)
        img, tc, aux = render(ts, t(pi), t(pm), fi, tc, rt_static=trs,
                              ddgi_volume=tvol)
        diff = np.abs(img.numpy().astype(int)
                      - np.asarray(jimg).astype(int)).max(-1)
        assert (diff <= 1).mean() >= 0.995, (i, (diff <= 1).mean())
        sm = np.abs(aux['shadow'].numpy()
                    - np.asarray(jaux['shadow']))
        assert (sm <= 1e-3).mean() >= 0.99, (i, (sm <= 1e-3).mean())
        np.testing.assert_allclose(float(tc['exposure']),
                                   float(jc['exposure']), rtol=1e-4)
        view.advance(mats)
    assert 0.0 < float(aux['shadow'].mean()) < 1.0


def test_sah_main_tree_snapshot_resumes_bit_equal(sah_main, tmp_path):
    sh, _, ts, pi, pm, trs, _ = sah_main
    host = sh
    pi_t, pm_t = t(pi), t(pm)
    st = RenderSettings(**{**SAH_FRAME, 'enable_taa': True})
    vol = TD.volume_from_aabb(*host.world_aabb, max_probes_axis=4,
                              rays_per_probe=32)
    kw = dict(ddgi_volume=vol, rt_static=trs)
    carry = init_carry(ts, st, vol, rt_static=trs, pair_inst=pi_t,
                       pair_meshlet=pm_t)
    assert isinstance(carry['rt_bvh_cache'], TS.BvhSah)
    render = make_render_fn(st, "cpu")
    view = View.from_scene(host, W, H)
    _, _, carry = run_chain(render, ts, host, (pi_t, pm_t), 2, carry, view,
                            kw, 0.02)
    save_state(tmp_path / "sah.npz", carry, view)
    view2 = View.from_scene(host, W, H)
    carry2 = load_state(tmp_path / "sah.npz", st, view2, device="cpu")
    assert isinstance(carry2['rt_bvh_cache'], TS.BvhSah)
    a, aux_a, _ = run_chain(render, ts, host, (pi_t, pm_t), 3, carry, view,
                            kw, 0.02)
    b, aux_b, _ = run_chain(render, ts, host, (pi_t, pm_t), 3, carry2, view2,
                            kw, 0.02)
    for i in range(3):
        np.testing.assert_array_equal(a[i], b[i], err_msg=f"frame {2 + i}")
    assert [x['rebuilt'] for x in aux_b] == [x['rebuilt'] for x in aux_a]
