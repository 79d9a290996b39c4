"""The DDGI probe rays' pair route (TR_GI_PAIRS=1: ops/rt_pairs.py, its
fold K6 as the plain version here) in the port's probe trace and frame.

* `trace_probe_block` with TR_GI_PAIRS=1 against the reference's
  (TR_GI_PAIRS=1, TR_INTERPRET=1: its pair kernel in interpret mode, at
  its bf16x3 precision), on cornell's complete tree (the reference's,
  carried across) with a 4 x 4 x 4 probe grid of 32 rays, a phased block
  with relocated and inactive probes: radiance and distance within 1e-3
  on >= 99.5% of the rays (a ray whose hit flips between the bf16x3
  split and float32 sums changes both); the lifecycle's inputs within
  1e-3 on every probe whose rays all agree.
* The port's frame (cornell, 96x64, RT shadows and GI updating every
  frame, 2 frames, as tests/test_e2e.py:433-480 renders the reference's)
  through the pair route against the default route: mean |diff| < 2.0 on
  the 0-255 scale, the reference's own gate; on GI's own SAH tree and on
  the shared shadow tree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import ddgi as JD
from toyrenderer_tpu.ops.bvh_sah import build_rt_static_gi as jax_gi_static

from test_torch_bvh import _jax_inst_world
from test_torch_culling import _scene
from test_torch_ddgi import _probe_state, _sky_j, _sky_t
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, make_render_fn)
from toyrenderer_tpu_torch.ops import bvh as TB
from toyrenderer_tpu_torch.ops import bvh_sah as TS
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.ops import geometry as TG
from toyrenderer_tpu_torch.ops import rt_pairs as TR
from toyrenderer_tpu_torch.weights import bvh_from_numpy


def _volume(mod, sh):
    lo, hi = (np.asarray(x) for x in sh.world_aabb)
    return mod.DdgiVolume(origin=tuple(lo), spacing=tuple((hi - lo) / 3.0),
                          counts=(4, 4, 4), rays_per_probe=32,
                          max_ray_distance=float(np.linalg.norm(hi - lo)))


@pytest.fixture(scope="module")
def cornell():
    sh, js, ts = _scene("cornell.gltf")
    return dict(sh=sh, js=js, ts=ts, jvol=_volume(JD, sh),
                tvol=_volume(TD, sh))


def test_trace_probe_block_pairs_matches_reference(cornell, monkeypatch):
    monkeypatch.setenv('TR_GI_PAIRS', '1')
    monkeypatch.setenv('TR_INTERPRET', '1')
    sh, js = cornell['sh'], cornell['js']
    jvol, tvol = cornell['jvol'], cornell['tvol']
    rts, gpi, gpm, _ = jax_gi_static(sh, 'all')
    iw = _jax_inst_world(sh)
    jbvh = JB.refit_bvh(rts, jnp.asarray(iw))
    tbvh = bvh_from_numpy(dict(child_boxes=np.asarray(jbvh.child_boxes),
                               leaf_rows=np.asarray(jbvh.leaf_rows),
                               level_offset=jbvh.level_offset,
                               num_levels=jbvh.num_levels), 'cpu')
    v = JB.world_triangles(js, jnp.asarray(iw), gpi, gpm)
    shade = JD.build_shade_records(js, gpi, gpm, *v[:3])
    irr, _, off, state = _probe_state(jvol, 7)
    sun = np.asarray([0.3, 0.8, 0.52], np.float32)
    sun /= np.linalg.norm(sun)
    col = np.asarray([1.0, 0.95, 0.9], np.float32)
    inten = np.asarray([3.0], np.float32)
    num_phases, frame = 2, 5
    want = JD.trace_probe_block(
        jvol, jbvh, shade, jnp.asarray(irr), jnp.asarray(sun),
        jnp.asarray(col), jnp.asarray(inten), jnp.asarray(frame, jnp.int32),
        _sky_j, num_phases, max_steps=4096, probe_offset=jnp.asarray(off),
        probe_state=jnp.asarray(state))
    rad, dist, dirs, start, life = TD.trace_probe_block(
        tvol, tbvh, torch.from_numpy(np.array(shade)),
        torch.from_numpy(irr), torch.from_numpy(sun), torch.from_numpy(col),
        torch.from_numpy(inten), torch.tensor(frame, dtype=torch.int32),
        _sky_t, num_phases, probe_offset=torch.from_numpy(off),
        probe_state=torch.from_numpy(state))
    np.testing.assert_allclose(dirs.numpy(), np.asarray(want[2]), atol=2e-6)
    assert int(start) == int(want[3])
    w_rad, w_dist = np.asarray(want[0]), np.asarray(want[1])
    assert rad.shape == w_rad.shape and dist.shape == w_dist.shape
    hit = w_dist < 1e4
    assert 0.05 < hit.mean() < 0.99
    agree = (np.isclose(dist.numpy(), w_dist, rtol=1e-3, atol=1e-3)
             & np.isclose(rad.numpy(), w_rad, rtol=1e-3, atol=1e-3).all(-1))
    assert agree.mean() >= 0.995, agree.mean()
    probes = agree.all(1)
    assert probes.mean() >= 0.5, probes.mean()
    for k, v_ in life.items():
        np.testing.assert_allclose(v_.numpy()[probes],
                                   np.asarray(want[4][k])[probes],
                                   rtol=1e-3, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("gi_tree", ["own SAH tree", "shared shadow tree"])
def test_pair_route_frame_matches_default_route(gi_tree, monkeypatch):
    from toyrenderer_tpu_torch.scene import load_scene
    host = load_scene("resources/cornell.gltf", use_cache=False)
    scene = host.to_device("cpu")
    pi, pm = (torch.from_numpy(a) for a in TG.static_meshlet_pairs(host))
    rts = TB.build_rt_static(host, pi.numpy(), pm.numpy(), device="cpu")
    vol = _volume(TD, host)
    st = RenderSettings(width=96, height=64, enable_gi=True,
                        enable_shadows=True, gi_half_res=False,
                        manual_exposure=0.02)
    kw = dict(rt_static=rts, ddgi_volume=vol)
    if gi_tree == "own SAH tree":
        gi, gpi, gpm, _ = TS.build_rt_static_gi(host, 'all', device="cpu")
        assert isinstance(gi, TS.RtStaticSah)
        kw.update(rt_static_gi=gi, gi_pair_inst=gpi, gi_pair_meshlet=gpm)
    calls = []
    traverse_pairs = TR.traverse_pairs

    def counted(*a, **k):
        calls.append(a[0])
        return traverse_pairs(*a, **k)
    monkeypatch.setattr(TR, "traverse_pairs", counted)
    imgs = {}
    for route in ("default", "pairs"):
        monkeypatch.setenv("TR_GI_PAIRS", "1" if route == "pairs" else "0")
        render = make_render_fn(st, device="cpu")
        view = View.from_scene(host, st.width, st.height)
        view.enable_jitter = False
        carry = init_carry(scene, st, vol)
        for _ in range(2):
            mats = view.matrices()
            img, carry, aux = render(scene, pi, pm,
                                     default_frame_inputs(host, mats),
                                     carry, **kw)
            view.advance(mats)
            assert aux['ddgi_updated']
        imgs[route] = img.numpy().astype(np.float32)
        irr = carry['ddgi_irradiance']
        assert bool(torch.isfinite(irr).all()) and float(irr.max()) > 0
    # two traces (the probe rays, their sun rays) on each update frame
    assert len(calls) == 4
    want = TS.BvhSah if gi_tree == "own SAH tree" else TB.Bvh
    assert all(isinstance(tree, want) for tree in calls)
    diff = np.abs(imgs["default"] - imgs["pairs"]).mean()
    assert diff < 2.0, diff
