"""engine/snapshot.py: the carry and the camera saved and restored.

* The reference's round trip (its tests/test_e2e.py:145) in the port:
  Cornell at 224x128, culled with TAA (the HZB's tuple of mips in the
  carry), 2 frames, saved with the View, loaded into a fresh View: the
  next frame is bit-equal to the uninterrupted chain's, and the npz holds
  the keys the reference writes for the same carry.
* The all-on chain with its caches (RT shadows, GI on its own tree in 4
  interval phases, AO, TAA) over a camera pan: saved after 5 frames and
  loaded into a fresh carry and View, the next 3 frames (an update frame
  among them) are bit-equal to the chain's -- the View's previous
  view-projection, which the motion vectors read, is saved too -- and
  rebuild the same caches (none: the saved host mirror keeps them
  current).
* A snapshot that the reference package wrote on the CPU (2 frames of the
  first case) loads into the port: the port's next frame equals the
  reference's continuation within 1 on >= 99.9% of the pixels (the
  tolerance of tests/test_torch_frame.py's Cornell frames), and the
  loaded carry equals the reference's, key for key.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine import snapshot as jax_snapshot
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.engine.frame import make_render_fn as jax_make
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_culling import _scene, t
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, make_render_fn)
from toyrenderer_tpu_torch.engine.snapshot import load_state, save_state
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.ops.bvh import build_rt_static
from toyrenderer_tpu_torch.scene import load_scene

W, H = 224, 128
YAW = 0.02
CULLED_TAA = dict(width=W, height=H, manual_exposure=0.01,
                  enable_culling=True, enable_taa=True)


@pytest.fixture(scope="module")
def cornell():
    host = load_scene("resources/cornell.gltf", use_cache=False)
    scene = host.to_device("cpu")
    pi, pm = (torch.from_numpy(a) for a in static_meshlet_pairs(host, 'all'))
    return host, scene, pi, pm


def _run(render, scene, host, pairs, n, carry, view, kw=None, yaw=0.0):
    imgs, auxes = [], []
    for _ in range(n):
        mats = view.matrices()
        img, carry, aux = render(scene, *pairs,
                                 default_frame_inputs(host, mats), carry,
                                 **(kw or {}))
        view.advance(mats)
        view.rotate_yaw_pitch(yaw, 0.0)
        imgs.append(img.numpy())
        auxes.append(aux)
    return imgs, auxes, carry


def test_state_snapshot_roundtrip(cornell, tmp_path):
    host, scene, pi, pm = cornell
    st = RenderSettings(**CULLED_TAA)
    render = make_render_fn(st, "cpu")
    view = View.from_scene(host, W, H)
    _, _, carry = _run(render, scene, host, (pi, pm), 2,
                       init_carry(scene, st), view)
    save_state(tmp_path / "state.npz", carry, view)
    view2 = View.from_scene(host, W, H)
    carry2 = load_state(tmp_path / "state.npz", st, view2, device="cpu")
    assert view2.frame_index == view.frame_index
    assert carry2.keys() == carry.keys()
    assert carry2.host.frame_index == carry.host.frame_index == 2
    resumed, _, _ = _run(render, scene, host, (pi, pm), 1, carry2, view2)
    cont, _, _ = _run(render, scene, host, (pi, pm), 1, carry, view)
    np.testing.assert_array_equal(resumed[0], cont[0])
    # the reference's flat keys for the same carry
    jc = jax_init_carry(host_js(), JaxSettings(**CULLED_TAA))
    jax_snapshot.save_state(tmp_path / "jax.npz", jc)
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "state.npz") as b:
        ours = {k for k in b.files if not k.startswith('__host/')}
        assert ours - {'__cam_pos', '__cam_rot', '__cam_frame',
                       '__cam_prev_view_proj'} == set(a.files)


_JS = {}


def host_js():
    """The reference package's device scene of Cornell."""
    if 'js' not in _JS:
        _JS['sh'], _JS['js'], _ = _scene("cornell.gltf")
    return _JS['js']


def test_cached_allon_snapshot_resumes_bit_equal(cornell, tmp_path):
    host, scene, pi, pm = cornell
    st = RenderSettings(width=96, height=64, manual_exposure=0.02,
                        enable_shadows=True, enable_gi=True, enable_ao=True,
                        enable_taa=True, gi_update_phases=4)
    rts = build_rt_static(host, pi.numpy(), pm.numpy(), device="cpu")
    vol = TD.volume_from_aabb(*host.world_aabb, max_probes_axis=4,
                              rays_per_probe=32)
    kw = dict(ddgi_volume=vol, rt_static=rts, rt_static_gi=rts,
              gi_pair_inst=pi, gi_pair_meshlet=pm)
    carry = init_carry(scene, st, vol, rt_static=rts, rt_static_gi=rts,
                       pair_inst=pi, pair_meshlet=pm, gi_pair_inst=pi,
                       gi_pair_meshlet=pm)
    render = make_render_fn(st, "cpu")
    view = View.from_scene(host, 96, 64)
    _, _, carry = _run(render, scene, host, (pi, pm), 5, carry, view, kw,
                       YAW)
    save_state(tmp_path / "allon.npz", carry, view)
    view2 = View.from_scene(host, 96, 64)
    carry2 = load_state(tmp_path / "allon.npz", st, view2, device="cpu")
    assert {'rt_bvh_cache', 'gi_bvh_cache', 'gi_shade_cache'} <= set(carry2)
    a, aux_a, _ = _run(render, scene, host, (pi, pm), 3, carry, view, kw,
                       YAW)
    b, aux_b, _ = _run(render, scene, host, (pi, pm), 3, carry2, view2, kw,
                       YAW)
    for i in range(3):
        np.testing.assert_array_equal(a[i], b[i], err_msg=f"frame {5 + i}")
    assert [x['ddgi_updated'] for x in aux_b] == [False, False, True]
    assert [x['rebuilt'] for x in aux_b] == [x['rebuilt'] for x in aux_a] \
        == [[], [], []]


def test_port_reads_reference_snapshot(cornell, tmp_path):
    host, scene, pi, pm = cornell
    js = host_js()
    jst = JaxSettings(**CULLED_TAA)
    jrender = jax_make(jst, donate_carry=False)
    jpi, jpm = (jnp.asarray(x.numpy()) for x in (pi, pm))
    view = JView.from_scene(_JS['sh'], W, H)
    jc = jax_init_carry(js, jst)
    for _ in range(2):
        mats = view.matrices()
        _, jc, _ = jrender(js, jpi, jpm, jax_fi(_JS['sh'], mats), jc)
        view.advance(mats)
    jax_snapshot.save_state(tmp_path / "jax.npz", jc, view)
    mats = view.matrices()
    fi = jax_fi(_JS['sh'], mats)
    jimg, _, _ = jrender(js, jpi, jpm, fi, jc)

    st = RenderSettings(**CULLED_TAA)
    view2 = View.from_scene(host, W, H)
    tc = load_state(tmp_path / "jax.npz", st, view2, device="cpu")
    assert view2.frame_index == view.frame_index
    assert tc.keys() == jc.keys()
    for k, v in jc.items():
        got = tc[k] if isinstance(v, tuple) else (tc[k],)
        want = v if isinstance(v, tuple) else (v,)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=k)
    img, _, _ = make_render_fn(st, "cpu")(
        scene, pi, pm, {k: np.asarray(v) for k, v in fi.items()}, tc)
    diff = np.abs(img.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert (diff.max(-1) <= 1).mean() >= 0.999
    assert dataclasses.replace(tc.host).frame_index == 2
