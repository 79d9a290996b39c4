"""The render CLI's flags of slice 8 on the CPU (64x32).

* `--scene stress` with `--debugview 2`, `--restir`, `--transparency
  --oitlayers 2` (the stress scene has no blend material: the blend set
  is empty and the opaque filter 'opaque' keeps every pair): the PNG
  equals the same frames rendered through make_render_fn, with the CLI's
  content-sized capacities and RT tree.
* `--animate` on the animated Cornell (one rotation channel in the
  port's scene cache) and `--orbit 0.1`: the PNG equals the loop of
  AnimationPlayer and View.rotate_yaw_pitch through make_render_fn, and
  differs from the frame without the flag.
* `--aniso 4 --customscenescale 2 --forcedlod 1`: the port's parse sets
  the same RenderSettings fields and scene scale as the reference CLI's
  (its main, stopped once it builds its RenderSettings); a culled
  Cornell frame at 96x64 with `--forcedlod 1` renders on the CPU, equal
  to the same frame through make_render_fn.
"""

import numpy as np
import pytest
import torch

from test_torch_animation import write_animated_cornell
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, capacity, default_frame_inputs, init_carry,
    make_render_fn)
from toyrenderer_tpu_torch.ops.bvh import build_rt_static
from toyrenderer_tpu_torch.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.animation import AnimationPlayer
from toyrenderer_tpu_torch.scene.png import decode_png
from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
from toyrenderer_tpu_torch.tools import render as cli
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

W, H = 64, 32


def _cli(tmp_path, capsys, args):
    out = tmp_path / "cli.png"
    assert cli.main(["--displayresolution", f"{W}x{H}", "--device", "cpu",
                     "--output", str(out), *args]) == 0
    return decode_png(out.read_bytes())[..., :3], capsys.readouterr().out


def _direct(host, frames, opaque_filter='all', player=None, orbit=0.0,
            rt=False, **kw):
    """The CLI's loop through make_render_fn."""
    scene = host.to_device("cpu")
    pi, pm = (torch.from_numpy(a) for a in
              static_meshlet_pairs(host, opaque_filter))
    st = RenderSettings(width=W, height=H, **kw)
    view = View.from_scene(host, W, H)
    counts = capacity.tile_pair_counts(scene, frame_inputs_from_numpy(
        default_frame_inputs(host, view.matrices()), "cpu"), st,
        {"opaque": (pi, pm)})
    st = capacity.sized_settings(st, counts)
    extra = {}
    if rt:
        extra['rt_static'] = build_rt_static(host, pi.numpy(), pm.numpy(),
                                             device="cpu")
    render = make_render_fn(st, "cpu", raster_cfg=capacity.
                            sized_raster_config(st, counts))
    carry = init_carry(scene, st)
    for i in range(frames):
        mats = view.matrices()
        fi = default_frame_inputs(host, mats)
        if player is not None:
            t, r, s = player.evaluate(i / 60.0, host.node_translation,
                                      host.node_rotation, host.node_scale)
            fi.update(node_translation=t, node_rotation=r, node_scale=s)
        img, carry, aux = render(scene, pi, pm, fi, carry, **extra)
        view.advance(mats)
        if orbit:
            view.rotate_yaw_pitch(orbit, 0.0)
    return img.numpy(), aux


@pytest.fixture(scope="module")
def stress():
    return make_stress_scene(n_objects=64, sphere_res=16, textured=True)


@pytest.mark.parametrize("flags,kw", [
    (["--debugview", "2"], dict(debug_mode=2)),
    (["--debugview", "14"], dict(debug_mode=14)),
    (["--restir"], dict(enable_restir=True)),
    (["--transparency", "--oitlayers", "2"],
     dict(enable_transparency=True, oit_layers=2)),
    (["--restir", "--transparency", "--oitlayers", "2", "--debugview", "7"],
     dict(enable_restir=True, enable_transparency=True, oit_layers=2,
          debug_mode=7))])
def test_cli_stress_flags(tmp_path, capsys, stress, flags, kw):
    img, printed = _cli(tmp_path, capsys, ["--scene", "stress", "--frames",
                                           "2", "--exposure", "0.1", *flags])
    want, aux = _direct(stress, 2, manual_exposure=0.1,
                        rt=kw.get('enable_restir', False), **kw)
    np.testing.assert_array_equal(img, want)
    if kw.get('enable_transparency'):
        assert "[transparency] 0 blend pairs" in printed
    if kw.get('enable_restir'):
        assert "[rt] static topology" in printed
        assert int(aux['restir_lights']) > 0


def test_cli_restir_adds_light(tmp_path, capsys, stress):
    lit, _ = _cli(tmp_path, capsys, ["--scene", "stress", "--exposure",
                                     "0.1", "--restir"])
    plain, _ = _cli(tmp_path, capsys, ["--scene", "stress", "--exposure",
                                       "0.1"])
    assert (lit.astype(int) - plain.astype(int)).sum() > 0


@pytest.mark.parametrize("flags", [["--animate"], ["--orbit", "0.1"],
                                   ["--animate", "--orbit", "0.1"]])
def test_cli_animate_and_orbit(tmp_path, capsys, flags):
    scene = write_animated_cornell(tmp_path / "anim")
    args = ["--scene", str(scene), "--frames", "3", "--exposure", "0.01",
            "--taa"]
    img, printed = _cli(tmp_path, capsys, args + flags)
    host = load_scene(scene)
    player = None
    if "--animate" in flags:
        assert "[anim] 1 channels, 4.00s" in printed
        player = AnimationPlayer(host.animation_data())
    orbit = 0.1 if "--orbit" in flags else 0.0
    want, _ = _direct(host, 3, player=player, orbit=orbit,
                      manual_exposure=0.01, enable_taa=True)
    np.testing.assert_array_equal(img, want)
    still, _ = _cli(tmp_path, capsys, args)
    assert (still != img).any()


class _Built(Exception):
    """Stops the reference CLI once it has built its RenderSettings."""


FLAGS = ["--aniso", "4", "--customscenescale", "2", "--forcedlod", "1"]


def test_cli_flags_match_reference_parse(monkeypatch):
    import toyrenderer_tpu.engine as jax_engine
    import toyrenderer_tpu.scene as jax_scene
    from toyrenderer_tpu.tools import render as jax_cli
    from toyrenderer_tpu_torch import scene as port_scene

    seen = {}
    jax_load = jax_scene.load_scene

    def jax_loader(path, scale=1.0, use_cache=True):
        seen['jax_scale'] = scale
        return jax_load(path, use_cache=False)

    def jax_settings(**kw):
        seen['jax'] = kw
        raise _Built
    monkeypatch.setattr(jax_scene, 'load_scene', jax_loader)
    monkeypatch.setattr(jax_engine, 'RenderSettings', jax_settings)
    with pytest.raises(_Built):
        jax_cli.main(["--displayresolution", f"{W}x{H}", *FLAGS])

    port_load = port_scene.load_scene

    def port_loader(path, scale=1.0, use_cache=True):
        seen['port_scale'] = scale
        return port_load(path, use_cache=False)
    monkeypatch.setattr(port_scene, 'load_scene', port_loader)
    args = cli.parse_args(["--displayresolution", f"{W}x{H}",
                           "--device", "cpu", *FLAGS])
    st = cli.build(args, torch.device("cpu"), log=lambda *_: None).settings
    assert seen['port_scale'] == seen['jax_scale'] == 2.0
    assert (st.texture_aniso, st.forced_lod) == (
        seen['jax']['texture_aniso'], seen['jax']['forced_lod']) == (4, 1)


def test_cli_forcedlod_renders(tmp_path, capsys):
    img, printed = _cli(tmp_path, capsys, ["--frames", "2", "--exposure",
                                           "0.01", "--culling",
                                           "--forcedlod", "1"])
    assert "[stats] covered pixels: 0/" not in printed
    host = load_scene("resources/cornell.gltf")
    scene = host.to_device("cpu")
    pi, pm = (torch.from_numpy(a) for a in static_meshlet_pairs(host, 'all'))
    st = RenderSettings(width=W, height=H, manual_exposure=0.01,
                        enable_culling=True, forced_lod=1)
    view = View.from_scene(host, W, H)
    counts = capacity.culled_pair_counts(scene, frame_inputs_from_numpy(
        default_frame_inputs(host, view.matrices()), "cpu"), st, len(pi),
        None, None)
    st = capacity.sized_culled_settings(st, counts)
    render = make_render_fn(st, "cpu", raster_cfg=capacity.
                            sized_raster_config(st, {"opaque":
                                                     counts["opaque"]}))
    carry = init_carry(scene, st)
    for _ in range(2):
        mats = view.matrices()
        want, carry, _ = render(scene, pi, pm,
                                default_frame_inputs(host, mats), carry)
        view.advance(mats)
    np.testing.assert_array_equal(img, want.numpy())
