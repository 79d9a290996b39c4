"""The reference's environment switches and frame inputs in the port.

Each switch that changes the reference's route or output is honoured,
never ignored:

* TR_GI_SAH (reference bvh_sah.py:489): '0' builds the GI tree as the
  complete tree wherever the port builds it by default
  (`build_rt_static_gi` without `sah=`, the render CLI);
* TR_RT_SAH=1 (reference bvh_sah.py:450, an SAH main RT tree): the
  render CLI builds and reports the SAH main tree, and its frames with
  RT shadows, and with GI on that tree, equal the complete tree's within
  1 on >= 99.9% of the pixels (the same triangles, exact walks); a frame
  given the SAH topology refits it and equals the complete tree's frame;
* TR_CONE_DIRS / TR_CONE_BRICK (reference ddgi.py:137-139, read there at
  import; its module attributes are set here, and the default arguments
  of its `_cone_block`, as an import under those values would leave
  them): the probe block equals the reference's (test_torch_ddgi's
  tolerances), rtbench's ray sets equal the reference's element for
  element, and the CLI's GI frames, whose 64 rays are whole cones of
  8, equal the default layout's bit for bit;
* the texture-residency overrides in frame_inputs (reference
  engine/frame.py:528-537): read by the frame, each turning the
  analytic descriptors off.
"""

import types

import numpy as np
import pytest
import torch

from toyrenderer_tpu.ops import ddgi as JD
from toyrenderer_tpu.tools import rtbench as JR

from test_torch_ddgi import cornell, hold_probe_block  # noqa: F401
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, make_render_fn)
from toyrenderer_tpu_torch.engine.frame import frame_atlas
from toyrenderer_tpu_torch.ops.bvh import RtStatic, build_rt_static
from toyrenderer_tpu_torch.ops.bvh_sah import (
    BvhSah, RtStaticSah, build_rt_static_gi, build_rt_static_sah)
from toyrenderer_tpu_torch.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.png import decode_png
from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
from toyrenderer_tpu_torch.tools import render as cli
from toyrenderer_tpu_torch.tools import rtbench

SCENE = "resources/cornell.gltf"
CPU = types.SimpleNamespace(device=torch.device("cpu"))
W, H = 96, 64


def _cli(*flags):
    return cli.parse_args(["--scene", SCENE, "--device", "cpu", *flags])


_DEFAULT_FRAMES = {}


def _cli_frame(tmp_path, capsys, *flags):
    """(the CLI's PNG as (H, W, 4) u8, what it printed): Cornell at
    96x64, 2 frames, on the CPU."""
    out = tmp_path / f"cli{len(list(tmp_path.iterdir()))}.png"
    rc = cli.main(["--scene", SCENE, "--displayresolution", f"{W}x{H}",
                   "--frames", "2", "--exposure", "0.02", "--device", "cpu",
                   "--nocache", "--output", str(out), *flags])
    assert rc == 0
    return decode_png(out.read_bytes()), capsys.readouterr().out


def _default_frame(tmp_path, capsys, flag):
    """The CLI's frame with `flag` and every switch at its default."""
    if flag not in _DEFAULT_FRAMES:
        mp = pytest.MonkeyPatch()
        for var in ("TR_RT_SAH", "TR_CONE_DIRS", "TR_CONE_BRICK"):
            mp.delenv(var, raising=False)
        try:
            _DEFAULT_FRAMES[flag] = _cli_frame(tmp_path, capsys, flag)[0]
        finally:
            mp.undo()
    return _DEFAULT_FRAMES[flag]


def _cli_case(flag, kind, exact):
    """The CLI with the switch set: its main tree's kind printed, its
    PNG against the default's (bit-equal, or within 1 on >= 99.9% of the
    pixels)."""
    def run(tmp_path, capsys):
        img, printed = _cli_frame(tmp_path, capsys, flag)
        assert f"[rt] static topology ({kind})" in printed
        want = _default_frame(tmp_path, capsys, flag)
        if exact:
            np.testing.assert_array_equal(img, want)
        else:
            diff = np.abs(img.astype(int) - want.astype(int)).max(-1)
            assert (diff <= 1).mean() >= 0.999, (diff <= 1).mean()
    return run


def _frame_with_main_tree(tmp_path, capsys):
    """render_frame given the SAH topology (its tree refit into the
    carry's cache) against the same frame given the complete tree."""
    host = load_scene(SCENE, use_cache=False)
    scene = host.to_device("cpu")
    pi, pm = static_meshlet_pairs(host, 'all')
    st = RenderSettings(width=W, height=H, manual_exposure=0.02,
                        enable_shadows=True)
    imgs = []
    for build in (build_rt_static_sah, build_rt_static):
        rts = build(host, pi, pm, device="cpu")
        tp = (torch.from_numpy(pi), torch.from_numpy(pm))
        carry = init_carry(scene, st, rt_static=rts, pair_inst=tp[0],
                           pair_meshlet=tp[1])
        img, carry, aux = make_render_fn(st, "cpu")(
            scene, *tp, default_frame_inputs(
                host, View.from_scene(host, W, H).matrices()), carry,
            rt_static=rts)
        assert aux['rebuilt'] == ['rt']
        assert isinstance(carry['rt_bvh_cache'],
                          BvhSah if build is build_rt_static_sah
                          else type(carry['rt_bvh_cache']))
        imgs.append(img.numpy())
    diff = np.abs(imgs[0].astype(int) - imgs[1].astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.999, (diff <= 1).mean()


def _probe_trace(cornell):
    def run(tmp_path, capsys):
        hold_probe_block(cornell)
    return run


def _ray_sets(tmp_path, capsys):
    """rtbench's ray sets at the switched layout, against the
    reference's."""
    host = load_scene(rtbench.COURTYARD)
    lo, hi = (np.asarray(x) for x in host.world_aabb)
    sun = np.asarray(host.sun_direction)
    want = JR.ray_sets(16384, lo, hi, sun)
    got = rtbench.ray_sets(16384, lo, hi, sun)
    for w_set, g_set in zip(want, got):
        for w, g in zip(w_set, g_set):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, np.asarray(w))


CASES = [
    ("TR_RT_SAH", "1", lambda c: _cli_case("--shadows", "sah", False)),
    ("TR_RT_SAH", "1", lambda c: _cli_case("--gi", "sah", False)),
    ("TR_RT_SAH", "1", lambda c: _frame_with_main_tree),
    ("TR_CONE_DIRS", "32", _probe_trace),
    ("TR_CONE_DIRS", "32", lambda c: _ray_sets),
    ("TR_CONE_DIRS", "8", lambda c: _cli_case("--gi", "complete", True)),
    ("TR_CONE_BRICK", "64", _probe_trace),
    ("TR_CONE_BRICK", "128", lambda c: _ray_sets),
    ("TR_CONE_BRICK", "512", lambda c: _cli_case("--gi", "complete", True)),
]


@pytest.mark.parametrize("var,value,case", CASES, ids=[
    "rt-sah-cli-shadows", "rt-sah-cli-gi", "rt-sah-frame",
    "cone-dirs-trace", "cone-dirs-rtbench", "cone-dirs-cli",
    "cone-brick-trace", "cone-brick-rtbench", "cone-brick-cli"])
def test_switch_matches_reference(monkeypatch, tmp_path, capsys, cornell,
                                  var, value, case):
    run = case(cornell)
    monkeypatch.setenv(var, value)
    if var.startswith("TR_CONE"):
        attr = var[len("TR_"):]
        monkeypatch.setattr(JD, attr, int(value))
        monkeypatch.setattr(JD._cone_block, '__defaults__',
                            (JD.CONE_BRICK, JD.CONE_DIRS))
    run(tmp_path, capsys)


@pytest.mark.parametrize("var,value,call", [
    ("TR_RT_SAH", "0", lambda: _cli("--shadows")),
    ("TR_CONE_DIRS", "16", lambda: _cli("--gi")),
    ("TR_CONE_BRICK", "256", lambda: _ray_sets(None, None)),
], ids=["rt-sah-0", "cone-dirs-default", "cone-brick-default"])
def test_switch_at_the_ported_value_runs(monkeypatch, var, value, call):
    """The values the port has are accepted, spelled out or not."""
    monkeypatch.setenv(var, value)
    call()


@pytest.mark.parametrize("key", ["tex_texels", "tex_desc", "tex_min_mip",
                                 "tex_tile_table"])
def test_residency_override_turns_analytic_off(key):
    """Each residency override alone replaces the scene's array in the
    frame's atlas, keeps the records' encoding and turns the analytic
    descriptors off (reference package, engine/frame.py:528-537)."""
    host = make_stress_scene(n_objects=2, sphere_res=4, textured=True)
    scene = host.to_device("cpu")
    assert scene.tex_analytic
    plain = frame_atlas(scene, {})
    assert plain['_enc'] and plain['_analytic']
    value = torch.zeros(4, dtype=torch.int32)
    atlas = frame_atlas(scene, {key: value, 'jitter': None})
    assert atlas[key] is value
    assert atlas['_enc'] and not atlas['_analytic']
    assert atlas.keys() - {key} == plain.keys() - {key}


@pytest.mark.parametrize("value,kind", [
    ("1", RtStaticSah), (None, RtStaticSah), ("0", RtStatic)],
    ids=["sah", "default", "complete"])
def test_gi_sah_switch_picks_the_gi_tree(monkeypatch, value, kind):
    """TR_GI_SAH picks the GI tree's flavour where no `sah=` is given;
    TR_GI_SAH=0 gives the complete tree of `sah=False`, slot for slot."""
    if value is None:
        monkeypatch.delenv("TR_GI_SAH", raising=False)
    else:
        monkeypatch.setenv("TR_GI_SAH", value)
    host = load_scene(SCENE, use_cache=False)
    tree, gpi, gpm, lod = build_rt_static_gi(host, 'all', device="cpu")
    assert isinstance(tree, kind)
    if kind is RtStatic:
        want = build_rt_static_gi(host, 'all', sah=False, device="cpu")[0]
        assert torch.equal(tree.payload, want.payload)
        assert torch.equal(tree.obj_v0, want.obj_v0)
