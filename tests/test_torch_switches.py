"""The reference's environment switches and frame inputs in the port.

Each switch that changes the reference's route or output is either
honoured or refused with NotImplementedError naming its ROADMAP item,
never ignored:

* TR_GI_SAH (reference bvh_sah.py:489): '0' builds the GI tree as the
  complete tree wherever the port builds it by default
  (`build_rt_static_gi` without `sah=`, the render CLI);
* TR_RT_SAH=1 (reference bvh_sah.py:450, an SAH main RT tree): refused
  by the render CLI and by a frame given a main tree;
* TR_CONE_DIRS / TR_CONE_BRICK other than 16 / 256 (reference
  ddgi.py:137-139): refused by the probe trace, rtbench and the CLI;
* the texture-residency overrides in frame_inputs (reference
  engine/frame.py:528-537): read by the frame, each turning the
  analytic descriptors off.
"""

import types

import numpy as np
import pytest
import torch

from toyrenderer_tpu_torch.engine import RenderSettings
from toyrenderer_tpu_torch.engine.frame import frame_atlas, render_frame
from toyrenderer_tpu_torch.ops import ddgi
from toyrenderer_tpu_torch.ops.bvh import RtStatic
from toyrenderer_tpu_torch.ops.bvh_sah import (
    RtStaticSah, build_rt_static_gi)
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
from toyrenderer_tpu_torch.tools import render as cli
from toyrenderer_tpu_torch.tools import rtbench

SCENE = "resources/cornell.gltf"
CPU = types.SimpleNamespace(device=torch.device("cpu"))


def _cli(*flags):
    return cli.parse_args(["--scene", SCENE, "--device", "cpu", *flags])


def _frame_with_main_tree():
    render_frame(CPU, None, None, {}, {}, RenderSettings(),
                 rt_static=object())


def _probe_trace():
    ddgi.trace_probe_block(*([None] * 9), num_phases=4)


def _ray_sets():
    rtbench.ray_sets(4096, np.zeros(3), np.ones(3), np.ones(3))


@pytest.mark.parametrize("var,value,call", [
    ("TR_RT_SAH", "1", lambda: _cli("--shadows")),
    ("TR_RT_SAH", "1", lambda: _cli("--gi")),
    ("TR_RT_SAH", "1", _frame_with_main_tree),
    ("TR_CONE_DIRS", "32", _probe_trace),
    ("TR_CONE_DIRS", "32", _ray_sets),
    ("TR_CONE_DIRS", "8", lambda: _cli("--gi")),
    ("TR_CONE_BRICK", "64", _probe_trace),
    ("TR_CONE_BRICK", "128", _ray_sets),
    ("TR_CONE_BRICK", "512", lambda: _cli("--gi")),
], ids=["rt-sah-cli-shadows", "rt-sah-cli-gi", "rt-sah-frame",
        "cone-dirs-trace", "cone-dirs-rtbench", "cone-dirs-cli",
        "cone-brick-trace", "cone-brick-rtbench", "cone-brick-cli"])
def test_unported_switch_raises(monkeypatch, var, value, call):
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match=f"{var}.*ROADMAP"):
        call()


@pytest.mark.parametrize("var,value,call", [
    ("TR_RT_SAH", "0", lambda: _cli("--shadows")),
    ("TR_CONE_DIRS", "16", lambda: _cli("--gi")),
    ("TR_CONE_BRICK", "256", _ray_sets),
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
