"""Depth-peeled order-independent transparency against the reference.

The two frames of the reference's tests/test_e2e.py:177-300 at 192x96,
on the same stress scene (8 objects, sphere_res 8, seed 9) with the same
blend materials, in both packages (the reference on its XLA fill path,
the port's plain fills):

* the forward pass: instance 1's material red glass at alpha 0.5; the
  image with `enable_transparency` against the reference's, and the
  reference test's own checks (the glass tints some pixels by more than
  20, fewer than half of them);
* `oit_layers` 1 and 2 with the ground green glass at alpha 0.4 too: each
  image against the reference's, and the reference test's checks (the
  second layer changes > 20 pixels by more than 10, and more than half
  of the pixels not at all).

Images within 1 on >= 99.5% of the pixels (the tolerance of the other
frame tests: the geometry stage's products round an ulp apart).  The
blend set's raster counters land in aux as `raster_trans_*`, none
dropped; layer 0 is unbounded by the opaque depth, as in the reference
(ROADMAP queue 3): a blend surface behind an opaque one can win layer 0
and is then dropped by the composite.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.engine.frame import make_render_fn as jax_make
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu.scene.gltf import ALPHA_BLEND
from toyrenderer_tpu.scene.procedural import make_stress_scene

from test_torch_raster import _one_torch_thread, scene_arrays  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, init_carry, make_render_fn)
from toyrenderer_tpu_torch.engine.capacity import (
    culled_pair_counts, sized_culled_settings, sized_raster_config)
from toyrenderer_tpu_torch.weights import (
    frame_inputs_from_numpy, scene_from_numpy)

W, H = 192, 96
COMMON = dict(width=W, height=H, manual_exposure=0.05,
              max_tris_per_tile=256, max_big_tris=64, tile_batch=4)


def _scene(ground_glass: bool):
    s = make_stress_scene(n_objects=8, sphere_res=8, seed=9)
    if ground_glass:
        mat = int(s.prim_material[int(s.inst_prim[0])])
        s.mat_alpha_mode[mat] = ALPHA_BLEND
        s.mat_base_color[mat] = [0.1, 0.9, 0.1, 0.4]
    mat = int(s.prim_material[int(s.inst_prim[1])])
    s.mat_alpha_mode[mat] = ALPHA_BLEND
    s.mat_base_color[mat] = [0.9, 0.1, 0.1, 0.5]
    js = s.to_device()
    view = JView.from_scene(s, W, H)
    view.enable_jitter = False
    pi, pm = static_meshlet_pairs(s, 'opaque')
    ti, tm = static_meshlet_pairs(s, 'blend')
    assert len(ti) > 0
    return dict(js=js, ts=scene_from_numpy(scene_arrays(js), "cpu"),
                fi=jax_fi(s, view.matrices()), pairs=(pi, pm, ti, tm))


def _render(sc, **kw):
    """(reference image, port image, port aux) of one frame."""
    pi, pm, ti, tm = sc['pairs']
    jst = JaxSettings(**COMMON, **kw)
    jimg, _, _ = jax_make(jst)(
        sc['js'], jnp.asarray(pi), jnp.asarray(pm), sc['fi'],
        jax_init_carry(sc['js'], jst), trans_pair_inst=jnp.asarray(ti),
        trans_pair_meshlet=jnp.asarray(tm))
    st = RenderSettings(**COMMON, **kw)
    t = [torch.from_numpy(a) for a in (pi, pm, ti, tm)]
    img, _, aux = make_render_fn(st, "cpu")(
        sc['ts'], t[0], t[1], frame_inputs_from_numpy(sc['fi'], "cpu"),
        init_carry(sc['ts'], st), trans_pair_inst=t[2],
        trans_pair_meshlet=t[3])
    return np.asarray(jimg), img.numpy(), aux


def _close(a, b) -> float:
    return float((np.abs(a.astype(int) - b.astype(int)).max(-1) <= 1).mean())


@pytest.fixture(scope="module")
def forward():
    return _scene(ground_glass=False)


@pytest.fixture(scope="module")
def stacked():
    return _scene(ground_glass=True)


def test_transparent_forward_pass_matches_reference(forward):
    jimg, img, aux = _render(forward, enable_transparency=True)
    assert _close(img, jimg) >= 0.995
    assert int(aux['raster_trans_tris']) > 0
    assert int(aux['raster_trans_dropped']) == 0
    # without the pass the blend set is not drawn
    pi, pm, _, _ = (torch.from_numpy(a) for a in forward['pairs'])
    st = RenderSettings(**COMMON)
    img_o, _, aux_o = make_render_fn(st, "cpu")(
        forward['ts'], pi, pm, frame_inputs_from_numpy(forward['fi'], "cpu"),
        init_carry(forward['ts'], st))
    assert not any(k.startswith('raster_trans_') for k in aux_o)
    diff = np.abs(img.astype(int) - img_o.numpy().astype(int))
    assert diff.max() > 20                        # the glass tints pixels
    assert (diff.sum(-1) > 0).mean() < 0.5        # but only locally


@pytest.mark.parametrize("layers", [1, 2])
def test_oit_layers_match_reference(stacked, layers):
    jimg, img, aux = _render(stacked, enable_transparency=True,
                             oit_layers=layers)
    assert _close(img, jimg) >= 0.995
    assert int(aux['raster_trans_dropped']) == 0
    stacked[f'img{layers}'] = img


def test_second_oit_layer_adds_the_occluded_glass(stacked):
    imgs = {}
    for k in (1, 2):
        if f'img{k}' not in stacked:
            _, stacked[f'img{k}'], _ = _render(
                stacked, enable_transparency=True, oit_layers=k)
        imgs[k] = stacked[f'img{k}'].astype(int)
    diff = np.abs(imgs[1] - imgs[2]).sum(-1)
    assert (diff > 10).sum() > 20
    assert (diff == 0).mean() > 0.5


def test_blend_set_capacities_sized_from_content(stacked):
    """The blend set is measured as a set of its own in the culled
    frame's probe; its config holds its binned pairs, with the pair
    budget raised where the opaque set's would drop them, and the culled
    glass frame renders with it dropping nothing."""
    pi, pm, ti, tm = (torch.from_numpy(a) for a in stacked['pairs'])
    fi = frame_inputs_from_numpy(stacked['fi'], "cpu")
    base = RenderSettings(**COMMON, enable_culling=True,
                          enable_transparency=True, oit_layers=2)
    counts = culled_pair_counts(stacked['ts'], fi, base, len(pi),
                                blend_pairs=(ti, tm))
    st = sized_culled_settings(base, counts)
    cfg_t = sized_raster_config(st, {"blend": counts["blend"]})
    assert counts['blend']['pairs'] > 0
    assert cfg_t.pair_capacity >= counts['blend']['pairs']
    # a budget below the set's pairs is raised to 1.55x them; one that
    # holds them is kept
    small = dataclasses.replace(st, pair_capacity=counts['blend']['pairs']
                                - 1)
    assert sized_raster_config(small, {"blend": counts["blend"]}) \
        .pair_capacity >= 1.55 * counts['blend']['pairs']
    assert sized_raster_config(st, {"blend": counts["blend"]}) \
        .pair_capacity == st.pair_capacity
    img, _, aux = make_render_fn(st, "cpu", trans_raster_cfg=cfg_t)(
        stacked['ts'], pi, pm, fi, init_carry(stacked['ts'], st),
        trans_pair_inst=ti, trans_pair_meshlet=tm)
    assert int(aux['raster_trans_dropped']) == 0
    assert int(aux['raster_trans_tris']) > 0
    assert img.shape == (H, W, 3)
