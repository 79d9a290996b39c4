"""The compact masked merge (one L-layer peel fill, then resolve and
texture only on the quads a masked fragment reaches) against the port's
own dense per-layer path and against the reference package's frame.

The scene is the reference's two-cutout stack (tests/test_e2e.py
`test_peel_merge_matches_dense`): a green card whose right half is cut
out, a red card behind it, an opaque backdrop; built here with the
reference package's GlbBuilder (the port never imports it) and handed to
both packages as the same arrays.

* The reference renders each path as the port does: the port's dense
  path equals the reference's dense path through its Pallas fill, and
  the port's compact merge equals the reference's compact merge, each
  within 1 on every pixel (measured: equal).
* Capacity 1.0 and 0.8 hold every hit quad: the image, ids and depth
  equal the dense path's, except on the pixels where the reference's
  own two paths disagree.  There, at the cards' silhouettes, a 2x2 quad
  holds a pixel no masked fragment covers: the dense path's fill kernel
  gives that pixel zero interpolant planes, the compact merge resolves
  it from record 0 (as the reference's XLA fill does), and the quad
  texture sampler pools uv over all four pixels, so the alpha test, and
  with it the winning layer, may change.  The port reproduces both
  paths, so it splits on the same pixels (186 of 16,384 here; ROADMAP
  queue 3).
* Capacity 0.05 drops quads: the image stays finite and equal to the
  dense path outside the masked cards.
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
from toyrenderer_tpu.engine.frame import make_render_fn as jax_render_fn
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu.scene import load_scene as jax_load_scene
from toyrenderer_tpu.tools.gen_scene import GlbBuilder, quad_card

from test_torch_raster import _one_torch_thread, scene_arrays  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, init_carry, make_render_fn)
from toyrenderer_tpu_torch.ops import peel_cuda
from toyrenderer_tpu_torch.weights import scene_from_numpy

SIZE = 128
COMMON = dict(width=SIZE, height=SIZE, manual_exposure=0.3, alpha_layers=2,
              max_tris_per_tile=64, max_big_tris=64, tile_batch=4)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    g = GlbBuilder(compress=False)
    img_f = np.zeros((64, 64, 4), np.uint8)
    img_f[:, :, 1] = 255
    img_f[:, :, 3] = 255
    img_f[:, 32:, 3] = 0
    img_b = np.zeros((64, 64, 4), np.uint8)
    img_b[:, :, 0] = 255
    img_b[:, :, 3] = 255
    mf = g.add_material("front", base_tex=g.add_texture(img_f),
                        alpha_mode="MASK", cutoff=0.5, double_sided=True)
    mb = g.add_material("back", base_tex=g.add_texture(img_b),
                        alpha_mode="MASK", cutoff=0.5, double_sided=True)
    mg = g.add_material("bg", base_color=(0.02, 0.02, 0.02, 1.0))
    g.add_node("bg", mesh=g.add_mesh("qg", *quad_card(20.0, 20.0), mg),
               t=(0, -10, -5.0))
    g.add_node("front", mesh=g.add_mesh("qf", *quad_card(2.0, 2.0), mf),
               t=(0, -1, 0))
    g.add_node("back", mesh=g.add_mesh("qb", *quad_card(2.0, 2.0), mb),
               t=(0, -1, -1.0))
    g.add_node("cam", camera=0, t=(0, 0, 2.5))
    g.add_node("sun", light=0, r=[-0.3, 0.1, 0.0,
                                  float(np.sqrt(1 - 0.09 - 0.01))])
    path = tmp_path_factory.mktemp("stack") / "stack.glb"
    g.finish(str(path), [{"type": "perspective",
                          "perspective": {"yfov": 1.0, "znear": 0.05}}],
             [{"type": "directional", "color": [1, 1, 1], "intensity": 3.0}])
    sh = jax_load_scene(str(path), use_cache=False)
    js = sh.to_device()
    view = JView.from_scene(sh, SIZE, SIZE)
    view.enable_jitter = False
    pairs = dict(zip(('pi', 'pm'), static_meshlet_pairs(sh, 'not_mask')))
    pairs.update(zip(('mi', 'mm'), static_meshlet_pairs(sh, 'mask')))
    return dict(sh=sh, js=js, ts=scene_from_numpy(scene_arrays(js), "cpu"),
                fi=jax_fi(sh, view.matrices()), **pairs)


def _port(stack, frac, **cfg_kw):
    st = RenderSettings(**COMMON, peel_merge_frac=frac)
    p = {k: torch.from_numpy(np.array(stack[k]))
         for k in ('pi', 'pm', 'mi', 'mm')}
    img, _, aux = make_render_fn(st, device="cpu", **cfg_kw)(
        stack['ts'], p['pi'], p['pm'], stack['fi'],
        init_carry(stack['ts'], st), mask_pair_inst=p['mi'],
        mask_pair_meshlet=p['mm'])
    return img.numpy().astype(int), aux


@pytest.fixture(scope="module")
def reference(stack):
    """The reference's frame through its Pallas fills (interpret mode):
    {peel_merge_frac: u8 image} for the dense path and the compact
    merge."""
    out = {}
    for frac in (0.0, 0.8):
        jst = JaxSettings(**COMMON, peel_merge_frac=frac,
                          use_pallas_fill=True)
        img, _, _ = jax_render_fn(jst)(
            stack['js'], jnp.asarray(stack['pi']), jnp.asarray(stack['pm']),
            stack['fi'], jax_init_carry(stack['js'], jst),
            mask_pair_inst=jnp.asarray(stack['mi']),
            mask_pair_meshlet=jnp.asarray(stack['mm']))
        out[frac] = np.asarray(img).astype(int)
    return out


def test_compact_merge_matches_dense_path(stack, reference):
    before = peel_cuda.launches
    dense, dense_aux = _port(stack, 0.0)
    split = (reference[0.0] != reference[0.8]).any(-1)
    assert 0 < split.mean() < 0.02
    for frac in (1.0, 0.8):
        img, aux = _port(stack, frac)
        for k in ('tri_id', 'depth'):
            np.testing.assert_array_equal(aux[k].numpy()[~split],
                                          dense_aux[k].numpy()[~split])
        np.testing.assert_array_equal(img[~split], dense[~split])
        assert (img != dense).any(-1)[split].all()
    # both cutout cards reach the image: green through the front card's
    # kept half, red through its cut-out half
    assert (dense[..., 1] > 2 * dense[..., 0] + 20).mean() > 0.02
    assert (dense[..., 0] > 2 * dense[..., 1] + 20).mean() > 0.02
    tiny, _ = _port(stack, 0.05)
    assert np.isfinite(tiny).all()
    np.testing.assert_array_equal(tiny[:, :10], dense[:, :10])
    assert (tiny != dense).any()             # quads past the cap drop
    assert peel_cuda.launches == before      # CPU tensors: plain version


@pytest.mark.parametrize("frac", [0.0, 0.8])
def test_frame_matches_reference(stack, reference, frac):
    port, _ = _port(stack, frac)
    assert np.abs(port - reference[frac]).max() <= 1


@pytest.mark.parametrize("frac", [0.0, 0.8])
def test_masked_set_takes_its_own_raster_config(stack, frac):
    """mask_raster_cfg bins the masked set alone: binned without span
    classes, the masked set reports its one class counter while the
    opaque set keeps its three; and the frame is the same bit for bit
    (the classes change how many slots a triangle gets, not the sorted
    pair stream)."""
    img, aux = _port(stack, frac)
    cfg_m = dataclasses.replace(RenderSettings(**COMMON).raster_config(),
                                bin_split=False)
    img_m, aux_m = _port(stack, frac, mask_raster_cfg=cfg_m)
    assert 'raster_mask_drop_small' in aux_m
    assert 'raster_mask_drop_rest' not in aux_m
    assert 'raster_drop_rest' in aux_m and 'raster_drop_small' not in aux_m
    np.testing.assert_array_equal(img_m, img)
    for k in ('tri_id', 'depth'):
        assert torch.equal(aux_m[k], aux[k])
