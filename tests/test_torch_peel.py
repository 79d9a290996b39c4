"""Parity of the port's L-layer peel fill (`fill_peel_plain`, the plain
PyTorch version of the CUDA kernel csrc/fill_peel.cu) with the reference
package's Pallas kernel `_fill_peel_stream_kernel` in interpret mode.
The kernel itself is held against the plain version in
tests/test_torch_kernel.py.

Both packages get the SAME triangle setup and pair stream (the
reference's, handed over as numpy), so the fill itself is compared.
Tolerances, as tests/test_torch_fill.py holds the fill+resolve kernel:
triangle ids exact (the cascade is a chain of compares and selects, and
the stream order is the same); depth rtol 1e-6 (XLA may fuse a
multiply-add the port rounds twice).  A fragment whose depth lies within
an ulp of a layer's PEEL_BOUND band could be dropped in one package and
kept in the other, which would show as an id difference: none occurs
here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.engine import View
from toyrenderer_tpu.ops import raster as JR
from toyrenderer_tpu.ops.geometry import (
    instance_transforms, meshlet_clip_triangles, node_world_matrices,
    static_meshlet_pairs)
from toyrenderer_tpu.ops.raster_pallas import fill_peel_stream as jpeel
from toyrenderer_tpu.scene import load_scene

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import peel_cuda as TP
from toyrenderer_tpu_torch.ops import raster as TR

W, H = 448, 256
CFG = dict(width=W, height=H, max_tris_per_tile=128, max_big_tris=64)


@pytest.fixture(scope="module")
def cornell():
    """The reference's setup / pair stream for the Cornell scene at
    448x256 with the pair budget `cap`, and the same as torch tensors."""
    s = load_scene("resources/cornell.gltf", use_cache=False)
    d = s.to_device()
    pi, pm = static_meshlet_pairs(s)
    mats = View.from_scene(s, W, H).matrices()
    world = node_world_matrices(
        d, jnp.asarray(s.node_translation), jnp.asarray(s.node_rotation),
        jnp.asarray(s.node_scale))
    inst_world, _ = instance_transforms(d, world)
    geo = meshlet_clip_triangles(d, inst_world,
                                 jnp.asarray(mats['view_proj']),
                                 jnp.asarray(pi), jnp.asarray(pm))

    def t(x):
        return torch.from_numpy(np.array(x))
    out = {}
    for cap in (None, 256):       # the default budget, and one that clips
        cfg = JR.RasterConfig(**CFG, pair_capacity=cap)
        setup = JR.setup_triangles(geo, cfg)
        bins = JR.bin_pairs_stream(setup, cfg)
        out[cap] = dict(
            cfg=cfg, setup=setup, bins=bins,
            tcfg=TR.RasterConfig(**CFG, pair_capacity=cap),
            tsetup={k: t(v) for k, v in setup.items()},
            tbins=dict({k: t(v) for k, v in bins.items() if k != 'drop'},
                       drop={}))
    return out


@pytest.mark.parametrize("cap", [None, 256])
@pytest.mark.parametrize("occluded", [False, True])
def test_plain_peel_matches_pallas_interpret(cornell, cap, occluded):
    """Two layers, without an occluder and with one (half the nearest
    layer's depth, so that some fragments hide behind it) and an id
    offset; cap=256 clips the pair budget, leaving tiles unvisited."""
    c = cornell[cap]
    kw = {}
    if occluded:
        z0, _ = jpeel(c['setup'], c['bins'], c['cfg'], layers=1,
                      interpret=True)
        kw = dict(occluder_depth=np.asarray(z0[0]) * np.float32(0.5),
                  emit_base=100)
    z_j, id_j = jpeel(c['setup'], c['bins'], c['cfg'], layers=2,
                      interpret=True,
                      **{k: jnp.asarray(v) if k == 'occluder_depth' else v
                         for k, v in kw.items()})
    z_t, id_t = TP.fill_peel_stream(
        c['tsetup'], c['tbins'], c['tcfg'], layers=2,
        **{k: torch.from_numpy(v) if k == 'occluder_depth' else v
           for k, v in kw.items()})
    z_j, id_j = np.asarray(z_j), np.asarray(id_j)
    assert z_t.shape == (2, H, W) and id_t.dtype == torch.int32
    np.testing.assert_array_equal(id_t.numpy(), id_j)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-6, atol=1e-7)
    assert (id_j[0] >= 0).mean() > 0.3 and (id_j[1] >= 0).any()
    if occluded:
        # where no fragment won, a layer keeps the occluder's depth
        keep = id_j < 0
        np.testing.assert_array_equal(
            z_t.numpy()[keep],
            np.broadcast_to(kw['occluder_depth'], z_j.shape)[keep])
        assert (id_j[0] >= 100).any()
    if cap is not None:
        lay = TP.peel_inputs(c['tsetup'], c['tbins'], c['tcfg']).lay
        assert bool((lay['n_chunks'] == 0).any())   # unvisited tiles
    assert TP.launches == 0                  # CPU tensors: plain version


def test_big_bbox_filter_changes_nothing(cornell):
    """Each tile tests only the big triangles whose tile bbox holds it;
    testing every big triangle on every tile gives the same layers."""
    c = cornell[None]
    inp = TP.peel_inputs(c['tsetup'], c['tbins'], c['tcfg'], layers=2)
    nb = int((inp.bins['big_list'] >= 0).sum())
    assert nb > 0
    whole = torch.tensor([0, inp.cfg.tiles_x - 1, 0, inp.cfg.tiles_y - 1],
                         dtype=torch.int32)
    every = dataclasses.replace(inp, lay=dict(
        inp.lay, big_box=whole.expand_as(inp.lay['big_box'])))
    z_f, id_f = TP.fill_peel_plain(inp)
    z_e, id_e = TP.fill_peel_plain(every)
    assert torch.equal(id_f, id_e) and torch.equal(z_f, z_e)
