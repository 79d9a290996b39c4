"""Content-sized span-class caps (engine/capacity.py).

The binning's span-class caps are fractions of a set's triangle count
that the settings do not reach; the courtyard's alpha-masked set at
640x360 holds more `rest` triangles than its default cap, and drops
them.  The sized RasterConfig covers every class, so it drops nothing.
A cap only bounds how many slots a class gets and pairs keep their
stable per-tile order, so wherever the default caps drop nothing the
sized config's pair stream and fills are bit-equal to the default's.
"""

import dataclasses

import pytest
import torch

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, render_frame)
from toyrenderer_tpu_torch.engine.capacity import (
    sized_raster_config, tile_pair_counts)
from toyrenderer_tpu_torch.ops import geometry as G
from toyrenderer_tpu_torch.ops import raster as R
from toyrenderer_tpu_torch.ops import peel_cuda, raster_cuda
from toyrenderer_tpu_torch.ops.gbuffer import pack_resolve_records
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy


@pytest.fixture(scope="module")
def courtyard():
    host = load_scene("resources/courtyard.glb", use_cache=False)
    return host, host.to_device("cpu")


def _masked_set(host, scene, w, h):
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, w, h).matrices()), "cpu")
    pairs = tuple(map(torch.from_numpy, G.static_meshlet_pairs(host, 'mask')))
    world = G.node_world_matrices(scene, fi['node_translation'],
                                  fi['node_rotation'], fi['node_scale'])
    iw, adj = G.instance_transforms(scene, world)
    geo = G.meshlet_clip_triangles(scene, iw, fi['view_proj'], *pairs)
    return fi, pairs, geo, (iw, adj)


def test_sized_class_caps_drop_nothing(courtyard):
    host, scene = courtyard
    st = RenderSettings(width=640, height=360)
    fi, pairs, geo, _ = _masked_set(host, scene, 640, 360)
    counts = tile_pair_counts(scene, fi, st, {'masked': pairs})
    assert counts['masked']['drop']['drop_rest'] > 0
    default = st.raster_config()
    sized = sized_raster_config(st, counts)
    assert sized.rest_frac > default.rest_frac
    assert sized_raster_config(st, dict(counts, other=dict(
        counts['masked'], classes=dict(tiny=0, short=0, rest=0)))) == sized
    drops = {}
    for name, cfg in (('default', default), ('sized', sized)):
        bins = R.bin_pairs_stream(R.setup_triangles(geo, cfg), cfg)
        drops[name] = {k: int(v) for k, v in bins['drop'].items()}
        if name == 'sized':
            assert int(bins['counts'].sum()) == counts['masked']['pairs']
    assert drops['default']['drop_rest'] == \
        counts['masked']['drop']['drop_rest']
    assert not any(drops['sized'].values()), drops['sized']


def test_sized_config_is_bit_equal_where_nothing_drops(courtyard):
    """The masked set at 384x216 drops nothing at the default caps; with
    the (larger) caps sized for 640x360, its pair stream, fill+resolve
    and peel fill are the same bit for bit."""
    host, scene = courtyard
    fi640, pairs, _, _ = _masked_set(host, scene, 640, 360)
    big = sized_raster_config(RenderSettings(width=640, height=360),
                              tile_pair_counts(scene, fi640, RenderSettings(
                                  width=640, height=360),
                                  {'masked': pairs}))
    fi, pairs, geo, (iw, adj) = _masked_set(host, scene, 384, 216)
    default = RenderSettings(width=384, height=216).raster_config()
    sized = dataclasses.replace(big, width=384, height=216)
    assert sized != default
    out = {}
    for name, cfg in (('default', default), ('sized', sized)):
        setup = R.setup_triangles(geo, cfg)
        bins = R.bin_pairs_stream(setup, cfg)
        assert not any(int(v) for v in bins['drop'].values())
        recs = pack_resolve_records(setup, scene, iw, adj, iw,
                                    fi['prev_view_proj_nojitter'])
        n = int(bins['offs'][-1])
        out[name] = [bins['offs'], bins['counts'], bins['vals_s'][:n],
                     *raster_cuda.fill_resolve_stream(setup, recs, bins,
                                                      cfg),
                     *peel_cuda.fill_peel_stream(setup, bins, cfg)]
    for a, b in zip(out['default'], out['sized']):
        assert torch.equal(a, b)
    assert (out['sized'][4] >= 0).any()         # the fill drew pixels


@pytest.mark.parametrize("arg", ["raster_cfg", "mask_raster_cfg"])
def test_render_frame_refuses_a_config_of_another_size(courtyard, arg):
    _, scene = courtyard
    st = RenderSettings(width=64, height=32)
    other = RenderSettings(width=32, height=32).raster_config()
    with pytest.raises(ValueError, match=f"^{arg} is 32x32"):
        render_frame(scene, torch.zeros(1, dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32), {}, init_carry(
                         scene, st), st, **{arg: other})
