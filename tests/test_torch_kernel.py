"""The CUDA kernels (fill+resolve, K1; L-layer peel fill, K2) against
their plain PyTorch versions.

These tests need the card (the kernel has no CPU mode) and skip
elsewhere.  They import nothing of JAX, so they also run where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_kernel.py

Tolerances: ids and depth bit-equal -- the kernels are built with
-fmad=false and evaluate edges and depth in the plain version's order,
and PyTorch's elementwise kernels round each operation once; planes to
1e-5, for the same sums with sqrt / divide rounding.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from toyrenderer_tpu_torch.engine import View, default_frame_inputs
from toyrenderer_tpu_torch.ops import geometry as G
from toyrenderer_tpu_torch.ops import peel_cuda as PC
from toyrenderer_tpu_torch.ops import raster as R
from toyrenderer_tpu_torch.ops import raster_cuda as RC
from toyrenderer_tpu_torch.ops.gbuffer import pack_resolve_records
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel only runs on the card)")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(name, w, h, dev, **cfg_kw):
    host = load_scene(ROOT / "resources" / name, use_cache=False)
    scene = host.to_device(dev)
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, w, h).matrices()), dev)
    world = G.node_world_matrices(scene, fi['node_translation'],
                                  fi['node_rotation'], fi['node_scale'])
    iw, adj = G.instance_transforms(scene, world)
    pi, pm = G.static_meshlet_pairs(host, 'not_mask')
    geo = G.meshlet_clip_triangles(scene, iw, fi['view_proj'],
                                   torch.from_numpy(pi).to(dev),
                                   torch.from_numpy(pm).to(dev))
    cfg = R.RasterConfig(width=w, height=h, **cfg_kw)
    setup = R.setup_triangles(geo, cfg)
    recs = pack_resolve_records(setup, scene, iw, adj, iw,
                                fi['prev_view_proj_nojitter'])
    return setup, recs, R.bin_pairs_stream(setup, cfg), cfg


def _assert_same(got, want):
    z_k, id_k, rec_k = (x.cpu() for x in got)
    z_p, id_p, rec_p = (x.cpu() for x in want)
    assert torch.equal(id_k, id_p)
    assert torch.equal(z_k, z_p)
    np.testing.assert_allclose(rec_k.numpy(), rec_p.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,size,cfg_kw", [
    ("cornell.gltf", (448, 256), dict(max_tris_per_tile=128,
                                      max_big_tris=64)),
    ("courtyard.glb", (640, 360), dict(max_tris_per_tile=2048,
                                       max_big_tris=2048, bin_slots_y=8,
                                       bin_slots_x=2, pair_capacity=4096)),
])
def test_kernel_matches_plain_version(cuda_device, scene, size, cfg_kw):
    """Opaque fill, a peeled second layer, and a continuation with init
    planes and an id offset; the courtyard case clips the pair budget,
    so some tiles are not visited and keep their init planes."""
    setup, recs, bins, cfg = _inputs(scene, *size, cuda_device, **cfg_kw)
    first = RC.fill_inputs(setup, recs, bins, cfg)
    before = RC.launches
    got = RC.launch(first)
    torch.cuda.synchronize()
    assert RC.launches == before + 1
    _assert_same(got, RC.fill_resolve_plain(first))
    z0, id0, rec0 = got
    for kw in (dict(peel_depth=z0),
               dict(init_depth=z0 * 0.5, init_tri_id=id0 * 0 + 7,
                    init_rec=rec0, emit_base=1000)):
        inp = RC.fill_inputs(setup, recs, bins, cfg, padded_io=True, **kw)
        _assert_same(RC.launch(inp), RC.fill_resolve_plain(inp))
    if 'pair_capacity' in cfg_kw:
        assert bool((first.lay['n_chunks'] == 0).any())


@pytest.mark.cuda
def test_wrapper_launches_for_cuda_tensors(cuda_device):
    setup, recs, bins, cfg = _inputs("cornell.gltf", 448, 256, cuda_device,
                                     max_tris_per_tile=128, max_big_tris=64)
    before = RC.launches
    z, tid, planes = RC.fill_resolve_stream(setup, recs, bins, cfg)
    assert RC.launches == before + 1
    assert z.is_cuda and z.shape == (256, 448) and planes.shape[0] == 32
    with pytest.raises(ValueError):            # wrong dtype is refused
        RC.launch(RC.fill_inputs(setup, recs.double(), bins, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,size,cfg_kw", [
    ("cornell.gltf", (448, 256), dict(max_tris_per_tile=128,
                                      max_big_tris=64)),
    ("courtyard.glb", (640, 360), dict(max_tris_per_tile=2048,
                                       max_big_tris=2048, bin_slots_y=8,
                                       bin_slots_x=2, pair_capacity=4096)),
])
def test_peel_kernel_matches_plain_version(cuda_device, scene, size,
                                           cfg_kw):
    """1, 2 and 4 layers, without and with an occluder (part of the
    nearest surface's depth) and an id offset; the courtyard case clips
    the pair budget, so some tiles are not visited and keep the
    occluder."""
    setup, recs, bins, cfg = _inputs(scene, *size, cuda_device, **cfg_kw)
    z0 = RC.fill_resolve_stream(setup, recs, bins, cfg)[0]
    for layers, occ, emit in ((2, None, 0), (2, z0 * 0.5, 100),
                              (1, z0 * 0.9, 0), (4, z0 * 0.25, 7)):
        inp = PC.peel_inputs(setup, bins, cfg, layers, emit, occ)
        before = PC.launches
        z_k, id_k = PC.launch(inp)
        torch.cuda.synchronize()
        assert PC.launches == before + 1
        z_p, id_p = PC.fill_peel_plain(inp)
        assert torch.equal(id_k, id_p), (layers, int((id_k != id_p).sum()))
        assert torch.equal(z_k, z_p), layers
        assert bool((id_k[0] >= emit).any())
    if 'pair_capacity' in cfg_kw:
        assert bool((inp.lay['n_chunks'] == 0).any())


@pytest.mark.cuda
def test_peel_wrapper_launches_for_cuda_tensors(cuda_device):
    setup, recs, bins, cfg = _inputs("cornell.gltf", 448, 256, cuda_device,
                                     max_tris_per_tile=128, max_big_tris=64)
    before = PC.launches
    z, tid = PC.fill_peel_stream(setup, bins, cfg, layers=2)
    assert PC.launches == before + 1
    assert z.is_cuda and z.shape == (2, 256, 448) and tid.shape == z.shape
    with pytest.raises(ValueError):            # wrong dtype is refused
        PC.launch(PC.peel_inputs(setup, bins, cfg, 2, 0,
                                 torch.zeros(256, 448, dtype=torch.float64,
                                             device=cuda_device)))
