"""The port's `raster.rasterize` (setup, the dense (tiles, K) table, the
dense-table fill: the plain version of the CUDA kernel,
toyrenderer_tpu_torch/ops/dense_cuda.py) and `rasterize_bruteforce`
against the reference package's, on the Cornell box at 256x128 and on
random triangles at 128x128.  The kernel itself is held against the
plain version in tests/test_torch_kernel.py.

Both packages get the same clip-space triangles.  The reference's fill
runs as its Pallas kernel (`rasterize(use_pallas=True)`) in interpret
mode and as its XLA fill.  Tolerances: ids equal; depth on Cornell within
rtol 1e-6, atol 1e-7 -- the reference's Pallas and XLA fills are not
bit-equal in depth on the CPU (up to 6.9e-8 apart there), and the port
rounds like neither everywhere.  On the random triangles (one depth per
triangle, so the depth's numerator and denominator are sums whose terms
cancel, and XLA fuses some of their multiply-adds) the reference's own
two fills are up to 3.5e-6 apart, on 3,364 of 16,384 pixels: depth there
within atol 1e-5, the reference's own bound of its binned fill against
its bruteforce (tests/test_raster.py:141-144).  The port's binned path
against its own bruteforce: that bound (depth atol 1e-5, ids differing
on < 0.1% of the pixels, on exact depth ties).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from toyrenderer_tpu.engine import View
from toyrenderer_tpu.ops import raster as JR
from toyrenderer_tpu.ops.geometry import (
    instance_transforms, meshlet_clip_triangles, node_world_matrices,
    static_meshlet_pairs)
from toyrenderer_tpu.scene import load_scene

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import dense_cuda
from toyrenderer_tpu_torch.ops import raster as TR

CFG = dict(max_tris_per_tile=128, max_big_tris=64)


def _cornell_geo():
    w, h = 256, 128
    s = load_scene("resources/cornell.gltf", use_cache=False)
    d = s.to_device()
    pi, pm = static_meshlet_pairs(s)
    world = node_world_matrices(
        d, jnp.asarray(s.node_translation), jnp.asarray(s.node_rotation),
        jnp.asarray(s.node_scale))
    inst_world, _ = instance_transforms(d, world)
    geo = meshlet_clip_triangles(
        d, inst_world,
        jnp.asarray(View.from_scene(s, w, h).matrices()['view_proj']),
        jnp.asarray(pi), jnp.asarray(pm))
    return {k: np.asarray(v) for k, v in geo.items()}, w, h


def _random_geo(seed=7, t=60):
    """Random small double-sided triangles in front of the camera, as
    tests/test_raster.py:125-136 builds them."""
    rng = np.random.default_rng(seed)
    tris = np.zeros((t, 3, 4), np.float32)
    tris[..., :2] = (rng.uniform(-0.9, 0.9, size=(t, 1, 2))
                     + rng.uniform(-0.25, 0.25, size=(t, 3, 2)))
    tris[..., 2] = rng.uniform(0.1, 0.9, size=(t, 1))
    tris[..., 3] = 1.0
    return dict(clip=tris, vtx_ids=np.zeros((t, 3), np.int32),
                inst_id=np.zeros(t, np.int32), mat_id=np.zeros(t, np.int32),
                double_sided=np.ones(t, bool), tri_valid=np.ones(t, bool),
                pair_meshlet=np.zeros(1, np.int32),
                pair_inst=np.zeros(1, np.int32)), 128, 128


@pytest.fixture(scope="module", params=["cornell", "random"])
def case(request):
    geo, w, h = _cornell_geo() if request.param == "cornell" \
        else _random_geo()
    geo = {k: np.array(v) for k, v in geo.items()}
    return dict(geo=geo, jgeo={k: jnp.asarray(v) for k, v in geo.items()},
                tgeo={k: torch.from_numpy(v) for k, v in geo.items()},
                tol=(dict(rtol=1e-6, atol=1e-7) if request.param == "cornell"
                     else dict(rtol=0.0, atol=1e-5)),
                jcfg=JR.RasterConfig(width=w, height=h, **CFG),
                tcfg=TR.RasterConfig(width=w, height=h, **CFG))


def _assert_close(got, want, tol):
    (tz, tid), (jz, jid) = got, want
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **tol)


def _reference_kernel(case):
    with pltpu.force_tpu_interpret_mode():
        _, z, tid = JR.rasterize(case['jgeo'], case['jcfg'], use_pallas=True)
        return np.asarray(z), np.asarray(tid)


def test_rasterize_matches_reference_kernel(case):
    dense_cuda.launches = 0
    _, z, tid = TR.rasterize(case['tgeo'], case['tcfg'])
    _assert_close((z, tid), _reference_kernel(case), case['tol'])
    assert (tid >= 0).float().mean() > 0.05
    assert dense_cuda.launches == 0     # CPU tensors ran the plain version


def test_rasterize_matches_reference_xla_fill(case):
    _, z, tid = TR.rasterize(case['tgeo'], case['tcfg'], use_pallas=True)
    _, jz, jid = JR.rasterize(case['jgeo'], case['jcfg'])
    _assert_close((z, tid), (jz, jid), case['tol'])


def test_continuation_matches_reference_kernel(case):
    """A second fill over the same triangles moved nearer, continuing
    init planes (half the image drawn by the first fill, half empty)
    with its ids offset by T: the nearer copy wins where it covers, the
    init planes stay elsewhere bit for bit."""
    _, z0, id0 = TR.rasterize(case['tgeo'], case['tcfg'])
    z0, id0 = z0.numpy(), id0.numpy()
    half = np.arange(z0.shape[1])[None, :] < z0.shape[1] // 2
    init_z = np.where(half, z0, 0.0).astype(np.float32)
    init_id = np.where(half, id0, -1).astype(np.int32)
    geo = dict(case['geo'])
    clip = geo['clip'].copy()
    clip[..., 2] = clip[..., 2] + 0.05 * clip[..., 3]   # nearer (reverse-Z)
    geo['clip'] = clip
    t = clip.shape[0]
    jgeo = {k: jnp.asarray(v) for k, v in geo.items()}
    with pltpu.force_tpu_interpret_mode():
        _, jz, jid = JR.rasterize(jgeo, case['jcfg'], use_pallas=True,
                                  init_depth=jnp.asarray(init_z),
                                  init_tri_id=jnp.asarray(init_id),
                                  tri_id_base=t)
    _, z, tid = TR.rasterize({k: torch.from_numpy(v) for k, v in geo.items()},
                             case['tcfg'], init_depth=torch.from_numpy(init_z),
                             init_tri_id=torch.from_numpy(init_id),
                             tri_id_base=t)
    _assert_close((z, tid), (jz, jid), case['tol'])
    won = tid.numpy() >= t
    assert won.any() and (tid.numpy()[~won] == init_id[~won]).all()
    assert np.array_equal(z.numpy()[~won], init_z[~won])


def test_bruteforce_matches_reference(case):
    _, z, tid = TR.rasterize_bruteforce(case['tgeo'], case['tcfg'])
    _, jz, jid = JR.rasterize_bruteforce(case['jgeo'], case['jcfg'])
    _assert_close((z, tid), (jz, jid), case['tol'])


def test_binned_matches_bruteforce(case):
    _, zb, idb = TR.rasterize(case['tgeo'], case['tcfg'])
    _, zf, idf = TR.rasterize_bruteforce(case['tgeo'], case['tcfg'])
    np.testing.assert_allclose(zb.numpy(), zf.numpy(), atol=1e-5)
    assert (idb != idf).float().mean() < 0.001


def test_dense_kernel_inputs_on_cpu(case):
    """The dense-table kernel's prepared inputs on CPU tensors: its plain
    version on them (the reference the kernel is held against on the
    card) is raster.fill_visibility bit for bit, continuation included;
    the records its walk tests are each tile's first tile_count table
    entries and the big triangles whose tile bbox holds the tile; and no
    big triangle's record covers a pixel centre of a tile outside its
    bbox (what lets the walk skip them there)."""
    cfg = case['tcfg']
    setup = TR.setup_triangles(case['tgeo'], cfg)
    table, count, big, _ = TR.bin_triangles(setup, cfg)
    z0, id0 = TR.fill_visibility(setup, table, big, cfg)
    init_z = torch.where(torch.arange(z0.shape[1]) < 64, -2.0, z0 * 0.5)
    for kw in ({}, dict(init_depth=init_z, init_tri_id=id0, emit_base=99)):
        inp = dense_cuda.dense_inputs(setup, table, count, big, cfg, **kw)
        z, tid = dense_cuda.fill_dense_plain(inp)
        zw, idw = TR.fill_visibility(setup, table, big, cfg, **kw)
        assert torch.equal(tid, idw) and torch.equal(z, zw)
    tile, tri = dense_cuda.walked_pairs_by_tile(inp)
    tiles = torch.arange(cfg.num_tiles)
    tx, ty = tiles % cfg.tiles_x, tiles // cfg.tiles_x
    box = inp.big_box.long()
    nb = int((big >= 0).sum())          # 10 on Cornell, none at random
    inside = ((tx[:, None] >= box[None, :nb, 0])
              & (tx[:, None] <= box[None, :nb, 1])
              & (ty[:, None] >= box[None, :nb, 2])
              & (ty[:, None] <= box[None, :nb, 3]))        # (tiles, nb)
    assert tile.numel() == int(count.sum()) + int(inside.sum())
    assert torch.equal(inp.bighit, inside.any(1).to(torch.int32))
    pxn, pyn = TR.tile_pixel_coords(cfg, tiles)
    depth = TR.coverage_depth(inp.tri_rec[big[:nb].long()][None],
                              pxn[:, None], pyn[:, None])  # (tiles, nb, ..)
    assert bool((depth[~inside] == -1.0).all())
    assert nb == 0 or bool((depth[inside] != -1.0).any())
