"""The port's streaming managers (engine/streaming.py) against the
reference package's, and the reference's own streaming behaviours.

Parity: both packages' TileStreamingManager and TextureStreamingManager
get the same atlas and the same feedback sequences -- hot tiles with
finer wants, then cold updates that evict and defrag, then a re-warm --
and after every update their tables, descriptor rows, min mips, stats,
slot maps and pools are equal, the pool bit for bit.  The port's pool is
one tensor, written in place: every update hands back the same object.

Behaviours (the reference's tests/test_streaming.py, on the port's own
atlas builder and sampler): coarse-only initial residency, streaming in
on demand, eviction, the block allocator's reuse, the tile fallback and
its refinement under the sampler's own feedback, eviction + defrag, the
bookkeeping's speed at a 4096-tile pool (the reference's 0.9 s bound),
and the disk-backed tile bank's asynchronous reads.
"""

import time
from dataclasses import replace

import numpy as np
import pytest
import torch

from toyrenderer_tpu.engine import streaming as JS
from toyrenderer_tpu.scene import textures as JX

from toyrenderer_tpu_torch.engine.streaming import (
    TILE, TILE_ROWS, TexelTileBank, TextureStreamingManager,
    TileStreamingManager)
from toyrenderer_tpu_torch.ops import texture as TT
from toyrenderer_tpu_torch.scene import textures as TX


def _random_images(sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        img[..., 3] = 255
        out.append(img)
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _check_same(ref, port, ref_ov, port_ov):
    assert ref_ov.keys() == port_ov.keys()
    for k, v in ref_ov.items():
        np.testing.assert_array_equal(port_ov[k].numpy(), _bits(v),
                                      err_msg=k)
    assert port_ov['tex_texels'] is port.pool
    assert port.stats == ref.stats
    if isinstance(ref, JS.TileStreamingManager):
        assert port.slot_of == ref.slot_of
        assert port.tile_of_slot == ref.tile_of_slot
        assert list(port.free) == list(ref.free)
        np.testing.assert_array_equal(port.table, ref.table)
    else:
        assert port.block_of == ref.block_of
        assert port.free == ref.free
        np.testing.assert_array_equal(port.resident_min, ref.resident_min)


def test_tile_manager_matches_reference():
    imgs = _random_images([(256, 256), (300, 180), (128, 128), (512, 512),
                           (64, 64)], 7)
    ja = JX.build_atlas(images=imgs)
    ta = TX.build_atlas(images=imgs)
    kw = dict(pool_tiles=44, tiles_per_frame=8, defrag_per_frame=4,
              evict_after=2)
    ref = JS.TileStreamingManager(ja, **kw)
    port = TileStreamingManager(ta, device="cpu", **kw)
    assert port.table_size == ref.table_size and port.slot0 == ref.slot0
    rng = np.random.default_rng(1)
    n = ref.table_size
    seq = [np.full(n, np.inf, np.float32)]
    for i in range(9):
        fb = np.full(n, np.inf, np.float32)
        if i < 4 or i == 8:                 # hot, then cold, then re-warm
            hot = rng.choice(n, 24, replace=False)
            fb[hot] = rng.uniform(-1.0, 4.0, hot.size)
        seq.append(fb)
    for fb in seq:
        _check_same(ref, port, ref.update(fb), port.update(torch.from_numpy(
            fb)))
    assert port.stats['tile_evictions'] > 0
    assert port.stats['defrag_moves'] > 0
    assert port.uploaded_bytes > 0


def test_mip_manager_matches_reference():
    imgs = _random_images([(256, 256), (200, 150), (128, 64), (512, 512),
                           (40, 40)], 3)
    ja = JX.build_atlas(images=imgs)
    ta = TX.build_atlas(images=imgs)
    kw = dict(pool_texels=1 << 18, textures_per_frame=2)
    ref = JS.TextureStreamingManager(ja, **kw)
    port = TextureStreamingManager(ta, device="cpu", **kw)
    rng = np.random.default_rng(5)
    for i in range(12):
        fb = np.where(rng.uniform(size=5) < (0.8 if i < 6 else 0.1),
                      rng.uniform(0.0, 6.0, 5), np.inf).astype(np.float32)
        _check_same(ref, port, ref.update(fb), port.update(fb))
    assert port.stats['evictions'] > 0 and port.stats['loads'] > 0


# -- the reference's streaming behaviours, on the port ----------------------

@pytest.fixture()
def mgr():
    atlas = TX.build_atlas(images=[TX.checkerboard(256, 8),
                                   TX.checkerboard(128, 4)])
    return atlas, TextureStreamingManager(atlas, pool_texels=1 << 20,
                                          textures_per_frame=10,
                                          device="cpu")


def test_initial_residency_coarse_only(mgr):
    atlas, m = mgr
    # only mips <= 32x32 resident at start
    assert (m.resident_min > 0).all()
    for t in range(m.n_tex):
        assert atlas.desc_width[t, m.resident_min[t]] <= 32
        assert m.desc_offset[t, m.resident_min[t]] >= 0
        assert m.desc_offset[t, 0] == -1


def test_streams_in_on_demand(mgr):
    atlas, m = mgr
    fb = np.asarray([0.0, np.inf])      # texture 0 wants mip 0
    for _ in range(10):
        ov = m.update(fb)
    assert m.resident_min[0] == 0
    assert m.desc_offset[0, 0] >= 0
    # samples from the pool match the original mip-0 data
    dev = dict(atlas.to_device("cpu"), **ov)
    uv = torch.tensor([[0.3, 0.7]])
    zero = torch.zeros((1, 2))
    ent = torch.tensor([0], dtype=torch.int32)
    got = TT.sample_texture(dev, ent, uv, zero, zero)
    want = TT.sample_texture(atlas.to_device("cpu"), ent, uv, zero, zero)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_evicts_when_unneeded(mgr):
    _, m = mgr
    for _ in range(10):
        m.update(np.asarray([0.0, 0.0]))
    assert m.resident_min[0] == 0
    tex_before = m.stats['resident_texels']
    for _ in range(20):
        m.update(np.asarray([np.inf, np.inf]))   # nothing sampled
    assert m.resident_min[0] > 0
    assert m.stats['evictions'] > 0
    assert m.stats['resident_texels'] < tex_before


def test_pool_allocator_reuses_space(mgr):
    _, m = mgr
    total_free_before = sum(sz for _, sz in m.free)
    for _ in range(10):
        m.update(np.asarray([0.0, 0.0]))
    for _ in range(30):
        m.update(np.asarray([np.inf, np.inf]))
    for _ in range(10):
        m.update(np.asarray([0.0, 0.0]))
    # blocks merged back and reused: free space bounded
    assert sum(sz for _, sz in m.free) <= total_free_before
    # no overlapping live blocks
    blocks = sorted(m.block_of.values())
    for (o1, s1), (o2, _) in zip(blocks, blocks[1:]):
        assert o1 + s1 <= o2


def _sample_mip0(dev, n=8):
    """Sample an n x n grid of points at mip 0 (tiny derivatives)."""
    g = (np.arange(n) + 0.5) / n
    uv = torch.tensor([[u, v] for v in g for u in g], dtype=torch.float32)
    k = uv.shape[0]
    d = torch.full((k, 2), 1e-4)
    return TT.sample_texture(dev, torch.zeros(k, dtype=torch.int32), uv, d,
                             d).numpy()


@pytest.fixture()
def tile_mgr():
    atlas = TX.build_atlas(images=_random_images([(256, 256)], 7))
    return atlas, TileStreamingManager(atlas, pool_tiles=32,
                                       tiles_per_frame=8, evict_after=5,
                                       device="cpu")


def test_tiles_initial_fallback_then_refine(tile_mgr):
    atlas, m = tile_mgr
    # 256: mip0 = 4x4 tiles, mip1 (128) = 2x2 tiles (pinned), mip2+ static
    assert m.first_tiled[0] == 1
    assert m.stats['resident_tiles'] == 4          # pinned 2x2

    truth = _sample_mip0(atlas.to_device("cpu"))
    ov = m.update(np.full(m.table_size, np.inf))
    dev = dict(atlas.to_device("cpu"), **ov)
    # the fallback serves the pinned coarser mip: it differs from mip 0
    assert not np.allclose(_sample_mip0(dev), truth, atol=0.05)

    # drive with the sampler's own per-tile feedback until resident
    g = (np.arange(8) + 0.5) / 8
    uv = torch.tensor([[u, v] for v in g for u in g], dtype=torch.float32)
    d = torch.full((64, 2), 1e-4)
    for _ in range(8):
        maps = TT.sample_material_maps(
            dev, torch.zeros(64, dtype=torch.int32), uv, d, d)
        fb = TT.vt_tile_feedback(maps['tile_id'], maps['desired'],
                                 m.table_size)
        ov = m.update(fb)
        dev = dict(atlas.to_device("cpu"), **ov)
    np.testing.assert_allclose(_sample_mip0(dev), truth, atol=1e-3)
    assert m.stats['tile_loads'] >= 16 + 4         # all mip-0 tiles in


def test_tiles_evict_and_defrag(tile_mgr):
    atlas, m = tile_mgr
    fb_hot = np.zeros(m.table_size, np.float32)
    for _ in range(6):
        m.update(fb_hot)
    assert m.stats['resident_tiles'] > 4
    # go cold: everything but the pinned fallback evicts
    for _ in range(10):
        ov = m.update(np.full(m.table_size, np.inf))
    assert m.stats['tile_evictions'] > 0
    assert m.stats['resident_tiles'] == 4
    # pool compacted: occupied slots are the lowest ones
    occupied = sorted(m.tile_of_slot)
    assert occupied == list(range(m.slot0, m.slot0 + len(occupied)))
    dev = dict(atlas.to_device("cpu"), **ov)
    assert np.isfinite(_sample_mip0(dev)).all()
    # re-loading after defrag lands correct content
    for _ in range(8):
        ov = m.update(fb_hot)
    dev = dict(atlas.to_device("cpu"), **ov)
    np.testing.assert_allclose(_sample_mip0(dev),
                               _sample_mip0(atlas.to_device("cpu")),
                               atol=1e-3)


def test_tile_manager_scales_to_4k_pool():
    """Bookkeeping stays O(hot tiles) per update: a 4096-tile pool over
    a large texture set with a big tile table updates within the
    reference's bound (0.9 s; its quadratic regression measured > 1 s)."""
    rng = np.random.default_rng(3)
    atlas = TX.build_atlas(images=_random_images([(512, 512)] * 24, 3))
    m = TileStreamingManager(atlas, pool_tiles=4096, tiles_per_frame=64,
                             defrag_per_frame=16, evict_after=4,
                             device="cpu")
    assert m.table_size > 2000

    # the inverse table agrees with the grid layout everywhere
    for tid in range(0, m.table_size, 97):
        t, mm, ty, tx = m.tid_key[tid]
        tb = m.tile_base[t, mm]
        ht, wt = m.grid[(int(t), int(mm))]
        assert tb <= tid < tb + ht * wt
        assert tid == tb + ty * wt + tx

    fb = np.full(m.table_size, np.inf, np.float32)
    fb[rng.choice(m.table_size, 64, replace=False)] = 0.0
    m.update(fb)
    t0 = time.time()
    for _ in range(12):
        fb[:] = np.inf
        fb[rng.choice(m.table_size, 64, replace=False)] = 0.0
        m.update(fb)
    dt = (time.time() - t0) / 12
    assert dt < 0.9, f"update too slow: {dt * 1e3:.1f} ms"
    # every entry points at a resident slot or a pinned fallback
    resident = m.table_slot >= 0
    ent = m.table
    assert (ent[resident] == m.table_slot[resident]).all()
    fall = ent[~resident]
    assert fall.size == 0 or ((fall >> 24) > 0).all()


def test_async_tile_bank_streams_from_disk(tmp_path):
    """Tile bytes come from DISK through the async bank: the manager
    never touches atlas.texels (a 1-row stub), reads run on the bank's
    threads, and streamed-in tiles equal the original data bit for
    bit."""
    atlas = TX.build_atlas(images=_random_images([(256, 256)], 11))
    bank_path = str(tmp_path / "texels.bank")
    TexelTileBank.write(atlas, bank_path)
    stub = replace(atlas, texels=np.zeros((1, atlas.texels.shape[1]),
                                          np.uint32))
    src = TexelTileBank(bank_path)
    m = TileStreamingManager(stub, pool_tiles=32, tiles_per_frame=8,
                             evict_after=10, source=src, device="cpu")

    # mip-0 feedback: the first update schedules reads, later ones upload
    fb = np.full(m.table_size, np.inf, np.float32)
    tb0 = int(m.tile_base[0, 0])
    fb[tb0:tb0 + 4] = 0.0
    want_keys = [(0, 0, 0, k) for k in range(4)]
    ov = None
    for _ in range(50):
        ov = m.update(fb)
        if all(k in m.slot_of for k in want_keys):
            break
        time.sleep(0.02)
    assert src.stats['async_reads'] >= 4
    for k in want_keys:
        assert k in m.slot_of, "tile never streamed in"

    pool = ov['tex_texels'].numpy()
    slot = m.slot_of[(0, 0, 0, 0)]
    got = pool[slot * TILE_ROWS:(slot + 1) * TILE_ROWS]
    w, h = int(atlas.desc_width[0, 0]), int(atlas.desc_height[0, 0])
    o = int(atlas.desc_offset[0, 0])
    want = atlas.texels[o:o + w * h].reshape(h, w, -1)[
        :TILE, :TILE].reshape(TILE_ROWS, -1)
    np.testing.assert_array_equal(got, want.view(np.int32))
