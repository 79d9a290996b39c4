"""Parity of the port's fused fill+resolve (the plain PyTorch version of
the CUDA kernel, toyrenderer_tpu_torch/ops/raster_cuda.py) with the
reference package's Pallas kernel in interpret mode.  The kernel itself
is held against the plain version in tests/test_torch_kernel.py.

Both packages get the SAME triangle setup, resolve records and pair
stream (the reference's, handed over as numpy), so the fill itself is
what is compared.  Tolerances:
  * triangle ids exact: the port evaluates edges and depth in the
    reference's association order, and ties keep the first fragment in
    stream order in both;
  * depth rtol 1e-6: XLA may fuse a multiply-add the port rounds twice
    (the reference's own tests hold its two fills to the same bound);
  * interpolant planes per plane, as tests/test_raster.py holds the
    reference's kernel to its XLA resolve: the Pallas kernel fetches
    records through hi/lo bf16 products (~2^-17 relative) where the port
    gathers exact f32, and the derivative planes subtract near-equal
    interpolants.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.engine import View
from toyrenderer_tpu.ops import gbuffer as JGB
from toyrenderer_tpu.ops import raster as JR
from toyrenderer_tpu.ops.geometry import (
    instance_transforms, meshlet_clip_triangles, node_world_matrices,
    static_meshlet_pairs)
from toyrenderer_tpu.ops.raster_pallas import fill_resolve_stream as jfill
from toyrenderer_tpu.scene import load_scene

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import gbuffer as TGB
from toyrenderer_tpu_torch.ops import raster as TR
from toyrenderer_tpu_torch.ops import raster_cuda as TRC

W, H = 448, 256
CFG = dict(width=W, height=H, max_tris_per_tile=128, max_big_tris=64)


@pytest.fixture(scope="module")
def cornell():
    """The reference's setup / records / pair stream for the Cornell
    scene at 448x256, and the same as torch CPU tensors."""
    s = load_scene("resources/cornell.gltf", use_cache=False)
    d = s.to_device()
    pi, pm = static_meshlet_pairs(s)
    mats = View.from_scene(s, W, H).matrices()
    world = node_world_matrices(
        d, jnp.asarray(s.node_translation), jnp.asarray(s.node_rotation),
        jnp.asarray(s.node_scale))
    inst_world, inst_adj = instance_transforms(d, world)
    geo = meshlet_clip_triangles(d, inst_world,
                                 jnp.asarray(mats['view_proj']),
                                 jnp.asarray(pi), jnp.asarray(pm))
    cfg = JR.RasterConfig(**CFG)
    setup = JR.setup_triangles(geo, cfg)
    records = JGB.pack_resolve_records(
        setup, d, inst_world, inst_adj, inst_world,
        jnp.asarray(mats['prev_view_proj_nojitter']))
    bins = JR.bin_pairs_stream(setup, cfg)

    def t(x):
        return torch.from_numpy(np.array(x))
    return dict(
        cfg=cfg, setup=setup, records=records, bins=bins,
        tcfg=TR.RasterConfig(**CFG),
        tsetup={k: t(v) for k, v in setup.items()},
        trecords=t(records),
        tbins=dict({k: t(v) for k, v in bins.items() if k != 'drop'},
                   drop={}))


def _check_planes(got, want):
    """Per-plane tolerances of tests/test_raster.py:262-279."""
    deriv = range(5, 15)                      # duv_dx/duv_dy/T/B planes
    prev = range(28, 31)                      # clip-scale prev_xyw planes
    for ch in range(TGB.INTERP_C):
        tol = 2e-3 if ch in deriv else (1e-3 if ch in prev else 1e-4)
        ok = np.isclose(got[:, ch], want[:, ch], rtol=tol, atol=tol)
        assert ok.mean() > 0.995, (ch, ok.mean())
        ok10 = np.isclose(got[:, ch], want[:, ch], rtol=10 * tol,
                          atol=10 * tol)
        assert ok10.mean() > 0.9995, (ch, ok10.mean())
    # integer-valued planes (material, atlas entry, statics) exactly
    for ch in (TGB.I_MAT, TGB.I_TEX, TGB.I_WS, TGB.I_H0):
        np.testing.assert_array_equal(np.round(got[:, ch]), want[:, ch])


def test_stream_layout_matches_reference(cornell):
    from toyrenderer_tpu.ops.raster_pallas import _stream_layout
    c = 32
    for cap in (None, 256):     # the default budget, and one that clips
        cfg = JR.RasterConfig(**CFG, pair_capacity=cap)
        tcfg = TR.RasterConfig(**CFG, pair_capacity=cap)
        recs = cornell['records']
        comb = jnp.concatenate([jnp.zeros((recs.shape[0], 16)), recs], 1)
        want = _stream_layout(cornell['setup'], cornell['bins'], cfg, comb,
                              c)
        acc = _stream_layout(cornell['setup'], cornell['bins'], cfg, None, c)
        got = TRC.stream_layout(cornell['tsetup'], cornell['tbins'], tcfg, c)
        assert got['ch_cap'] == want['ch_cap']
        for k, ref in (('counts_eff', want['counts_eff']),
                       ('bighit', want['bighit']),
                       ('chunk_base', jnp.concatenate(
                           [want['chunk_base'],
                            acc['total_chunks'].reshape(1)])),
                       ('total_chunks', acc['total_chunks']),
                       ('counts_clamped', acc['counts_clamped'])):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref),
                                          err_msg=k)


def test_plain_fill_matches_pallas_interpret(cornell):
    """Opaque fill, then a continuation with init planes and emit_base."""
    z_j, id_j, rec_j = jfill(cornell['setup'], cornell['records'],
                             cornell['bins'], cornell['cfg'], interpret=True)
    z_t, id_t, rec_t = TRC.fill_resolve_stream(
        cornell['tsetup'], cornell['trecords'], cornell['tbins'],
        cornell['tcfg'])
    z_j, id_j = np.asarray(z_j), np.asarray(id_j)
    np.testing.assert_array_equal(id_t.numpy(), id_j)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-6, atol=1e-7)
    m = id_j >= 0
    assert m.mean() > 0.5                     # the scene covers the view
    _check_planes(rec_t.numpy()[:, m].T, np.asarray(rec_j)[:, m].T)
    assert TRC.launches == 0                  # CPU tensors: plain version

    # phase-2 continuation: other init planes and an id offset
    init_z = (z_j * 0.5).astype(np.float32)
    init_id = (id_j * 0 + 7).astype(np.int32)
    z2j, id2j, rec2j = jfill(
        cornell['setup'], cornell['records'], cornell['bins'],
        cornell['cfg'], init_depth=jnp.asarray(init_z),
        init_tri_id=jnp.asarray(init_id), init_rec=rec_j, emit_base=1000,
        interpret=True)
    z2t, id2t, rec2t = TRC.fill_resolve_stream(
        cornell['tsetup'], cornell['trecords'], cornell['tbins'],
        cornell['tcfg'], init_depth=torch.from_numpy(init_z),
        init_tri_id=torch.from_numpy(init_id),
        init_rec=torch.from_numpy(np.array(rec_j)), emit_base=1000)
    np.testing.assert_array_equal(id2t.numpy(), np.asarray(id2j))
    np.testing.assert_allclose(z2t.numpy(), np.asarray(z2j), rtol=1e-6,
                               atol=1e-7)
    # pixels this fill did not win keep the init planes bit for bit
    keep = np.asarray(id2j) == 7
    assert keep.any()
    np.testing.assert_array_equal(rec2t.numpy()[:, keep],
                                  np.asarray(rec_j)[:, keep])
    _check_planes(rec2t.numpy().reshape(32, -1).T,
                  np.asarray(rec2j).reshape(32, -1).T)


def test_plain_fill_peel_layer_matches_pallas_interpret(cornell):
    z0, _, _ = jfill(cornell['setup'], cornell['records'], cornell['bins'],
                     cornell['cfg'], interpret=True)
    z1j, id1j, rec1j = jfill(cornell['setup'], cornell['records'],
                             cornell['bins'], cornell['cfg'],
                             peel_depth=z0, interpret=True)
    z1t, id1t, rec1t = TRC.fill_resolve_stream(
        cornell['tsetup'], cornell['trecords'], cornell['tbins'],
        cornell['tcfg'], peel_depth=torch.from_numpy(np.array(z0)))
    id1j = np.asarray(id1j)
    np.testing.assert_array_equal(id1t.numpy(), id1j)
    np.testing.assert_allclose(z1t.numpy(), np.asarray(z1j), rtol=1e-6,
                               atol=1e-7)
    m = id1j >= 0
    assert m.any()                            # a second layer exists
    _check_planes(rec1t.numpy()[:, m].T, np.asarray(rec1j)[:, m].T)


def test_plain_fill_matches_plain_xla_fill(cornell):
    """The port's fill_visibility (the reference's XLA fill, ported) and
    its bin_triangles agree with the reference's on the same setup."""
    table, counts, big, drop = JR.bin_triangles(cornell['setup'],
                                                cornell['cfg'])
    z_j, id_j = JR.fill_visibility(cornell['setup'], table, big,
                                   cornell['cfg'])
    ttable, tcounts, tbig, tdrop = TR.bin_triangles(cornell['tsetup'],
                                                    cornell['tcfg'])
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(table))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(tbig.numpy(), np.asarray(big))
    assert {k: int(v) for k, v in tdrop.items()} == \
        {k: int(v) for k, v in drop.items()}
    z_t, id_t = TR.fill_visibility(cornell['tsetup'], ttable, tbig,
                                   cornell['tcfg'])
    np.testing.assert_array_equal(id_t.numpy(), np.asarray(id_j))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6,
                               atol=1e-7)
