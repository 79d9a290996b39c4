"""The CUDA kernels (fill+resolve, K1; L-layer peel fill, K2; the
dense-table fill, K7; BVH traversal, K3 on the complete tree and K3-SAH
on the SAH tree, with grouped directions K5 and seeded packets
K3-seeded; reprojection warp, K4; the pair route's fold, K6) against
their plain PyTorch versions.

These tests need the card (the kernel has no CPU mode) and skip
elsewhere.  They import nothing of JAX, so they also run where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_kernel.py

Tolerances: ids and depth bit-equal -- the kernels are built with
-fmad=false and evaluate edges and depth in the plain version's order,
and PyTorch's elementwise kernels round each operation once; planes to
1e-5, for the same sums with sqrt / divide rounding.  K3's, K3-SAH's,
K5's and K3-seeded's hit, t, tri and visit counts and K4's output
bit-equal, for the same reason (each ray walks the tree in the plain
version's order, whichever warp runs it); K6's best t and ordinal
bit-equal (each form summed in the plain version's order; the 39
coefficients mt_tables zeroes add nothing to a ray with finite
features, and a ray without them sums all 16 terms); K8's best t and
payload bit-equal (the reference's Moller-Trumbore in its order, the
first least slot of a pair, the least payload across pairs).  The K1, K2 and
K7 inputs include ones off the frames' domain (init or occluder depths
below -1, NaN depths), where the kernels walk exactly as the plain
versions do.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, make_render_fn)
from toyrenderer_tpu_torch.engine import streaming
from toyrenderer_tpu_torch.ops import bvh as B
from toyrenderer_tpu_torch.ops import bvh_cuda as BC
from toyrenderer_tpu_torch.ops import bvh_sah as BS
from toyrenderer_tpu_torch.ops import chunks_cuda as CC
from toyrenderer_tpu_torch.ops import geometry as G
from toyrenderer_tpu_torch.ops import pairs_cuda as PRC
from toyrenderer_tpu_torch.ops import peel_cuda as PC
from toyrenderer_tpu_torch.ops import rt_pairs as RP
from toyrenderer_tpu_torch.ops import raster as R
from toyrenderer_tpu_torch.ops import raster_cuda as RC
from toyrenderer_tpu_torch.ops import rt_chunks as RT
from toyrenderer_tpu_torch.ops import warp_cuda as WC
from toyrenderer_tpu_torch.ops.gbuffer import pack_resolve_records
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

from test_torch_pair_split import PAIR_LISTS, pair_list

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


def _random_geo(dev, t=4000, seed=7):
    """Random double-sided triangles over the screen, most small, some
    large enough for the big list, depths in (0.1, 0.9)."""
    rng = np.random.default_rng(seed)
    tris = np.zeros((t, 3, 4), np.float32)
    size = np.where(rng.uniform(size=(t, 1, 1)) < 0.02, 0.8, 0.06)
    tris[..., :2] = (rng.uniform(-1.0, 1.0, size=(t, 1, 2))
                     + rng.uniform(-1.0, 1.0, size=(t, 3, 2)) * size)
    tris[..., 2] = rng.uniform(0.1, 0.9, size=(t, 3))
    tris[..., 3] = 1.0
    geo = dict(clip=tris, vtx_ids=np.zeros((t, 3), np.int32),
               inst_id=np.zeros(t, np.int32), mat_id=np.zeros(t, np.int32),
               double_sided=np.ones(t, bool), tri_valid=np.ones(t, bool),
               pair_meshlet=np.zeros(1, np.int32),
               pair_inst=np.zeros(1, np.int32))
    return {k: torch.from_numpy(v).to(dev) for k, v in geo.items()}


@pytest.mark.cuda
def test_dense_kernel_matches_plain_version(cuda_device):
    """K7 over random triangles at 1000x600 (ragged tiles at both edges),
    bit-equal to raster.fill_visibility on the same CUDA inputs: a first
    fill, and a continuation of part of its planes with an id offset
    through `raster.rasterize`."""
    from toyrenderer_tpu_torch.ops import dense_cuda as DC
    cfg = R.RasterConfig(width=1000, height=600, max_tris_per_tile=512,
                         max_big_tris=256, compact_frac=1.0, short_frac=1.0,
                         rest_frac=1.0)
    geo = _random_geo(cuda_device)
    setup = R.setup_triangles(geo, cfg)
    table, count, big, drop = R.bin_triangles(setup, cfg)
    assert int((big >= 0).sum()) > 0 and not any(int(v) for v in
                                                 drop.values())
    before = DC.launches
    z, tid = DC.fill_visibility_dense(setup, table, count, big, cfg)
    torch.cuda.synchronize()
    assert DC.launches == before + 1
    zp, idp = R.fill_visibility(setup, table, big, cfg)
    assert torch.equal(tid, idp) and torch.equal(z, zp)
    assert float((tid >= 0).float().mean()) > 0.5
    init_z = torch.where(z > 0.5, z, 0.0)
    init_id = torch.where(z > 0.5, tid, -1)
    _, z2, id2 = R.rasterize(geo, cfg, init_depth=init_z,
                             init_tri_id=init_id, tri_id_base=4000)
    assert DC.launches == before + 2
    zp2, idp2 = R.fill_visibility(setup, table, big, cfg,
                                  init_depth=init_z, init_tri_id=init_id,
                                  emit_base=4000)
    assert torch.equal(id2, idp2) and torch.equal(z2, zp2)
    kept = id2 < 4000
    assert bool(kept.any()) and torch.equal(id2[kept], init_id[kept])
    with pytest.raises(ValueError):            # wrong dtype is refused
        DC.launch(setup, table.long(), count, big, cfg)


# the scaled variants: subnormal products, small, past the margin's cap
# (huge_edges: the edge functions only)
SCALES = dict(tiny=1e-40, small=1e-30, huge=1e36, huge_edges=1e36)


def _adversarial(dev, variant, t=3000, seed=11):
    """The streamed fills' inputs over random triangles at 1000x600
    (ragged tiles at both edges), their raster records made adversarial
    for the warp walk's corner reject (tests/test_torch_region_reject.py
    holds the plain predicate on the same kinds of record): `behind`,
    some vertices behind the camera; `centres`, an edge of every 5th
    record moved onto a row or column of pixel centres; SCALES, every
    function scaled (`huge_edges`: the edge functions only, so K1's
    record check passes); `nan_edges`, a NaN in an edge coefficient of
    every 7th record (the record then covers no pixel, and K1's record
    check passes: the fast walk and its reject see them); `nan`, a NaN
    in an edge or denominator coefficient of every 7th record and a NaN
    in a depth-numerator coefficient of every 7th record from the 4th
    (its depth is NaN wherever it covers a centre: the plain fill's
    chunk maximum takes the NaN, and the chunk loses at that pixel).
    The resolve records are benign (the base records' edges, unit
    scales, random attributes).  Returns (setup, res_rec, bins, cfg,
    tri_rec)."""
    cfg = R.RasterConfig(width=1000, height=600, max_tris_per_tile=512,
                         max_big_tris=256, pair_capacity=1 << 16,
                         compact_frac=1.0, short_frac=1.0, rest_frac=1.0)
    geo = _random_geo(dev, t, seed)
    if variant == "behind":
        w = geo['clip'][..., 3].clone()
        w[::4, 0] = -0.5
        geo['clip'] = torch.cat([geo['clip'][..., :3] * w[..., None]
                                 / geo['clip'][..., 3:], w[..., None]], -1)
    setup = R.setup_triangles(geo, cfg)
    bins = R.bin_pairs_stream(setup, cfg)
    rec = RC.pack_tri_records(setup)
    g = torch.Generator(device='cpu').manual_seed(seed)
    res = torch.rand(t, 64, generator=g).to(dev)
    res[:, 0:9] = rec[:, 0:9]
    res[:, 9:12] = 1.0
    if variant == "centres":
        i = torch.arange(0, t, 5, device=dev)
        col = torch.randint(0, cfg.width, (i.numel(),), generator=g).to(dev)
        row = torch.randint(0, cfg.height, (i.numel(),), generator=g).to(dev)
        xc = (col.float() + 0.5) * (1.0 / cfg.width)
        yc = (row.float() + 0.5) * (1.0 / cfg.height)
        sign = torch.where(i % 2 == 0, 1.0, -1.0)
        one, zero = torch.ones_like(xc), torch.zeros_like(xc)
        vertical = torch.stack([sign * one, zero, -sign * xc], 1)
        horizontal = torch.stack([zero, sign * one, -sign * yc], 1)
        k = (i % 3) * 3
        for j, line in ((0, vertical), (1, horizontal)):
            pick = (i // 5) % 2 == j
            for c in range(3):
                rec[i[pick], k[pick] + c] = line[pick, c]
    elif variant in SCALES:
        k = 9 if variant == "huge_edges" else 15
        rec[:, :k] = (rec[:, :k].double() * SCALES[variant]).float()
    elif variant in ("nan", "nan_edges"):
        i = torch.arange(0, t, 7, device=dev)
        coeff = torch.tensor([*range(9)] + [12, 13, 14] * (variant == "nan"),
                             device=dev)
        rec[i, coeff[i % coeff.numel()]] = float('nan')
        if variant == "nan":
            j = torch.arange(3, t, 7, device=dev)
            rec[j, 9 + j % 3] = float('nan')
    return setup, res.contiguous(), bins, cfg, rec.contiguous()


def _units_below_floor(depth):
    """The (tile, region) units of a padded (Hp, Wp) depth image that
    hold a pixel below -1: the units the warp walks leave to the exact
    pass."""
    hp, wp = depth.shape
    low = (depth < -1).reshape(hp // RC.REGION_H, RC.REGION_H,
                               wp // RC.REGION_W, RC.REGION_W)
    return int(low.any(3).any(1).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["base", "behind", "centres", "tiny",
                                     "small", "huge", "huge_edges",
                                     "nan_edges", "nan"])
def test_fills_match_plain_on_adversarial_records(cuda_device, variant):
    """K1 (a first layer; a continuation from init planes, part of them
    at depth -1, the floor of the frames' domain, where a failed test
    ties and must not win, and part at -2, below it, where a missed
    centre or an empty slot of the plain fill's chunks wins with -1; a
    peeled layer) and K2 (L = 1..4, without an occluder, with one, and
    with one partly at -1 and partly at -2, where the plain version's
    misses and empty slots take layers at -1) on records made to sit on
    the reject's edge cases, NaN edges and NaN depths included: ids and
    depth bit-equal to the plain versions on every input, and the planes
    of pixels no fragment won bit-equal (the planes of won pixels are
    held on real records by test_kernel_matches_plain_version: these
    resolve records are random).  Each launch's exact pass walks exactly
    the units it should: those holding a pixel below -1, or every unit
    of K1 when a record's depth may be NaN (a depth coefficient not a
    number or past the margin's cap: `nan`, `huge`), none on the rest --
    so the fast walks run at -1, on NaN edges and on edges past the
    cap."""
    setup, res, bins, cfg, rec = _adversarial(cuda_device, variant)
    every = cfg.num_tiles * RC.REGIONS
    checked = bool((rec[:, 9:15].abs() <= RC.MARGIN_CAP).all())
    assert checked == (variant not in ("nan", "huge"))

    def held(inp, won_id_floor, want_exact):
        exact = {}
        (z_k, id_k, pl_k), (z_p, id_p, pl_p) = (
            RC.launch(inp, exact=exact), RC.fill_resolve_plain(inp))
        assert torch.equal(id_k, id_p), int((id_k != id_p).sum())
        assert torch.equal(z_k, z_p)
        kept = id_p < won_id_floor
        assert torch.equal(pl_k[:, kept], pl_p[:, kept])
        assert int(exact['units']) == (want_exact if checked else every)
        return z_k, id_k, pl_k

    first = dataclasses.replace(RC.fill_inputs(setup, res, bins, cfg),
                                tri_rec=rec)
    z0, id0, planes0 = held(first, 0, 0)
    torch.cuda.synchronize()
    assert bool((id0 >= 0).any())
    col = torch.arange(z0.shape[1], device=cuda_device)
    low = torch.where(col < 128, -1.0, torch.where(col < 300, -2.0,
                                                   z0 * 0.5))
    assert 0 < _units_below_floor(low) < every
    for kw, floor, want in ((dict(init_depth=low, init_tri_id=id0,
                                  init_rec=planes0, emit_base=5000), 5000,
                             _units_below_floor(low)),
                            (dict(peel_depth=z0), 0, 0)):
        held(dataclasses.replace(
            RC.fill_inputs(setup, res, bins, cfg, padded_io=True, **kw),
            tri_rec=rec), floor, want)
    for layers in (1, 2, 3, 4):
        for occ in (None, RC.crop_image(z0, cfg) * 0.5,
                    RC.crop_image(low, cfg)):
            inp = dataclasses.replace(
                PC.peel_inputs(setup, bins, cfg, layers, 3, occ),
                tri_rec=rec)
            exact = {}
            z_k, id_k = PC.launch(inp, exact=exact)
            z_p, id_p = PC.fill_peel_plain(inp)
            assert torch.equal(id_k, id_p), (layers, occ is None)
            assert torch.equal(z_k, z_p), (layers, occ is None)
            assert int(exact['units']) == (
                0 if occ is None else _units_below_floor(inp.occluder))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["base", "behind", "centres", "tiny",
                                     "small", "huge", "huge_edges",
                                     "nan_edges", "nan"])
def test_dense_fill_matches_plain_on_adversarial_records(cuda_device,
                                                         variant):
    """K7 on the records of test_fills_match_plain_on_adversarial_records
    over bin_triangles' dense table: a first fill, then a continuation
    from init planes part at depth -1 (a failed test ties and must not
    win) and part at -2 (the plain fill's missed centres and empty slots
    win there with id -1) with an id offset, and that continuation again
    with every third tile's own list and the big list emptied (their -2
    pixels go to an empty slot).  Ids and depth bit-equal to the plain
    version, raster.fill_dense as raster.fill_visibility runs it, on the
    same records.  The `centres` records cover tiles outside their
    triangles' bbox, so their big triangles' boxes are the whole grid;
    every other variant's records cover no pixel outside them, and the
    walk's big-list bbox filter runs on the setup's boxes.  Each call's
    exact pass walks exactly the units holding a pixel below -1, or
    every unit when a record's depth may be NaN (`nan`, `huge`)."""
    from toyrenderer_tpu_torch.ops import dense_cuda as DC
    setup, _, _, cfg, rec = _adversarial(cuda_device, variant)
    table, count, big, _ = R.bin_triangles(setup, cfg)
    every = cfg.num_tiles * RC.REGIONS
    checked = bool((rec[:, 9:15].abs() <= RC.MARGIN_CAP).all())
    assert checked == (variant not in ("nan", "huge"))

    def held(want_exact, table=table, count=count, big=big, **kw):
        inp = dataclasses.replace(
            DC.dense_inputs(setup, table, count, big, cfg, **kw),
            tri_rec=rec)
        if variant == "centres":
            grid = torch.tensor([0, cfg.tiles_x - 1, 0, cfg.tiles_y - 1],
                                dtype=torch.int32, device=cuda_device)
            inp = dataclasses.replace(
                inp, big_box=grid.expand_as(inp.big_box).contiguous(),
                bighit=torch.ones_like(inp.bighit))
        exact = {}
        z_k, id_k = DC.launch_inputs(inp, exact=exact)
        z_p, id_p = DC.fill_dense_plain(inp)
        assert torch.equal(id_k, id_p), int((id_k != id_p).sum())
        assert torch.equal(z_k, z_p)
        assert int(exact['units']) == (want_exact if checked else every)
        return z_k, id_k

    z0, id0 = held(0)
    assert bool((id0 >= 0).any())
    col = torch.arange(z0.shape[1], device=cuda_device)
    low = torch.where(col < 128, -1.0, torch.where(col < 300, -2.0,
                                                   z0 * 0.5))
    want = _units_below_floor(RC.pad_image(low, cfg))
    assert 0 < want < every
    cont = dict(init_depth=low, init_tri_id=id0, emit_base=5000)
    held(want, **cont)
    bare, bare_count = table.clone(), count.clone()
    bare[::3], bare_count[::3] = -1, 0
    _, id2 = held(want, bare, bare_count, torch.full_like(big, -1), **cont)
    assert bool((id2[low < -1] == -1).any())


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


def _tree_and_rays(dev, n=20000, seed=0):
    """The courtyard's RT tree under the rest pose (LOD0 opaque pairs and
    the coverage-kept masked ones), and rays from points near its
    triangles: half toward the sun (shadow rays), half in random
    directions, ~10% dead."""
    host = load_scene(ROOT / "resources" / "courtyard.glb", use_cache=False)
    scene = host.to_device(dev)
    mk_i, mk_m = G.static_meshlet_pairs(host, 'mask')
    pi, pm, _ = G.rt_lod_pairs(host, 'not_mask')
    rts = B.build_rt_static(host, pi, pm, mask_pair_inst=mk_i,
                            mask_pair_meshlet=mk_m, device=dev)
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, 64, 64).matrices()), dev)
    world = G.node_world_matrices(scene, fi['node_translation'],
                                  fi['node_rotation'], fi['node_scale'])
    bvh = B.refit_bvh(rts, G.instance_transforms(scene, world)[0])
    g = torch.Generator(device='cpu').manual_seed(seed)
    rows = bvh.leaf_rows.reshape(-1, 10, 12).transpose(1, 2).reshape(-1, 10)
    rows = rows[rows[:, 9] >= 0]
    pick = rows[torch.randint(0, rows.shape[0], (n,), generator=g).to(dev)]
    o = pick[:, 0:3] + 0.3 * pick[:, 3:6] + 0.3 * pick[:, 6:9]
    d = torch.randn(n, 3, generator=g).to(dev)
    d[: n // 2] = -fi['sun_direction'] + 0.01 * d[: n // 2]
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    o = (o + 0.02 * d).contiguous()
    live = (torch.rand(n, generator=g) > 0.1).to(torch.float32).to(dev)
    return bvh, o, d.contiguous(), live


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [True, False])
def test_traverse_kernel_matches_plain_version(cuda_device, any_hit):
    bvh, o, d, live = _tree_and_rays(cuda_device)
    before = BC.launches_by_kernel['K3']
    got = BC.launch(bvh, o, d, 1e4, any_hit, live)
    torch.cuda.synchronize()
    assert BC.launches_by_kernel['K3'] == before + 1
    want = BC.traverse_plain(bvh, o, d, 1e4, any_hit, live)
    for k in ('hit', 't', 'tri'):
        assert torch.equal(got[k], want[k]), (k, int((got[k] != want[k]).sum()))
    assert torch.equal(got['steps'], want['steps'])
    hit = got['hit'][live > 0].float().mean()
    assert 0.05 < float(hit) < 0.95
    assert not bool(got['hit'][live == 0].any())


@pytest.mark.cuda
def test_traverse_wrapper_launches_for_cuda_tensors(cuda_device):
    bvh, o, d, live = _tree_and_rays(cuda_device, n=512)
    before = BC.launches_by_kernel['K3']
    res = BC.traverse_auto(bvh, o, d, 1e4, any_hit=True, live=live)
    assert BC.launches_by_kernel['K3'] == before + 1 and res['t'].is_cuda
    with pytest.raises(ValueError):            # wrong dtype is refused
        BC.launch(bvh, o.double(), d, 1e4)
    with pytest.raises(ValueError):            # wrong shape is refused
        BC.launch(bvh, o[:, :2].contiguous(), d, 1e4)
    with pytest.raises(ValueError):            # rays on another device
        BC.launch(bvh, o.cpu(), d.cpu(), 1e4)


def _gi_tree_and_rays(dev, n=128 * 160, seed=1):
    """The courtyard's GI tree (the SAH tree over the LOD under the 100k
    triangle budget, the masked pairs appended) under the rest pose, and
    probe-like rays: origins scattered over the scene's box, one random
    direction per 128 rays, ~10% dead."""
    host = load_scene(ROOT / "resources" / "courtyard.glb", use_cache=False)
    scene = host.to_device(dev)
    mk_i, mk_m = G.static_meshlet_pairs(host, 'mask')
    rts, _, _, _ = BS.build_rt_static_gi(host, 'not_mask', mask_pair_inst=mk_i,
                                         mask_pair_meshlet=mk_m, device=dev)
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, 64, 64).matrices()), dev)
    world = G.node_world_matrices(scene, fi['node_translation'],
                                  fi['node_rotation'], fi['node_scale'])
    tree = BS.refit_sah(rts, G.instance_transforms(scene, world)[0])
    g = torch.Generator(device='cpu').manual_seed(seed)
    lo, hi = (torch.tensor(np.asarray(b, np.float32)) for b in host.world_aabb)
    o = (lo + (hi - lo) * torch.rand(n, 3, generator=g)).to(dev)
    gd = torch.randn(n // BC.GROUP, 3, generator=g)
    gd = (gd / torch.linalg.vector_norm(gd, dim=1, keepdim=True)).to(dev)
    live = (torch.rand(n, generator=g) > 0.1).to(torch.float32).to(dev)
    return tree, o.contiguous(), gd.contiguous(), live


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [True, False])
def test_sah_and_grouped_kernels_match_plain_version(cuda_device, any_hit):
    """K3-SAH on per-ray directions and K5 on grouped ones, on the SAH
    GI tree; K5 also on the complete tree.  K5 equals K3 / K3-SAH on the
    expanded directions."""
    tree, o, gd, live = _gi_tree_and_rays(cuda_device)
    d = gd.repeat_interleave(BC.GROUP, 0).contiguous()
    before = dict(BC.launches_by_kernel)
    sah = BC.launch(tree, o, d, 1e4, any_hit, live)
    grouped = BC.launch(tree, o, None, 1e4, any_hit, live, group_dirs=gd)
    torch.cuda.synchronize()
    assert BC.launches_by_kernel == dict(before, **{
        'K3-SAH': before['K3-SAH'] + 1, 'K5': before['K5'] + 1})
    want = BC.traverse_plain(tree, o, d, 1e4, any_hit, live)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(sah[k], want[k]), (
            k, int((sah[k] != want[k]).sum()))
        assert torch.equal(grouped[k], sah[k]), k
    hit = float(sah['hit'][live > 0].float().mean())
    assert 0.05 < hit < 0.95
    assert not bool(sah['hit'][live == 0].any())

    bvh, o2, _, live2 = _tree_and_rays(cuda_device, n=128 * 40)
    gd2 = gd[:40].contiguous()
    got = BC.launch(bvh, o2, None, 1e4, any_hit, live2, group_dirs=gd2)
    want = BC.traverse_plain(bvh, o2, None, 1e4, any_hit, live2,
                             group_dirs=gd2)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_sah_stack_guard_refuses_deep_trees(cuda_device):
    """The SAH kernels' stack holds 160 entries (depth <= 22): a deeper
    tree is refused before the launch, by the wrapper and by the C
    entry point."""
    tree, o, gd, live = _gi_tree_and_rays(cuda_device, n=256)
    d = gd.repeat_interleave(BC.GROUP, 0).contiguous()
    deep = BS.BvhSah(tree.node_rows, tree.leaf_rows, depth=23)
    before = dict(BC.launches_by_kernel)
    with pytest.raises(ValueError, match="stack"):
        BC.launch(deep, o, d, 1e4, False, live)
    assert BC.launches_by_kernel == before
    lib = BC.kernel_library()
    outs = [torch.empty(256, dtype=dt, device=cuda_device)
            for dt in (torch.float32, torch.int32, torch.int32)]
    t_max = torch.full((256,), 1e4, device=cuda_device)
    import ctypes
    err = lib.traverse_launch(
        tree.node_rows.data_ptr(), tree.node_rows.shape[0],
        tree.leaf_rows.data_ptr(), tree.leaf_rows.shape[0], 1,
        (ctypes.c_int * 1)(0), o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
        live.data_ptr(), None, 1, *(x.data_ptr() for x in outs), 256, 0,
        23, 0, outs[1].data_ptr(), ctypes.byref(ctypes.c_int(0)),
        torch.cuda.current_stream(cuda_device).cuda_stream)
    assert err != 0
    # the deepest tree the guard admits runs
    ok = BS.BvhSah(tree.node_rows, tree.leaf_rows, depth=22)
    res = BC.launch(ok, o, d, 1e4, False, live)
    torch.cuda.synchronize()
    assert torch.equal(res['t'], BC.launch(tree, o, d, 1e4, False,
                                           live)['t'])


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,reach", [(1080, 1920, 3, 6.0),
                                         (540, 960, 2, 20.0),
                                         (37, 75, 3, 9.0)])
def test_warp_kernel_matches_plain_version(cuda_device, h, w, c, reach):
    g = torch.Generator(device='cpu').manual_seed(h + c)
    img = torch.rand(h, w, c, generator=g).to(cuda_device)
    mot = ((torch.rand(h, w, 2, generator=g) * 2 - 1) * reach).to(
        cuda_device)
    before = WC.launches
    got = WC.launch(img, mot)
    torch.cuda.synchronize()
    assert WC.launches == before + 1
    assert torch.equal(got, WC.warp_bilinear_plain(img, mot))


@pytest.mark.cuda
def test_warp_wrapper_launches_for_cuda_tensors(cuda_device):
    img = torch.rand(64, 96, 3, device=cuda_device)
    mot = torch.zeros(64, 96, 2, device=cuda_device)
    before = WC.launches
    assert torch.equal(WC.warp_bilinear(img, mot), img)
    assert WC.launches == before + 1
    with pytest.raises(ValueError):            # wrong dtype is refused
        WC.launch(img.double(), mot)
    with pytest.raises(ValueError):            # wrong shape is refused
        WC.launch(img, mot[:, :, :1].contiguous())
    with pytest.raises(ValueError):            # motion on another device
        WC.launch(img, mot.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("pair_factor", [1024, 1])
def test_pair_kernel_matches_plain_version(cuda_device, pair_factor,
                                           monkeypatch):
    """K6 on the pair route's own inputs (the GI tree, probe-like rays),
    bit-equal to pair_fold_plain; the route's result against K3-SAH on
    the same rays (hit on >= 99.9% of live rays, t within rtol and atol
    2e-4 where both hit, the gate of tests/test_rt_pairs.py:36-51: the
    fold's t_num is a difference of products of world coordinates, so a
    short t carries an absolute rounding error).  At pair_factor 1024 the cap holds every (block, chunk)
    pair, so no block overflows; at 1 most blocks overflow and take
    K3-SAH."""
    tree, o, gd, live = _gi_tree_and_rays(cuda_device, n=128 * 96)
    d = gd.repeat_interleave(BC.GROUP, 0).contiguous()
    seen = []
    launch = PRC.launch

    def recording(*args):
        seen.append(args)
        return launch(*args)
    monkeypatch.setattr(PRC, "launch", recording)
    before = dict(BC.launches_by_kernel)
    stats = {}
    res = RP.traverse_pairs(tree, o, d, 1e4, live=live,
                            pair_factor=pair_factor, stats=stats)
    torch.cuda.synchronize()
    assert BC.launches_by_kernel == dict(before, **{
        'K6': before['K6'] + 1, 'K3-SAH': before['K3-SAH'] + 1})
    assert len(seen) == 1
    got = launch(*seen[0])
    want = RP.pair_fold_plain(*seen[0])
    assert torch.equal(got[0], want[0]), int((got[0] != want[0]).sum())
    assert torch.equal(got[1], want[1])
    assert bool(torch.isfinite(got[0]).any())
    over = int(stats['overflow'].sum())
    assert (over > 0) == (pair_factor == 1)
    ref = BC.launch(tree, o, d, 1e4, False, live)
    alive = live > 0
    agree = (res['hit'] == ref['hit'])[alive].float().mean()
    assert float(agree) >= 0.999, float(agree)
    both = res['hit'] & ref['hit']
    assert torch.allclose(res['t'][both], ref['t'][both], rtol=2e-4,
                          atol=2e-4)
    assert not bool(res['hit'][~alive].any())


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [True, False])
def test_seeded_kernel_matches_plain_version(cuda_device, any_hit):
    """K3-seeded (packets of 1024 rays, each from an entry subtree or
    empty) bit-equal to traverse_plain(seeds=); the binned traversal's
    hit (and closest-hit t) bit-equal to K3's root walk."""
    bvh, o, d, live = _tree_and_rays(cuda_device, n=1024 * 12)
    _, seeds, _ = BC._entry_nodes_complete(bvh)
    g = torch.Generator(device='cpu').manual_seed(2)
    pick = torch.randint(0, seeds.shape[0], (12,), generator=g)
    seed_p = seeds[pick.to(cuda_device)].clone()
    seed_p[3] = -1
    before = dict(BC.launches_by_kernel)
    got = BC.launch(bvh, o, d, 1e4, any_hit, live, None, seed_p, 1024)
    torch.cuda.synchronize()
    assert BC.launches_by_kernel == dict(
        before, **{'K3-seeded': before['K3-seeded'] + 1})
    want = BC.traverse_plain(bvh, o, d, 1e4, any_hit, live, seeds=seed_p,
                             packet=1024)
    for k in ('hit', 't', 'tri', 'steps'):
        assert torch.equal(got[k], want[k]), (k, int((got[k] != want[k]).sum()))
    assert not bool(got['steps'][3 * 1024:4 * 1024].any())
    assert int(got['hit'].sum()) > 0
    res = BC.traverse_binned(bvh, o, d, 1e4, any_hit, live)
    ref = BC.launch(bvh, o, d, 1e4, any_hit, live)
    assert torch.equal(res['hit'], ref['hit'])
    if not any_hit:
        assert torch.equal(res['t'], ref['t'])
    with pytest.raises(ValueError):            # seeds walk the complete tree
        tree, o2, gd, live2 = _gi_tree_and_rays(cuda_device, n=1024)
        BC.launch(tree, o2, gd.repeat_interleave(BC.GROUP, 0), 1e4, False,
                  live2, None, seed_p[:1], 1024)
    with pytest.raises(ValueError):            # and per-ray directions
        BC.traverse(bvh, o, d, 1e4, any_hit, live,
                    group_dirs=d[::BC.GROUP].contiguous(), seeds=seed_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAIR_LISTS))
def test_pair_fold_edge_cases(cuda_device, case):
    """K6's even split on hand-made pair lists (PAIR_LISTS: empty blocks,
    lists that straddle work items, a list that ends before, at and past
    its capacity) over a soup whose every triangle appears twice, so
    equal t ties to the least ordinal: best t and ordinal bit-equal to
    pair_fold_plain, with dead rays, all-dead warps, and live rays with
    a non-finite origin or direction (which take the full 16-term sums)
    in the blocks."""
    rng = np.random.default_rng(9)
    n = 4000                    # 8,000 triangles: 84 chunks of 96
    v0 = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(0, 0.9, (n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(0, 0.9, (n, 3)).astype(np.float32)
    tris = [torch.from_numpy(np.concatenate([v, v])).to(cuda_device)
            for v in (v0, v1, v2)]
    bvh = B.build_bvh(*tris, torch.ones(2 * n, dtype=torch.bool,
                                        device=cuda_device))
    _, feat, _ = RP.mt_tables(bvh)
    counts, cap = PAIR_LISTS[case]
    pchk, starts, n_walk = (x.to(cuda_device) for x in pair_list(
        counts, cap, feat.shape[0] - 1, seed=len(case)))
    nb = len(counts)
    g = torch.Generator(device='cpu').manual_seed(3)
    o = torch.rand(nb, RP.BLOCK, 3, generator=g) * 8 - 4
    d = torch.randn(nb, RP.BLOCK, 3, generator=g)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    t_max = torch.where(torch.rand(nb, RP.BLOCK, 1, generator=g) < 0.2,
                        2.0, 1e4)
    live = (torch.rand(nb, RP.BLOCK, 1, generator=g) > 0.15).float()
    live[0, 64:96] = 0.0                          # an all-dead warp
    o[0, 5, 1] = float('inf')                     # live, non-finite
    d[nb - 1, 40, 2] = float('nan')
    live[0, 5] = live[nb - 1, 40] = 1.0
    rays = torch.cat([o, d, t_max, live], -1).to(cuda_device).contiguous()
    before = dict(BC.launches_by_kernel)
    got = PRC.launch(rays, feat, pchk, starts, n_walk)
    torch.cuda.synchronize()
    assert BC.launches_by_kernel == dict(before, K6=before['K6'] + 1)
    want = RP.pair_fold_plain(rays, feat, pchk, starts, n_walk)
    assert torch.equal(got[0], want[0]), int((got[0] != want[0]).sum())
    assert torch.equal(got[1], want[1]), int((got[1] != want[1]).sum())
    if int(n_walk.sum()):
        assert bool(torch.isfinite(got[0]).any())


# the traversal kernel's ten instances: (tree, any_hit, grouped, seeded)
TRAVERSE_INSTANCES = [(tree, any_hit, grouped, False)
                      for tree in ("complete", "sah")
                      for any_hit in (True, False)
                      for grouped in (False, True)] + [
    ("complete", any_hit, False, True) for any_hit in (True, False)]


@pytest.fixture(scope="module")
def traverse_trees():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel only runs on the card)")
    dev = torch.device("cuda", torch.cuda.current_device())
    return (_tree_and_rays(dev, n=4224), _gi_tree_and_rays(dev, n=4224))


@pytest.mark.cuda
@pytest.mark.parametrize("tree,any_hit,grouped,seeded", TRAVERSE_INSTANCES)
def test_traverse_instances_on_ragged_counts(traverse_trees, tree, any_hit,
                                             grouped, seeded):
    """Each of the ten kernel instances on ray counts the persistent warps'
    pool must handle -- fewer than a warp, not a multiple of 32 or 128
    (grouped directions: whole groups of 128), all slots dead, seeded
    packets one of which has seed -1 -- bit-equal to traverse_plain in
    hit, t, tri and steps, each wrapper call one launch of its kernel."""
    (bvh, o, d, live), (sah, so, gd, slive) = traverse_trees
    if tree == "sah":
        bvh, o, live = sah, so, slive
        d = gd.repeat_interleave(BC.GROUP, 0).contiguous()
    key = ('K3-seeded' if seeded else 'K5' if grouped
           else 'K3-SAH' if tree == "sah" else 'K3')
    counts = (128, 384, 4224) if grouped else (1, 17, 1000, 4099)
    for n in counts:
        for dead in (False, True):
            kw = {}
            lv = torch.zeros(n, device=o.device) if dead else live[:n]
            if grouped:
                kw['group_dirs'] = gd[:n // BC.GROUP].contiguous()
            if seeded:
                _, seeds, _ = BC._entry_nodes_complete(bvh)
                packet = 8 if n < 64 else 256
                p = -(-n // packet)
                seed_p = seeds[torch.arange(p, device=o.device)
                               % seeds.shape[0]].clone()
                seed_p[p // 2] = -1
                kw.update(seeds=seed_p, packet=packet)
            args = (bvh, o[:n].contiguous(), d[:n].contiguous(), 1e4,
                    any_hit, lv)
            before = dict(BC.launches_by_kernel)
            schedule = {}
            got = BC.launch(*args, **kw, schedule=schedule)
            torch.cuda.synchronize()
            assert BC.launches_by_kernel == dict(before,
                                                 **{key: before[key] + 1})
            want = BC.traverse_plain(*args, **kw)
            for k in ('hit', 't', 'tri', 'steps'):
                assert torch.equal(got[k], want[k]), (
                    n, dead, k, int((got[k] != want[k]).sum()))
            if dead:
                assert not bool(got['hit'].any())
                assert not bool(got['steps'].any())
            assert 0 < schedule['warps'] <= 4 * -(-n // 128)
            assert int(schedule['fetched']) >= n


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tile", "mip"])
def test_streamed_frame_matches_plain_version(cuda_device, mode):
    """The streamed culled stress frame (textured, 192x96, two frames
    across two updates) on the card -- K1 and the card's gathers --
    against the same frames on the CPU (the plain versions), both on
    the overrides of one manager that the CPU frame's feedback drives.
    Images within 1 on >= 99.9% of the pixels (the devices' 4x4
    products may round apart by an ulp at an edge, so a pixel may change
    triangle); the feedback within 3e-3 mips where both are finite, and
    finite at the same entries but for at most 2% of them (a pixel that
    changes triangle may reach another tile)."""
    host = make_stress_scene(n_objects=16, sphere_res=10, seed=5,
                             textured=True)
    pi, pm = G.static_meshlet_pairs(host, 'all')
    st = RenderSettings(width=192, height=96, manual_exposure=0.1,
                        enable_culling=True, max_tris_per_tile=256,
                        max_big_tris=64, tile_batch=4)
    cpu = torch.device("cpu")
    atlas = streaming.scene_atlas(host)
    if mode == 'tile':
        mgr = streaming.TileStreamingManager(atlas, pool_tiles=24,
                                             device=cpu)
        ov = mgr.update(np.full(mgr.table_size, np.inf))
        fb_key = 'vt_tile_feedback'
    else:
        mgr = streaming.TextureStreamingManager(
            atlas, pool_texels=1 << 17, textures_per_frame=2, device=cpu)
        ov = mgr.update(np.full(host.num_textures, np.inf))
        fb_key = 'tex_feedback'
    devs = (cuda_device, cpu)
    scenes = [host.to_device(d) for d in devs]
    renders = [make_render_fn(st, d) for d in devs]
    carries = [init_carry(s, st) for s in scenes]
    pairs = [[torch.from_numpy(a).to(d) for a in (pi, pm)] for d in devs]
    view = View.from_scene(host, 192, 96)
    for _ in range(2):
        mats = view.matrices()
        out = []
        for i, d in enumerate(devs):
            fi = dict(default_frame_inputs(host, mats),
                      **{k: v.to(d) for k, v in ov.items()})
            img, carries[i], aux = renders[i](scenes[i], *pairs[i], fi,
                                              carries[i])
            out.append((img.cpu().numpy().astype(int),
                        aux[fb_key].cpu().numpy()))
        view.advance(mats)
        (img_c, fb_c), (img_p, fb_p) = out
        close = (np.abs(img_c - img_p).max(-1) <= 1).mean()
        assert close >= 0.999, close
        both = np.isfinite(fb_c) & np.isfinite(fb_p)
        assert both.any()
        np.testing.assert_allclose(fb_c[both], fb_p[both], rtol=0,
                                   atol=3e-3)
        assert (np.isfinite(fb_c) != np.isfinite(fb_p)).sum() <= (
            0.02 * both.sum()), fb_key
        ov = mgr.update(fb_p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAIR_LISTS))
def test_chunk_fold_edge_cases(cuda_device, case):
    """K8 on the hand-made pair lists of test_pair_fold_edge_cases over a
    soup whose every triangle appears twice (so each pair holds equal-t
    slots and the two-level tie rule decides), with dead rays, an
    all-dead warp, short t_max and a live ray with a non-finite origin
    or direction: best t and payload bit-equal to chunk_fold_plain."""
    rng = np.random.default_rng(9)
    n = 4000
    v0 = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(0, 0.9, (n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(0, 0.9, (n, 3)).astype(np.float32)
    tris = [torch.from_numpy(np.concatenate([v, v])).to(cuda_device)
            for v in (v0, v1, v2)]
    bvh = B.build_bvh(*tris, torch.ones(2 * n, dtype=torch.bool,
                                        device=cuda_device))
    _, data = RT.chunk_table(bvh)
    counts, cap = PAIR_LISTS[case]
    pchk, starts, n_walk = (x.to(cuda_device) for x in pair_list(
        counts, cap, data.shape[0], seed=len(case)))
    nb = len(counts)
    g = torch.Generator(device='cpu').manual_seed(3)
    o = torch.rand(nb, RT.BLOCK, 3, generator=g) * 8 - 4
    d = torch.randn(nb, RT.BLOCK, 3, generator=g)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    t_max = torch.where(torch.rand(nb, RT.BLOCK, 1, generator=g) < 0.2,
                        2.0, 1e4)
    live = (torch.rand(nb, RT.BLOCK, 1, generator=g) > 0.15).float()
    live[0, 64:96] = 0.0
    o[0, 5, 1] = float('inf')
    d[nb - 1, 40, 2] = float('nan')
    live[0, 5] = live[nb - 1, 40] = 1.0
    rays = torch.cat([o, d, t_max, live], -1).to(cuda_device).contiguous()
    before = dict(BC.launches_by_kernel)
    got = CC.launch(rays, data, pchk, starts, n_walk)
    torch.cuda.synchronize()
    assert BC.launches_by_kernel == dict(before, K8=before['K8'] + 1)
    want = RT.chunk_fold_plain(rays, data, pchk, starts, n_walk)
    assert torch.equal(got[0], want[0]), int((got[0] != want[0]).sum())
    assert torch.equal(got[1], want[1]), int((got[1] != want[1]).sum())
    if int(n_walk.sum()):
        assert bool(torch.isfinite(got[0]).any())
