"""The warp walk's region reject (csrc/tile_walk.cuh `region_rejects`)
through its plain PyTorch version, `raster_cuda.region_rejects`.

K1 and K2 drop a raster record for a warp's 32x8 region when one of its
edge functions is below -margin (or its depth denominator at or below
-margin) at the region's four corner pixel centres; the margin bounds the
rounding of the corner and the pixel evaluations.  These tests hold the
claim that makes the kernels' ids and depth bit-equal to the full walk:
a rejected record covers no pixel of its region under the plain
per-pixel evaluation (the kernels' f32 multiply / add order, as
`raster.coverage_depth` evaluates it).  Records come from triangles set
up as the frames set them up (vertices behind the camera included), from
raw coefficients over many scales, and from hand-made adversarial cases;
then the culled courtyard at 384x216, where the reject must drop records
(so the claim is not vacuous) and none wrongly.  Also: the launch's
dealing of (tile, region) units to warps visits each unit once.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import View, default_frame_inputs
from toyrenderer_tpu_torch.ops import culling as C
from toyrenderer_tpu_torch.ops import geometry as G
from toyrenderer_tpu_torch.ops import peel_cuda as PC
from toyrenderer_tpu_torch.ops import raster as R
from toyrenderer_tpu_torch.ops import raster_cuda as RC
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

CFG = R.RasterConfig(width=256, height=64)      # 2 x 4 tiles, 64 regions


def region_pixels(cfg, tiles, regions):
    """(pxn, pyn) (N, 8, 32): the pixel centres of each region, picked
    from raster.tile_pixel_coords."""
    pxn, pyn = R.tile_pixel_coords(cfg, tiles)
    rows = ((regions // 4) * RC.REGION_H)[:, None] + torch.arange(
        RC.REGION_H)
    cols = ((regions % 4) * RC.REGION_W)[:, None] + torch.arange(
        RC.REGION_W)
    n = torch.arange(tiles.shape[0])[:, None, None]
    return (pxn[n, rows[:, :, None], cols[:, None, :]],
            pyn[n, rows[:, :, None], cols[:, None, :]])


def covers(rec, pxn, pyn):
    """(N,) bool: record rec[i] passes the coverage test at a pixel of
    its region -- the per-pixel arithmetic of raster.coverage_depth."""
    def field(f):
        return rec[:, f, None, None]
    l0 = field(0) * pxn + field(1) * pyn + field(2)
    l1 = field(3) * pxn + field(4) * pyn + field(5)
    l2 = field(6) * pxn + field(7) * pyn + field(8)
    den = field(12) * pxn + field(13) * pyn + field(14)
    inside = (torch.minimum(torch.minimum(l0, l1), l2) >= 0.0) & (den > 0.0)
    return inside.flatten(1).any(dim=1)


def every_region(rec, cfg=CFG):
    """Each record against each region of cfg's grid: (tiles, regions,
    rejected, covered), N = records x tiles x 8."""
    n_units = cfg.num_tiles * RC.REGIONS
    unit = torch.arange(n_units).repeat(rec.shape[0])
    rec = rec.repeat_interleave(n_units, dim=0)
    tiles, regions = unit // RC.REGIONS, unit % RC.REGIONS
    rejected = RC.region_rejects(rec, RC.region_corners(cfg, tiles, regions))
    return (tiles, regions, rejected,
            covers(rec, *region_pixels(cfg, tiles, regions)))


def check(rec, cfg=CFG):
    """No rejected record covers a pixel of its region; returns the
    rejected and covered masks."""
    _, _, rejected, covered = every_region(rec, cfg)
    wrong = rejected & covered
    assert not bool(wrong.any()), int(wrong.sum())
    return rejected, covered


def triangle_records(clip: np.ndarray, cfg=CFG) -> torch.Tensor:
    """Raster records of clip-space triangles (T, 3, 4), set up as the
    frames set them up (double-sided, so no triangle is culled)."""
    t = clip.shape[0]
    geo = dict(clip=torch.from_numpy(clip.astype(np.float32)),
               tri_valid=torch.ones(t, dtype=torch.bool),
               double_sided=torch.ones(t, dtype=torch.bool),
               vtx_ids=torch.zeros((t, 3), dtype=torch.int32),
               inst_id=torch.zeros(t, dtype=torch.int32),
               mat_id=torch.zeros(t, dtype=torch.int32),
               pair_meshlet=torch.zeros(1, dtype=torch.int32),
               pair_inst=torch.zeros(1, dtype=torch.int32))
    return RC.pack_tri_records(R.setup_triangles(geo, cfg))


def record(e0, e1, e2, den, num=(0.0, 0.0, 0.5)):
    return torch.tensor([[*e0, *e1, *e2, *num, *den, 0.0]],
                        dtype=torch.float32)


# the pixel centres of CFG's tile 0, as the kernels round them
PXN, PYN = R.tile_pixel_coords(CFG, torch.zeros(1, dtype=torch.long))
ONE = (0.0, 0.0, 1.0)                # a function that passes everywhere


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1),
       size=st.sampled_from([0.002, 0.02, 0.2, 2.0]),
       w_lo=st.sampled_from([-1.0, -0.01, 0.05]),
       scale=st.sampled_from([1e-6, 1.0, 1e4]))
def test_rejected_triangles_cover_no_pixel(seed, size, w_lo, scale):
    """Triangles of many sizes around the screen, some with vertices
    behind the camera (w <= 0), at several homogeneous scales."""
    rng = np.random.default_rng(seed)
    t = 48
    w = rng.uniform(w_lo, 3.0, size=(t, 3))
    centre = rng.uniform(-1.2, 1.2, size=(t, 1, 2))
    xy = (centre + rng.normal(scale=size, size=(t, 3, 2))) * w[..., None]
    clip = np.concatenate([xy, rng.uniform(0.0, 1.0, (t, 3, 1)) * w[..., None],
                           w[..., None]], axis=-1) * scale
    check(triangle_records(clip))


finite = st.floats(min_value=-1e6, max_value=1e6, width=32,
                   allow_subnormal=True)


@settings(max_examples=60, deadline=None, database=None)
@given(coef=st.lists(finite, min_size=15, max_size=15),
       exponent=st.sampled_from([-44, -38, -30, -8, 0, 8, 24, 32]))
def test_rejected_raw_records_cover_no_pixel(coef, exponent):
    """Raw coefficients of any sign and scale, down to subnormal
    products and up past the margin's cap."""
    rec = torch.tensor([coef + [0.0]], dtype=torch.float32)
    rec[:, :15] = rec[:, :15] * torch.tensor(10.0 ** exponent,
                                             dtype=torch.float64).float()
    check(rec)


@pytest.mark.parametrize("col", [0, 31, 32, 63, 100, 127])
def test_edges_through_pixel_centres_are_kept(col):
    """An edge exactly through a column (or row) of pixel centres passes
    the coverage test there (l = 0), from either side, so no region
    holding that column or row is rejected, and the reject never drops a
    record that covers a pixel."""
    xc = float(PXN[0, 0, col])
    yc = float(PYN[0, col % 16, 0])
    recs = torch.cat([
        record((1.0, 0.0, -xc), ONE, ONE, ONE),        # x >= xc
        record((-1.0, 0.0, xc), ONE, ONE, ONE),        # x <= xc
        record((0.0, 1.0, -yc), ONE, ONE, ONE),        # y >= yc
        record((0.0, -1.0, yc), ONE, ONE, ONE),        # y <= yc
        # a sliver one column wide, on the centres, and one between them
        record((1.0, 0.0, -xc), (-1.0, 0.0, xc), ONE, ONE),
        record((1.0, 0.0, -(xc + 0.25 / CFG.width)),
               (-1.0, 0.0, xc + 0.75 / CFG.width), ONE, ONE),
        # the depth plane's denominator through the centres: den > 0
        # fails on the column, passes right of it
        record(ONE, ONE, ONE, (1.0, 0.0, -xc)),
    ])
    tiles, regions, rejected, covered = every_region(recs)
    assert not bool((rejected & covered).any())
    n = recs.shape[0]
    cov = covered.reshape(n, -1)
    kept = ~rejected.reshape(n, -1)
    # the regions holding the column, and those holding the row
    q = col // RC.REGION_W
    on_col = ((tiles == 0) & (regions % 4 == q)).reshape(n, -1)
    on_row = ((tiles == 0) & (regions // 4 == (col % 16) // RC.REGION_H)
              ).reshape(n, -1)
    for i, on in ((0, on_col), (1, on_col), (4, on_col), (2, on_row),
                  (3, on_row)):
        assert bool(cov[i][on[i]].all()) and bool(kept[i][on[i]].all())
    assert not bool(cov[5].any())              # between the centres
    if col < RC.REGION_W * q + RC.REGION_W - 1:
        assert bool(cov[6][on_col[6]].all())


def test_far_regions_are_rejected():
    """The reject is not vacuous: an edge far off a region drops it, in
    both tile rows and columns, for each edge and for the denominator;
    a horizontal edge drops exactly the regions above it."""
    far = (1.0, 0.0, -2.0)                    # x >= 2: off screen
    recs = torch.cat([record(far, ONE, ONE, ONE), record(ONE, far, ONE, ONE),
                      record(ONE, ONE, far, ONE), record(ONE, ONE, ONE, far)])
    rejected, covered = check(recs)
    assert bool(rejected.all()) and not bool(covered.any())
    # y >= the centre of row 8 of tile 0: its regions 0-3 (rows 0-7) drop
    yc = float(PYN[0, 8, 0])
    tiles, regions, rejected, _ = every_region(
        record((0.0, 1.0, -yc), ONE, ONE, ONE))
    first = tiles == 0
    assert torch.equal(rejected[first], regions[first] < 4)


@pytest.mark.parametrize("scale", [1e-44, 1e-38, 1e-20, 1e20, 1e36, 1e38])
def test_scaled_triangles(scale):
    """The same triangles with every function scaled: scaling changes no
    coverage in exact arithmetic; the reject stays safe where products
    fall below the normal range and where they near the top of it."""
    rng = np.random.default_rng(3)
    t = 64
    w = rng.uniform(0.5, 2.0, size=(t, 3, 1))
    xy = (rng.uniform(-1, 1, size=(t, 1, 2))
          + rng.normal(scale=0.05, size=(t, 3, 2))) * w
    rec = triangle_records(np.concatenate([xy, 0.5 * w, w], axis=-1))
    rec[:, :15] = (rec[:, :15].double() * scale).float()
    check(rec)


def test_nan_inf_and_the_cap_never_reject_alone():
    """A function with a NaN or an infinite coefficient, or whose margin
    passes MARGIN_CAP, rejects nothing; a record whose every function is
    so is never rejected."""
    nan, inf = float('nan'), float('inf')
    far = (1.0, 0.0, -2.0)
    capped = (1e36, 0.0, -2e36)               # far, but S > MARGIN_CAP
    for bad in ((nan, 0.0, -2.0), (1.0, 0.0, nan), (inf, 0.0, -2.0),
                (-inf, 0.0, -2.0), (1.0, 0.0, -inf), capped):
        recs = torch.cat([record(bad, ONE, ONE, ONE),
                          record(ONE, ONE, ONE, bad),
                          record(bad, bad, bad, bad)])
        rejected, _ = check(recs)
        assert not bool(rejected.any()), bad
    # another function may still reject a record holding a NaN
    rejected, _ = check(record(far, (nan,) * 3, ONE, (nan,) * 3))
    assert bool(rejected.all())
    one = torch.zeros(1, dtype=torch.long)
    assert not bool(RC.region_rejects(
        torch.full((1, 16), nan), RC.region_corners(CFG, one, one)).any())


@pytest.mark.parametrize("tiles", [1, 2, 7, 33, 64, 131, 1020, 4095])
def test_dealt_units_visit_every_region_once(tiles):
    """Warp w of block b takes unit w * B + b: every (tile, region)
    exactly once, and the heaviest tile's regions on the first blocks,
    one a block where there are enough blocks."""
    g = torch.Generator().manual_seed(tiles)
    order = torch.randperm(tiles, generator=g).to(torch.int32)
    tile, region = RC.dealt_units(order)
    assert tile.shape == (tiles * RC.REGIONS // RC.WALK_WARPS,
                          RC.WALK_WARPS)
    unit = tile * RC.REGIONS + region
    assert torch.equal(torch.sort(unit.flatten()).values,
                       torch.arange(tiles * RC.REGIONS))
    blocks = tile.shape[0]
    heaviest = torch.nonzero(tile == order[0])[:, 0]
    assert torch.unique(heaviest).numel() == min(blocks, RC.REGIONS)
    if blocks >= RC.REGIONS:
        assert bool((tile[:RC.REGIONS, 0] == order[0]).all())
        assert torch.equal(region[:RC.REGIONS, 0], torch.arange(RC.REGIONS))


def test_census_of_the_culled_courtyard():
    """The courtyard at 384x216 through frustum culling and LOD (the
    culled frame's early list without an HZB): the reject drops most
    (pair, region) tests, and no rejected record covers a pixel of its
    region."""
    w, h = 384, 216
    host = load_scene("resources/courtyard.glb", use_cache=False)
    scene = host.to_device("cpu")
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, w, h).matrices()), "cpu")
    world = G.node_world_matrices(scene, fi['node_translation'],
                                  fi['node_rotation'], fi['node_scale'])
    iw, _ = G.instance_transforms(scene, world)
    c = C.cull_instances(scene, iw, fi['cull_frustum_planes'],
                         fi['cull_cam_pos'], fi['proj_scale_px'], w, h,
                         error_threshold_px=2.0)
    a, b, v, _ = C.build_pairs(scene, c['visible'], c['lod'], 4096)
    v = C.cull_meshlets(scene, a, b, v, iw, fi['cull_frustum_planes'],
                        fi['cull_cam_pos'], w, h)
    geo = G.meshlet_clip_triangles(scene, iw, fi['view_proj'], a, b, v)
    cfg = R.RasterConfig(width=w, height=h, max_tris_per_tile=2048,
                         max_big_tris=512, pair_capacity=1 << 17)
    setup = R.setup_triangles(geo, cfg)
    inp = PC.peel_inputs(setup, R.bin_pairs_stream(setup, cfg), cfg, 1)

    census = RC.region_census(inp)
    tile, tri = RC.walked_pairs_by_tile(inp)
    assert census['regions_walked'] == tile.numel() * RC.REGIONS > 100000
    assert 0 < census['regions_kept'] < census['regions_walked'] // 2
    assert 0 < census['densest_unit_kept'] <= census['densest_unit_walked']
    wrong = kept = 0
    rec = inp.tri_rec[tri]
    for q in range(RC.REGIONS):
        region = torch.full_like(tile, q)
        rej = RC.region_rejects(rec, RC.region_corners(cfg, tile, region))
        kept += int((~rej).sum())
        pxn, pyn = region_pixels(cfg, tile[rej], region[rej])
        wrong += int(covers(rec[rej], pxn, pyn).sum())
    assert wrong == 0
    assert kept == census['regions_kept']
