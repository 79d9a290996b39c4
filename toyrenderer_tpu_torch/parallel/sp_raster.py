"""One frame's raster sharded by tile rows over a mesh axis.

Counterpart of toyrenderer_tpu/parallel/sp_raster.py.  The frame's
tiles are independent (sort-middle binning), so each device of the axis
bins and fills only a horizontal band of tile rows: no halo, no merge.
Each band is filled by the fused fill + resolve kernel (K1,
ops/raster_cuda.fill_resolve_stream) unchanged, through an AFFINE EDGE
TRANSLATION: the kernel evaluates the edge functions at band-local
normalized coordinates py_l = (ty_l * TH + row) / H_l, and the frame
needs py_g = py_l * (H_l / H_g) + ty_lo * TH / H_g, so in
L = a * px + b * py_g + c each band's edges become

    b' = b * (H_l / H_g),     c' = c + b * (ty_lo * TH / H_g),

applied to the setup's edges and to slots 0:9 of the resolve records
(their copy of the same equations).  Depth, barycentrics and every
interpolant contract the same L values, so they are unchanged up to the
1-2 ulp of the two extra f32 roundings.

Departures from the reference (ROADMAP queue 3):

* `raster_frame_sp` takes `peel_depth` and gives it to every band: the
  reference's has no such parameter, so its masked and OIT layers on a
  mesh re-render layer 0 (its frame.py:645-650, 1196-1200).
* The bands' drop counters are summed into the stats under the single
  fill's names (`dropped`, `drop_*`); the reference's stats hold only
  `binned_pairs` and `big_tris`.
* Each band's pair budget is the frame's (engine/capacity.band_config),
  not max(cap // n, 256), so a band that holds more than its share of
  the pairs drops none that the single fill keeps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from toyrenderer_tpu_torch.engine.capacity import band_config
from toyrenderer_tpu_torch.ops.raster import RasterConfig
from toyrenderer_tpu_torch.ops.raster_cuda import (
    bin_pairs_with_budget, crop_image, fill_resolve_stream, pad_image)
from toyrenderer_tpu_torch.parallel.mesh import (
    Mesh, gather, run_on, to_device)


def shard_config(cfg: RasterConfig, n_shards: int) -> RasterConfig:
    """The RasterConfig of one band of n_shards (capacity.band_config);
    raises unless tiles_y % n_shards == 0."""
    return band_config(cfg, n_shards)


def shift_to_shard(setup: dict, records: torch.Tensor, ty_lo: int,
                   cfg: RasterConfig, cfg_s: RasterConfig):
    """The setup and resolve records in the local frame of the band whose
    first global tile row is ty_lo (sp_raster.py:49-76).  Returns
    (setup_s, records_s) for a fill with cfg_s."""
    f32 = torch.float32
    dev = records.device
    sy = (torch.tensor(cfg_s.height, dtype=f32, device=dev)
          / torch.tensor(cfg.height, dtype=f32, device=dev))
    dy = (torch.tensor(ty_lo * cfg.tile_h, dtype=f32, device=dev)
          / torch.tensor(cfg.height, dtype=f32, device=dev))
    e = setup['edges']                                   # (T, 3, 3)
    e = torch.stack([e[..., 0], e[..., 1] * sy, e[..., 2] + e[..., 1] * dy],
                    dim=-1)
    rows = cfg_s.tiles_y
    valid = (setup['valid'] & (setup['ty1'] >= ty_lo)
             & (setup['ty0'] < ty_lo + rows))
    setup_s = dict(setup, edges=e, valid=valid,
                   ty0=torch.clamp(setup['ty0'] - ty_lo, 0, rows - 1),
                   ty1=torch.clamp(setup['ty1'] - ty_lo, 0, rows - 1))
    # slots 0:9 repeat the edges: [a0 b0 c0 a1 b1 c1 a2 b2 c2]
    b = records[:, 1:9:3]
    c = records[:, 2:9:3] + b * dy
    abc = torch.stack([records[:, 0:9:3], b * sy, c], dim=-1).reshape(-1, 9)
    return setup_s, torch.cat([abc, records[:, 9:]], dim=1)


@dataclass
class Band:
    """One band's fill inputs, on its device: the shifted setup and
    records, its binned pair stream (with the pair-budget accounting) and
    its config."""
    device: torch.device
    ty_lo: int
    cfg: RasterConfig
    setup: dict
    records: torch.Tensor
    bins: dict


def shard_bands(setup: dict, records: torch.Tensor, cfg: RasterConfig,
                mesh: Mesh, axis: str = 'sp') -> list[Band]:
    """Shift and bin each band of `axis` on its device (the layer-
    invariant part of a fill: a peeled set bins once for all layers).
    The setup and records are copied to each band's device."""
    devices = mesh.along(axis)
    cfg_s = shard_config(cfg, len(devices))
    out = []
    for i, dev in enumerate(devices):
        with run_on(dev):
            ty_lo = i * cfg_s.tiles_y
            setup_s, rec_s = shift_to_shard(
                to_device(setup, dev), to_device(records, dev), ty_lo, cfg,
                cfg_s)
            out.append(Band(dev, ty_lo, cfg_s, setup_s, rec_s,
                            bin_pairs_with_budget(setup_s, cfg_s)))
    return out


def band_stats(setup: dict, bands: list[Band], device) -> dict:
    """The bands' raster counters summed on `device`, under the single
    fill's names (frame._raster_stats): tris (the frame's valid
    triangles), binned_pairs, big_tris, dropped and each drop_*."""
    def total(vals):
        return sum(v.to(device, non_blocking=True) for v in vals)
    out = dict(
        tris=torch.sum(setup['valid'].to(torch.int32)).to(device),
        binned_pairs=total(torch.sum(b.bins['counts']) for b in bands),
        big_tris=total(torch.sum((b.bins['big_list'] >= 0).to(torch.int32))
                       for b in bands))
    drops = {k: total(b.bins['drop'][k] for b in bands)
             for k in bands[0].bins['drop']}
    out['dropped'] = sum(drops.values())
    out.update(drops)
    return out


def raster_frame_sp(setup: dict, records: torch.Tensor, cfg: RasterConfig,
                    mesh: Mesh, axis: str = 'sp', init_depth=None,
                    init_tri_id=None, init_rec=None, emit_base: int = 0,
                    padded_io: bool = False, peel_depth=None,
                    bands: list[Band] | None = None):
    """The fused fill + resolve of one triangle set (fill_resolve_stream's
    contract), its tile rows sharded over `axis` (sp_raster.py:79-145):
    each band bins its rows and K1 fills them on its device (the plain
    fill for CPU tensors); init planes and peel bound are cut by tile
    rows, the outputs stitched on the mesh's first device.

    setup: raster.setup_triangles; records: (T, 64) pack_resolve_records.
    init_depth / init_tri_id / init_rec continue a previous fill;
    peel_depth is an exclusive near bound (depth peeling), given to
    every band.  `bands`: shard_bands of the same set, when the caller
    fills it more than once.  Returns (depth (H, W), tri_id (H, W),
    interp (INTERP_C, H, W), stats), padded to the tile grid when
    padded_io; stats sums the bands' counters (band_stats)."""
    if bands is None:
        bands = shard_bands(setup, records, cfg, mesh, axis)
    out_dev = mesh.first
    rows_px = bands[0].cfg.tiles_y * cfg.tile_h

    def padded(img, fill=0):
        if img is None or padded_io:
            return img
        return pad_image(img, cfg, fill)
    planes = dict(init_depth=padded(init_depth),
                  init_tri_id=padded(init_tri_id, -1),
                  init_rec=padded(init_rec), peel_depth=padded(peel_depth))
    zs, ids, recs = [], [], []
    for band in bands:
        y0 = band.ty_lo * cfg.tile_h
        with run_on(band.device):
            cut = {k: None if v is None else
                   to_device(v[..., y0:y0 + rows_px, :], band.device)
                   .contiguous() for k, v in planes.items()}
            z, tid, rec = fill_resolve_stream(
                band.setup, band.records, band.bins, band.cfg,
                emit_base=emit_base, padded_io=True, **cut)
        zs.append(z)
        ids.append(tid)
        recs.append(rec)
    z = gather(zs, out_dev, 0)
    tid = gather(ids, out_dev, 0)
    interp = gather(recs, out_dev, 1)
    stats = band_stats(setup, bands, out_dev)
    if padded_io:
        return z, tid, interp, stats
    return (crop_image(z, cfg), crop_image(tid, cfg), crop_image(interp, cfg),
            stats)
