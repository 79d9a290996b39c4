"""Content-sized raster capacities.

Counterpart of the reference package's engine/capacity.py
(`measure_raster_capacities`).  Every bounded path of the raster drops
what exceeds it and reports the drop: the per-tile list capacity K, the
big-triangle list B, the global pair budget, and the span-class caps of
the binning (`RasterConfig.compact_frac` / `short_frac` / `rest_frac`,
fractions of a set's triangle count).  Fixed values do not fit every
view: the unculled 1080p courtyard bins ~5,900 pairs into its densest
tile against the default K = 2048, and its alpha-masked set holds 1,549
`rest` triangles against a default cap of 616.  So the capacities are
sized from what the view really bins, measured by binning each set with
every bound lifted.

The probes run on the scene's device and return plain ints.  The class
caps are not RenderSettings fields (the reference's settings do not
reach them), so the sizing returns them as a RasterConfig per set,
which render_frame / make_render_fn take as `raster_cfg` (the opaque
set), `mask_raster_cfg` (the masked set) and `trans_raster_cfg` (the
blend set).  A cap only bounds
how many slots a class gets, and pairs keep their stable per-tile
order, so a sized config gives the same fill bit for bit wherever the
default one drops nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from toyrenderer_tpu_torch.ops import culling as cull_mod
from toyrenderer_tpu_torch.ops import geometry as geo_mod
from toyrenderer_tpu_torch.ops import raster as raster_mod

MARGIN = 1.3            # headroom of K, B and the class caps over the view
PAIR_MARGIN = 1.55      # and of the pair budget
# span class -> its RasterConfig fraction and cap
_CLASS_FIELDS = dict(tiny=('compact_frac', 'compact_cap'),
                     short=('short_frac', 'short_cap'),
                     rest=('rest_frac', 'rest_cap'))


def _probe_config(settings, t: int) -> raster_mod.RasterConfig:
    """settings' raster config with every bound lifted for a set of t
    triangles: nothing drops, so what binning needs is measured."""
    return dataclasses.replace(
        settings.raster_config(), max_tris_per_tile=1 << 30,
        max_big_tris=max(t, 1), pair_capacity=None, compact_frac=1.0,
        short_frac=1.0, rest_frac=1.0)


def _measure(geo: dict, settings) -> dict:
    """Bin one set's clip-space triangles with every bound lifted.

    Returns dict(tris: the set's triangle slots T, max_tile_pairs,
    pairs: the binned (tile, triangle) pairs, classes: the small
    triangles of each span class; and how settings' own bounds would
    hold them: big_tris the big list's length at its B, over_k the pairs
    over its K, drop the class caps' and the big list's drop
    counters)."""
    t = geo['tri_valid'].shape[0]
    cfg = _probe_config(settings, t)
    setup = raster_mod.setup_triangles(geo, cfg)
    bins = raster_mod.bin_pairs_stream(setup, cfg)
    classes = {k: int(v.sum()) for k, v in
               raster_mod.span_classes(setup, cfg).items()}
    counts = bins['counts']
    big = int((bins['big_list'] >= 0).sum())
    own = settings.raster_config()
    drop = {f'drop_{k}': max(classes[k] - getattr(own, cap)(t), 0)
            for k, (_, cap) in _CLASS_FIELDS.items()}
    drop['drop_big'] = max(big - settings.max_big_tris, 0)
    over_k = torch.clamp(counts - settings.max_tris_per_tile, min=0)
    return dict(tris=t, max_tile_pairs=int(counts.max()),
                pairs=int(counts.sum()),
                big_tris=min(big, settings.max_big_tris),
                classes={k: classes[k] for k in _CLASS_FIELDS},
                over_k=int(over_k.sum()), drop=drop)


def _instance_world(scene, frame_inputs):
    world = geo_mod.node_world_matrices(
        scene, frame_inputs['node_translation'],
        frame_inputs['node_rotation'], frame_inputs['node_scale'])
    return geo_mod.instance_transforms(scene, world)[0]


def tile_pair_counts(scene, frame_inputs: dict, settings,
                     pair_sets: dict) -> dict:
    """Measure each named (pair_inst, pair_meshlet) set of the unculled
    view (see _measure for the fields)."""
    inst_world = _instance_world(scene, frame_inputs)
    return {name: _measure(geo_mod.meshlet_clip_triangles(
        scene, inst_world, frame_inputs['view_proj'], inst, meshlet),
        settings) for name, (inst, meshlet) in pair_sets.items()}


def culled_pair_counts(scene, frame_inputs: dict, settings,
                       pair_capacity: int, mask_pairs=None,
                       blend_pairs=None) -> dict:
    """Measure the culled frame's sets: 'opaque', its early phase as the
    first frame runs it (frustum culling, screen-error LOD and meshlet
    culling into a list of `pair_capacity` pairs, no HZB: occlusion only
    removes pairs), and 'masked' / 'blend', the (pair_inst,
    pair_meshlet) sets `mask_pairs` / `blend_pairs` when given (drawn
    unculled).  The measured 'opaque' entry also holds `pairs_wanted`,
    the pairs culling kept before the list capacity."""
    inst_world = _instance_world(scene, frame_inputs)
    planes = frame_inputs['cull_frustum_planes']
    cam = frame_inputs['cull_cam_pos']
    w, h = settings.width, settings.height
    cull = cull_mod.cull_instances(
        scene, inst_world, planes, cam, frame_inputs['proj_scale_px'], w, h,
        error_threshold_px=settings.lod_error_px,
        forced_lod=settings.forced_lod)
    pi, pm, pv, total = cull_mod.build_pairs(scene, cull['visible'],
                                             cull['lod'], pair_capacity)
    pv = cull_mod.cull_meshlets(scene, pi, pm, pv, inst_world, planes, cam,
                                w, h, cone_cull=settings.enable_cone_culling)
    out = dict(opaque=_measure(geo_mod.meshlet_clip_triangles(
        scene, inst_world, frame_inputs['view_proj'], pi, pm, pv),
        settings))
    out['opaque']['pairs_wanted'] = int(total)
    for name, pairs in (('masked', mask_pairs), ('blend', blend_pairs)):
        if pairs is not None:
            out[name] = _measure(geo_mod.meshlet_clip_triangles(
                scene, inst_world, frame_inputs['view_proj'], *pairs),
                settings)
    return out


def _round_up(v: float, step: int, floor: int) -> int:
    return max(-(-int(v) // step) * step, floor)


def sized_settings(settings, counts: dict):
    """`settings` with max_tris_per_tile raised to the densest tile of
    `counts`, rounded up to the stream chunk; never lowered (the
    unculled frame's sizing)."""
    c = settings.raster_chunk
    need = max(v['max_tile_pairs'] for v in counts.values())
    k = max(settings.max_tris_per_tile, -(-need // c) * c)
    return dataclasses.replace(settings, max_tris_per_tile=k)


def sized_culled_settings(settings, counts: dict):
    """`settings` with K, B and the pair budget sized as the reference
    package's bench sizes them (bench.py:198-236): K and B at 1.3x the
    densest tile and the big list of any set, rounded up to 128, at
    least 512; the pair budget at 1.55x the opaque set's binned pairs,
    rounded up to 128, at least 4096.  (The reference counts those pairs
    clamped at the settings' K; here K already covers every tile.)"""
    k = max(v['max_tile_pairs'] for v in counts.values())
    b = max(v['big_tris'] + v['drop']['drop_big'] for v in counts.values())
    return dataclasses.replace(
        settings,
        max_tris_per_tile=_round_up(k * MARGIN, 128, 512),
        max_big_tris=_round_up(b * MARGIN, 128, 512),
        pair_capacity=_round_up(counts['opaque']['pairs'] * PAIR_MARGIN,
                                128, 4096))


def sized_raster_config(settings, counts: dict) -> raster_mod.RasterConfig:
    """settings.raster_config() with each span-class fraction raised, if
    need be, so that every set of `counts` fits its caps with the 1.3x
    margin: the set that needs the largest fraction decides, and the
    fractions are never lowered.  Size each set of a frame on its own
    counts: a larger cap than a set needs only makes its binning sort
    more empty slots.  A pair budget a set's binned pairs exceed is
    raised to 1.55x them, rounded up to 128 (a set the budget holds keeps
    it)."""
    cfg = settings.raster_config()
    fracs = {}
    for cls, (field, _) in _CLASS_FIELDS.items():
        need = max((-(-int(v['classes'][cls] * MARGIN) // 8) * 8 + 1)
                   / v['tris'] for v in counts.values())
        fracs[field] = max(getattr(cfg, field), min(need, 1.0))
    pairs = max(v['pairs'] for v in counts.values())
    if cfg.pair_capacity is not None and pairs > cfg.pair_capacity:
        fracs['pair_capacity'] = _round_up(pairs * PAIR_MARGIN, 128, 4096)
    return dataclasses.replace(cfg, **fracs)


def band_config(cfg: raster_mod.RasterConfig,
                n_bands: int) -> raster_mod.RasterConfig:
    """The RasterConfig of one of `n_bands` horizontal bands of `cfg`'s
    tile rows (parallel/sp_raster.py): the band's height, and the frame's
    own pair budget.  A band bins the frame's pairs of its own tile rows
    (a triangle clipped to the band keeps its tiles there), so a band
    whose pairs fit the frame's budget walks all of them: every pair the
    single fill walks there, and more where the single fill's budget ran
    out before the band's rows.  The
    reference divides the budget by the bands, max(cap // n, 256)
    (its sp_raster.py:43-44), so a band holding more than its share drops
    pairs the single fill keeps.  K, B and the class caps (fractions of
    the set's triangle slots, the same in every band) stay the frame's.
    One band is the frame itself (its height unpadded: the edges then
    translate by exactly nothing).  Requires tiles_y % n_bands == 0."""
    if n_bands < 1 or cfg.tiles_y % n_bands:
        raise ValueError(f"tiles_y={cfg.tiles_y} must divide by the "
                         f"{n_bands} bands (pad the render height)")
    if n_bands == 1:
        return cfg
    return dataclasses.replace(
        cfg, height=cfg.tiles_y // n_bands * cfg.tile_h)
