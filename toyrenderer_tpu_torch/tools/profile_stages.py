"""The deferred frame's stages called one by one and timed.

Counterpart of toyrenderer_tpu/tools/profile_stages.py: on the stress
scene (192 objects, every pair, unculled), each stage of the default
frame -- node and instance transforms, meshlet clip, triangle setup,
binning into the dense (tiles, K) table, the dense-table fill (K7 on the
card, raster.fill_visibility on the CPU), the resolve records, the
resolve and GBuffer, deferred lighting with the sky, the tonemap -- is
called on the previous stage's output and timed: the median of `--reps`
calls after a warm-up, each by CUDA events on the card (by the host's
clock on the CPU).  The raster config is sized to the view
(engine/capacity.py: K to the densest tile, the big list and the span
classes to what they hold), so binning drops nothing and the fill draws
the whole frame; the reference keeps the default K, over which the
192-object view drops pairs.

Usage:
  python -m toyrenderer_tpu_torch.tools.profile_stages [--small] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch


def timed(fn, dev, reps: int):
    """(median ms of fn() over `reps` calls after one warm-up, its
    result)."""
    out = fn()
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(dev)
    ts = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize(dev)
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), out


def run(argv=None) -> list[tuple[str, float, str]]:
    """The stages' rows: (name, median ms, note)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--small", action="store_true",
                   help="32 objects at 448x256")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--objects", type=int, default=192)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if args.small:
        args.objects, args.width, args.height = 32, 448, 256

    from toyrenderer_tpu_torch.device import resolve_device
    from toyrenderer_tpu_torch.engine import (
        RenderSettings, View, default_frame_inputs)
    from toyrenderer_tpu_torch.engine.capacity import (
        sized_raster_config, sized_settings, tile_pair_counts)
    from toyrenderer_tpu_torch.ops import geometry as G
    from toyrenderer_tpu_torch.ops import raster as R
    from toyrenderer_tpu_torch.ops import sky
    from toyrenderer_tpu_torch.ops.dense_cuda import fill_visibility_dense
    from toyrenderer_tpu_torch.ops.gbuffer import (
        pack_resolve_records, resolve_gbuffer)
    from toyrenderer_tpu_torch.ops.lighting import deferred_lighting
    from toyrenderer_tpu_torch.ops.postprocess import compose_final
    from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

    dev = resolve_device(args.device)
    host = make_stress_scene(n_objects=args.objects, sphere_res=24)
    scene = host.to_device(dev)
    pi, pm = (torch.from_numpy(a).to(dev)
              for a in G.static_meshlet_pairs(host))
    settings = RenderSettings(width=args.width, height=args.height,
                              manual_exposure=0.1)
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, args.width, args.height).matrices()),
        dev)
    counts = tile_pair_counts(scene, fi, settings, {'opaque': (pi, pm)})
    need_b = counts['opaque']['big_tris'] + counts['opaque']['drop'][
        'drop_big']
    settings = dataclasses.replace(
        sized_settings(settings, counts),
        max_big_tris=max(settings.max_big_tris, need_b))
    cfg = sized_raster_config(settings, counts)
    rows = []

    def stage(name, fn, note=lambda out: ""):
        ms, out = timed(fn, dev, args.reps)
        rows.append((name, ms, note(out)))
        return out

    world = stage("node_world_matrices", lambda: G.node_world_matrices(
        scene, fi['node_translation'], fi['node_rotation'],
        fi['node_scale']))
    iw, iadj = stage("instance_transforms",
                     lambda: G.instance_transforms(scene, world))
    geo = stage("meshlet_clip", lambda: G.meshlet_clip_triangles(
        scene, iw, fi['view_proj'], pi, pm))
    setup = stage("setup_triangles", lambda: R.setup_triangles(geo, cfg))
    table, count, big, _ = stage(
        "bin_triangles", lambda: R.bin_triangles(setup, cfg),
        lambda o: f"max/tile={int(o[1].max())} big={int((o[2] >= 0).sum())}"
                  f" dropped={sum(int(v) for v in o[3].values())}")
    depth, tid = stage(
        "fill_visibility (K7)" if dev.type == 'cuda' else "fill_visibility",
        lambda: fill_visibility_dense(setup, table, count, big, cfg),
        lambda o: f"coverage={float((o[1] >= 0).float().mean()):.2f}")
    records = stage("pack_resolve_records", lambda: pack_resolve_records(
        setup, scene, iw, iadj, iw, fi['prev_view_proj_nojitter']))
    gb = stage("resolve_gbuffer", lambda: resolve_gbuffer(
        records, depth, tid, fi['jitter'], cfg))
    to_light = -fi['sun_direction']

    def sky_fn(d):
        return sky.sky_radiance_hosek(d, to_light, fi['sky_params'],
                                      sun_intensity=fi['sun_intensity'])
    hdr = stage("deferred_lighting+sky", lambda: deferred_lighting(
        gb, fi['cam_pos'], fi['inv_view_proj'], fi['sun_direction'],
        fi['sun_color'], fi['sun_intensity'], sky_fn))
    stage("postprocess", lambda: compose_final(hdr, exposure=0.1))
    print(f"device={dev}  {args.width}x{args.height}  pairs={pi.shape[0]}  "
          f"triangle slots={geo['tri_valid'].shape[0]}  "
          f"K={cfg.max_tris_per_tile}  B={cfg.max_big_tris}")
    for name, ms, note in rows:
        print(f"{name:<22} {ms:9.3f} ms   {note}")
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
