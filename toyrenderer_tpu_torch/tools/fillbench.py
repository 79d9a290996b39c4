"""The fused fill alone on the frame's early-phase inputs.

Counterpart of toyrenderer_tpu/tools/fillbench.py: the courtyard's
opaque pair list cut to 60% of LOD0 (bench.py parity), its clip-space
triangles at the default view, K sized to the view's densest tile (the
frame's capacity probe, engine/capacity.py), and then, each timed apart
by CUDA events (the least of --reps after a warm-up; with --device cpu
the host's clock around the plain versions):

  setup                  raster.setup_triangles
  bin_pairs_stream       the tile-sorted pair stream (with the pair
                         budget's accounting, raster_cuda.
                         bin_pairs_with_budget)
  pack_resolve_records   the (T, 64) resolve records
  fill_resolve_stream    K1, the fused fill + resolve (its plain version
                         on the CPU)

It prints one JSON line: the workload (valid triangles, binned pairs,
big triangles, chunk, tiles, K, drops), each stage's ms, the image's
coverage and mean depth, and on the card its name and power limit.
`--trace` also prints the per-op split of one run of each stage
(tools/passes.py: each stage a profiler range).

The reference's --chunk, --tile_h, --slots_y and --slots_x set its
Pallas kernel's layout and binning grid; the CUDA kernel is built for
16x128 tiles and the frame's binning, so they have no counterpart here
(as rtbench's --packet has none).

Usage:
  python -m toyrenderer_tpu_torch.tools.fillbench [--scene ...] \\
      [--width 1920 --height 1080] [--reps 3] [--trace] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from toyrenderer_tpu_torch.device import resolve_device

COURTYARD = (Path(__file__).resolve().parent.parent.parent / "resources"
             / "courtyard.glb")
PAIR_CUT = 0.6          # bench.py:140-146: the early pair list's share


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default=str(COURTYARD))
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    p.add_argument("--trace", action="store_true",
                   help="print the per-op split of one run of each stage")
    return p.parse_args(argv)


def _timed(fn, dev, reps):
    """(result, least ms of `reps` runs after a warm-up)."""
    res = fn()
    times = []
    for _ in range(max(reps, 1)):
        if dev.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            res = fn()
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            res = fn()
            times.append((time.perf_counter() - t) * 1e3)
    return res, min(times)


def card() -> str | None:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(argv=None) -> dict:
    """Build the inputs, time each stage, print and return the JSON
    line's dict."""
    from toyrenderer_tpu_torch.engine import RenderSettings, View
    from toyrenderer_tpu_torch.engine.capacity import (
        sized_settings, tile_pair_counts)
    from toyrenderer_tpu_torch.engine.frame import default_frame_inputs
    from toyrenderer_tpu_torch.ops import geometry as G
    from toyrenderer_tpu_torch.ops import raster as R
    from toyrenderer_tpu_torch.ops import raster_cuda as RC
    from toyrenderer_tpu_torch.ops.gbuffer import pack_resolve_records
    from toyrenderer_tpu_torch.scene import load_scene
    from toyrenderer_tpu_torch.utils.timing import profiler_range
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy
    args = _parse(argv)
    dev = resolve_device(args.device)
    host = load_scene(args.scene)
    mk_i, _ = G.static_meshlet_pairs(host, 'mask')
    pi, pm = G.static_meshlet_pairs(host, 'not_mask' if len(mk_i) else 'all')
    cap = max(int(len(pi) * PAIR_CUT), 256)
    pi, pm = (torch.from_numpy(a[:cap]).to(dev) for a in (pi, pm))
    scene = host.to_device(dev)
    st = RenderSettings(width=args.width, height=args.height)
    view = View.from_scene(host, st.width, st.height)
    fi = frame_inputs_from_numpy(default_frame_inputs(host, view.matrices()),
                                 dev)
    # K sized to the view's densest tile, as the frame's capacity probe
    # sizes it, so the fill walks every binned pair
    st = sized_settings(st, tile_pair_counts(scene, fi, st, {'opaque': (
        pi, pm)}))
    cfg = st.raster_config()
    world = G.node_world_matrices(scene, fi['node_translation'],
                                  fi['node_rotation'], fi['node_scale'])
    iw, ia = G.instance_transforms(scene, world)
    geo = G.meshlet_clip_triangles(scene, iw, fi['view_proj'], pi, pm)
    stages = dict(
        setup=lambda: R.setup_triangles(geo, cfg),
        bin_pairs_stream=lambda: RC.bin_pairs_with_budget(setup, cfg),
        pack_resolve_records=lambda: pack_resolve_records(
            setup, scene, iw, ia, iw, fi['prev_view_proj_nojitter']),
        fill_resolve_stream=lambda: RC.fill_resolve_stream(
            setup, records, bins, cfg))
    ms = {}
    setup, ms['setup'] = _timed(stages['setup'], dev, args.reps)
    bins, ms['bin_pairs_stream'] = _timed(stages['bin_pairs_stream'], dev,
                                          args.reps)
    records, ms['pack_resolve_records'] = _timed(
        stages['pack_resolve_records'], dev, args.reps)
    (depth, tid, _), ms['fill_resolve_stream'] = _timed(
        stages['fill_resolve_stream'], dev, args.reps)
    out = dict(
        scene=Path(args.scene).name, size=f"{args.width}x{args.height}",
        device=str(dev), valid_tris=int(setup['valid'].sum()),
        binned_pairs=int(bins['counts'].sum()),
        big_tris=int((bins['big_list'] >= 0).sum()), chunk=cfg.chunk,
        tiles=cfg.num_tiles, K=cfg.max_tris_per_tile,
        dropped={k: int(v) for k, v in bins['drop'].items()},
        ms={k: round(v, 4) for k, v in ms.items()},
        coverage=round(float((tid >= 0).float().mean()), 4),
        depth_mean=round(float(depth.mean()), 6))
    if dev.type == 'cuda':
        out['card'] = card()
    print(json.dumps(out), flush=True)
    if args.trace:
        from toyrenderer_tpu_torch.tools.passes import profile, table_lines

        def once():
            for name, fn in stages.items():
                with profiler_range(name):
                    fn()
        table, _ = profile(once, dev, 1)
        for line in table_lines(table, detail=list(stages)):
            print(line, flush=True)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
