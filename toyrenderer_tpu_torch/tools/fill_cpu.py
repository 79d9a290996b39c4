"""Time the dense fill's plain version, `raster.fill_visibility`, on the CPU.

It is `raster.rasterize`'s CPU path and the reference the dense-table
kernel (csrc/fill_dense.cu) is held against.  The tool sets up and bins
the Cornell box at the sizes the CPU tests rasterize it (448x256, K 128,
B 64: tests/test_torch_fill.py and tests/test_torch_dense_domain.py;
256x128, the same capacities: tests/test_torch_rasterize.py), then times
three calls of fill_visibility on one torch thread, as the tests run:
`first`, a first fill; `continued`, a fill continuing the first's planes
with ids offset; `below_floor`, that continuation with the left half of
the view at depth -2 (off the frames' domain).  Prints one JSON line a
size: the median seconds of --reps calls of each.

Usage (to compare two checkouts, put the other's root first on
PYTHONPATH and run this file by its path):
  python -m toyrenderer_tpu_torch.tools.fill_cpu [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from toyrenderer_tpu_torch.engine import View, default_frame_inputs
from toyrenderer_tpu_torch.ops import geometry as geo_mod
from toyrenderer_tpu_torch.ops import raster
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

SIZES = ((448, 256), (256, 128))
CAPACITY = dict(max_tris_per_tile=128, max_big_tris=64)


def cornell_setup(w: int, h: int):
    """(setup, table, big, cfg) of the Cornell box at w x h on the CPU."""
    root = Path(raster.__file__).resolve().parents[2]
    host = load_scene(root / "resources" / "cornell.gltf", use_cache=False)
    scene = host.to_device(torch.device('cpu'))
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, w, h).matrices()), torch.device('cpu'))
    world = geo_mod.node_world_matrices(
        scene, fi['node_translation'], fi['node_rotation'], fi['node_scale'])
    pairs = [torch.from_numpy(a)
             for a in geo_mod.static_meshlet_pairs(host, 'all')]
    geo = geo_mod.meshlet_clip_triangles(
        scene, geo_mod.instance_transforms(scene, world)[0],
        fi['view_proj'], *pairs)
    cfg = raster.RasterConfig(width=w, height=h, **CAPACITY)
    setup = raster.setup_triangles(geo, cfg)
    table, _, big, _ = raster.bin_triangles(setup, cfg)
    return setup, table, big, cfg


def median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for w, h in SIZES:
        setup, table, big, cfg = cornell_setup(w, h)
        z0, id0 = raster.fill_visibility(setup, table, big, cfg)
        low = torch.where(torch.arange(w)[None, :] < w // 2, -2.0, z0)
        cont = dict(init_tri_id=id0, emit_base=1000)
        row = dict(size=f"{w}x{h}", **CAPACITY, reps=args.reps, threads=1)
        for name, kw in (("first", {}),
                         ("continued", dict(init_depth=z0, **cont)),
                         ("below_floor", dict(init_depth=low, **cont))):
            row[f"{name}_s"] = median_s(
                lambda: raster.fill_visibility(setup, table, big, cfg, **kw),
                args.reps)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
