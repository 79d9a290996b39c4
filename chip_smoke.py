#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout: it builds the CUDA kernels (nvcc, one
process per source, in parallel, into toyrenderer_tpu_torch/build/),
builds the courtyard scene with the port's own loader, and then drives
both main paths through the port's entry points at 1920x1080:

* the default deferred frame (slice 1): the fill+resolve kernel (K1)
  held against its plain PyTorch version on the inputs of each of the
  frame's launches, a 384x216 frame on the card against the same frame
  on the CPU, 1 + 5 frames, a profile;
* the bench's culled frame (slice 2: 2-phase occlusion culling, HZB,
  screen-error LOD, the compact masked merge): K1 (its early fill and
  its late continuation) and the L-layer peel kernel (K2) held against
  their plain versions on the inputs of each of the frame's launches,
  1 + 5 frames with the carry (and its HZB) threaded, a 384x216 culled
  frame on the card against the CPU, a profile;
* the culled frame with RT sun shadows, the shadow denoiser, bloom,
  auto-exposure and TAA (slice 3), over a slow camera pan: the RT
  tree's host build, the BVH traversal kernel (K3, any-hit as the frame
  traces, and closest-hit) and the reprojection warp kernel (K4, its
  TAA and denoiser launches) held against their plain versions on the
  inputs the frame launches them with, 1 + 5 frames, 384x216 frames on
  the card against the CPU, a profile;
* the bench's all-on frame (slice 4): the shadowed frame with GTAO and
  DDGI on its own LOD-reduced SAH tree (gi_update_phases 4, interval
  mode): the GI tree's host build, the SAH traversal (K3-SAH) held
  against its plain version on an update frame's own probe rays,
  closest-hit and any-hit, the grouped-direction traversal (K5) on the
  same rays in the gdir layout (TR_GI_GDIR=1) held against its plain
  version and against K3-SAH, that frame's image against the default
  layout's, 1 + 8 frames (two of them update frames) with per-frame
  gates, update-frame and hold-frame medians and profiles, 384x216
  frames on the card against the CPU through one update;
* the probe rays' pair route (slice 5, TR_GI_PAIRS=1): the first update
  frame rendered again through it, the pair fold (K6) held against its
  plain version on both of the frame's launches, each route call (box
  phase, pair list, K6, the overflowed blocks' K3-SAH) against K3-SAH
  on the same rays, the frame against the default route's, both update
  frames profiled;
* the ray-traversal bench (slice 5, toyrenderer_tpu_torch/tools/
  rtbench.py) at 1,048,576 rays: the seeded walk (K3-seeded) of the
  binned rows held against its plain version, and each binned result
  against K3's root walk on the same rays;
* slice 6: `raster.rasterize` over the default view's dense (tiles, K)
  table, its fill (K7) held against its plain version on both of its
  launches (the opaque set, the masked set continuing its planes) and on
  the masked launch with part of its init depth at -2 (its exact pass),
  and against the bruteforce oracle on Cornell; the all-on update frame
  rendered again with its probe hits' sun taps read from the sun map;
  the bench's map-shadowed frame (the sun map's one-layer K2 launch
  held against its plain version, 1 + 5 frames, a profile); the stored
  goldens rendered as tests/test_goldens.py renders them (Cornell
  gated, the courtyard printed); the port's render CLI in its own
  process;
* slice 7, virtual-texture streaming: the plaza (resources/plaza.glb,
  3x3 courtyards) built with the port's loader and rendered as the
  reference bench's plaza chain renders it (bench.py:253-296, 683-721):
  the culled frame at 1920x1080 with content-sized capacities (printed
  beside the reference bench's probe of the same view), a tile manager
  of 96 tiles whose overrides ride frame_inputs, K1 (early, late) and
  K2 held against their plain versions on a streamed frame's launches,
  1 + 8 frames over the pan with each frame's tile feedback fed to the
  manager before the next (gates on every frame: drops 0, K1 2 and K2
  1, a finite image with coverage in (0, 1], the table's entries
  resident slots or fallbacks; refinement after the first feedback),
  the manager's host ms and bytes beside the frame's events, a
  profile, the last frame again with full residency (printed); then
  streamed 384x216 frames on the card against the CPU on one manager's
  overrides: the culled courtyard near its floor (tile manager), the
  culled textured stress scene (mip manager);
* slice 8, the frame's last settings: the glass-and-emitters frame at
  1920x1080 (the render CLI's stress scene with the ground and instance
  1 in glass, as tests/test_e2e.py:265-300 makes them; ReSTIR DI on its
  emissive triangles, the glass in 2 depth-peeled OIT layers, RT sun
  shadows, TAA): the traversal kernel (K3) held against its plain version
  on the frame's ReSTIR visibility rays (every pixel's) and shadow rays,
  K1 on both OIT layer launches, 1 + 5 frames of a pan with gates (a
  finite image, lights found, no drop in either set, ReSTIR light on
  some pixels; K1 3, K3 2, K4 2 a frame), a profile; the culled courtyard
  with the packed GBuffer, 1 + 5 frames, against the float-plane frame;
  each debug view 1-14 once on it; the all-on update frame with the probe
  overlay; 384x216 frames on the card against the CPU (the glass frame,
  the packed culled courtyard, debug views 2, 11 and 14, the probe
  overlay); the render CLI in its own processes (--scene stress --restir
  --transparency --oitlayers 2, and --animate on an animated Cornell,
  equal to the same frames rendered here).
* slice 9, the frame's caches: the shadowed, map-shadowed and all-on
  frames (the last also under TR_GI_PAIRS=1) at 1920x1080, each rendered
  uncached and cached (init_carry given the topologies and pair
  streams, cache_sun_map on) in the same loop, 1 + 8 frames of a pan
  with the node of instance 0 moved from frame 5 on: every frame
  bit-equal, no drop, the launches equal but for the sun map's K2
  (cached: 1 a still frame), the caches rebuilt on frames 0 and 5 and,
  for GI, on the update frames 3 and 7; medians and a profiled still
  frame's busy of both runs; GI's branch on all-on frames under
  torch.cuda.set_sync_debug_mode('warn'): the synchronizing calls of each
  frame, none from engine/frame.py and none added by the caches, the
  wait for the previous frame's convergence flag timed; the cached
  all-on chain saved after 5 frames (engine/snapshot.py), loaded into a
  fresh carry, its next 3 frames bit-equal to the uninterrupted chain;
  the per-pass tables (tools/passes.py) of a culled frame, an all-on
  update frame (also under TR_GI_PAIRS=1) and the glass frame, their
  sums within 2% of the busy union, at most 1% unattributed, at least
  98% of the launched kernels kept, each hand-written kernel in the pass
  that launches it; and tools/profile_stages.py once on the stress scene
  at the view's sized capacity (no drop), each K7 launch bit-equal to
  the plain fill on its arguments (its bound printed).  The
  map-shadowed phase of slice 6 runs with the cached sun map: K2 2 on
  its first frame, 1 on each still frame after it.
* slice 10, the reference's opt-in ray paths at 1920x1080: the chunk
  route (TR_RT_CHUNKS=1) on the all-on update frame's probe rays and
  their sun rays and on the glass frame's 2,073,600 ReSTIR rays -- the
  chunk fold (K8, csrc/chunks.cu) held bit-equal against its plain
  version on each launch (on a seeded sample of 1,024 blocks where the
  plain fold would take over 30 s, which the line names), each route
  call against the default route's kernel on the same rays (hit equal
  on >= 99.99% of live rays, closest-hit t within 1e-5 relative, its
  fallback launched once), the frames within 1 of the default route's
  on >= 99.5% of the pixels, no synchronizing call from
  engine/frame.py; the SAH main tree (TR_RT_SAH=1, built as the render
  CLI builds it) on the shadowed, map-shadowed, all-on and glass frames
  -- K3-SAH held against its plain walk on the shadow and ReSTIR rays
  it now traces, the shadow hits equal to the complete tree's on >=
  99.99% of live rays, each frame within 1 of the complete tree's on
  >= 99.5%, a cached still frame bit-equal to the uncached one, the
  cached chain's snapshot resumed bit-equal for 3 frames; the strip sun
  rays (TR_SHADOW_GDIR=1) on the shadowed frame -- K5 held against its
  plain version, the mask at half_angle=0 equal to the per-pixel
  layout's, at the sun's cone < 5% of it differing; the packed
  visibility fetch (TR_GI_VIS_PACK=1, its share within 1 printed) and
  the cone layouts TR_CONE_DIRS=8 / 32 and TR_CONE_BRICK=128 (bit-equal
  to the default layout) on the all-on update frame; every path's
  median frame ms and device busy beside its default's.

* slice 11, the multi-device frame and the last tools: meshes of 4
  repeated cards (and, where torch.cuda.device_count() > 1, of distinct
  ones; the `meshes` line says which ran): the culled courtyard's early
  fill at 1920x1080 through parallel.sp_raster.raster_frame_sp (4 bands
  of 17 tile rows) against the single K1 fill on the same setup (ids on
  >= 99.9%, depth within rtol 1e-5 / atol 1e-6 on >= 99.9% of the
  pixels where they agree, the largest difference printed, drops 0), each
  band's K1 launch bit-equal to the plain fill on its inputs, the band
  launches' ms beside the single launch's; the culled, all-on update and
  glass (2 OIT layers) frames on each mesh against the 1-device mesh
  (ids on >= 99.9%, depth as the sharded raster's; the culled image
  within 1 on >= 99.9%, the traced frames' -- all-on, glass -- within 2
  on >= 99.5%, the reference's own bar for its sharded traced frame;
  drops 0; the all-on update's probes bit-equal), the glass frame also
  against the frame without a mesh (the peel bound reaches the bands;
  within 2 on >= 99.5%), each frame's
  busy beside the frame without a mesh; traverse_auto with a mesh of 4
  on the frame's shadow rays (K3) and its probe rays in the gdir layout
  (K5), through the pair route (K6) and the chunk route (K8), each
  bit-equal to the unsharded call; 2 views on a ('dp', 'sp') = (2, 2)
  mesh, each within 1 of its view alone on >= 99.9%; tools/fillbench.py
  (its JSON line), tools/rtbench.py --scene stress (its rows' Mrays/s),
  and tools/shell.py on Cornell (--port 0 --max-frames 3) with
  /frame.jpg and /stats.json fetched over localhost, the JPEG decoded by
  the port's decoder within SHELL_PSNR dB of the frame.  The mesh
  frames' and sharded calls' launches add to the kernels line's counts.
* slice 12, every JPEG kind the reference decodes through Pillow: 4 of
  the courtyard's base-colour textures (stone0, stone2, brick, wood)
  encoded by scene/jpeg_encode.py, each transcoded by tests/
  jpeg_streams.py to progressive Huffman, sequential arithmetic and
  progressive arithmetic, every stream decoded on the host bit-equal to
  the baseline decode, each decoder's host seconds per megapixel (best
  of 3 decodes) beside the card's name and power limit; the culled
  courtyard frame at 1920x1080 with the progressive textures in place
  bit-equal to the frame with the baseline ones (image, HDR, launches)
  and unlike the PNG-textured frame.  Its frames' K1 and K2 launches add
  to the kernels line's counts.

Each K6 line gives its even split's census (pairs_cuda.census: ray
blocks with pairs, their largest and mean walk, work items and the grid,
runs, and the runs' warps that skip the arithmetic for want of a live
ray); each traversal line (K3, K3-SAH, K5, K3-seeded) gives its
persistent schedule's (the live share of the slots, the warps launched,
the ray slots the warps took, the last, empty fetch of each included).

Each K1, K2 and K7 line also gives the bound counted at the pixels of
each tested triangle's bbox (bound_ms) beside the count at every pixel
of the tile that PERF.md's earlier rows used (bound_all_px_ms); each
line gives the whole wrapper call's time from CUDA events (ms:
K1's call runs a check of the records for NaN depths, the walk and the
exact pass, K2's the walk and the exact pass, csrc/tile_walk.cuh; K7's
the same three) and each of those kernels' own from its profiler events
(walk_ms, check_ms, exact_ms), and the census of the warp walk's corner
reject (raster_cuda.pairs_census: (pair, region) tests walked and kept,
the densest unit's records).  In the `kernels` line, K1's, K2's and
K7's `ms` is the whole call's, the parts beside it.

It prints one line per phase, then a `kernels` JSON line and, last, an
`ok` JSON line.  Any failed phase raises: the script then exits nonzero
and prints no `ok` line.  Without a CUDA device, or outside a checkout
of the repo, it exits nonzero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "resources" / "courtyard.glb"
WIDTH, HEIGHT = 1920, 1080
SMALL = (384, 216)               # card-vs-CPU frames
FRAMES = 5                       # timed frames after one warm-up
ALLON_FRAMES = 8                 # the all-on path's: two update frames
KERNEL_REPS = 10                 # timed launches per kernel input
PROFILE_TRIES = 3                # device traces taken before none counts
OPAQUE_PAIR_FRAC = 0.6           # bench.py:140-146: the culled frame's
#                                  early pair list, as a share of LOD0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside
# the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations of one (pair, pixel) test: five affine evaluations
# (2 mul + 2 add each); of one peel-layer step of the cascade: the band
# bound (1 mul), its two compares and the nearer compare; and of one won
# pixel's resolve epilogue: three barycentric evaluations (~60), 16
# interpolants and their derivatives (~115), the normal's and the
# cotangent frame's normalisation (~65)
OPS_PER_TEST = 20
OPS_PER_CASCADE_LAYER = 4
OPS_PER_RESOLVE = 240
# f32 operations of one ray-box slab test (6 multiply-subtract pairs, 12
# min/max, the compare) and of one ray-triangle test (Moller-Trumbore:
# two cross products, four dot products, the tests), counting a
# multiply-add pair as two; under -fmad=false each pair compiles to two
# instructions, so the kernels reach at most half the FMA peak on them
OPS_PER_SLAB = 22
OPS_PER_TRI_TEST = 54
# bytes the traversal moves for a ray slot: every slot reads t_max and
# live and writes t, tri and steps; only a live slot also reads its
# origin and direction (a grouped one: its origin, and its group's
# direction once per group)
SLOT_BYTES = 4 + 4 + 12
VEC3_BYTES = 12
# f32 operations of one (pair, ray, triangle) test of the pair fold
# (K6): the forms' multiply-adds (two each) on their coefficients that
# are not zero by construction (rt_pairs.mt_tables: det 3 on d; u_num
# and v_num 3 on d and the 6 off-diagonal o (x) d; t_num 4 on 1 and o)
# and the epilogue (the |det| test, the reciprocal, three multiplies,
# u + v, six compares, the inv_det test)
PAIR_USED_ROWS = 3 + 9 + 9 + 4
OPS_PER_PAIR_TEST = PAIR_USED_ROWS * 2 + 13
# bytes of one pair-fold ray slot: read [o, d, t_max, live], write
# (t, ordinal)
PAIR_SLOT_BYTES = 8 * 4 + 2 * 4
SHADOW_YAW = 0.002               # rad a frame: ~2 px of pan at 1080p
PLAZA = ROOT / "resources" / "plaza.glb"
PLAZA_POOL = 96                  # bench.py:253-296: BENCH_VTPOOL's default
PLAZA_FRAMES = 8                 # timed plaza frames after one warm-up
# the reference bench's capacity probe of the same plaza view
# (BENCH_r05.json plaza_auto_caps: densest tile, big list, binned
# pairs; counts from the JAX package's CPU probe, not times)
REF_PLAZA_MEASURED = (4260, 592, 243409)
NEAR_FLOOR = (-0.6, -0.8)        # pitch (rad) and height change (units)
#                                  of the courtyard view whose floor wants
#                                  its tiled mips at 384x216
# planes the kernel copies from the winner's record (material factors,
# ids, texture statics, cutoff): bit-equal; the others are computed and
# held to 1e-5, as tests/test_torch_kernel.py holds them
COPIED_PLANES = list(range(15, 28)) + [31]
PLANE_TOL = 1e-5


def phase(title: str, **fields):
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{title}] {parts}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over `reps` runs, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# each hand-written kernel's symbol, and the positions in launch_counts()
# of the wrappers that launch it
KERNEL_SYMBOLS = (("fill_resolve_kernel", (0,)),
                  ("nan_check_kernel", (0, 8)),
                  ("fill_resolve_exact_kernel", (0,)),
                  ("fill_peel_kernel", (1,)), ("fill_peel_exact_kernel", (1,)),
                  ("traverse_kernel", (2, 4, 5, 6)), ("warp_kernel", (3,)),
                  ("pairs_kernel", (7,)), ("fill_dense_kernel", (8,)),
                  ("fill_dense_exact_kernel", (8,)), ("chunks_kernel", (9,)))


def is_range(key: str) -> bool:
    """Whether a profiler key is one of render_frame's pass ranges (or
    tools/passes.py's frame range)."""
    from toyrenderer_tpu_torch.engine.frame import PASS_LABELS
    return (key in PASS_LABELS or key == 'Frame'
            or key.startswith('TransparentForward('))


def trace(fn):
    """fn() under the profiler: (fn's result, the trace's key averages,
    the device ms of its kernels, short): `short` maps each hand-written
    kernel whose events in the trace fall short of the launches fn made
    of it (its wrappers' launch counts) to "events/launches"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from toyrenderer_tpu_torch.ops import bvh_cuda

    def counts():
        return launch_counts() + [bvh_cuda.launches_by_kernel['K8']]
    before = counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    launched = [a - b for a, b in zip(counts(), before)]
    events = prof.key_averages()
    # a frame's pass ranges (record_function) come back as device events
    # spanning their kernels: not kernels themselves
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not is_range(e.key)]
    ms = sum(e.self_device_time_total for e in device) / 1e3
    short = {}
    for sym, idx in KERNEL_SYMBOLS:
        want = sum(launched[i] for i in idx)
        got = sum(e.count for e in device if sym in e.key)
        if got < want:
            short[sym] = f"{got}/{want}"
    return out, events, ms, short


def profiled(fn):
    """fn() under the profiler: (fn's result, the trace's key averages,
    the device ms of its kernels; 0.0 when no trace was whole).  The
    profiler's device trace now and then comes back with no kernel in
    it, or with fewer events of a hand-written kernel than fn launched
    of it.  Such a trace is taken again, up to PROFILE_TRIES times in
    all, each time printing a [profiler] line with the kernel events
    found against the launches made."""
    for attempt in range(PROFILE_TRIES):
        out, events, ms, short = trace(fn)
        if ms > 0 and not short:
            return out, events, ms
        phase("profiler", note=("the device trace came back empty" if ms == 0
                                else "the device trace holds fewer kernel "
                                "events than launches"),
              events_of_launches=json.dumps(short),
              attempt=f"{attempt + 1}/{PROFILE_TRIES}")
    return out, events, 0.0


def kernel_ms(fn, reps: int, symbol: str) -> float:
    """Mean device time of one launch of the hand-written kernel
    `symbol`, which fn() launches: over `reps` calls after a warm-up, the
    mean duration of that kernel's events in the profiler's trace.  A
    trace that lost some of them still times the ones it holds (a
    [profiler] line counts them); one that holds none is taken again, up
    to PROFILE_TRIES times, then CUDA events time it."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        _, events, _, short = trace(lambda: [fn() for _ in range(reps)])
        mine = [e for e in events
                if e.device_type == DeviceType.CUDA and symbol in e.key]
        n = sum(e.count for e in mine)
        if symbol in short:
            phase("profiler", note="the device trace holds fewer kernel "
                  "events than launches; timed from the events it holds",
                  kernel=symbol, events_of_launches=short[symbol],
                  attempt=f"{attempt + 1}/{PROFILE_TRIES}")
        if n:
            return sum(e.self_device_time_total for e in mine) / 1e3 / n
    phase("profiler", note="no kernel event in the trace; timed with CUDA "
          "events", kernel=symbol)
    return cuda_ms(fn, reps)


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls after a warm-up: the
    summed time of the device kernels it launched, from the profiler.
    Events around a loop of short kernels would also count the gaps in
    which the host is still launching the next one; they are the
    measurement only where no trace came back whole."""
    import torch
    fn()
    torch.cuda.synchronize()
    _, _, ms = profiled(lambda: [fn() for _ in range(reps)])
    if ms > 0:
        return ms / reps
    phase("profiler", note="no whole device trace; timed with CUDA events")
    return cuda_ms(fn, reps)


def big_box_tests(inp):
    """(tiles that test the big list, big entries) bool: entry b's tile
    bbox holds visited tile k, so k must test it."""
    import torch
    lay, cfg = inp.lay, inp.cfg
    nb = int((inp.bins['big_list'] >= 0).sum())
    box = lay['big_box'][:nb]
    tiles = torch.nonzero((lay['n_chunks'] > 0)
                          & (lay['bighit'] > 0)).flatten()
    tx = (tiles % cfg.tiles_x)[:, None]
    ty = (tiles // cfg.tiles_x)[:, None]
    return ((tx >= box[None, :, 0]) & (tx <= box[None, :, 1])
            & (ty >= box[None, :, 2]) & (ty <= box[None, :, 3]))


def walked_pairs(inp):
    """(tile, triangle) of every test a streamed fill makes (each visited
    tile's own pairs, then the big triangles whose tile bbox holds it: a
    triangle covers no pixel outside its bbox), and how many of them are
    pair-stream entries."""
    from toyrenderer_tpu_torch.ops.raster_cuda import walked_pairs_by_tile
    tile, tri = walked_pairs_by_tile(inp)
    lay = inp.lay
    return tile, tri, int(lay['counts_eff'][lay['n_chunks'] > 0].sum())


def box_pixels(edges, tiles, cfg) -> int:
    """The pixel tests a fill needs for its (tile, triangle) tests: for
    each, the tile's pixels inside the triangle's pixel bbox, or the whole
    tile where a vertex is not in front of the camera (its covered region
    is then not bounded by its vertices).  edges (N, 3, 3): the tested
    triangles' edge equations, raster records [0:9]; tiles (N,).  The
    vertices come back from the edges: edge i is (v_j x v_k) up to the
    winding's sign, so e_1 x e_2 is det * v_0 (and so on round), and the
    sign of det(e) is the sign of det, which gives each vertex's w."""
    import torch
    e = edges.double()
    c = torch.stack([torch.linalg.cross(e[:, 1], e[:, 2]),
                     torch.linalg.cross(e[:, 2], e[:, 0]),
                     torch.linalg.cross(e[:, 0], e[:, 1])], dim=1)
    w = c[..., 2] * torch.sign(torch.linalg.det(e))[:, None]
    sx = c[..., 0] / c[..., 2] * cfg.width
    sy = c[..., 1] / c[..., 2] * cfg.height
    bounded = (w > 0).all(1) & torch.isfinite(sx).all(1) & torch.isfinite(
        sy).all(1)
    x0 = (tiles % cfg.tiles_x) * cfg.tile_w
    y0 = (tiles // cfg.tiles_x) * cfg.tile_h

    def span(lo, hi, t0, size):
        a = torch.clamp(torch.floor(lo), min=-1, max=1e6)
        b = torch.clamp(torch.floor(hi), min=-1, max=1e6)
        return torch.clamp(torch.minimum(b, t0 + size - 1.0)
                           - torch.maximum(a, t0.double()) + 1.0, min=0)
    nx = span(sx.amin(1), sx.amax(1), x0, cfg.tile_w)
    ny = span(sy.amin(1), sy.amax(1), y0, cfg.tile_h)
    n = torch.where(bounded, nx * ny, float(cfg.tile_w * cfg.tile_h))
    return int(n.sum())


def bound(ops: float, bytes_: float) -> tuple[float, str]:
    """The larger of the operations and the bytes at the card's peaks."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def pixel_tests(inp, tile, tri, all_px: bool) -> int:
    """The (pair, pixel) tests a streamed fill needs for its (tile,
    triangle) tests: box_pixels, or (all_px, the count the earlier rows
    of PERF.md used) every pixel of the tile for each."""
    if all_px:
        return tile.numel() * inp.cfg.tile_h * inp.cfg.tile_w
    return box_pixels(inp.tri_rec[tri, :9].reshape(-1, 3, 3), tile,
                      inp.cfg)


def fill_bound_ms(inp, tid, won, all_px=False) -> tuple[float, str]:
    """Least time the card could take for one fill+resolve on these
    inputs, counted for this run's data.  Operations: the (pair, pixel)
    tests of `pixel_tests` and the resolve of each won pixel.  Bytes:
    each input read once -- the records of the triangles tested and of
    the winners, the pair stream, the per-tile tables, the init planes
    and peel bound this fill was given (the first layer is given none) --
    and the 34 output planes written once."""
    import torch
    cfg = inp.cfg
    tile, tri, n_stream = walked_pairs(inp)
    n_won = int(won.sum())
    ops = (pixel_tests(inp, tile, tri, all_px) * OPS_PER_TEST
           + n_won * OPS_PER_RESOLVE)
    winners = torch.unique(tid[won] - inp.emit_base).numel()
    hp, wp = inp.padded_shape
    n_px = hp * wp
    nb = int((inp.bins['big_list'] >= 0).sum())
    given = [x for x in (inp.init_z, inp.init_id, inp.peel) if x is not None]
    bytes_ = (torch.unique(tri).numel() * 16 * 4      # raster records
              + n_stream * 4 + nb * 5 * 4             # stream, big list
              + cfg.num_tiles * 4 * 4                 # per-tile tables
              + winners * 64 * 4                      # resolve records
              + len(given) * n_px * 4
              + (0 if inp.init_rec is None else (n_px - n_won) * 32 * 4)
              + n_px * 34 * 4)                        # depth, ids, planes
    return bound(ops, bytes_)


def peel_bound_ms(inp, all_px=False) -> tuple[float, str]:
    """Least time the card could take for one L-layer peel fill on these
    inputs: every (pair, pixel) test of `pixel_tests` runs the edge and
    depth evaluation and the cascade's L layers; bytes: the occluder read
    once, the records of the triangles tested, the pair stream and
    per-tile tables, and the 2 L planes (depth, id) written once."""
    import torch
    cfg = inp.cfg
    tile, tri, n_stream = walked_pairs(inp)
    ops = (pixel_tests(inp, tile, tri, all_px)
           * (OPS_PER_TEST + OPS_PER_CASCADE_LAYER * inp.layers))
    hp, wp = inp.padded_shape
    nb = int((inp.bins['big_list'] >= 0).sum())
    bytes_ = (torch.unique(tri).numel() * 16 * 4
              + n_stream * 4 + nb * 5 * 4 + cfg.num_tiles * 4 * 4
              + (0 if inp.occluder is None else hp * wp * 4)
              + 2 * inp.layers * hp * wp * 4)
    return bound(ops, bytes_)


def dense_bound_ms(setup, inp, all_px=False) -> tuple[float, str]:
    """Least time the card could take for one dense-table fill (K7) on
    one launch's inputs (dense_cuda.DenseInputs): operations, the edge
    and depth tests of every record the kernel's walk tests
    (dense_cuda.walked_pairs_by_tile: each tile's table entries, then
    the big triangles whose tile bbox holds it) at the pixels box_pixels
    counts (none outside a bounded triangle's pixel bbox) or, all_px, at
    every pixel of the tile; bytes, the records of the triangles tested
    read once, the walked table entries, the big list and its boxes, the
    per-tile tables (row start, count, big hit, order), the init planes
    given, and the depth and id planes written once."""
    import torch
    from toyrenderer_tpu_torch.ops.dense_cuda import walked_pairs_by_tile
    cfg = inp.cfg
    tile, tri = walked_pairs_by_tile(inp)
    px = (tile.numel() * cfg.tile_h * cfg.tile_w if all_px else
          box_pixels(setup['edges'][tri], tile, cfg))
    hp, wp = cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w
    given = [x for x in (inp.init_z, inp.init_id) if x is not None]
    bytes_ = (torch.unique(tri).numel() * 16 * 4 + int(inp.count.sum()) * 4
              + int((inp.big_list >= 0).sum()) * 5 * 4
              + cfg.num_tiles * 4 * 4
              + len(given) * hp * wp * 4 + 2 * hp * wp * 4)
    return bound(px * OPS_PER_TEST, bytes_)


def units_below_floor(depth, cfg) -> int:
    """The (tile, region) units of an (H, W) init depth that hold a pixel
    below -1: the units a K1 or K7 walk leaves to its exact pass."""
    from toyrenderer_tpu_torch.ops.raster_cuda import (
        REGION_H, REGION_W, pad_image)
    d = pad_image(depth, cfg)
    hp, wp = d.shape
    low = (d < -1).reshape(hp // REGION_H, REGION_H, wp // REGION_W,
                           REGION_W)
    return int(low.any(3).any(1).sum())


def perceptual_diff(a_u8, b_u8) -> tuple[float, float]:
    """The golden images' metric (tests/test_goldens.py:76-85): per pixel
    the largest channel difference of the two images in linear RGB,
    each blurred by a separable [1 2 1] / 4 (edges clamped); returns
    its mean and 99th percentile."""
    import numpy as np

    def blur(x):
        k = (0.25, 0.5, 0.25)
        p = np.pad(x, ((1, 1), (0, 0), (0, 0)), mode='edge')
        x = k[0] * p[:-2] + k[1] * p[1:-1] + k[2] * p[2:]
        p = np.pad(x, ((0, 0), (1, 1), (0, 0)), mode='edge')
        return k[0] * p[:, :-2] + k[1] * p[:, 1:-1] + k[2] * p[:, 2:]

    def lin(u8):
        s = u8.astype(np.float64) / 255.0
        return np.where(s <= 0.04045, s / 12.92,
                        ((s + 0.055) / 1.055) ** 2.4)
    d = np.abs(blur(lin(a_u8)) - blur(lin(b_u8))).max(axis=-1)
    return float(d.mean()), float(np.percentile(d, 99))


def compare_fill(got, want, won_mask) -> float:
    """Kernel output vs plain output: ids and depth bit-equal; on every
    won pixel the copied planes bit-equal and the computed ones within
    PLANE_TOL; elsewhere the init planes bit-equal.  Returns the planes'
    max |difference|."""
    import torch
    z_k, id_k, rec_k = got
    z_p, id_p, rec_p = want
    if not torch.equal(id_k, id_p):
        n = int((id_k != id_p).sum())
        raise AssertionError(f"triangle ids differ at {n} pixels")
    if not torch.equal(z_k, z_p):
        raise AssertionError("depth is not bit-equal: max |d| "
                             f"{float((z_k - z_p).abs().max())}")
    a, b = rec_k[:, won_mask], rec_p[:, won_mask]
    for ch in range(a.shape[0]):
        if ch in COPIED_PLANES:
            ok = torch.equal(a[ch], b[ch])
        else:
            ok = bool(torch.isclose(a[ch], b[ch], rtol=PLANE_TOL,
                                    atol=PLANE_TOL).all())
        if not ok:
            raise AssertionError(f"plane {ch}: max |d| "
                                 f"{float((a[ch] - b[ch]).abs().max())}")
    keep = ~won_mask
    if not torch.equal(rec_k[:, keep], rec_p[:, keep]):
        raise AssertionError("planes of pixels no fragment won differ")
    return float((rec_k - rec_p).abs().max())


def every_box(inp):
    """inp with every big bbox widened to the whole tile grid (K7's
    DenseInputs: and every tile marked as one a big bbox holds, so every
    region walks the whole big list)."""
    import torch
    cfg = inp.cfg
    box = inp.lay['big_box'] if hasattr(inp, 'lay') else inp.big_box
    grid = torch.tensor([0, cfg.tiles_x - 1, 0, cfg.tiles_y - 1],
                        dtype=torch.int32, device=box.device)
    if not hasattr(inp, 'lay'):
        return dataclasses.replace(
            inp, big_box=grid.expand_as(box).contiguous(),
            bighit=torch.ones_like(inp.bighit))
    return dataclasses.replace(inp, lay=dict(inp.lay,
                                             big_box=grid.expand_as(box)))


def hold_k1(name, inp) -> dict:
    """K1 against its plain version on one input: ids and depth
    bit-equal, planes as compare_fill holds them, and the plain version
    testing every big triangle on every tile it could reach agrees (the
    big-list bbox filter changes no pixel).  Prints the phase line;
    returns the input's err, ms, plain_ms and bound."""
    import torch
    from toyrenderer_tpu_torch.ops import raster_cuda
    got = raster_cuda.launch(inp)
    t = time.time()
    want = raster_cuda.fill_resolve_plain(inp)
    torch.cuda.synchronize()
    plain_wall = time.time() - t
    won = want[1] != raster_cuda.init_planes(inp)[1]
    err = compare_fill(got, want, won)
    z_all, id_all, _ = raster_cuda.fill_resolve_plain(every_box(inp))
    if not (torch.equal(id_all, got[1]) and torch.equal(z_all, got[0])):
        raise AssertionError(f"K1 ({name}): the big-list bbox filter "
                             "changed the fill")
    st = dict(err=err, ms=cuda_ms(lambda: raster_cuda.launch(inp),
                                  KERNEL_REPS),
              **{f"{part}_ms": kernel_ms(lambda: raster_cuda.launch(inp),
                                         KERNEL_REPS, symbol)
                 for part, symbol in (("walk", "fill_resolve_kernel"),
                                      ("check", "nan_check_kernel"),
                                      ("exact", "fill_resolve_exact_kernel"))},
              plain_ms=cuda_ms(lambda: raster_cuda.fill_resolve_plain(inp),
                               1),
              bound=fill_bound_ms(inp, want[1], won),
              bound_all_px=fill_bound_ms(inp, want[1], won, True)[0],
              census=raster_cuda.region_census(inp))
    phase("K1 vs plain", input=json.dumps(name), won_px=int(won.sum()),
          pairs_walked=int(inp.lay['counts_eff'].sum()),
          init_planes=inp.init_z is not None, emit_base=inp.emit_base,
          ids="equal", depth="bit-equal", planes_max_abs=f"{err:.3g}",
          big_tests_in_box=f"{int(big_box_tests(inp).sum())}"
          f"/{int(big_box_tests(every_box(inp)).sum())}",
          census=json.dumps(st['census']),
          ms=f"{st['ms']:.4f}", walk_ms=f"{st['walk_ms']:.4f}",
          check_ms=f"{st['check_ms']:.4f}", exact_ms=f"{st['exact_ms']:.4f}",
          plain_ms=f"{st['plain_ms']:.1f}",
          plain_first_wall_s=f"{plain_wall:.1f}",
          bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1],
          bound_all_px_ms=f"{st['bound_all_px']:.4f}")
    return st


def hold_k2_times(inp, plain_inp) -> dict:
    """K2's numbers on one input (held bit-equal by the caller): the
    whole call's time from CUDA events, its walk's and its exact pass's
    from their kernel events, the plain version's, the bound and the
    all-pixel bound, and the reject's census."""
    from toyrenderer_tpu_torch.ops import peel_cuda, raster_cuda
    return dict(
        ms=cuda_ms(lambda: peel_cuda.launch(inp), KERNEL_REPS),
        walk_ms=kernel_ms(lambda: peel_cuda.launch(inp), KERNEL_REPS,
                          "fill_peel_kernel"),
        exact_ms=kernel_ms(lambda: peel_cuda.launch(inp), KERNEL_REPS,
                           "fill_peel_exact_kernel"),
        plain_ms=cuda_ms(lambda: peel_cuda.fill_peel_plain(plain_inp), 1),
        bound=peel_bound_ms(inp), bound_all_px=peel_bound_ms(inp, True)[0],
        census=raster_cuda.region_census(inp))


def k2_fields(st) -> dict:
    """hold_k2_times' numbers as phase fields."""
    return dict(census=json.dumps(st['census']),
                ms=f"{st['ms']:.4f}", walk_ms=f"{st['walk_ms']:.4f}",
                exact_ms=f"{st['exact_ms']:.4f}",
                plain_ms=f"{st['plain_ms']:.1f}",
                bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1],
                bound_all_px_ms=f"{st['bound_all_px']:.4f}")


def hold_k7(name, args) -> dict:
    """K7 against its plain version on one launch's arguments: ids and
    depth bit-equal to raster.fill_visibility at tile_batch 128 (its
    result does not depend on the batch: tests/test_torch_dense_domain.py),
    and the exact pass walking the units that hold an init depth below
    -1 (none on a frame's planes).  Then the whole call's time from CUDA
    events (ms: dense_cuda.launch_inputs on the prepared inputs, as K1's
    launch is timed -- the record check, the walk, the exact pass), each
    of those kernels' own from its profiler events, the plain version's,
    the bound and the all-pixel bound, and the corner reject's census.
    Beside them the same call with the big-list bbox filter off (every
    big bbox the whole grid, every_box): its result bit-equal, its time
    and its walk's (every_box_ms, every_box_walk_ms), and its census's
    regions walked.  Prints the phase line; returns those numbers."""
    import torch
    from toyrenderer_tpu_torch.ops import dense_cuda, raster_cuda
    setup, table, count, big, cfg, init_z, _, base = args
    inp = dense_cuda.dense_inputs(*args)
    plain = dataclasses.replace(
        inp, cfg=dataclasses.replace(cfg, tile_batch=128))
    exact = {}
    got = dense_cuda.launch_inputs(inp, exact=exact)
    t = time.time()
    want = dense_cuda.fill_dense_plain(plain)
    torch.cuda.synchronize()
    plain_wall = time.time() - t
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"K7 ({name}): ids differ at "
                             f"{int((got[1] != want[1]).sum())} pixels")
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"K7 ({name}): depth is not bit-equal")
    low = 0 if init_z is None else units_below_floor(init_z, cfg)
    if int(exact['units']) != low:
        raise AssertionError(f"K7 ({name}): the exact pass walked "
                             f"{int(exact['units'])} units, want {low}")

    every = every_box(inp)
    got_every = dense_cuda.launch_inputs(every)
    if not (torch.equal(got_every[0], got[0])
            and torch.equal(got_every[1], got[1])):
        raise AssertionError(f"K7 ({name}): the big-list bbox filter "
                             "changes the result")

    def call(inp=inp):
        return dense_cuda.launch_inputs(inp)
    st = dict(err=float((got[0] - want[0]).abs().max()),
              ms=cuda_ms(call, KERNEL_REPS),
              **{f"{part}_ms": kernel_ms(call, KERNEL_REPS, symbol)
                 for part, symbol in (("walk", "fill_dense_kernel"),
                                      ("check", "nan_check_kernel"),
                                      ("exact", "fill_dense_exact_kernel"))},
              plain_ms=cuda_ms(lambda: dense_cuda.fill_dense_plain(plain),
                               1),
              bound=dense_bound_ms(setup, inp),
              bound_all_px=dense_bound_ms(setup, inp, True)[0],
              census=raster_cuda.pairs_census(
                  *dense_cuda.walked_pairs_by_tile(inp), inp.tri_rec, cfg),
              every_box_ms=cuda_ms(lambda: call(every), KERNEL_REPS),
              every_box_walk_ms=kernel_ms(lambda: call(every), KERNEL_REPS,
                                          "fill_dense_kernel"),
              every_box_regions_walked=len(
                  dense_cuda.walked_pairs_by_tile(every)[0])
              * raster_cuda.REGIONS,
              exact_units=low)
    phase("K7 vs plain", input=json.dumps(name), K=cfg.max_tris_per_tile,
          B=cfg.max_big_tris, binned_pairs=int(count.sum()),
          max_tile_pairs=int(count.max()), big_tris=int((big >= 0).sum()),
          init_planes=init_z is not None, emit_base=base,
          won_px=int((got[1] >= base).sum()), ids="equal",
          depth="bit-equal", exact_units=low,
          census=json.dumps(st['census']), ms=f"{st['ms']:.4f}",
          walk_ms=f"{st['walk_ms']:.4f}", check_ms=f"{st['check_ms']:.4f}",
          exact_ms=f"{st['exact_ms']:.4f}",
          every_box_ms=f"{st['every_box_ms']:.4f}",
          every_box_walk_ms=f"{st['every_box_walk_ms']:.4f}",
          every_box_regions_walked=st['every_box_regions_walked'],
          plain_ms=f"{st['plain_ms']:.1f}",
          plain_first_wall_s=f"{plain_wall:.1f}",
          bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1],
          bound_all_px_ms=f"{st['bound_all_px']:.4f}")
    return st


@contextlib.contextmanager
def recorded(modules, attr="launch"):
    """While open, each call of each module's function `attr` (its
    kernel launch by default) also appends (its positional arguments,
    its keyword arguments, its result) to that module's list in the
    yielded dict; the functions run as they do in any frame."""
    seen = {m: [] for m in modules}
    originals = {m: getattr(m, attr) for m in modules}

    def recording(m):
        def call(*args, **kwargs):
            out = originals[m](*args, **kwargs)
            seen[m].append((args, kwargs, out))
            return out
        return call
    try:
        for m in modules:
            setattr(m, attr, recording(m))
        yield seen
    finally:
        for m, f in originals.items():
            setattr(m, attr, f)


def launch_inputs(render, scene, pairs, fi_np, carry, kw, modules):
    """The arguments of each kernel launch of one frame, in launch order:
    one list of argument tuples per wrapper module.  Returns (those
    lists, the frame's result)."""
    import torch
    with recorded(modules) as seen:
        out = render(scene, *pairs, fi_np, carry, **kw)
        torch.cuda.synchronize()
    return [[a for a, _, _ in seen[m]] for m in modules], out


def drops_of(aux) -> tuple[int, int]:
    """(raster_dropped, raster_mask_dropped): the sums of the frame's
    drop counters, as bench.py:333-335 sums the keys ending in
    'dropped' -- the opaque set's (reference keys, with the blend set's
    raster_trans_* when it is drawn) and, apart, the masked set's (the
    port's raster_mask_* keys; 0 when no masked set is drawn)."""
    opaque = sum(int(v) for k, v in aux.items() if k.endswith('dropped')
                 and not k.startswith('raster_mask_'))
    return opaque, int(aux.get('raster_mask_dropped', 0))


def reset_launch_counts():
    """Set every kernel wrapper's launch count to 0."""
    from toyrenderer_tpu_torch.ops import (
        bvh_cuda, dense_cuda, peel_cuda, raster_cuda, warp_cuda)
    for m in (raster_cuda, peel_cuda, warp_cuda, dense_cuda):
        m.launches = 0
    bvh_cuda.reset_launches()


def launch_counts() -> list[int]:
    """The launch counts K1 K2 K3 K4 K3-SAH K5 K3-seeded K6 K7 since the
    last reset."""
    from toyrenderer_tpu_torch.ops import (
        bvh_cuda, dense_cuda, peel_cuda, raster_cuda, warp_cuda)
    by = bvh_cuda.launches_by_kernel
    return [raster_cuda.launches, peel_cuda.launches, by['K3'],
            warp_cuda.launches, by['K3-SAH'], by['K5'], by['K3-seeded'],
            by['K6'], dense_cuda.launches]


def drive(render, scene, pairs, fi_np, carry, mask_kw, frames, per_frame):
    """One warm-up frame, then `frames` timed ones with the carry
    threaded; fi_np is a frame's inputs or a callable giving the next
    frame's.  Every kernel's launch count is set to 0 after the warm-up.
    Returns (device ms, host ms, last image, last aux, carry,
    per_frame(aux, carry) of each timed frame)."""
    import torch
    inputs = fi_np if callable(fi_np) else (lambda: fi_np)
    img, carry, aux = render(scene, *pairs, inputs(), carry, **mask_kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    times, walls, rows = [], [], []
    for _ in range(frames):
        fi = inputs()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        img, carry, aux = render(scene, *pairs, fi, carry, **mask_kw)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        times.append(start.elapsed_time(end))
        rows.append(per_frame(aux, carry))
    return times, walls, img, aux, carry, rows


def check_frame(img, aux, k1, k2, want_k1, want_k2, name):
    import torch
    if (k1, k2) != (want_k1, want_k2):
        raise AssertionError(f"{name}: K1 launched {k1}, K2 {k2} times in "
                             f"{FRAMES} frames; want {want_k1}, {want_k2}")
    if img.shape != (HEIGHT, WIDTH, 3) or img.dtype != torch.uint8:
        raise AssertionError(f"{name}: image {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(aux['hdr']).all()):
        raise AssertionError(f"{name}: non-finite HDR values")
    dropped = drops_of(aux)
    if dropped != (0, 0):
        raise AssertionError(f"{name}: raster_dropped, raster_mask_dropped"
                             f" = {dropped}")
    coverage = float((aux['tri_id'] >= 0).float().mean())
    if coverage < 0.5:
        raise AssertionError(f"{name}: coverage {coverage}")
    return coverage


def profile_frame(render, scene, pairs, fi_np, carry, mask_kw):
    """One frame under the profiler: device busy ms (each device kernel
    once), (op, ms, calls) by the PyTorch op that launched them (the
    hand-written kernels, launched through ctypes, by their own names),
    and the frame's result (busy 0.0: not measured, every trace came
    back empty)."""
    from torch.autograd import DeviceType
    out, events, busy = profiled(
        lambda: render(scene, *pairs, fi_np, carry, **mask_kw))
    mine = tuple(sym for sym, _ in KERNEL_SYMBOLS)

    def name(key):
        return next((m for m in mine if m in key), key)
    by_op = [(name(e.key), round(e.self_device_time_total / 1e3, 3),
              e.count) for e in events if e.self_device_time_total > 0
             and not is_range(e.key) and (
                 e.device_type == DeviceType.CPU
                 or any(m in e.key for m in mine))]
    by_op.sort(key=lambda r: -r[1])
    return busy, by_op, out


def card_vs_cpu(host, scene, settings, pairs_np, frames, cfg_kw,
                yaw=0.0, kw_on=lambda dev: {}, min_share=0.999,
                volume=None):
    """The same frames on the card (kernels) and on the CPU (plain
    versions), the camera turning `yaw` a frame: u8 images within 1 on
    >= min_share of the pixels (default 99.9%: the two devices' 4x4
    products may round apart by an ulp, so a few edge pixels may change
    triangle), no drops.  cfg_kw: the frame's raster_cfg /
    mask_raster_cfg; kw_on(device): further render keywords on that
    device; volume: the DDGI probe grid of the carry.  Returns (share
    within 1, max difference)."""
    import numpy as np
    import torch
    from toyrenderer_tpu_torch.engine import (
        View, default_frame_inputs, init_carry, make_render_fn)
    w, h = settings.width, settings.height
    imgs, drops = [], []
    for sc in (scene, host.to_device("cpu")):
        d = sc.device
        p = [torch.from_numpy(a).to(d) for a in pairs_np]
        render = make_render_fn(settings, d, **cfg_kw)
        carry = init_carry(sc, settings, volume)
        view = View.from_scene(host, w, h)
        out = []
        for _ in range(frames):
            mats = view.matrices()
            img, carry, aux = render(
                sc, p[0], p[1], default_frame_inputs(host, mats), carry,
                mask_pair_inst=p[2], mask_pair_meshlet=p[3], **kw_on(d))
            view.advance(mats)
            view.rotate_yaw_pitch(yaw, 0.0)
            out.append(img.cpu().numpy().astype(int))
            drops.append(drops_of(aux))
        imgs.append(np.stack(out))
    diff = np.abs(imgs[0] - imgs[1]).max(-1)
    close = float((diff <= 1).mean())
    if close < min_share or any(x != (0, 0) for x in drops):
        raise AssertionError(f"{w}x{h} frames: card vs CPU within 1 on "
                             f"{close:.5f} of pixels, drops {drops}")
    return close, int(diff.max())


def traverse_bound_ms(census, alive, node_floats=48,
                      grouped=False, seed_bytes=0) -> tuple[float, str]:
    """Least time the card could take for these rays: operations, every
    slab test of the internal nodes and every triangle test of the
    leaves the rays visit (the plain version's census of this run's
    walk); bytes, the distinct tree rows read once (node rows of
    `node_floats` floats: 48 on the complete tree, 64 on the SAH tree),
    each slot's SLOT_BYTES, and the origin and direction of each live
    slot (`alive` (N,) bool) read once -- with `grouped` directions, the
    direction of each group of 128 that holds a live slot; `seed_bytes`:
    a seeded launch's seed table."""
    from toyrenderer_tpu_torch.ops.bvh_cuda import GROUP
    leaf = int(census['leaf_steps'].sum())
    inner = int(census['steps'].sum()) - leaf
    ops = inner * 8 * OPS_PER_SLAB + leaf * 12 * OPS_PER_TRI_TEST
    n_live = int(alive.sum())
    n_dirs = (int(alive.reshape(-1, GROUP).any(1).sum()) if grouped
              else n_live)
    bytes_ = (int(census['box_rows_read'].sum()) * node_floats * 4
              + int(census['leaf_rows_read'].sum()) * 120 * 4
              + alive.numel() * SLOT_BYTES + (n_live + n_dirs) * VEC3_BYTES
              + seed_bytes)
    return bound(ops, bytes_)


def hold_trace(label, args) -> dict:
    """One recorded launch of the traversal (K3, K3-SAH or K5) against
    the plain version in its own mode: hit, t, tri and the visit counts
    bit-equal; for K5 also against the kernel on the expanded directions
    (K3 / K3-SAH on the same rays).
    Prints a phase line; returns its err, ms (the profiler's device time
    per launch), events ms, plain ms, bound, Mrays/s over live rays and
    the visit census."""
    import torch
    from toyrenderer_tpu_torch.ops import bvh_cuda
    from toyrenderer_tpu_torch.ops.bvh_sah import BvhSah
    bvh, o, d, t_max, any_hit, live, gd = args[:7]
    seeded = (dict(seeds=args[7], packet=args[8])
              if len(args) > 7 and args[7] is not None else {})
    # every slot is live where the caller gave no live mask (ReSTIR)
    live_f = (torch.ones(o.shape[0], device=o.device) if live is None
              else live)
    mode = "any-hit" if any_hit else "closest-hit"
    schedule = {}
    got = bvh_cuda.launch(*args, schedule=schedule)
    schedule['fetched'] = int(schedule['fetched'])
    t = time.time()
    want = bvh_cuda.traverse_plain(bvh, o, d, t_max, any_hit, live,
                                   census=True, group_dirs=gd, **seeded)
    torch.cuda.synchronize()
    plain_wall = time.time() - t
    checks = [("plain", want)]
    if gd is not None:
        expanded = bvh_cuda.expand_group_dirs(gd, o.shape[0]).contiguous()
        checks.append(("per-ray kernel", bvh_cuda.launch(
            bvh, o, expanded, t_max, any_hit, live)))
    for what, ref in checks:
        for k in ('hit', 't', 'tri', 'steps'):
            if not torch.equal(got[k], ref[k]):
                raise AssertionError(
                    f"{label} {mode} vs {what}: {k} differs on "
                    f"{int((got[k] != ref[k]).sum())} rays")
    # the kernel's dead slots: live <= 0 or t_max <= 0
    alive = (live_f > 0) & (torch.as_tensor(t_max, device=o.device) > 0)
    n_live = int(alive.sum())
    steps = want['steps'][alive].float()
    st = dict(err=float((got['t'] - want['t']).abs().max()),
              ms=kernel_ms(lambda: bvh_cuda.launch(*args), KERNEL_REPS,
                           "traverse_kernel"),
              events_ms=cuda_ms(lambda: bvh_cuda.launch(*args), KERNEL_REPS),
              plain_ms=cuda_ms(lambda: bvh_cuda.traverse_plain(
                  bvh, o, d, t_max, any_hit, live, group_dirs=gd,
                  **seeded), 1),
              bound=traverse_bound_ms(
                  want, alive, 64 if isinstance(bvh, BvhSah) else 48,
                  gd is not None,
                  4 * seeded['seeds'].numel() if seeded else 0),
              visits_mean=float(steps.mean()), visits_max=int(steps.max()),
              ray_slots=o.shape[0], live_rays=n_live,
              live_share=n_live / o.shape[0],
              warps_launched=schedule['warps'],
              slots_fetched=schedule['fetched'])
    st['mrays_s'] = n_live / st['ms'] / 1e3
    phase(label + " vs plain", mode=mode, ray_slots=o.shape[0],
          live_rays=n_live, live_share=f"{st['live_share']:.4f}",
          warps_launched=schedule['warps'],
          slots_fetched=schedule['fetched'],
          stack_entries=bvh_cuda.stack_entries(bvh),
          group_dirs=0 if gd is None else gd.shape[0],
          seeded_packets=(f"{int((seeded['seeds'] >= 0).sum())}"
                          f"/{seeded['seeds'].numel()}" if seeded else 0),
          hit_share=f"{float(got['hit'][alive].float().mean()):.4f}",
          visits_mean=f"{st['visits_mean']:.1f}",
          visits_max=st['visits_max'],
          leaf_visits=int(want['leaf_steps'].sum()),
          rows_read=f"{int(want['box_rows_read'].sum())}"
          f"+{int(want['leaf_rows_read'].sum())}",
          hit_t_tri_visits="bit-equal to " + " and ".join(
              w for w, _ in checks),
          kernel_ms=f"{st['ms']:.4f}",
          kernel_events_ms=f"{st['events_ms']:.4f}",
          mrays_per_s=f"{st['mrays_s']:.1f}",
          plain_ms=f"{st['plain_ms']:.1f}",
          plain_first_wall_s=f"{plain_wall:.1f}",
          bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1])
    return st


def pair_bound_ms(args) -> tuple[float, str]:
    """Least time the card could take for one pair fold (K6) on these
    inputs: operations, every (walked pair, live ray of its block,
    triangle) test; bytes, the used coefficients of each distinct chunk
    walked (PAIR_USED_ROWS rows of 96 triangles f32), the walked
    pair-list entries, each block's start and count, and every ray slot
    read and its result written once."""
    import torch
    from toyrenderer_tpu_torch.ops import rt_pairs
    rays, feat, pchk, starts, n_walk = args
    n_walk = n_walk.long()
    live = (rays[..., 7] > 0).sum(1)
    ops = (int((n_walk * live).sum()) * rt_pairs.CHUNK_TRIS
           * OPS_PER_PAIR_TEST)
    total = int(n_walk.sum())
    blk = torch.repeat_interleave(torch.arange(rays.shape[0],
                                               device=rays.device), n_walk)
    rank = torch.arange(total, device=rays.device) - (
        torch.cumsum(n_walk, 0) - n_walk)[blk]
    chunks = torch.unique(pchk[starts.long()[blk] + rank]).numel()
    bytes_ = (chunks * PAIR_USED_ROWS * rt_pairs.CHUNK_TRIS * 4 + total * 4
              + rays.shape[0] * 8 + rays.shape[0] * rays.shape[1]
              * PAIR_SLOT_BYTES)
    return bound(ops, bytes_)


def hold_k6(label, args) -> dict:
    """One recorded launch of the pair fold (K6) against pair_fold_plain
    on its arguments: best t and ordinal bit-equal.  Prints a phase line;
    returns its err, ms (the profiler's device time per launch), events
    ms, plain ms and bound."""
    import torch
    from toyrenderer_tpu_torch.ops import pairs_cuda, rt_pairs
    got = pairs_cuda.launch(*args)
    t = time.time()
    want = rt_pairs.pair_fold_plain(*args)
    torch.cuda.synchronize()
    plain_wall = time.time() - t
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"K6 ({label}): output {k} differs on "
                                 f"{int((a != b).sum())} rays")
    rays, _, pchk, starts, n_walk = args
    census = pairs_cuda.census(rays, starts, n_walk, pchk.shape[0])
    st = dict(err=float((got[0] - want[0]).abs().nan_to_num(0.0).max()),
              census=census,
              ms=kernel_ms(lambda: pairs_cuda.launch(*args), KERNEL_REPS,
                           "pairs_kernel"),
              events_ms=cuda_ms(lambda: pairs_cuda.launch(*args),
                                KERNEL_REPS),
              plain_ms=cuda_ms(lambda: rt_pairs.pair_fold_plain(*args), 1),
              bound=pair_bound_ms(args))
    phase("K6 vs plain", input=json.dumps(label),
          blocks=args[0].shape[0], pairs_walked=int(args[4].sum()),
          census=json.dumps(census),
          rays_with_hit=int(torch.isfinite(got[0]).sum()),
          t_ordinal="bit-equal", kernel_ms=f"{st['ms']:.4f}",
          kernel_events_ms=f"{st['events_ms']:.4f}",
          plain_ms=f"{st['plain_ms']:.1f}",
          plain_first_wall_s=f"{plain_wall:.1f}",
          bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1])
    return st


def hold_pair_route(label, call, k6) -> dict:
    """One recorded call of the pair route (rt_pairs.traverse_pairs)
    against K3-SAH on the same rays.  The live rays of overflowed blocks
    come from K3-SAH in the route's own mode: bit-equal to it.  The
    other live rays come from the fold, which is closest-hit in either
    mode: against K3-SAH closest-hit, hit equal on >= 99.9% of them, t
    within rtol and atol 2e-4 and tri equal on >= 98% where both hit (the
    gates of tests/test_rt_pairs.py:36-51: t_num is a difference of
    products of world coordinates, so a short t carries an absolute
    rounding error).  Times the whole route (box phase,
    sort, fold, fallback) beside K3-SAH in the route's own mode, and the
    pair tables' build.  Prints a phase line; returns the census."""
    import torch
    from toyrenderer_tpu_torch.ops import bvh_cuda, rt_pairs
    (bvh, o, d, t_max), kw, res = call
    any_hit, live, tables = kw['any_hit'], kw['live'], kw['tables']
    st = {}
    before = dict(bvh_cuda.launches_by_kernel)
    again = rt_pairs.traverse_pairs(bvh, o, d, t_max, any_hit=any_hit,
                                    live=live, tables=tables, stats=st)
    fallback_launches = (bvh_cuda.launches_by_kernel['K3-SAH']
                         - before['K3-SAH'])
    for k in ('hit', 't', 'tri', 'steps'):
        if not torch.equal(again[k], res[k]):
            raise AssertionError(f"pair route ({label}): {k} changed "
                                 "between two calls")
    counts, n_walk, over = st['counts'], st['n_walk'], st['overflow']
    ref = bvh_cuda.launch(bvh, o, d, t_max, False, live)
    own = bvh_cuda.launch(bvh, o, d, t_max, True, live) if any_hit else ref
    alive = live > 0
    n_live = int(alive.sum())
    fb = over.repeat_interleave(rt_pairs.BLOCK)[:o.shape[0]] & alive
    for k in ('hit', 't', 'tri'):
        if not torch.equal(res[k][fb], own[k][fb]):
            raise AssertionError(f"pair route ({label}): the overflowed "
                                 f"blocks' {k} differs from K3-SAH")
    fold = alive & ~fb
    hit_agree = float((res['hit'] == ref['hit'])[fold].float().mean())
    both = res['hit'] & ref['hit'] & fold
    dt = (res['t'][both] - ref['t'][both]).abs()
    t_ok = bool(torch.isclose(res['t'][both], ref['t'][both], rtol=2e-4,
                              atol=2e-4).all())
    tri_agree = float((res['tri'] == ref['tri'])[both].float().mean())
    if hit_agree < 0.999 or not t_ok or tri_agree < 0.98:
        raise AssertionError(
            f"pair route ({label}) vs K3-SAH: hit on {hit_agree:.5f} of "
            f"the fold's live rays, t within 2e-4 {t_ok}, tri on "
            f"{tri_agree:.4f}")
    walked = n_walk[n_walk > 0].float()
    out = dict(
        ray_slots=o.shape[0], live_rays=n_live, blocks=counts.numel(),
        empty_blocks=int((counts == 0).sum()), pcap=st['pcap'],
        pairs=int(counts.sum()), pairs_walked=int(n_walk.sum()),
        walked_mean=float(walked.mean()) if walked.numel() else 0.0,
        walked_max=int(n_walk.max()), overflow_blocks=int(over.sum()),
        fold_rays=int(fold.sum()), fallback_rays=int(fb.sum()),
        fallback_launches=fallback_launches, hit_agree=hit_agree,
        tri_agree=tri_agree,
        route_ms=device_ms(lambda: rt_pairs.traverse_pairs(
            bvh, o, d, t_max, any_hit=any_hit, live=live, tables=tables), 3),
        sah_ms=kernel_ms(lambda: bvh_cuda.launch(bvh, o, d, t_max, any_hit,
                                                 live), KERNEL_REPS,
                         "traverse_kernel"),
        tables_ms=device_ms(lambda: rt_pairs.mt_tables(bvh), 3))
    phase("pair route vs K3-SAH", input=json.dumps(label),
          mode="any-hit" if any_hit else "closest-hit",
          ray_slots=out['ray_slots'], live_rays=n_live,
          blocks=out['blocks'], blocks_without_pairs=out['empty_blocks'],
          pair_capacity=out['pcap'], pairs=out['pairs'],
          pairs_walked=out['pairs_walked'],
          pairs_per_walking_block_mean=f"{out['walked_mean']:.1f}",
          pairs_per_block_max=out['walked_max'],
          overflowed_blocks=out['overflow_blocks'],
          fallback_k3sah_launches=fallback_launches,
          fold_live_rays=out['fold_rays'],
          fallback_live_rays=f"{out['fallback_rays']} (bit-equal to K3-SAH)",
          hit_equal_share=f"{hit_agree:.6f}", t_within_2e4="held",
          t_max_abs_diff=f"{float(dt.max()) if dt.numel() else 0.0:.3g}",
          t_max_rel_diff=(f"{float((dt / ref['t'][both]).max()):.3g}"
                          if dt.numel() else "0"),
          tri_equal_share=f"{tri_agree:.5f}",
          k6_ms=f"{k6['ms']:.4f}",
          k6_mrays_per_s=f"{n_live / k6['ms'] / 1e3:.1f}",
          k6_bound_ms=f"{k6['bound'][0]:.4f}", k6_bound_by=k6['bound'][1],
          route_device_ms=f"{out['route_ms']:.4f}",
          k3sah_same_rays_ms=f"{out['sah_ms']:.4f}",
          mt_tables_ms=f"{out['tables_ms']:.4f}")
    return out


def hold_k4(name, args) -> dict:
    """K4 against its plain version on one recorded launch: bit-equal.
    Also times torch.nn.functional.grid_sample (bilinear, border
    padding, align_corners) on the same clamped sample points as a
    yardstick; the port never calls it."""
    import torch
    from toyrenderer_tpu_torch.ops import warp_cuda
    img, mot, max_disp = args
    got = warp_cuda.launch(*args)
    want = warp_cuda.warp_bilinear_plain(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"K4 ({name}): max |d| "
                             f"{float((got - want).abs().max())}")
    h, w, c = img.shape
    lim = warp_cuda._reach(max_disp)
    yg = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xg = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    y = yg + torch.clamp(torch.clamp(yg - mot[..., 1], 0.0, h - 1.0) - yg,
                         -lim, lim)
    x = xg + torch.clamp(torch.clamp(xg - mot[..., 0], 0.0, w - 1.0) - xg,
                         -lim, lim)
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1],
                       -1)[None].contiguous()
    planar = img.permute(2, 0, 1)[None].contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            planar, grid, mode='bilinear', padding_mode='border',
            align_corners=True)
    lib_err = float((library()[0].permute(1, 2, 0) - got).abs().max())
    st = dict(err=float((got - want).abs().max()),
              ms=kernel_ms(lambda: warp_cuda.launch(*args), KERNEL_REPS,
                           "warp_kernel"),
              events_ms=cuda_ms(lambda: warp_cuda.launch(*args),
                                KERNEL_REPS),
              plain_ms=cuda_ms(lambda: warp_cuda.warp_bilinear_plain(*args),
                               KERNEL_REPS),
              library_ms=device_ms(library, KERNEL_REPS),
              bound=bound(h * w * (6 * c + 30),
                          h * w * (2 * c * 4 + 8)))
    phase("K4 vs plain", input=json.dumps(name), shape=f"{h}x{w}x{c}",
          motion_max_px=f"{float(mot.abs().max()):.2f}", out="bit-equal",
          kernel_ms=f"{st['ms']:.4f}",
          kernel_events_ms=f"{st['events_ms']:.4f}",
          plain_ms=f"{st['plain_ms']:.4f}",
          grid_sample_ms=f"{st['library_ms']:.4f}",
          grid_sample_max_abs_diff=f"{lib_err:.3g}",
          bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1])
    return st


def rt_static_on(rts, dev):
    """The static RT topology's tensors moved to `dev`."""
    import torch
    return dataclasses.replace(rts, **{
        f.name: getattr(rts, f.name).to(dev)
        for f in dataclasses.fields(rts)
        if isinstance(getattr(rts, f.name), torch.Tensor)})


def table_invariant(mgr) -> bool:
    """The tile manager's table: each entry a resident slot inside the
    pool, or a fallback with a mip delta > 0 (the reference package's
    tests/test_streaming.py:218-223)."""
    import numpy as np
    res = mgr.table_slot >= 0
    ent = mgr.table
    ok_res = bool(np.all((ent[res] == mgr.table_slot[res])
                         & (ent[res] >= mgr.slot0)
                         & (ent[res] < mgr.slot0 + mgr.pool_tiles)))
    return ok_res and bool(np.all((ent[~res] >> 24) > 0))


def streamed_card_vs_cpu(host, scene, settings, pairs_np, mask_np, mgr,
                         fb_key, view, frames, cfg_kw):
    """The streamed frames on the card and on the CPU (the plain
    versions) on the overrides of one CPU-side manager, which the CPU
    frame's feedback drives (the card's read against it): u8 images
    within 1 on >= 99.9% of the pixels, no drops.  Returns (share within
    1, max difference, feedback entries finite on both, on one only,
    the largest difference where both are finite)."""
    import numpy as np
    import torch
    from toyrenderer_tpu_torch.engine import (
        default_frame_inputs, init_carry, make_render_fn)
    cpu = torch.device("cpu")
    n_fb = (mgr.table_size if fb_key == 'vt_tile_feedback'
            else host.num_textures)
    ov = mgr.update(np.full(n_fb, np.inf))
    runs = []
    for sc in (scene, host.to_device(cpu)):
        d = sc.device
        runs.append(dict(
            scene=sc, render=make_render_fn(settings, d, **cfg_kw),
            carry=init_carry(sc, settings),
            pairs=[torch.from_numpy(a).to(d) for a in pairs_np],
            mask={k: torch.from_numpy(a).to(d)
                  for k, a in mask_np.items()}))
    imgs = [[], []]
    both = one = 0
    fb_diff = 0.0
    drops = []
    for _ in range(frames):
        mats = view.matrices()
        fbs = []
        for i, r in enumerate(runs):
            d = r['scene'].device
            fi = dict(default_frame_inputs(host, mats),
                      **{k: v.to(d) for k, v in ov.items()})
            img, r['carry'], aux = r['render'](
                r['scene'], *r['pairs'], fi, r['carry'], **r['mask'])
            imgs[i].append(img.cpu().numpy().astype(int))
            fbs.append(aux[fb_key].cpu().numpy())
            drops.append(drops_of(aux) if r['mask'] else (sum(
                int(v) for k, v in aux.items() if k.endswith('dropped')), 0))
        view.advance(mats)
        fin = [np.isfinite(f) for f in fbs]
        both += int((fin[0] & fin[1]).sum())
        one += int((fin[0] != fin[1]).sum())
        if (fin[0] & fin[1]).any():
            fb_diff = max(fb_diff, float(np.abs(
                fbs[0][fin[0] & fin[1]] - fbs[1][fin[0] & fin[1]]).max()))
        ov = mgr.update(fbs[1])
    diff = np.abs(np.stack(imgs[0]) - np.stack(imgs[1])).max(-1)
    close = float((diff <= 1).mean())
    if close < 0.999 or any(x != (0, 0) for x in drops):
        raise AssertionError(f"streamed {settings.width}x{settings.height} "
                             f"frames: card vs CPU within 1 on {close:.5f} "
                             f"of pixels, drops {drops}")
    return close, int(diff.max()), both, one, fb_diff


def slice7(dev, host, scene, cpairs, mpairs, cap1, k2):
    """Slice 7's phases: the plaza's streamed culled frame at 1080p (its
    build, capacities, K1 / K2 against their plain versions on its
    launches, 1 + PLAZA_FRAMES frames with the tile manager, a profile,
    the full-residency frame) and streamed 384x216 frames on the card
    against the CPU.  host / scene: the courtyard; cpairs: its culled
    early list, mpairs its masked pairs (numpy); cap1 the early list's
    capacity; k2: the K2 inputs' numbers, which gains the plaza's.
    Returns (the plaza's K1 numbers by input, its K1 and K2 launches in
    the timed frames)."""
    import numpy as np
    import torch

    from toyrenderer_tpu_torch._build import BUILD_DIR
    from toyrenderer_tpu_torch.engine import (
        RenderSettings, View, default_frame_inputs, init_carry,
        make_render_fn, streaming)
    from toyrenderer_tpu_torch.engine.capacity import (
        culled_pair_counts, sized_culled_settings, sized_raster_config)
    from toyrenderer_tpu_torch.ops import geometry as geo_mod
    from toyrenderer_tpu_torch.ops import peel_cuda, raster_cuda
    from toyrenderer_tpu_torch.scene import load_scene
    from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy
    cpi, cpm = cpairs
    mk_i, mk_m = mpairs
    mask_inst, mask_meshlet = (torch.from_numpy(a).to(dev) for a in mpairs)

    # 26. the plaza (3x3 courtyards) built with the port's loader, and the
    #     reference bench's plaza chain (bench.py:253-296, 683-721): the
    #     culled deferred frame at 1920x1080 with tile streaming on, a
    #     pool of 96 tiles, every frame's vt_tile_feedback fed to the
    #     manager before the next frame
    t = time.time()
    p_host = load_scene(PLAZA, use_cache=False)
    p_build_s = time.time() - t
    p_scene = p_host.to_device()
    p_mk = geo_mod.static_meshlet_pairs(p_host, 'mask')
    p_pi, p_pm = geo_mod.static_meshlet_pairs(p_host, 'not_mask')
    p_tris = int(p_host.meshlet_tri_count[p_pm].sum()
                 + p_host.meshlet_tri_count[p_mk[1]].sum())
    p_cap = max(int(len(p_pi) * OPAQUE_PAIR_FRAC), 256)
    p_pairs = tuple(torch.from_numpy(a).to(dev)
                    for a in (p_pi[:p_cap], p_pm[:p_cap]))
    p_mask = tuple(torch.from_numpy(a).to(dev) for a in p_mk)
    p_mask_kw = dict(mask_pair_inst=p_mask[0], mask_pair_meshlet=p_mask[1])
    t = time.time()
    mgr = streaming.TileStreamingManager(streaming.scene_atlas(p_host),
                                         pool_tiles=PLAZA_POOL)
    p_ov = mgr.update(np.full(mgr.table_size, np.inf))
    torch.cuda.synchronize()
    mgr_s = time.time() - t
    pinned = mgr.stats['resident_tiles']
    phase("plaza", seconds=f"{p_build_s:.2f}",
          instances=p_host.num_instances, lod0_triangles=p_tris,
          opaque_pairs=len(p_pi), early_list=p_cap,
          masked_pairs=len(p_mk[0]), textures=p_host.num_textures,
          tile_table=mgr.table_size, pool_tiles=mgr.pool_tiles,
          pinned_tiles=pinned, pool_rows=mgr.pool.shape[0],
          pool_mib=f"{mgr.pool.numel() * 4 / 2 ** 20:.1f}",
          manager_build_s=f"{mgr_s:.3f}",
          initial_upload_bytes=mgr.uploaded_bytes)

    # 27. capacity (plaza): the content-sized K, B and pair budget of the
    #     bench's view, beside the reference bench's probe of that view
    p_view = View.from_scene(p_host, WIDTH, HEIGHT)
    p_bench = RenderSettings(width=WIDTH, height=HEIGHT,
                             manual_exposure=0.25, enable_culling=True,
                             peel_merge_frac=0.10)
    p_counts = culled_pair_counts(
        p_scene, frame_inputs_from_numpy(default_frame_inputs(
            p_host, dataclasses.replace(p_view).matrices()), dev),
        p_bench, p_cap, p_mask)
    p_set = sized_culled_settings(p_bench, p_counts)
    p_kw = dict(raster_cfg=sized_raster_config(
        p_set, {"opaque": p_counts["opaque"]}),
        mask_raster_cfg=sized_raster_config(
            p_set, {"masked": p_counts["masked"]}))
    measured = (max(v['max_tile_pairs'] for v in p_counts.values()),
                max(v['big_tris'] + v['drop']['drop_big']
                    for v in p_counts.values()),
                p_counts['opaque']['pairs'])
    phase("capacity (plaza)", K=p_set.max_tris_per_tile,
          B=p_set.max_big_tris, pair_capacity=p_set.pair_capacity,
          pairs_wanted=p_counts['opaque']['pairs_wanted'],
          densest_tile_big_pairs=json.dumps(measured),
          reference_densest_tile_big_pairs=json.dumps(REF_PLAZA_MEASURED),
          max_tile_pairs=json.dumps(
              {k: v['max_tile_pairs'] for k, v in p_counts.items()}),
          default_cap_drops=json.dumps(
              {k: v['drop'] for k, v in p_counts.items()}))

    # 28. K1 and K2 against their plain versions on the inputs of each
    #     of a streamed plaza frame's launches (its early and late K1,
    #     its masked set's K2 with the opaque depth as occluder), the
    #     frame culling against the HZB of the frame before it
    p_render = make_render_fn(p_set, **p_kw)
    p_fi = dict(default_frame_inputs(
        p_host, dataclasses.replace(p_view).matrices()), **p_ov)
    _, warm_carry, _ = p_render(p_scene, *p_pairs, p_fi,
                                init_carry(p_scene, p_set), **p_mask_kw)
    (k1_in, k2_in), _ = launch_inputs(p_render, p_scene, p_pairs, p_fi,
                                      warm_carry, p_mask_kw,
                                      (raster_cuda, peel_cuda))
    k1_in, k2_in = [a[0] for a in k1_in], [a[0] for a in k2_in]
    if (len(k1_in), len(k2_in)) != (2, 1):
        raise AssertionError(f"plaza frame: {len(k1_in)} K1 and "
                             f"{len(k2_in)} K2 launches; want 2 and 1")
    plaza_k1 = {n: hold_k1(n, inp)
                for n, inp in zip(("plaza early", "plaza late"), k1_in)}
    del k1_in, warm_carry
    z_k, id_k = peel_cuda.launch(k2_in[0])
    z_p, id_p = peel_cuda.fill_peel_plain(dataclasses.replace(
        k2_in[0], cfg=dataclasses.replace(k2_in[0].cfg, tile_batch=256)))
    if not (torch.equal(id_k, id_p) and torch.equal(z_k, z_p)):
        raise AssertionError("K2 (plaza masked set): ids or depth differ "
                             "from the plain version")
    k2["plaza masked set"] = hold_k2_times(k2_in[0], dataclasses.replace(
        k2_in[0], cfg=dataclasses.replace(k2_in[0].cfg, tile_batch=256)))
    k2["plaza masked set"]['err'] = float((z_k - z_p).abs().max())
    phase("K2 vs plain", input=json.dumps("plaza masked set"),
          layers=k2_in[0].layers,
          fragments_per_layer=json.dumps(
              [int((id_k[i] >= 0).sum()) for i in range(k2_in[0].layers)]),
          ids="equal", depth="bit-equal",
          **k2_fields(k2["plaza masked set"]))
    del k2_in, z_k, id_k, z_p, id_p

    # 29. the streamed plaza frame at 1920x1080: one warm-up frame and
    #     PLAZA_FRAMES timed ones over the pan, each frame's tile feedback
    #     read back and fed to the manager before the next frame (its
    #     host ms apart from the frame's events); gates on every frame
    p_view = View.from_scene(p_host, WIDTH, HEIGHT)
    p_carry = init_carry(p_scene, p_set)
    p_rows, p_times, p_updates = [], [], []
    p_k1 = p_k2 = 0
    for i in range(1 + PLAZA_FRAMES):
        mats = p_view.matrices()
        fi = dict(default_frame_inputs(p_host, mats), **p_ov)
        carry_in = p_carry
        reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p_img, p_carry, p_aux = p_render(p_scene, *p_pairs, fi, p_carry,
                                         **p_mask_kw)
        end.record()
        torch.cuda.synchronize()
        launches = (raster_cuda.launches, peel_cuda.launches)
        p_view.advance(mats)
        p_view.rotate_yaw_pitch(SHADOW_YAW, 0.0)
        t = time.perf_counter()
        p_ov = mgr.update(p_aux['vt_tile_feedback'])
        torch.cuda.synchronize()
        upd_ms = (time.perf_counter() - t) * 1e3
        coverage = float((p_aux['tri_id'] >= 0).float().mean())
        dropped = drops_of(p_aux)
        row = dict(frame=i, ms=round(start.elapsed_time(end), 3),
                   k1=launches[0], k2=launches[1], coverage=round(
                       coverage, 4), dropped=dropped,
                   update_ms=round(upd_ms, 3),
                   uploaded_bytes=mgr.last_upload_bytes,
                   hot_tiles=int(torch.isfinite(
                       p_aux['vt_tile_feedback']).sum()),
                   **mgr.stats)
        p_rows.append(row)
        if i > 0:
            p_times.append(row['ms'])
            p_updates.append(upd_ms)
            p_k1 += launches[0]
            p_k2 += launches[1]
        if dropped != (0, 0) or launches != (2, 1):
            raise AssertionError(f"plaza frame {i}: drops {dropped}, "
                                 f"K1 / K2 launches {launches}")
        if not (0.0 < coverage <= 1.0
                and bool(torch.isfinite(p_aux['hdr']).all())
                and p_img.shape == (HEIGHT, WIDTH, 3)):
            raise AssertionError(f"plaza frame {i}: coverage {coverage}, "
                                 f"image {tuple(p_img.shape)}")
        if not table_invariant(mgr) or not torch.equal(
                p_ov['tex_tile_table'].cpu(), torch.from_numpy(mgr.table)):
            raise AssertionError(f"plaza update {i}: a table entry is "
                                 "neither a resident slot nor a fallback")
        if p_ov['tex_texels'] is not mgr.pool:
            raise AssertionError("plaza: the manager handed a new pool")
        if i == 0 and mgr.stats['tile_loads'] <= pinned:
            raise AssertionError(f"plaza: the first feedback loaded no "
                                 f"tile ({mgr.stats})")
    np.save(BUILD_DIR / f"chip_smoke_plaza_{WIDTH}x{HEIGHT}.npy",
            p_img.cpu().numpy())
    phase("frame", path="plaza streamed", size=f"{WIDTH}x{HEIGHT}",
          frames=PLAZA_FRAMES, median_ms=f"{statistics.median(p_times):.3f}",
          all_ms=json.dumps(p_times),
          update_host_ms=json.dumps([round(x, 3) for x in p_updates]),
          median_update_host_ms=f"{statistics.median(p_updates):.3f}",
          launches_k1=p_k1, launches_k2=p_k2,
          rows=json.dumps(p_rows))
    busy, by_op, _ = profile_frame(p_render, p_scene, p_pairs, fi,
                                   carry_in, p_mask_kw)
    phase("profile", path="plaza streamed", device_busy_ms=f"{busy:.3f}",
          busy_share_of_median_frame=(
              f"{busy / statistics.median(p_times):.3f}" if busy
              else "not measured"),
          by_op_ms_calls=json.dumps(by_op[:16]))

    # 30. the last plaza frame again with full residency (the scene's
    #     analytic atlas, no overrides), from the same carry: printed,
    #     not gated
    full_fi = default_frame_inputs(p_host, mats)
    full_ms = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        f_img, _, f_aux = p_render(p_scene, *p_pairs, full_fi, carry_in,
                                   **p_mask_kw)
        end.record()
        torch.cuda.synchronize()
        full_ms.append(round(start.elapsed_time(end), 3))
    f_diff = (f_img.int() - p_img.int()).abs().amax(-1)
    phase("plaza full residency", frame=PLAZA_FRAMES, ms=json.dumps(full_ms),
          streamed_ms=p_times[-1],
          within_1=f"{float((f_diff <= 1).float().mean()):.6f}",
          mean_abs_diff=f"{float(f_diff.float().mean()):.4f}",
          max_diff=int(f_diff.max()), dropped=json.dumps(drops_of(f_aux)),
          has_tile_feedback='vt_tile_feedback' in f_aux)
    del p_img, f_img, p_aux, f_aux, p_carry, carry_in, p_ov, mgr, p_scene

    # 31. streamed frames on the card against the CPU at 384x216, on the
    #     overrides of one manager: the culled courtyard seen from near
    #     its floor (tile manager, 80 tiles), the culled textured stress
    #     scene (mip manager)
    near = View.from_scene(host, *SMALL)
    near.rotate_yaw_pitch(0.0, NEAR_FLOOR[0])
    near.move(up=NEAR_FLOOR[1])
    n_fi = frame_inputs_from_numpy(default_frame_inputs(
        host, dataclasses.replace(near).matrices()), dev)
    n_set = RenderSettings(width=SMALL[0], height=SMALL[1],
                           manual_exposure=0.25, enable_culling=True,
                           peel_merge_frac=0.10)
    n_counts = culled_pair_counts(scene, n_fi, n_set, cap1,
                                  (mask_inst, mask_meshlet))
    n_set = sized_culled_settings(n_set, n_counts)
    n_cfg = {f"{'mask_' if k == 'masked' else ''}raster_cfg":
             sized_raster_config(n_set, {k: v}) for k, v in n_counts.items()}
    close, max_diff, fb_both, fb_one, fb_diff = streamed_card_vs_cpu(
        host, scene, n_set, [cpi, cpm],
        dict(mask_pair_inst=mk_i, mask_pair_meshlet=mk_m),
        streaming.TileStreamingManager(streaming.scene_atlas(host),
                                       pool_tiles=80, device="cpu"),
        'vt_tile_feedback', near, 2, n_cfg)
    phase("streamed frames card vs cpu", scene="courtyard near the floor",
          manager="tile, 80", size=f"{SMALL[0]}x{SMALL[1]}", frames=2,
          within_1=f"{close:.6f}", max_diff=max_diff,
          feedback_finite_both=fb_both, feedback_finite_one=fb_one,
          feedback_max_diff=f"{fb_diff:.3g}")
    st_host = make_stress_scene(n_objects=64, sphere_res=16, textured=True)
    st_scene = st_host.to_device(dev)
    st_pairs = [np.asarray(a) for a in geo_mod.static_meshlet_pairs(
        st_host, 'all')]
    st_set = RenderSettings(width=SMALL[0], height=SMALL[1],
                            manual_exposure=0.1, enable_culling=True)
    st_counts = culled_pair_counts(st_scene, frame_inputs_from_numpy(
        default_frame_inputs(st_host, View.from_scene(
            st_host, *SMALL).matrices()), dev), st_set, len(st_pairs[0]))
    st_set = sized_culled_settings(st_set, st_counts)
    close, max_diff, fb_both, fb_one, fb_diff = streamed_card_vs_cpu(
        st_host, st_scene, st_set, st_pairs, {},
        streaming.TextureStreamingManager(streaming.scene_atlas(st_host),
                                          pool_texels=1 << 18,
                                          device="cpu"),
        'tex_feedback', View.from_scene(st_host, *SMALL), 2,
        dict(raster_cfg=sized_raster_config(st_set, st_counts)))
    phase("streamed frames card vs cpu", scene="stress (textured)",
          manager="mip, 262144 texels", size=f"{SMALL[0]}x{SMALL[1]}",
          frames=2, within_1=f"{close:.6f}", max_diff=max_diff,
          feedback_finite_both=fb_both, feedback_finite_one=fb_one,
          feedback_max_diff=f"{fb_diff:.3g}")

    return plaza_k1, p_k1, p_k2


def glass_scene():
    """The stress scene as the render CLI's --scene stress builds it, with
    the reference's glass (tests/test_e2e.py:265-300): the ground's
    material green glass at alpha 0.4, instance 1's red glass at 0.5."""
    from toyrenderer_tpu_torch.scene.gltf import ALPHA_BLEND
    from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
    s = make_stress_scene(n_objects=64, sphere_res=16, textured=True)
    for inst, colour in ((0, [0.1, 0.9, 0.1, 0.4]),
                         (1, [0.9, 0.1, 0.1, 0.5])):
        mat = int(s.prim_material[int(s.inst_prim[inst])])
        s.mat_alpha_mode[mat] = ALPHA_BLEND
        s.mat_base_color[mat] = colour
    return s


def write_animated_cornell(dst: Path) -> Path:
    """Cornell with one synthesized rotation channel (node 0, a half turn
    about z over 4 s), saved as the port's scene cache of a copy of
    cornell.gltf in `dst` (tests/test_animation.py:74-95 writes the
    reference's so); load_scene of the copy reads the channel."""
    import shutil

    import numpy as np

    from toyrenderer_tpu_torch.scene import scenebuild as sb
    from toyrenderer_tpu_torch.scene.animation import pack_animations
    from toyrenderer_tpu_torch.scene.gltf import GltfAnimationChannel
    dst.mkdir(parents=True, exist_ok=True)
    src = ROOT / "resources" / "cornell.gltf"
    copy = dst / "cornell_animated.gltf"
    shutil.copy(src, copy)
    shutil.copy(src.with_suffix(".bin"), dst / "cornell.bin")
    s = sb.load_scene(copy, use_cache=False)
    data = pack_animations([GltfAnimationChannel(
        node=0, path="rotation", times=np.asarray([0.0, 4.0], np.float32),
        values=np.asarray([[0, 0, 0, 1], [0, 0, 1, 0]], np.float32))])
    s.anim_node, s.anim_path = data.node, data.path
    s.anim_interp, s.anim_key_offset = data.interp, data.key_offset
    s.anim_times, s.anim_values = data.times, data.values
    s.anim_duration = data.duration
    sb.save_scene_cache(sb.cache_path(copy, 1.0), s)
    return copy


def slice8(dev, ctx: dict) -> dict:
    """Slice 8's phases: the glass-and-emitters frame at 1920x1080 (ReSTIR
    DI, two depth-peeled OIT layers, RT sun shadows, TAA on the stress
    scene with glass): K3 against its plain version on the frame's ReSTIR
    rays and its shadow rays, K1 on both OIT layer launches, 1 + FRAMES
    frames with gates, a profile; the culled courtyard with
    pack_gbuffer=True against its float-plane frame; the 14 debug views
    on it; the all-on update frame with the probe overlay; 384x216 frames
    on the card against the CPU; the render CLI in its own processes
    (the glass flags, and --animate on an animated Cornell).  ctx: the
    earlier phases' scene, settings, pairs and numbers it builds on.
    Returns the numbers the kernels line adds."""
    import numpy as np
    import torch

    from toyrenderer_tpu_torch._build import BUILD_DIR
    from toyrenderer_tpu_torch.engine import (
        RenderSettings, View, default_frame_inputs, init_carry,
        make_render_fn)
    from toyrenderer_tpu_torch.engine.capacity import (
        sized_raster_config, sized_settings, tile_pair_counts)
    from toyrenderer_tpu_torch.ops import bvh as bvh_mod
    from toyrenderer_tpu_torch.ops import bvh_cuda, raster_cuda
    from toyrenderer_tpu_torch.ops import geometry as geo_mod
    from toyrenderer_tpu_torch.scene import load_scene
    from toyrenderer_tpu_torch.scene.animation import AnimationPlayer
    from toyrenderer_tpu_torch.scene.png import decode_png
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy
    out = {}
    t8 = time.time()

    # 27. the glass-and-emitters frame: the stress scene (64 objects,
    #     textured; every 7th material emissive) with two glass materials,
    #     ReSTIR DI on its emissive triangles, the glass in 2 OIT layers,
    #     RT sun shadows and TAA over a slow pan
    g_host = glass_scene()
    g_scene = g_host.to_device(dev)
    gpi, gpm = geo_mod.static_meshlet_pairs(g_host, 'opaque')
    gti, gtm = geo_mod.static_meshlet_pairs(g_host, 'blend')
    g_pairs = tuple(torch.from_numpy(a).to(dev) for a in (gpi, gpm))
    g_blend = tuple(torch.from_numpy(a).to(dev) for a in (gti, gtm))
    g_base = RenderSettings(width=WIDTH, height=HEIGHT, manual_exposure=0.1,
                            enable_restir=True, enable_transparency=True,
                            oit_layers=2, enable_shadows=True,
                            enable_taa=True)
    pan = View.from_scene(g_host, WIDTH, HEIGHT)
    g_fi = []
    for _ in range(4 + FRAMES):
        mats = pan.matrices()
        g_fi.append(default_frame_inputs(g_host, mats))
        pan.advance(mats)
        pan.rotate_yaw_pitch(SHADOW_YAW, 0.0)
    g_fi.reverse()
    g_counts = tile_pair_counts(g_scene, frame_inputs_from_numpy(
        g_fi[-1], dev), g_base, {"opaque": g_pairs, "blend": g_blend})
    g_set = sized_settings(g_base, g_counts)
    g_cfg = dict(raster_cfg=sized_raster_config(
        g_set, {"opaque": g_counts["opaque"]}),
        trans_raster_cfg=sized_raster_config(
            g_set, {"blend": g_counts["blend"]}))
    t = time.time()
    g_rts = bvh_mod.build_rt_static(g_host, gpi, gpm, device=dev)
    g_build_s = time.time() - t
    g_kw = dict(trans_pair_inst=g_blend[0], trans_pair_meshlet=g_blend[1],
                rt_static=g_rts)
    g_render = make_render_fn(g_set, **g_cfg)
    emissive = g_host.mat_emissive.sum(-1) > 1e-3
    lit_pairs = emissive[g_host.prim_material[g_host.meshlet_prim[gpm]]]
    phase("glass scene", instances=g_host.num_instances,
          opaque_pairs=len(gpi), blend_pairs=len(gti),
          emissive_materials=int(emissive.sum()),
          emissive_triangles=int(g_host.meshlet_tri_count[gpm][
              lit_pairs].sum()),
          restir_max_lights=g_set.restir_max_lights,
          rt_host_build_s=f"{g_build_s:.2f}",
          K=g_set.max_tris_per_tile,
          blend_max_tile_pairs=g_counts['blend']['max_tile_pairs'],
          blend_binned_pairs=g_counts['blend']['pairs'])

    # 28. K3 and K1 against their plain versions on the inputs of one
    #     frame's launches (the second frame: the reservoir and the
    #     histories valid): K3 on the shadow rays and on ReSTIR's
    #     visibility rays (every pixel's, any-hit, as the frame traces
    #     them), K1 on the opaque fill and both OIT layers
    _, g_carry, _ = g_render(g_scene, *g_pairs, g_fi.pop(),
                             init_carry(g_scene, g_set), **g_kw)
    (k1_in, k3_in), (_, g_carry, g_aux) = launch_inputs(
        g_render, g_scene, g_pairs, g_fi.pop(), g_carry, g_kw,
        (raster_cuda, bvh_cuda))
    k1_in = [a[0] for a in k1_in]
    if (len(k1_in), len(k3_in)) != (3, 2):
        raise AssertionError(f"glass frame: {len(k1_in)} K1 and "
                             f"{len(k3_in)} K3 launches; want 3 and 2")
    restir_args = k3_in[1]
    if restir_args[5] is not None or restir_args[1].shape[0] != \
            WIDTH * HEIGHT:
        raise AssertionError("glass frame: ReSTIR's launch is not every "
                             "pixel's ray")
    out['k3'] = {
        "glass shadow rays, any-hit": hold_trace("K3", k3_in[0]),
        "ReSTIR visibility rays, any-hit": hold_trace("K3 (ReSTIR)",
                                                      restir_args)}
    out['k1'] = {name: hold_k1(name, inp) for name, inp in
                 zip(("OIT layer 0", "OIT layer 1"), k1_in[1:])}
    del k1_in, k3_in, restir_args
    phase("slice 8 timing", step="glass scene and kernels",
          seconds=f"{time.time() - t8:.1f}")
    t8 = time.time()

    # 29. the glass frame at 1920x1080 through the entry points: 1 + 5
    #     frames of the pan; every timed frame launches K1 3 times
    #     (opaque, 2 layers), K3 twice (shadows, ReSTIR), K4 twice, drops
    #     nothing in either set, finds the lights, and ReSTIR adds light
    def g_per_frame(aux, carry):
        hit = aux['depth'] > 0
        added = aux['restir'].sum(-1)
        return dict(launches=launch_counts(),
                    finite=bool(torch.isfinite(aux['hdr']).all()),
                    lights=int(aux['restir_lights']),
                    drops=sum(int(v) for k, v in aux.items()
                              if k.endswith('dropped')),
                    trans_dropped=int(aux['raster_trans_dropped']),
                    restir_lit=float((added[hit] > 0).float().mean()),
                    restir_mean=float(added[hit].mean()))
    g_times, g_walls, g_img, g_aux, g_carry, g_rows = drive(
        g_render, g_scene, g_pairs, g_fi.pop, g_carry, g_kw, FRAMES,
        g_per_frame)
    prev = [0] * 9
    for i, r in enumerate(g_rows):
        per = [a - b for a, b in zip(r['launches'], prev)]
        prev = r['launches']
        if (per != [3, 0, 2, 2, 0, 0, 0, 0, 0] or not r['finite']
                or r['lights'] <= 0 or r['drops'] or r['trans_dropped']
                or not r['restir_lit'] > 0):
            raise AssertionError(f"glass frame {i}: launches K1-K7 {per} "
                                 f"(want [3, 0, 2, 2, 0, 0, 0, 0, 0]), {r}")
    out['glass_launches'] = prev
    if g_img.shape != (HEIGHT, WIDTH, 3) or g_img.dtype != torch.uint8:
        raise AssertionError(f"glass frame: image {tuple(g_img.shape)}")
    np.save(BUILD_DIR / f"chip_smoke_glass_{WIDTH}x{HEIGHT}.npy",
            g_img.cpu().numpy())
    g_next = g_fi.pop()
    g_busy, g_by_op, _ = profile_frame(g_render, g_scene, g_pairs,
                                       g_next, g_carry, g_kw)
    phase("frame", path="glass and emitters", size=f"{WIDTH}x{HEIGHT}",
          frames=FRAMES, median_ms=f"{statistics.median(g_times):.3f}",
          all_ms=json.dumps([round(x, 3) for x in g_times]),
          host_wall_ms=json.dumps([round(x, 3) for x in g_walls]),
          device_busy_ms=f"{g_busy:.3f}",
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(prev),
          lights=g_rows[-1]['lights'],
          restir_lit_share=json.dumps([round(r['restir_lit'], 4)
                                       for r in g_rows]),
          restir_mean=json.dumps([round(r['restir_mean'], 5)
                                  for r in g_rows]),
          coverage=f"{float((g_aux['tri_id'] >= 0).float().mean()):.4f}",
          blend_tris=int(g_aux['raster_trans_tris']),
          raster_dropped=g_rows[-1]['drops'],
          raster_trans_dropped=g_rows[-1]['trans_dropped'])
    phase("profile", path="glass and emitters",
          device_busy_ms=f"{g_busy:.3f}",
          busy_share_of_median_frame=(
              f"{g_busy / statistics.median(g_times):.3f}" if g_busy
              else "not measured"),
          by_op_ms_calls=json.dumps(g_by_op[:20]))
    # the glass frame's state and its profiled frame, for slice 9's pass
    # table
    out['glass'] = dict(render=g_render, scene=g_scene, pairs=g_pairs,
                        kw=g_kw, carry=g_carry, fi=g_next, host=g_host,
                        pairs_np=(gpi, gpm))
    del g_img, g_aux
    phase("slice 8 timing", step="glass frames and profile",
          seconds=f"{time.time() - t8:.1f}")
    t8 = time.time()

    # 30. the bench's culled courtyard with the packed GBuffer: every
    #     resolve writes the four u32 words, the passes read only them;
    #     1 + 5 frames as the float-plane culled frame ran them, its image
    #     against that frame's
    scene, c_pairs, fi_np = ctx['scene'], ctx['c_pairs'], ctx['fi_np']
    mask_kw, c_kw = ctx['mask_kw'], ctx['c_kw']
    pk_set = dataclasses.replace(ctx['c_set'], pack_gbuffer=True)
    pk_render = make_render_fn(pk_set, **c_kw)
    pk_times, pk_walls, pk_img, pk_aux, pk_carry, _ = drive(
        pk_render, scene, c_pairs, fi_np, init_carry(scene, pk_set),
        mask_kw, FRAMES, lambda a, c: None)
    out['packed_launches'] = launch_counts()
    pk_coverage = check_frame(pk_img, pk_aux, out['packed_launches'][0],
                              out['packed_launches'][1], 2 * FRAMES, FRAMES,
                              "packed culled frame")
    pk_close = float(((pk_img.int() - ctx['c_img'].int()).abs().amax(-1)
                      <= 1).float().mean())
    if pk_close < 0.99:
        raise AssertionError(f"packed culled frame: within 1 of the float "
                             f"frame on {pk_close:.5f}")
    pk_busy, pk_by_op, _ = profile_frame(pk_render, scene, c_pairs, fi_np,
                                         pk_carry, mask_kw)
    phase("frame", path="culled, packed GBuffer", size=f"{WIDTH}x{HEIGHT}",
          frames=FRAMES, median_ms=f"{statistics.median(pk_times):.3f}",
          all_ms=json.dumps([round(x, 3) for x in pk_times]),
          host_wall_ms=json.dumps([round(x, 3) for x in pk_walls]),
          device_busy_ms=f"{pk_busy:.3f}",
          float_frame_busy_ms=f"{ctx['c_busy']:.3f}",
          float_frame_median_ms=f"{ctx['c_median']:.3f}",
          within_1_of_float_frame=f"{pk_close:.6f}",
          launches_k1_k2=json.dumps(out['packed_launches'][:2]),
          coverage=f"{pk_coverage:.4f}",
          by_op_ms_calls=json.dumps(pk_by_op[:12]))

    # 31. each debug view 1-14 once on that frame (the lit passes still
    #     run; the image is the view in u8)
    views = {}
    for mode in range(1, 15):
        img, _, aux = make_render_fn(dataclasses.replace(
            pk_set, debug_mode=mode), **c_kw)(scene, *c_pairs, fi_np,
                                              pk_carry, **mask_kw)
        if (img.dtype != torch.uint8 or img.shape != (HEIGHT, WIDTH, 3)
                or not bool(torch.isfinite(aux['hdr']).all())):
            raise AssertionError(f"debug view {mode}: {img.dtype} "
                                 f"{tuple(img.shape)}")
        views[mode] = round(float(img.float().mean()), 3)
    if views[2] == views[1] or views[11] == views[1]:
        raise AssertionError(f"debug views: normals / meshlets show the "
                             f"albedo ({views})")
    phase("debug views", path="culled, packed GBuffer", modes="1-14",
          mean_u8=json.dumps(views))
    del pk_img, pk_aux

    # 32. the all-on frame with the probe overlay, on its first update
    #     frame (frames 0-2 hold the probes)
    a_set, a_kw = ctx['a_set'], ctx['a_kw']
    a_render = make_render_fn(a_set, **c_kw)
    a_carry = init_carry(scene, a_set, a_kw['ddgi_volume'])
    for _ in range(3):
        _, a_carry, _ = a_render(scene, *c_pairs, fi_np, a_carry, **a_kw)
    _, _, plain_aux = a_render(scene, *c_pairs, fi_np, a_carry, **a_kw)
    o_img, _, o_aux = make_render_fn(dataclasses.replace(
        a_set, show_gi_probes=True), **c_kw)(scene, *c_pairs, fi_np,
                                             a_carry, **a_kw)
    # the HDR the overlay draws into (auto-exposure then moves every
    # pixel of the u8 image a little)
    drawn = float((o_aux['hdr'] != plain_aux['hdr']).any(-1).float().mean())
    if (not o_aux['ddgi_updated'] or not 0.0 < drawn < 0.5
            or not bool(torch.isfinite(o_aux['hdr']).all())):
        raise AssertionError(f"probe overlay: updated "
                             f"{o_aux['ddgi_updated']}, drawn share {drawn}")
    phase("probe overlay", path="all-on update frame", frame=3,
          probes=a_kw['ddgi_volume'].num_probes,
          pixels_drawn=f"{drawn:.5f}")
    del plain_aux, o_img, o_aux, a_carry
    phase("slice 8 timing", step="packed frame, debug views, overlay",
          seconds=f"{time.time() - t8:.1f}")
    t8 = time.time()

    # 33. the render CLI in its own processes, both at once and beside
    #     the small frames below: the glass flags on --scene stress
    #     (960x540, 2 frames), and --animate on the animated Cornell
    #     (448x256, 3 frames), whose PNG must equal the same frames
    #     rendered here
    anim = write_animated_cornell(BUILD_DIR / "anim_cornell")
    runs = {
        "glass flags": ["--scene", "stress", "--restir", "--transparency",
                        "--oitlayers", "2", "--shadows", "--taa",
                        "--displayresolution", "960x540", "--frames", "2",
                        "--exposure", "0.1"],
        "animate": ["--scene", str(anim), "--animate", "--frames", "3",
                    "--displayresolution", "448x256", "--exposure", "0.01"]}
    t_cli = time.time()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "toyrenderer_tpu_torch.tools.render", *a,
         "--output", str(BUILD_DIR / f"chip_smoke_cli8_{i}.png")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (k, a) in enumerate(runs.items())}

    # 34. 384x216 frames on the card against the CPU: the glass frame
    #     (2 frames: ReSTIR's temporal reuse), the packed culled
    #     courtyard, debug views 2, 11 and 14 and the probe overlay (1
    #     frame each; a CPU frame of the culled courtyard takes ~9 s)
    host, small_c, s_counts = ctx['host'], ctx['small_c'], ctx['s_counts']
    none = np.zeros(0, np.int32)
    gs_base = dataclasses.replace(g_base, width=SMALL[0], height=SMALL[1])
    gs_counts = tile_pair_counts(g_scene, frame_inputs_from_numpy(
        default_frame_inputs(g_host, View.from_scene(g_host, *SMALL)
                             .matrices()), dev), gs_base,
        {"opaque": g_pairs, "blend": g_blend})
    gs_set = sized_settings(gs_base, gs_counts)
    g_rts_cpu = rt_static_on(g_rts, torch.device("cpu"))
    small = {}
    small['glass'] = card_vs_cpu(
        g_host, g_scene, gs_set, [gpi, gpm, none, none], 2, dict(
            raster_cfg=sized_raster_config(
                gs_set, {"opaque": gs_counts["opaque"]}),
            trans_raster_cfg=sized_raster_config(
                gs_set, {"blend": gs_counts["blend"]})),
        yaw=SHADOW_YAW * WIDTH / SMALL[0], min_share=0.995,
        kw_on=lambda d: dict(
            trans_pair_inst=torch.from_numpy(gti).to(d),
            trans_pair_meshlet=torch.from_numpy(gtm).to(d),
            rt_static=g_rts if d.type == "cuda" else g_rts_cpu))
    cpi, cpm, mk_i, mk_m = ctx['c_pairs_np']
    s_cfg = dict(raster_cfg=sized_raster_config(
        small_c, {"opaque": s_counts["opaque"]}),
        mask_raster_cfg=sized_raster_config(
            small_c, {"masked": s_counts["masked"]}))
    small_pk = dataclasses.replace(small_c, pack_gbuffer=True)
    small['packed culled'] = card_vs_cpu(
        host, scene, small_pk, [cpi, cpm, mk_i, mk_m], 1, s_cfg,
        min_share=0.995)
    for mode in (2, 11, 14):
        small[f'debug {mode}'] = card_vs_cpu(
            host, scene, dataclasses.replace(small_pk, debug_mode=mode),
            [cpi, cpm, mk_i, mk_m], 1, s_cfg, min_share=0.995)
    # the probe hits' sun visibility by rays (a sun map's plain fill is
    # too slow for the CPU side)
    small_o = dataclasses.replace(small_c, enable_gi=True,
                                  show_gi_probes=True, gi_update_phases=1,
                                  gi_sun_technique='rt')
    small['probe overlay'] = card_vs_cpu(
        host, scene, small_o, [cpi, cpm, mk_i, mk_m], 1, s_cfg,
        min_share=0.995, kw_on=ctx['small_kw'], volume=ctx['small_vol'])
    phase("slice 8 small frames card vs cpu", size=f"{SMALL[0]}x{SMALL[1]}",
          within_1_and_max_diff=json.dumps(
              {k: [round(v[0], 6), v[1]] for k, v in small.items()}),
          seconds=f"{time.time() - t8:.1f}")

    # 35. the CLI processes' results
    results = {k: p.communicate(timeout=600) + (p.returncode,)
               for k, p in procs.items()}
    cli_s = time.time() - t_cli
    for k, (so, se, rc) in results.items():
        if rc != 0:
            raise AssertionError(f"render CLI ({k}) exited {rc}:\n"
                                 f"{so[-2000:]}{se[-4000:]}")
    a_host = load_scene(anim)
    a_scene = a_host.to_device(dev)
    a_pairs = [torch.from_numpy(x).to(dev) for x in
               geo_mod.static_meshlet_pairs(a_host, 'all')]
    st = RenderSettings(width=448, height=256, manual_exposure=0.01)
    render = make_render_fn(st)
    carry = init_carry(a_scene, st)
    view = View.from_scene(a_host, 448, 256)
    player = AnimationPlayer(a_host.animation_data())
    for i in range(3):
        mats = view.matrices()
        fi = default_frame_inputs(a_host, mats)
        tr, ro, sc = player.evaluate(i / 60.0, a_host.node_translation,
                                     a_host.node_rotation, a_host.node_scale)
        fi.update(node_translation=tr, node_rotation=ro, node_scale=sc)
        img, carry, _ = render(a_scene, *a_pairs, fi, carry)
        view.advance(mats)
    cli_img = decode_png((BUILD_DIR / "chip_smoke_cli8_1.png").read_bytes())
    if not np.array_equal(cli_img[..., :3], img.cpu().numpy()):
        raise AssertionError("render CLI --animate: the PNG differs from "
                             "the same frames rendered here")
    glass_png = decode_png((BUILD_DIR / "chip_smoke_cli8_0.png").read_bytes())
    phase("cli", commands=json.dumps({k: " ".join(a)
                                      for k, a in runs.items()}),
          started_to_collected_s=f"{cli_s:.1f}",
          animate_equals_in_process=True,
          anim_line=json.dumps([ln for ln in results["animate"][0]
                                .splitlines() if ln.startswith("[anim]")]),
          glass_png=f"{glass_png.shape[1]}x{glass_png.shape[0]}",
          frame_lines=json.dumps({k: [ln for ln in r[0].splitlines()
                                      if ln.startswith("[frame")]
                                  for k, r in results.items()}))
    return out


def pan_inputs(host, n, move_from=None):
    """n frames' host inputs of a slow pan (SHADOW_YAW a frame); from
    frame `move_from` on, the node of instance 0 stands 0.05 higher (a
    new array on each of those frames)."""
    from toyrenderer_tpu_torch.engine import View, default_frame_inputs
    pan = View.from_scene(host, WIDTH, HEIGHT)
    node = int(host.inst_node[0])
    out = []
    for i in range(n):
        mats = pan.matrices()
        fi = default_frame_inputs(host, mats)
        if move_from is not None and i >= move_from:
            t = fi['node_translation'].copy()
            t[node, 1] += 0.05
            fi['node_translation'] = t
        out.append(fi)
        pan.advance(mats)
        pan.rotate_yaw_pitch(SHADOW_YAW, 0.0)
    return out


def sync_log(fn):
    """fn() under torch.cuda.set_sync_debug_mode('warn'): (its result,
    the synchronizing calls it made, each as 'file:line')."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    calls = [f"{Path(w.filename).name}:{w.lineno}" for w in seen
             if "synchroniz" in str(w.message)]
    return out, calls


def slice9(dev, ctx: dict) -> dict:
    """Slice 9's phases: the frame's caches at 1920x1080 (the shadowed,
    map-shadowed and all-on frames, the last also under TR_GI_PAIRS=1,
    each cached and uncached in the same loop, frame by frame); GI's
    branch under torch.cuda.set_sync_debug_mode('warn'); the snapshot of
    the cached all-on chain; the pass tables of the culled and all-on
    frames; tools/profile_stages.py (K7).  ctx: the earlier phases'
    scene, settings, pairs and topologies.  Returns the numbers the
    kernels line adds."""
    import dataclasses as dc

    import torch

    from toyrenderer_tpu_torch._build import BUILD_DIR
    from toyrenderer_tpu_torch.engine import (
        View, default_frame_inputs, init_carry, make_render_fn,
        pack_frame_inputs)
    from toyrenderer_tpu_torch.engine import frame as frame_mod
    from toyrenderer_tpu_torch.engine.snapshot import load_state, save_state
    from toyrenderer_tpu_torch.ops import dense_cuda
    from toyrenderer_tpu_torch.ops import raster as raster_mod
    from toyrenderer_tpu_torch.tools import passes, profile_stages
    host, scene, c_pairs, c_kw = (ctx['host'], ctx['scene'], ctx['c_pairs'],
                                  ctx['c_kw'])
    card = ctx['card']
    out = {}
    t9 = time.time()
    cache_kw = dict(rt_static=ctx['s_kw']['rt_static'],
                    rt_static_gi=ctx['a_kw']['rt_static_gi'],
                    pair_inst=c_pairs[0], pair_meshlet=c_pairs[1],
                    rt_pair_inst=ctx['s_kw']['rt_pair_inst'],
                    rt_pair_meshlet=ctx['s_kw']['rt_pair_meshlet'],
                    gi_pair_inst=ctx['a_kw']['gi_pair_inst'],
                    gi_pair_meshlet=ctx['a_kw']['gi_pair_meshlet'],
                    **ctx['mask_kw'])
    vol = ctx['a_kw']['ddgi_volume']

    def carries(st, gi):
        """(uncached render and carry, cached render and carry)."""
        st_u = dc.replace(st, cache_sun_map=False)
        v = vol if gi else None
        return ((make_render_fn(st_u, **c_kw), init_carry(scene, st_u, v)),
                (make_render_fn(st, **c_kw),
                 init_carry(scene, st, v, **cache_kw)))

    # 34. the caches: 1 + 8 frames of a slow pan, the node of instance 0
    #     moved from frame 5 on, each path uncached and cached in the same
    #     loop; every frame bit-equal, no drop, the launches equal but for
    #     the sun map's K2 (cached: frames 0 and 5 only) and the rebuilt
    #     caches on frames 0, 5 and, for GI, the update frames 3 and 7;
    #     then one still frame of each run profiled
    n_frames, move_at = 9, 5
    fis = pan_inputs(host, n_frames + 1, move_from=move_at)
    want_rebuilt = {
        "shadowed": {0: ['rt'], 5: ['rt']},
        "shadowed-map": {0: ['sm'], 5: ['sm']},
        "all-on": {0: ['rt'], 3: ['gi'], 5: ['rt'], 7: ['gi']},
        "all-on, TR_GI_PAIRS=1": {0: ['rt'], 3: ['gi', 'mt'], 5: ['rt'],
                                  7: ['gi', 'mt']}}
    paths = (("shadowed", ctx['s_set'], ctx['s_kw'], False),
             ("shadowed-map", ctx['m_set'], ctx['s_kw'], False),
             ("all-on", ctx['a_set'], ctx['a_kw'], True),
             ("all-on, TR_GI_PAIRS=1", ctx['a_set'], ctx['a_kw'], True))
    cache_rows = {}
    for name, st, kw, gi in paths:
        if "PAIRS" in name:
            os.environ['TR_GI_PAIRS'] = '1'
        try:
            runs = carries(st, gi)
            carry = [c for _, c in runs]
            if "PAIRS" in name and 'gi_mt_cache' not in carry[1]:
                raise AssertionError("cached all-on carry under "
                                     "TR_GI_PAIRS=1 has no gi_mt_cache")
            rows = [[], []]
            times = [[], []]
            for i, fi in enumerate(fis[:n_frames]):
                imgs = []
                for r, (render, _) in enumerate(runs):
                    packed = pack_frame_inputs(fi, dev)
                    reset_launch_counts()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    img, carry[r], aux = render(scene, *c_pairs, packed,
                                                carry[r], **kw)
                    end.record()
                    torch.cuda.synchronize()
                    times[r].append(start.elapsed_time(end))
                    rows[r].append(dict(
                        launches=launch_counts(), rebuilt=aux['rebuilt'],
                        drops=drops_of(aux),
                        sm_drop=int(aux.get('shadow_map_dropped', 0)),
                        updated=aux.get('ddgi_updated', False)))
                    imgs.append(img)
                if not torch.equal(*imgs):
                    raise AssertionError(f"caches, {name}: frame {i} differs "
                                         "from the uncached frame on "
                                         f"{int((imgs[0] != imgs[1]).any(-1).sum())}"
                                         " pixels")
            for r in (0, 1):
                for i, row in enumerate(rows[r]):
                    rebuilt = want_rebuilt[name].get(i, []) if r else []
                    if (row['drops'] != (0, 0) or row['sm_drop']
                            or row['rebuilt'] != rebuilt):
                        raise AssertionError(
                            f"caches, {name}, {'cached' if r else 'uncached'}"
                            f" frame {i}: drops {row['drops']}, sun-map drops "
                            f"{row['sm_drop']}, rebuilt {row['rebuilt']} "
                            f"(want {rebuilt})")
            for i, (u, c) in enumerate(zip(*rows)):
                lu, lc = u['launches'], c['launches']
                k2 = ((2, 1 if i not in (0, move_at) else 2)
                      if name == "shadowed-map" else (lu[1], lu[1]))
                upd = u['updated']
                if ((lu[1], lc[1]) != k2 or lu[:1] + lu[2:] != lc[:1] + lc[2:]
                        or u['updated'] != c['updated']
                        or (gi and "PAIRS" not in name
                            and lu[4] != (2 if upd else 0))
                        or ("PAIRS" in name and lu[7] != (2 if upd else 0))):
                    raise AssertionError(
                        f"caches, {name} frame {i}: launches K1-K7 "
                        f"uncached {lu}, cached {lc} (K2 want {k2}), "
                        f"updated {u['updated']} / {c['updated']}")
            if gi and [r['updated'] for r in rows[0]] != [
                    i in (3, 7) for i in range(n_frames)]:
                raise AssertionError(f"caches, {name}: update frames "
                                     f"{[r['updated'] for r in rows[0]]}")
            busy = []
            for r, (render, _) in enumerate(runs):
                b, by_op, _ = profile_frame(
                    render, scene, c_pairs, pack_frame_inputs(fis[-1], dev),
                    carry[r], kw)
                busy.append(b)
        finally:
            os.environ.pop('TR_GI_PAIRS', None)
        timed = range(1, n_frames)
        med = [statistics.median(times[r][i] for i in timed) for r in (0, 1)]
        upd = [i for i in timed if rows[0][i]['updated']]
        hold = [i for i in timed if not rows[0][i]['updated']]
        extra = {}
        if gi:
            extra = dict(
                update_median_ms_uncached_cached=json.dumps([round(
                    statistics.median(times[r][i] for i in upd), 3)
                    for r in (0, 1)]),
                hold_median_ms_uncached_cached=json.dumps([round(
                    statistics.median(times[r][i] for i in hold), 3)
                    for r in (0, 1)]))
        cache_rows[name] = dict(median=med, busy=busy, times=times)
        phase("caches", path=name, size=f"{WIDTH}x{HEIGHT}",
              frames=f"1+{n_frames - 1}", moved_from_frame=move_at,
              bit_equal=True, card=json.dumps(card),
              median_ms_uncached_cached=json.dumps([round(x, 3)
                                                    for x in med]),
              busy_ms_uncached_cached=json.dumps([round(x, 3)
                                                  for x in busy]),
              **extra,
              all_ms_uncached=json.dumps([round(x, 3) for x in times[0]]),
              all_ms_cached=json.dumps([round(x, 3) for x in times[1]]),
              launches_per_frame_uncached=json.dumps(
                  [r['launches'] for r in rows[0]]),
              launches_per_frame_cached=json.dumps(
                  [r['launches'] for r in rows[1]]),
              rebuilt_cached=json.dumps([r['rebuilt'] for r in rows[1]]))
    out['caches'] = cache_rows
    phase("slice 9 timing", step="caches", seconds=f"{time.time() - t9:.1f}")

    # 35. GI's branch: the all-on frames 0-4 (an update on frame 3) under
    #     the sync debug mode, uncached and cached; each frame's
    #     synchronizing calls and where they were made; none may come
    #     from engine/frame.py (the GI branch reads no device value) and
    #     the caches add none.  The branch's wait for the previous frame's
    #     convergence flag (HostMirror.is_converged) is timed apart
    waits = []
    real_wait = frame_mod.HostMirror.is_converged

    def timed_wait(self):
        t = time.perf_counter()
        try:
            return real_wait(self)
        finally:
            waits.append((time.perf_counter() - t) * 1e3)
    runs = carries(ctx['a_set'], True)
    carry = [c for _, c in runs]
    sync = [[], []]
    frame_mod.HostMirror.is_converged = timed_wait
    try:
        for i, fi in enumerate(fis[:5]):
            for r, (render, _) in enumerate(runs):
                packed = pack_frame_inputs(fi, dev)
                (_, carry[r], _), calls = sync_log(
                    lambda: render(scene, *c_pairs, packed, carry[r],
                                   **ctx['a_kw']))
                sync[r].append(calls)
    finally:
        frame_mod.HostMirror.is_converged = real_wait
    for i, (u, c) in enumerate(zip(*sync)):
        mine = [s for s in u + c if s.startswith("frame.py:")]
        if mine or len(c) > len(u):
            raise AssertionError(f"GI branch, frame {i}: synchronizing "
                                 f"calls uncached {u}, cached {c}")
    phase("GI branch", path="all-on", frames=5, update_frame=3,
          sync_calls_per_frame_uncached=json.dumps([len(s) for s in sync[0]]),
          sync_calls_per_frame_cached=json.dumps([len(s) for s in sync[1]]),
          sync_call_sites=json.dumps(sorted(set(sum(sync[0] + sync[1], [])))),
          from_engine_frame=0,
          convergence_flag_waits=len(waits),
          convergence_flag_wait_ms=json.dumps([round(w, 4) for w in waits]))

    # 36. the snapshot: the cached all-on chain saved after 5 frames,
    #     loaded into a fresh carry; the next 3 frames bit-equal to the
    #     uninterrupted chain's, rebuilding the same caches
    render = make_render_fn(ctx['a_set'], **c_kw)
    carry = init_carry(scene, ctx['a_set'], vol, **cache_kw)
    view = View.from_scene(host, WIDTH, HEIGHT)

    def chain(carry, view, n):
        imgs, rebuilt = [], []
        for _ in range(n):
            mats = view.matrices()
            img, carry, aux = render(scene, *c_pairs, pack_frame_inputs(
                default_frame_inputs(host, mats), dev), carry,
                **ctx['a_kw'])
            view.advance(mats)
            view.rotate_yaw_pitch(SHADOW_YAW, 0.0)
            imgs.append(img)
            rebuilt.append(aux['rebuilt'])
        return imgs, rebuilt, carry
    _, _, carry = chain(carry, view, 5)
    snap = BUILD_DIR / "chip_smoke_snapshot.npz"
    t = time.time()
    save_state(snap, carry, view)
    save_s = time.time() - t
    view2 = View.from_scene(host, WIDTH, HEIGHT)
    t = time.time()
    carry2 = load_state(snap, ctx['a_set'], view2, device=dev,
                        rt_static_gi=ctx['a_kw']['rt_static_gi'])
    load_s = time.time() - t
    a, ra, _ = chain(carry, view, 3)
    b, rb, _ = chain(carry2, view2, 3)
    if not all(torch.equal(x, y) for x, y in zip(a, b)) or ra != rb:
        raise AssertionError(f"snapshot: resumed frames differ (rebuilt "
                             f"{rb}, uninterrupted {ra})")
    phase("snapshot", path="all-on, cached", saved_after=5, resumed=3,
          bit_equal=True, rebuilt=json.dumps(rb),
          npz_mb=f"{snap.stat().st_size / 2 ** 20:.1f}",
          save_s=f"{save_s:.2f}", load_s=f"{load_s:.2f}")
    snap.unlink()

    # 37. the pass tables of a culled frame, an all-on update frame
    #     (cached; the default route and TR_GI_PAIRS=1) and the glass
    #     frame: attributed + unattributed within 2% of the busy union,
    #     unattributed at most 1% of it, at least 98% of the launched
    #     kernels in the trace, every expected range present, and each
    #     hand-written kernel of the frame in the pass that launches it
    c_render = make_render_fn(ctx['c_set'], **c_kw)
    c_carry = init_carry(scene, ctx['c_set'])
    fi0 = pack_frame_inputs(fis[0], dev)
    _, c_carry, _ = c_render(scene, *c_pairs, fi0, c_carry, **ctx['mask_kw'])
    a_carry = init_carry(scene, ctx['a_set'], vol, **cache_kw)
    for fi in fis[:3]:
        _, a_carry, _ = render(scene, *c_pairs, pack_frame_inputs(fi, dev),
                               a_carry, **ctx['a_kw'])
    culled = {'UpdateInstanceConsts', 'GPUCulling', 'BasePass(fill+resolve)',
              'HZB(SPD)', 'GBufferResolve', 'AlphaMaskedPass',
              'DeferredLighting', 'PostProcess'}
    allon = culled | {'ShadowMask', 'Denoise', 'GI(DDGI)',
                      'AmbientOcclusion', 'Bloom', 'AdaptLuminance', 'TAA'}
    # the pair route's update frame (its tables cached) and the glass
    # frame (slice 8's chain, its next frame)
    os.environ['TR_GI_PAIRS'] = '1'
    try:
        p_carry = init_carry(scene, ctx['a_set'], vol, **cache_kw)
        for fi in fis[:3]:
            _, p_carry, _ = render(scene, *c_pairs, pack_frame_inputs(
                fi, dev), p_carry, **ctx['a_kw'])
    finally:
        del os.environ['TR_GI_PAIRS']

    def pairs_frame():
        os.environ['TR_GI_PAIRS'] = '1'
        try:
            return render(scene, *c_pairs, pack_frame_inputs(fis[3], dev),
                          p_carry, **ctx['a_kw'])
        finally:
            del os.environ['TR_GI_PAIRS']
    g = ctx['glass']
    g_fi = pack_frame_inputs(g['fi'], dev)
    # where the hand-written kernels must land: (kernel symbol, pass)
    base = {('fill_resolve_kernel', 'BasePass(fill+resolve)'),
            ('fill_peel_kernel', 'AlphaMaskedPass')}
    lit = {('traverse_kernel', 'ShadowMask'), ('warp_kernel', 'Denoise'),
           ('warp_kernel', 'TAA')}
    tables = {}
    for name, fn, want, where in (
            ("culled", lambda: c_render(scene, *c_pairs, fi0, c_carry,
                                        **ctx['mask_kw']), culled, base),
            ("all-on update frame", lambda: render(
                scene, *c_pairs, pack_frame_inputs(fis[3], dev), a_carry,
                **ctx['a_kw']), allon,
             base | lit | {('traverse_kernel', 'GI(DDGI)')}),
            ("all-on update frame, TR_GI_PAIRS=1", pairs_frame,
             allon | {'RT(pair boxes)'},
             base | lit | {('pairs_kernel', 'GI(DDGI)')}),
            ("glass and emitters", lambda: g['render'](
                g['scene'], *g['pairs'], g_fi, g['carry'], **g['kw']),
             {'UpdateInstanceConsts', 'BasePass(fill+resolve)',
              'GBufferResolve', 'RT(BVH build)', 'ShadowMask', 'Denoise',
              'ReSTIR', 'DeferredLighting', 'TransparentForward(layer 0)',
              'TransparentForward(layer 1)', 'TransparentForward(composite)',
              'TAA', 'PostProcess'},
             {('fill_resolve_kernel', 'BasePass(fill+resolve)'),
              ('traverse_kernel', 'ReSTIR')} | lit)):
        for attempt in range(PROFILE_TRIES):
            table, res = passes.profile(fn, dev)
            total = table['attributed_ms'] + table['unattributed_ms']
            kept = table['kernel_events'] / max(table['kernel_launches'], 1)
            lost = sorted((k, lab) for k, lab in where if not any(
                k in op for op in table['ops'].get(lab, {})))
            ok = (table['kernel_events'] > 0 and want <= set(table['passes'])
                  and abs(total - table['busy_ms'])
                  <= 0.02 * table['busy_ms']
                  and table['unattributed_ms'] <= 0.01 * table['busy_ms']
                  and kept >= 0.98 and not lost)
            if ok:
                break
            phase("profiler", note="pass table incomplete; taken again",
                  path=name, labels=json.dumps(sorted(table['passes'])),
                  attributed_ms=f"{table['attributed_ms']:.3f}",
                  unattributed_ms=f"{table['unattributed_ms']:.3f}",
                  busy_ms=f"{table['busy_ms']:.3f}", kept=f"{kept:.4f}",
                  kernels_not_in_their_pass=json.dumps(lost),
                  attempt=f"{attempt + 1}/{PROFILE_TRIES}")
        else:
            raise AssertionError(f"pass table ({name}): labels "
                                 f"{sorted(table['passes'])}, want {sorted(want)}"
                                 f"; attributed {table['attributed_ms']:.3f} + "
                                 f"unattributed {table['unattributed_ms']:.3f}"
                                 f" against busy {table['busy_ms']:.3f}; "
                                 f"kernels kept {kept:.4f} (want >= 0.98); "
                                 f"kernels not in their pass {lost}")
        if name.startswith("all-on") and not res[2]['ddgi_updated']:
            raise AssertionError("pass table: the all-on frame held")
        tables[name] = table
        phase("pass table", path=name, card=json.dumps(card),
              passes_ms=json.dumps({k: round(v, 3)
                                    for k, v in table['passes'].items()}),
              unattributed_ms=f"{table['unattributed_ms']:.3f}",
              attributed_plus_unattributed_ms=f"{total:.3f}",
              busy_union_ms=f"{table['busy_ms']:.3f}",
              frame_events_ms=f"{table['frame_ms']:.3f}",
              kernels_kept=f"{table['kernel_events']}/"
                           f"{table['kernel_launches']}",
              top_ops=json.dumps({k: {n[:72]: round(m, 3) for n, m in list(
                  v.items())[:3]} for k, v in table['ops'].items()}))
    out['tables'] = tables

    # 38. tools/profile_stages.py: the default frame's stages one by one
    #     on the stress scene (192 objects, 1920x1080), its fill on K7 at
    #     the view's sized capacity: binning drops nothing, and every K7
    #     launch of the stage is bit-equal to the plain fill
    #     (raster.fill_visibility's dense walk at tile_batch 128) on the
    #     arguments profile_stages gave it
    reset_launch_counts()
    with recorded((dense_cuda,)) as seen:
        rows = profile_stages.run([])
        torch.cuda.synchronize()
    st_launches = launch_counts()
    if st_launches[:8] != [0] * 8 or st_launches[8] < 1:
        raise AssertionError(f"profile_stages: launches K1-K7 {st_launches}"
                             "; want K7 only")
    args = seen[dense_cuda][0][0]
    setup, table, count, big, cfg_s = args[:5]
    st_drops = {k: int(v) for k, v in raster_mod.bin_triangles(
        setup, cfg_s)[3].items() if int(v)}
    if st_drops:
        raise AssertionError(f"profile_stages: binning drops {st_drops}")
    want = dense_cuda.fill_dense_plain(dataclasses.replace(
        dense_cuda.dense_inputs(*args),
        cfg=dataclasses.replace(cfg_s, tile_batch=128)))
    for a, _, got in seen[dense_cuda]:
        if not all(x is y for x, y in zip(a, args)):
            raise AssertionError("profile_stages: the fill's arguments "
                                 "changed between its calls")
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(
                f"profile_stages: K7 differs from the plain fill at "
                f"{int((got[1] != want[1]).sum())} ids, depth max "
                f"{float((got[0] - want[0]).abs().max())}")
    k7_calls = len(seen[dense_cuda])
    k7_bound = dense_bound_ms(setup, dense_cuda.dense_inputs(*args))
    del seen, args, setup, table, want
    out['stages_k7'] = st_launches[8]
    out['stages_k7_bound'] = k7_bound
    phase("profile_stages", scene="stress (192 objects)",
          size=f"{WIDTH}x{HEIGHT}", card=json.dumps(card),
          K=cfg_s.max_tris_per_tile, B=cfg_s.max_big_tris,
          binned_pairs=int(count.sum()), drops=0,
          k7_vs_plain=f"ids equal, depth bit-equal ({k7_calls} launches)",
          k7_bound_ms=f"{k7_bound[0]:.4f}", k7_bound_by=k7_bound[1],
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(
              st_launches),
          stages_ms=json.dumps({n: round(ms, 3) for n, ms, _ in rows}),
          notes=json.dumps({n: note for n, _, note in rows if note}))
    phase("slice 9 timing", step="all", seconds=f"{time.time() - t9:.1f}")
    return out


# f32 operations of one (pair, ray, triangle) test of the chunk fold
# (K8): the reference's direct Moller-Trumbore -- the two cross products
# (6 multiplies, 3 subtractions each), the four dot products (3
# multiplies, 2 additions each), the three origin differences, the three
# scalings by 1 / det, the |det| test, the reciprocal and its select,
# u + v and the seven compares -- and the fold's compare
OPS_PER_CHUNK_TEST = 2 * 9 + 4 * 5 + 3 + 3 + 4 + 1 + 7 + 2
# bytes of one chunk-fold ray slot: read [o, d, t_max, live], write the
# (t, payload) key
CHUNK_SLOT_BYTES = 8 * 4 + 8
PLAIN_LIMIT_S = 30.0             # a plain fold estimated longer: sampled
K8_SAMPLE_BLOCKS = 1024
PLAIN_CHUNK_BATCH = 1 << 24      # chunk_fold_plain's (pairs, 128, 96) batch


def chunk_bound_ms(args) -> tuple[float, str]:
    """Least time the card could take for one chunk fold (K8) on these
    inputs: operations, every (walked pair, live ray of its block,
    triangle) test; bytes, each distinct chunk walked (960 f32), the
    walked pair-list entries, each block's start and count, and every
    ray slot read and its key written once."""
    import torch
    from toyrenderer_tpu_torch.ops import rt_chunks
    rays, data, pchk, starts, n_walk = args
    live = (rays[..., 7] > 0).sum(1)
    ops = (int((n_walk.long() * live).sum()) * rt_chunks.CHUNK_TRIS
           * OPS_PER_CHUNK_TEST)
    _, chunk = rt_chunks._walk(n_walk, starts, pchk)
    bytes_ = (torch.unique(chunk).numel() * rt_chunks.CHUNK_FLOATS * 4
              + chunk.numel() * 4 + rays.shape[0] * 8
              + rays.shape[0] * rays.shape[1] * CHUNK_SLOT_BYTES)
    return bound(ops, bytes_)


def hold_k8(label, args) -> dict:
    """One recorded launch of the chunk fold (K8) against
    chunk_fold_plain on its arguments: best t and payload bit-equal.  The
    plain fold runs first on a seeded sample of K8_SAMPLE_BLOCKS blocks;
    where its time extrapolated to the whole launch exceeds
    PLAIN_LIMIT_S, the kernel is held on that sample's rays (every pair
    of a sampled block walked, the others' none) and the phase line says
    so.  Prints a phase line; returns its err, ms (the profiler's device
    time per launch), events ms, plain ms, bound and census."""
    import torch
    from toyrenderer_tpu_torch.ops import chunks_cuda, rt_chunks
    rays, data, pchk, starts, n_walk = args
    b = rays.shape[0]
    got = chunks_cuda.launch(*args)
    gen = torch.Generator().manual_seed(10)
    keep = torch.zeros(b, dtype=torch.bool)
    keep[torch.randperm(b, generator=gen)[:K8_SAMPLE_BLOCKS]] = True
    keep = keep.to(rays.device)
    sample = (rays, data, pchk, starts, torch.where(keep, n_walk, 0))
    t = time.time()
    want = rt_chunks.chunk_fold_plain(*sample, batch_elems=PLAIN_CHUNK_BATCH)
    torch.cuda.synchronize()
    sample_s = time.time() - t
    total = int(n_walk.sum())
    est_s = sample_s * total / max(int(sample[4].sum()), 1)
    sampled = b > K8_SAMPLE_BLOCKS and est_s > PLAIN_LIMIT_S
    plain_args = sample if sampled else args
    rows = (keep.repeat_interleave(rt_chunks.BLOCK) if sampled
            else torch.ones(b * rt_chunks.BLOCK, dtype=torch.bool,
                            device=rays.device))
    plain_wall = sample_s
    if not sampled:
        t = time.time()
        want = rt_chunks.chunk_fold_plain(*args,
                                          batch_elems=PLAIN_CHUNK_BATCH)
        torch.cuda.synchronize()
        plain_wall = time.time() - t
    for k, (a, w) in enumerate(zip(got, want)):
        if not torch.equal(a[rows], w[rows]):
            raise AssertionError(f"K8 ({label}): output {k} differs on "
                                 f"{int((a[rows] != w[rows]).sum())} rays")
    live = rays[..., 7] > 0
    st = dict(err=float((got[0][rows] - want[0][rows]).abs()
                        .nan_to_num(0.0).max()),
              ms=kernel_ms(lambda: chunks_cuda.launch(*args), KERNEL_REPS,
                           "chunks_kernel"),
              events_ms=cuda_ms(lambda: chunks_cuda.launch(*args),
                                KERNEL_REPS),
              plain_ms=cuda_ms(lambda: rt_chunks.chunk_fold_plain(
                  *plain_args, batch_elems=PLAIN_CHUNK_BATCH), 1),
              plain_scope=(f"{K8_SAMPLE_BLOCKS} seeded blocks of the launch"
                           if sampled else "the whole launch"),
              bound=chunk_bound_ms(args),
              census=dict(blocks=b, blocks_with_pairs=int((n_walk > 0).sum()),
                          pairs_walked=total, pair_list=pchk.shape[0],
                          live_rays=int(live.sum()),
                          rays_with_hit=int(torch.isfinite(got[0]).sum())))
    phase("K8 vs plain", input=json.dumps(label),
          compared=st['plain_scope'], t_payload="bit-equal",
          census=json.dumps(st['census']),
          plain_estimate_s=f"{est_s:.1f}", kernel_ms=f"{st['ms']:.4f}",
          kernel_events_ms=f"{st['events_ms']:.4f}",
          plain_ms=f"{st['plain_ms']:.1f}",
          plain_first_wall_s=f"{plain_wall:.1f}",
          bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1])
    return st


@contextlib.contextmanager
def env(**switches):
    """The environment switches set while open, restored after."""
    old = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def chunk_calls():
    """While open, each rt_chunks.traverse_chunks call appends (its
    positional arguments, keyword arguments, result, stats, the launches
    it made by kernel) to the yielded list."""
    from toyrenderer_tpu_torch.ops import bvh_cuda, rt_chunks
    real = rt_chunks.traverse_chunks
    calls = []

    def spy(*args, **kwargs):
        before = dict(bvh_cuda.launches_by_kernel)
        st = {}
        res = real(*args, stats=st, **kwargs)
        calls.append(dict(args=args, kw=kwargs, res=res, stats=st,
                          launches={k: v - before[k] for k, v in
                                    bvh_cuda.launches_by_kernel.items()}))
        return res
    rt_chunks.traverse_chunks = spy
    try:
        yield calls
    finally:
        rt_chunks.traverse_chunks = real


def hold_chunk_route(label, call, fallback_kernel) -> dict:
    """One recorded call of the chunk route (rt_chunks.traverse_chunks)
    against the default route's kernel on the same rays in the same mode
    (K3, or K3-SAH on the SAH tree): hit equal on >= 99.99% of the live
    rays, closest-hit t within 1e-5 relative where both hit; the call's
    fallback launched `fallback_kernel` once.  Times the whole route
    (box phase, pair list, K8, fallback) beside that kernel.  Prints a
    phase line; returns the census."""
    import torch
    from toyrenderer_tpu_torch.ops import bvh_cuda, rt_chunks
    bvh, o, d, t_max = call['args'][:4]
    any_hit, live = call['kw'].get('any_hit', False), call['kw'].get('live')
    res, st = call['res'], call['stats']
    fb = {k: v for k, v in call['launches'].items() if v and k != 'K8'}
    if fb != {fallback_kernel: 1} or call['launches']['K8'] != 1:
        raise AssertionError(f"chunk route ({label}): launches "
                             f"{call['launches']}; want K8 1 and "
                             f"{fallback_kernel} 1 (the fallback)")
    ref = bvh_cuda.launch(bvh, o, d, t_max, any_hit, live)
    alive = (torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
             if live is None else live > 0)
    n_live = int(alive.sum())
    hit_agree = float((res['hit'] == ref['hit'])[alive].float().mean())
    both = res['hit'] & ref['hit'] & alive
    rel = ((res['t'] - ref['t']).abs() / ref['t'])[both]
    rel_max = float(rel.max()) if rel.numel() else 0.0
    if hit_agree < 0.9999 or (not any_hit and rel_max > 1e-5):
        raise AssertionError(f"chunk route ({label}) vs {fallback_kernel}: "
                             f"hit equal on {hit_agree:.6f} of live rays, "
                             f"t within {rel_max:.3g} relative")
    counts, over = st['counts'], st['overflow']
    out = dict(ray_slots=o.shape[0], live_rays=n_live,
               blocks=counts.numel(), pcap=st['pcap'],
               pairs=int(counts.sum()), pairs_walked=int(st['n_walk'].sum()),
               overflow_blocks=int(over.sum()), hit_agree=hit_agree,
               t_rel_max=rel_max,
               route_ms=device_ms(lambda: rt_chunks.traverse_chunks(
                   bvh, o, d, t_max, any_hit=any_hit, live=live), 3),
               default_ms=kernel_ms(lambda: bvh_cuda.launch(
                   bvh, o, d, t_max, any_hit, live), KERNEL_REPS,
                   "traverse_kernel"),
               tables_ms=device_ms(lambda: rt_chunks.chunk_table(bvh), 3))
    phase("chunk route vs default route", input=json.dumps(label),
          mode="any-hit" if any_hit else "closest-hit",
          ray_slots=out['ray_slots'], live_rays=n_live,
          blocks=out['blocks'], pair_capacity=out['pcap'],
          pairs=out['pairs'], pairs_walked=out['pairs_walked'],
          overflowed_blocks=out['overflow_blocks'],
          fallback=f"{fallback_kernel} x1",
          hit_equal_share=f"{hit_agree:.6f}",
          t_max_rel_diff=("not compared (any-hit)" if any_hit
                          else f"{rel_max:.3g}"),
          route_device_ms=f"{out['route_ms']:.4f}",
          default_kernel_same_rays_ms=f"{out['default_ms']:.4f}",
          chunk_table_ms=f"{out['tables_ms']:.4f}")
    return out


def frame_times(render, scene, pairs, fi_np, carry, kw, reps=3):
    """(median device ms of `reps` renders of one frame from the same
    carry, by CUDA events; its device busy ms from the profiler)."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        render(scene, *pairs, fi_np, carry, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    busy, _, _ = profile_frame(render, scene, pairs, fi_np, carry, kw)
    return statistics.median(times), busy


def within_1(a, b) -> tuple[float, int]:
    """(share of pixels within 1 in every channel, the largest diff)."""
    diff = (a.int() - b.int()).abs().amax(-1)
    return float((diff <= 1).float().mean()), int(diff.max())


def slice10(dev, ctx: dict) -> dict:
    """Slice 10's phases, the reference's opt-in ray paths at 1920x1080:
    the chunk route (TR_RT_CHUNKS=1) on the all-on update frame's probe
    rays and their sun rays and on the glass frame's ReSTIR rays (K8
    against chunk_fold_plain, each route call against the default
    route's kernel on its rays, the frames against the default route's,
    no synchronizing call from engine/frame.py); the SAH main tree
    (TR_RT_SAH=1) on the shadowed, map-shadowed, all-on and glass frames
    (K3-SAH on its new rays against the plain walk, the shadow hit mask
    against the complete tree's, the frames against the complete tree's,
    a cached still frame against the uncached one, a snapshot resumed);
    the strip sun rays (TR_SHADOW_GDIR=1) on the shadowed frame (K5
    against plain, the mask at half_angle=0 against the per-pixel
    layout's, and at the real cone); the packed visibility fetch
    (TR_GI_VIS_PACK=1) and the cone layouts on the all-on update frame;
    each path's frame ms and device busy beside its default.  Returns
    the numbers the kernels line adds."""
    import torch

    from toyrenderer_tpu_torch._build import BUILD_DIR
    from toyrenderer_tpu_torch.engine import (
        View, default_frame_inputs, init_carry, make_render_fn)
    from toyrenderer_tpu_torch.engine.snapshot import load_state, save_state
    from toyrenderer_tpu_torch.ops import bvh_cuda, bvh_sah, chunks_cuda
    from toyrenderer_tpu_torch.ops import shadows as shadows_mod
    host, scene, c_pairs, c_kw = (ctx['host'], ctx['scene'], ctx['c_pairs'],
                                  ctx['c_kw'])
    card, g = ctx['card'], ctx['glass']
    a_set, a_kw, s_kw = ctx['a_set'], ctx['a_kw'], ctx['s_kw']
    vol = a_kw['ddgi_volume']
    out = dict(k8={}, routes={}, k3sah={}, k5={}, timing={})
    t10 = time.time()
    fis = pan_inputs(host, 5)

    def timing(path, default_path, row):
        out['timing'][path] = row
        d = out['timing'].get(default_path)
        phase("timing", path=path, card=json.dumps(card),
              median_frame_ms=f"{row[0]:.3f}", device_busy_ms=f"{row[1]:.3f}",
              default_path=default_path,
              default_median_frame_ms=f"{d[0]:.3f}" if d else "-",
              default_device_busy_ms=f"{d[1]:.3f}" if d else "-")

    # 39. the all-on update frame (frame 3; frames 0-2 hold) by the
    #     default route, then by the chunk route: K8 twice (the probe
    #     rays closest-hit, their sun rays any-hit), each route call's
    #     fallback K3-SAH once on the GI tree, the frame within 1 of the
    #     default route's on >= 99.5% of the pixels, no synchronizing
    #     call from engine/frame.py
    a_render = make_render_fn(a_set, **c_kw)
    a_carry = init_carry(scene, a_set, vol)
    for fi in fis[:3]:
        _, a_carry, aux = a_render(scene, *c_pairs, fi, a_carry, **a_kw)
        if aux['ddgi_updated']:
            raise AssertionError("slice 10: an all-on hold frame updated")
    fi3 = fis[3]
    img_d, carry_d, aux_d = a_render(scene, *c_pairs, fi3, a_carry, **a_kw)
    if not aux_d['ddgi_updated']:
        raise AssertionError("slice 10: all-on frame 3 did not update")
    timing("all-on update frame", None,
           frame_times(a_render, scene, c_pairs, fi3, a_carry, a_kw))
    with env(TR_RT_CHUNKS='1'):
        reset_launch_counts()
        with recorded((chunks_cuda,)) as k8_seen, chunk_calls() as calls:
            (img_c, carry_c, _), sync = sync_log(lambda: a_render(
                scene, *c_pairs, fi3, a_carry, **a_kw))
        launches = launch_counts() + [bvh_cuda.launches_by_kernel['K8']]
        timing("all-on update frame, TR_RT_CHUNKS=1", "all-on update frame",
               frame_times(a_render, scene, c_pairs, fi3, a_carry, a_kw))
    if (launches[4] != 2 or launches[9] != 2 or len(calls) != 2
            or [c['kw']['any_hit'] for c in calls] != [False, True]):
        raise AssertionError(f"chunk frame: launches K1-K7, K8 {launches}, "
                             f"route calls {len(calls)}; want K3-SAH 2, K8 2 "
                             "and a closest-hit and an any-hit call")
    mine = [s for s in sync if s.startswith("frame.py:")]
    if mine:
        raise AssertionError(f"chunk frame: synchronizing calls from "
                             f"engine/frame.py {mine}")
    for name, (args, _, _), call in zip(
            ("all-on probe rays, closest-hit",
             "all-on probe-hit sun rays, any-hit"), k8_seen[chunks_cuda],
            calls):
        out['k8'][name] = hold_k8(name, args)
        out['routes'][name] = hold_chunk_route(name, call, 'K3-SAH')
    del k8_seen, calls
    close, max_diff = within_1(img_c, img_d)
    if close < 0.995:
        raise AssertionError(f"chunk frame vs default frame: within 1 on "
                             f"{close:.5f} of pixels")
    irr = (carry_c['ddgi_irradiance'] - carry_d['ddgi_irradiance']).abs()
    phase("chunk frame vs default frame", path="all-on update frame",
          within_1=f"{close:.6f}", max_diff=max_diff, min_share=0.995,
          sync_calls=len(sync), sync_call_sites=json.dumps(sorted(set(sync))),
          from_engine_frame=0,
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7_k8=json.dumps(launches),
          probe_irradiance_diff_max=f"{float(irr.max()):.3g}")
    out['k8_launches'] = launches[9]
    del img_c, carry_c

    # 40. the glass frame (slice 8's chain, its next frame) by the default
    #     route and by the chunk route: ReSTIR's 2,073,600 visibility
    #     rays through K8 (its fallback K3 once), the shadow rays through
    #     K3 as before
    g_args = (g['scene'], g['pairs'], g['fi'], g['carry'], g['kw'])

    def g_frame(kw=None):
        return g['render'](g['scene'], *g['pairs'], g['fi'], g['carry'],
                           **(kw or g['kw']))
    img_gd, _, _ = g_frame()
    timing("glass frame", None, frame_times(
        g['render'], g_args[0], g_args[1], g_args[2], g_args[3], g_args[4]))
    with env(TR_RT_CHUNKS='1'):
        reset_launch_counts()
        with recorded((chunks_cuda,)) as k8_seen, chunk_calls() as calls:
            (img_gc, _, _), sync = sync_log(g_frame)
        launches = launch_counts() + [bvh_cuda.launches_by_kernel['K8']]
        timing("glass frame, TR_RT_CHUNKS=1", "glass frame", frame_times(
            g['render'], *g_args))
    if (launches[2] != 2 or launches[9] != 1 or len(calls) != 1
            or not calls[0]['kw']['any_hit']
            or calls[0]['args'][1].shape[0] != WIDTH * HEIGHT):
        raise AssertionError(f"glass chunk frame: launches K1-K7, K8 "
                             f"{launches}; want K3 2 (shadows, the fallback) "
                             "and K8 1 on every pixel's ReSTIR ray")
    if [s for s in sync if s.startswith("frame.py:")]:
        raise AssertionError(f"glass chunk frame: synchronizing calls {sync}")
    name = "glass ReSTIR visibility rays, any-hit"
    out['k8'][name] = hold_k8(name, k8_seen[chunks_cuda][0][0])
    out['routes'][name] = hold_chunk_route(name, calls[0], 'K3')
    out['k8_launches'] += launches[9]
    del k8_seen, calls
    close, max_diff = within_1(img_gc, img_gd)
    if close < 0.995:
        raise AssertionError(f"glass chunk frame vs default: within 1 on "
                             f"{close:.5f}")
    phase("chunk frame vs default frame", path="glass and emitters",
          within_1=f"{close:.6f}", max_diff=max_diff, min_share=0.995,
          sync_calls=len(sync), from_engine_frame=0,
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7_k8=json.dumps(launches))
    del img_gc
    phase("slice 10 timing", step="chunk route",
          seconds=f"{time.time() - t10:.1f}")

    # 41. the SAH main tree (TR_RT_SAH=1, as the render CLI builds it):
    #     the courtyard's over the RT pair list and the masked pairs, the
    #     glass scene's; each frame of the shadowed, map-shadowed, all-on
    #     and glass paths rendered on both main trees from the same carry
    t = time.time()
    with env(TR_RT_SAH='1'):
        sah = bvh_sah.build_rt_static_auto(
            host, ctx['rpi'], ctx['rpm'], mask_pair_inst=ctx['mk_i'],
            mask_pair_meshlet=ctx['mk_m'], device=dev)
        g_sah = bvh_sah.build_rt_static_auto(g['host'], *g['pairs_np'],
                                             device=dev)
    sah_s = time.time() - t
    if not (isinstance(sah, bvh_sah.RtStaticSah)
            and isinstance(g_sah, bvh_sah.RtStaticSah)):
        raise AssertionError("TR_RT_SAH=1 built no SAH main tree")
    phase("SAH main tree", host_build_s=f"{sah_s:.2f}",
          depth=len(sah.depth_ranges), glass_depth=len(g_sah.depth_ranges),
          triangles=int((sah.payload >= 0).sum()),
          n_mask_pairs=sah.n_mask_pairs,
          masked_kept=int(sah.pair_keep.sum()),
          complete_masked_kept=int(s_kw['rt_static'].pair_keep.sum()))
    if not torch.equal(sah.pair_keep, s_kw['rt_static'].pair_keep):
        raise AssertionError("SAH main tree: its masked keep differs from "
                             "the complete tree's")
    paths = (("shadowed", ctx['s_set'], s_kw, 2),
             ("shadowed-map", ctx['m_set'], s_kw, 2),
             ("all-on", a_set, a_kw, 4))
    for name, st, kw, n in paths:
        render = make_render_fn(st, **c_kw)
        v = vol if st.enable_gi else None
        kw_s = dict(kw, rt_static=sah)
        carry = [init_carry(scene, st, v), init_carry(scene, st, v)]
        shares = []
        for i, fi in enumerate(fis[:n]):
            imgs, seen = [], []
            for r, kw_r in enumerate((kw, kw_s)):
                reset_launch_counts()
                with recorded((bvh_cuda,)) as rec:
                    img, carry[r], aux = render(scene, *c_pairs, fi,
                                                carry[r], **kw_r)
                    torch.cuda.synchronize()
                imgs.append(img)
                seen.append((launch_counts(), rec[bvh_cuda]))
            (lc, rc), (ls, rs) = seen
            traced = lc[2] > 0
            if ls[2] != 0 or ls[4] != lc[2] + lc[4]:
                raise AssertionError(f"SAH main tree, {name} frame {i}: "
                                     f"launches complete {lc}, SAH {ls}")
            shares.append(within_1(imgs[1], imgs[0]))
            if shares[-1][0] < 0.995:
                raise AssertionError(f"SAH main tree, {name} frame {i}: "
                                     f"within 1 on {shares[-1][0]:.5f}")
            if name == "shadowed" and i == 1 and traced:
                (ca, _, cres), (sa, _, sres) = rc[0], rs[0]
                if not (torch.equal(ca[1], sa[1]) and torch.equal(ca[2],
                                                                  sa[2])):
                    raise AssertionError("SAH main tree: the shadow rays "
                                         "differ from the complete tree's")
                live = ca[5] > 0
                agree = float((cres['hit'] == sres['hit'])[live].float()
                              .mean())
                if agree < 0.9999:
                    raise AssertionError(f"SAH main tree: shadow hit equal "
                                         f"on {agree:.6f} of live rays")
                out['k3sah']["SAH main tree shadow rays, any-hit"] = \
                    hold_trace("K3-SAH (main tree)", sa)
                phase("SAH shadow mask vs complete tree", frame=i,
                      live_rays=int(live.sum()),
                      hit_equal_share=f"{agree:.6f}", min_share=0.9999)
        timing(f"{name}, complete main tree", None, frame_times(
            render, scene, c_pairs, fis[n], carry[0], kw))
        timing(f"{name}, SAH main tree", f"{name}, complete main tree",
               frame_times(render, scene, c_pairs, fis[n], carry[1], kw_s))
        phase("SAH frame vs complete frame", path=name, frames=n,
              within_1=json.dumps([round(s, 6) for s, _ in shares]),
              max_diff=json.dumps([m for _, m in shares]), min_share=0.995,
              bit_equal=all(s == 1.0 and m == 0 for s, m in shares))
    # the glass frame: its ReSTIR and shadow rays on the SAH main tree
    g_kw_s = dict(g['kw'], rt_static=g_sah)
    reset_launch_counts()
    with recorded((bvh_cuda,)) as rec:
        img_gs, _, _ = g_frame(g_kw_s)
        torch.cuda.synchronize()
    ls = launch_counts()
    if ls[2] != 0 or ls[4] != 2:
        raise AssertionError(f"SAH glass frame: launches {ls}; want K3-SAH 2")
    for label, (args, _, _) in zip(("glass shadow rays, any-hit",
                                    "glass ReSTIR visibility rays, any-hit"),
                                   rec[bvh_cuda]):
        out['k3sah'][f"SAH main tree {label}"] = hold_trace(
            "K3-SAH (main tree)", args)
    close, max_diff = within_1(img_gs, img_gd)
    if close < 0.995:
        raise AssertionError(f"SAH glass frame: within 1 on {close:.5f}")
    timing("glass frame, SAH main tree", "glass frame", frame_times(
        g['render'], g_args[0], g_args[1], g_args[2], g_args[3], g_kw_s))
    phase("SAH frame vs complete frame", path="glass and emitters",
          within_1=f"{close:.6f}", max_diff=max_diff, min_share=0.995)
    del img_gs, rec

    # a cached still frame (the shadowed path: the SAH tree refit once,
    # into the carry) against the uncached one, and the cached chain's
    # snapshot resumed for 3 frames
    st = ctx['s_set']
    render = make_render_fn(st, **c_kw)
    kw_s = dict(s_kw, rt_static=sah)
    cached = init_carry(scene, st, rt_static=sah, pair_inst=c_pairs[0],
                        pair_meshlet=c_pairs[1],
                        rt_pair_inst=s_kw['rt_pair_inst'],
                        rt_pair_meshlet=s_kw['rt_pair_meshlet'],
                        **ctx['mask_kw'])
    plain = init_carry(scene, st)
    rebuilt = []
    for _ in range(2):
        img_u, plain, _ = render(scene, *c_pairs, fis[0], plain, **kw_s)
        img_k, cached, aux = render(scene, *c_pairs, fis[0], cached, **kw_s)
        rebuilt.append(aux['rebuilt'])
        if not torch.equal(img_u, img_k):
            raise AssertionError("SAH main tree: a cached still frame "
                                 "differs from the uncached one")
    if rebuilt != [['rt'], []] or not isinstance(cached['rt_bvh_cache'],
                                                 bvh_sah.BvhSah):
        raise AssertionError(f"SAH main tree cache: rebuilt {rebuilt}")
    view = View.from_scene(host, WIDTH, HEIGHT)

    def chain(carry, view, n):
        imgs, reb = [], []
        for _ in range(n):
            mats = view.matrices()
            img, carry, aux = render(scene, *c_pairs, default_frame_inputs(
                host, mats), carry, **kw_s)
            view.advance(mats)
            view.rotate_yaw_pitch(SHADOW_YAW, 0.0)
            imgs.append(img)
            reb.append(aux['rebuilt'])
        return imgs, reb, carry
    _, _, cached = chain(cached, view, 2)
    snap = BUILD_DIR / "chip_smoke_sah_snapshot.npz"
    save_state(snap, cached, view)
    view2 = View.from_scene(host, WIDTH, HEIGHT)
    carry2 = load_state(snap, st, view2, device=dev)
    a, ra, _ = chain(cached, view, 3)
    b, rb, _ = chain(carry2, view2, 3)
    if not all(torch.equal(x, y) for x, y in zip(a, b)) or ra != rb:
        raise AssertionError(f"SAH snapshot: resumed frames differ (rebuilt "
                             f"{rb}, uninterrupted {ra})")
    phase("SAH main tree cache and snapshot", path="shadowed",
          still_frame_cached_bit_equal=True, rebuilt=json.dumps(rebuilt),
          snapshot_resumed=3, snapshot_bit_equal=True,
          snapshot_rebuilt=json.dumps(rb),
          npz_mb=f"{snap.stat().st_size / 2 ** 20:.1f}")
    snap.unlink()
    phase("slice 10 timing", step="SAH main tree",
          seconds=f"{time.time() - t10:.1f}")

    # 42. the strip sun rays (TR_SHADOW_GDIR=1) on the shadowed frame:
    #     K5 once (any-hit) held against its plain version and against
    #     K3 on the expanded directions; the frame's shadow-ray setup
    #     traced again at half_angle=0 in both layouts (equal masks) and
    #     at the sun's cone (< 5% of the pixels differ, the reference's
    #     bound, tests/test_shadows.py:185-191)
    s_render = make_render_fn(ctx['s_set'], **c_kw)
    s_carry = init_carry(scene, ctx['s_set'])
    _, s_carry, _ = s_render(scene, *c_pairs, fis[0], s_carry, **s_kw)
    img_sd, _, _ = s_render(scene, *c_pairs, fis[1], s_carry, **s_kw)
    with env(TR_SHADOW_GDIR='1'):
        reset_launch_counts()
        with recorded((bvh_cuda,)) as rec, recorded(
                (shadows_mod,), "trace_shadow_mask") as masks:
            img_sg, _, _ = s_render(scene, *c_pairs, fis[1], s_carry, **s_kw)
            torch.cuda.synchronize()
        ls = launch_counts()
        timing("shadowed, TR_SHADOW_GDIR=1", "shadowed, complete main tree",
               frame_times(s_render, scene, c_pairs, fis[1], s_carry, s_kw))
    if ls[2] != 0 or ls[5] != 1 or len(masks[shadows_mod]) != 1:
        raise AssertionError(f"strip frame: launches {ls}; want K5 1, K3 0")
    k5_args = rec[bvh_cuda][0][0]
    out['k5']["strip sun rays, any-hit"] = hold_trace("K5 (strip sun rays)",
                                                      k5_args)
    out['k5_launches'] = ls[5]
    m_args, m_kw, m_res = masks[shadows_mod][0]
    flat = [shadows_mod.trace_shadow_mask(*m_args, **dict(
        m_kw, half_angle=0.0, gdir=gd)) for gd in (False, True)]
    if not torch.equal(*flat):
        raise AssertionError("strip sun rays at half_angle=0: the mask "
                             "differs from the per-pixel layout's on "
                             f"{int((flat[0] != flat[1]).sum())} pixels")
    per_px = shadows_mod.trace_shadow_mask(*m_args, **dict(m_kw, gdir=False))
    differ = float((per_px != m_res).float().mean())
    if differ >= 0.05:
        raise AssertionError(f"strip sun rays: {differ:.4f} of the mask's "
                             "pixels differ from the per-pixel cone's")
    close, max_diff = within_1(img_sg, img_sd)
    phase("strip sun rays", path="shadowed", frame=1,
          mask_pixels=m_res.numel(), half_angle_0="masks equal",
          cone_mask_differ_share=f"{differ:.5f}", max_share=0.05,
          frame_within_1_of_per_pixel=f"{close:.6f}", max_diff=max_diff)
    del img_sd, img_sg, rec, masks, flat, per_px

    # 43. the all-on update frame with the packed visibility fetch
    #     (printed: the share within 1 of the unpacked frame) and at the
    #     cone layouts 8 and 32 directions, bricks of 128 probes: 256 rays
    #     a probe are whole cones, so each equals the default layout's
    for name, sw in (("TR_GI_VIS_PACK=1", dict(TR_GI_VIS_PACK='1')),
                     ("TR_CONE_DIRS=8", dict(TR_CONE_DIRS='8')),
                     ("TR_CONE_DIRS=32", dict(TR_CONE_DIRS='32')),
                     ("TR_CONE_BRICK=128", dict(TR_CONE_BRICK='128'))):
        with env(**sw):
            reset_launch_counts()
            img, carry, _ = a_render(scene, *c_pairs, fi3, a_carry, **a_kw)
            ls = launch_counts()
            row = frame_times(a_render, scene, c_pairs, fi3, a_carry, a_kw)
        close, max_diff = within_1(img, img_d)
        same = bool(torch.equal(img, img_d) and torch.equal(
            carry['ddgi_irradiance'], carry_d['ddgi_irradiance']))
        if "CONE" in name and not same:
            raise AssertionError(f"{name}: the update frame differs from "
                                 "the default layout's")
        if ls[4] != 2:
            raise AssertionError(f"{name}: launches {ls}; want K3-SAH 2")
        timing(f"all-on update frame, {name}", "all-on update frame", row)
        phase("layout frame vs default frame", path=f"all-on, {name}",
              bit_equal=same, within_1=f"{close:.6f}", max_diff=max_diff,
              gate=("bit-equal" if "CONE" in name else "printed"))
    phase("slice 10 timing", step="all", seconds=f"{time.time() - t10:.1f}")
    return out


# ===== slice 11: the multi-device frame, the last tools =====================
SP = 4                           # the sharded raster's bands (68 tile rows)
VIEWS = 2                        # the view batch's views, on a (2, 2) mesh
SHELL_PSNR = 30.0                # /frame.jpg against the frame it encodes


@contextlib.contextmanager
def ray_calls():
    """While open, each traverse_auto call of the frame's shadow and
    probe traces (ops/shadows.py, ops/ddgi.py import it by name) appends
    (the calling module's name, its positional arguments, its keyword
    arguments) to the yielded list; the calls run as in any frame."""
    from toyrenderer_tpu_torch.ops import bvh_cuda, ddgi, shadows
    real = bvh_cuda.traverse_auto
    calls = []

    def spy(module):
        def call(*args, **kwargs):
            calls.append((module, args, kwargs))
            return real(*args, **kwargs)
        return call
    ddgi.traverse_auto, shadows.traverse_auto = spy('ddgi'), spy('shadows')
    try:
        yield calls
    finally:
        ddgi.traverse_auto = shadows.traverse_auto = real


@contextlib.contextmanager
def sp_calls():
    """While open, each parallel.sp_raster.raster_frame_sp call appends
    (args, kwargs, result) to the yielded list."""
    from toyrenderer_tpu_torch.parallel import sp_raster
    real = sp_raster.raster_frame_sp
    calls = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out
    sp_raster.raster_frame_sp = spy
    try:
        yield calls
    finally:
        sp_raster.raster_frame_sp = real


def counted(fn):
    """(fn()'s result, the launches K1 K2 K3 K4 K3-SAH K5 K3-seeded K6 K7
    K8 it made): every count set to 0 just before, read just after."""
    import torch
    from toyrenderer_tpu_torch.ops import bvh_cuda
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts() + [bvh_cuda.launches_by_kernel['K8']]


LAUNCH_NAMES = ('K1', 'K2', 'K3', 'K4', 'K3-SAH', 'K5', 'K3-seeded', 'K6',
                'K7', 'K8')


def hold_band(name, inp) -> dict:
    """One band's K1 launch against the plain fill on its inputs (ids and
    depth bit-equal, planes as compare_fill holds them); its ms by CUDA
    events, the plain version's and the bound.  Prints a phase line."""
    from toyrenderer_tpu_torch.ops import raster_cuda
    got = raster_cuda.launch(inp)
    want = raster_cuda.fill_resolve_plain(inp)
    won = want[1] != raster_cuda.init_planes(inp)[1]
    err = compare_fill(got, want, won)
    st = dict(err=err, ms=cuda_ms(lambda: raster_cuda.launch(inp),
                                  KERNEL_REPS),
              plain_ms=cuda_ms(lambda: raster_cuda.fill_resolve_plain(inp),
                               1),
              bound=fill_bound_ms(inp, want[1], won))
    phase("K1 vs plain", input=json.dumps(name), won_px=int(won.sum()),
          pairs_walked=int(inp.lay['counts_eff'].sum()),
          band_rows=inp.cfg.tiles_y, ids="equal", depth="bit-equal",
          planes_max_abs=f"{err:.3g}", ms=f"{st['ms']:.4f}",
          plain_ms=f"{st['plain_ms']:.1f}", bound_ms=f"{st['bound'][0]:.4f}",
          bound_by=st['bound'][1])
    return st


def sharded_frame(label, render, scene, pairs, fi, carry, kw, meshes,
                  plain=None, traced=False) -> dict:
    """One frame rendered on each mesh of `meshes` ({name: Mesh}) and, for
    the glass frame, without a mesh (`plain`: True), each against the
    1-device mesh's frame: ids on >= 99.9% of the pixels, depth within
    rtol 1e-5 / atol 1e-6 on >= 99.9% of those (the sharded raster's
    bar, a band's edge constants round twice more), no drop on any.  The
    image within 1 on >= 99.9% of the pixels; a frame whose passes trace
    rays from the depth or carry history (`traced`: RT shadows, GTAO,
    ReSTIR, TAA) within 2 on >= 99.5%, the reference's own bar for its
    sharded traced frame (tests/test_parallel.py:224-226): a ray from a
    depth that moved by the band's rounding can flip, and the denoiser's
    blur spreads a flipped ray over ~30 pixels (both shares printed).
    The launches of each mesh frame counted.  Returns {name: (image, aux,
    carry, launches)} and the frame without a mesh as 'none'."""
    import torch
    out = {}
    for name, mesh in meshes.items():
        (img, carry2, aux), n = counted(lambda: render(
            scene, *pairs, fi, carry, sp_mesh=(mesh, 'sp'), **kw))
        out[name] = (img, aux, carry2, n)
    if plain:
        (img, carry2, aux), n = counted(lambda: render(
            scene, *pairs, fi, carry, **kw))
        out['none'] = (img, aux, carry2, n)
    ref = out['x1']
    for name, (img, aux, _, n) in out.items():
        drops = drops_of(aux)
        if any(drops):
            raise AssertionError(f"{label} on {name}: drops {drops}")
        if n[0] == 0:
            raise AssertionError(f"{label} on {name}: no K1 launch")
        agree = aux['tri_id'] == ref[1]['tri_id']
        ids = float(agree.float().mean())
        depth = float(torch.isclose(aux['depth'][agree],
                                    ref[1]['depth'][agree], rtol=1e-5,
                                    atol=1e-6).float().mean())
        close, worst = within_1(img, ref[0])
        close2 = float(((img.int() - ref[0].int()).abs().amax(-1) <= 2)
                       .float().mean())
        ok = close2 >= 0.995 if traced else close >= 0.999
        if ids < 0.999 or depth < 0.999 or not ok:
            raise AssertionError(
                f"{label}: {name} vs x1: ids {ids:.5f}, depth {depth:.5f}, "
                f"within 1 on {close:.5f}, within 2 on {close2:.5f}")
        # the traced passes' own agreement (the shadow mask, AO)
        passes = {f"{k}_within_1e3": "%.6f" % float(
            ((aux[k] - ref[1][k]).abs() <= 1e-3).float().mean())
            for k in ('shadow', 'ao') if k in aux}
        phase("sharded frame", path=json.dumps(label), mesh=name,
              ids_agree=f"{ids:.6f}", depth_within_1e5=f"{depth:.6f}",
              **passes,
              within_1_of_x1=f"{close:.6f}", within_2_of_x1=f"{close2:.6f}",
              gate="within 2 on 99.5%" if traced else "within 1 on 99.9%",
              max_diff=worst,
              launches=json.dumps(dict(zip(LAUNCH_NAMES, n))), drops=drops)
    return out


def hold_sharded_rays(label, args, kw, mesh, kernel) -> dict:
    """A recorded traverse_auto call again with sp_mesh = (mesh, 'sp')
    against the call without: every output bit-equal; the sharded call's
    launches of `kernel` (one a slice, and a route's fallback in each
    slice) counted; both timed by CUDA events.  Prints a phase line."""
    import torch
    from toyrenderer_tpu_torch.ops import bvh_cuda
    kw = {k: v for k, v in kw.items() if k != 'sp_mesh'}
    want, _ = counted(lambda: bvh_cuda.traverse_auto(*args, **kw))
    got, n = counted(lambda: bvh_cuda.traverse_auto(
        *args, sp_mesh=(mesh, 'sp'), **kw))
    for k in want:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"sharded rays ({label}): {k} differs at "
                                 f"{int((got[k] != want[k]).sum())} rays")
    launches = n[LAUNCH_NAMES.index(kernel)]
    if launches < mesh.shape['sp']:
        raise AssertionError(f"sharded rays ({label}): {kernel} launched "
                             f"{launches} times on {mesh.shape['sp']} "
                             "slices")
    st = dict(launches=launches, all_launches=dict(zip(LAUNCH_NAMES, n)),
              rays=int(args[1].shape[0]),
              ms=cuda_ms(lambda: bvh_cuda.traverse_auto(
                  *args, sp_mesh=(mesh, 'sp'), **kw), 3),
              unsharded_ms=cuda_ms(lambda: bvh_cuda.traverse_auto(
                  *args, **kw), 3))
    phase("sharded rays", input=json.dumps(label), kernel=kernel,
          rays=st['rays'], slices=mesh.shape['sp'], outputs="bit-equal",
          launches=json.dumps(st['all_launches']), ms=f"{st['ms']:.4f}",
          unsharded_ms=f"{st['unsharded_ms']:.4f}")
    return st


def psnr(a, b) -> float:
    import numpy as np
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(err, 1e-12)))


def slice11(dev, ctx: dict) -> dict:
    """Slice 11's phases: the multi-device frame and the last tools.
    Meshes of SP repeated cards (and, with more than one card, of
    distinct ones): the culled courtyard's early fill through
    parallel.sp_raster.raster_frame_sp against the single K1 fill on the
    same setup (ids on >= 99.9%, depth where they agree, drops 0), each
    band's K1 launch bit-equal to the plain fill; the culled, all-on
    update and glass frames on each mesh against the 1-device mesh
    (within 1 on >= 99.9%), the glass frame also against the frame
    without a mesh (the peel bound reaches the bands); the frame's
    shadow rays (K3), probe rays in the gdir layout (K5), through the
    pair route (K6) and the chunk route (K8) sharded, bit-equal to the
    unsharded call; VIEWS views on a ('dp', 'sp') = (2, 2) mesh, each
    within 1 of its view alone; fillbench, rtbench --scene stress and
    the shell on Cornell (/frame.jpg and /stats.json over localhost).
    Returns the numbers the kernels line adds."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from toyrenderer_tpu_torch.engine import init_carry, make_render_fn
    from toyrenderer_tpu_torch.ops import raster_cuda
    from toyrenderer_tpu_torch.parallel import (
        Mesh, make_sp_frame_renderer, make_view_batch_renderer, sp_raster)
    from toyrenderer_tpu_torch.scene.jpeg import decode_jpeg
    from toyrenderer_tpu_torch.tools import fillbench, rtbench, shell
    host, scene, c_pairs, c_kw = (ctx['host'], ctx['scene'], ctx['c_pairs'],
                                  ctx['c_kw'])
    c_set, mask_kw, card, g = (ctx['c_set'], ctx['mask_kw'], ctx['card'],
                               ctx['glass'])
    a_set, a_kw = ctx['a_set'], ctx['a_kw']
    t11 = time.time()
    out = dict(bands={}, rays={}, launches=dict.fromkeys(LAUNCH_NAMES, 0),
               timing={})
    meshes = {'x1': Mesh([dev], ('sp',)),
              f'x{SP} repeated': Mesh([dev] * SP, ('sp',))}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        k = 4 if n_cards >= 4 else 2
        meshes[f'x{k} distinct'] = Mesh(
            [torch.device('cuda', i) for i in range(k)], ('sp',))
    phase("meshes", cards=n_cards, ran=json.dumps(
        {k: [str(d) for d in m.devices.reshape(-1)]
         for k, m in meshes.items()}))
    main = meshes[f'x{SP} repeated']

    def add(n):
        for k, v in zip(LAUNCH_NAMES, n):
            out['launches'][k] += v

    def timing(path, render, scene_, pairs, fi, carry, kw):
        """The frame's device busy on the main mesh beside the frame
        without a mesh (profiled), and its CUDA-event ms."""
        row = {}
        for name, extra in (('mesh', dict(sp_mesh=(main, 'sp'))),
                            ('none', {})):
            full = dict(kw, **extra)
            busy, _, _ = profile_frame(render, scene_, pairs, fi, carry, full)
            ms = cuda_ms(lambda: render(scene_, *pairs, fi, carry, **full), 1)
            row[name] = (busy, ms)
        out['timing'][path] = row
        phase("sharded frame timing", path=json.dumps(path),
              card=json.dumps(card),
              mesh=f"x{SP} repeated", busy_ms=f"{row['mesh'][0]:.3f}",
              event_ms=f"{row['mesh'][1]:.3f}",
              no_mesh_busy_ms=f"{row['none'][0]:.3f}",
              no_mesh_event_ms=f"{row['none'][1]:.3f}")

    # 46. the culled courtyard frame (frame 0: the early phase draws the
    #     whole 60% list) through make_sp_frame_renderer on each mesh; its
    #     early fill's setup again through raster_frame_sp and the single
    #     K1 fill
    fis = pan_inputs(host, 4)
    c_render = make_render_fn(c_set, **c_kw)
    sp_render = {name: make_sp_frame_renderer(m, c_set, **c_kw)
                 for name, m in meshes.items()}

    def c_frame(scene_, a, b, fi, carry, sp_mesh=None, **kw):
        if sp_mesh is None:
            return c_render(scene_, a, b, fi, carry, **kw)
        name = next(k for k, m in meshes.items() if m is sp_mesh[0])
        return sp_render[name](scene_, a, b, fi, carry, **kw)
    c_carry = init_carry(scene, c_set)
    with sp_calls() as calls:
        culled = sharded_frame("culled", c_frame, scene, c_pairs, fis[0],
                               c_carry, mask_kw, meshes)
    add(culled[f'x{SP} repeated'][3])
    early = next(c for c in calls if c[0][3] is main)
    setup, records, cfg = early[0][:3]
    bins = raster_cuda.bin_pairs_with_budget(setup, cfg)
    (z1, id1, _), n1 = counted(lambda: raster_cuda.fill_resolve_stream(
        setup, records, bins, cfg, padded_io=True))
    with recorded((raster_cuda,)) as seen:
        (z4, id4, _, stats), n4 = counted(lambda: sp_raster.raster_frame_sp(
            setup, records, cfg, main, 'sp', padded_io=True))
    add(n4)
    z1c, id1c = raster_cuda.crop_image(z1, cfg), raster_cuda.crop_image(
        id1, cfg)
    z4c, id4c = raster_cuda.crop_image(z4, cfg), raster_cuda.crop_image(
        id4, cfg)
    # depth where the ids agree: within tests/test_parallel.py's bounds
    # (rtol 1e-5, atol 1e-6) on >= 99.9% of those pixels, as the ids: a
    # band's edge constants take two more f32 roundings, which move the
    # depth of a small, far triangle by more (the largest is printed)
    agree = id1c == id4c
    share = float(agree.float().mean())
    z_close = torch.isclose(z4c[agree], z1c[agree], rtol=1e-5, atol=1e-6)
    depth_share = float(z_close.float().mean())
    won = agree & (id1c >= 0)
    z_rel = float(((z4c - z1c).abs() / z1c.abs().clamp(min=1e-30))[won]
                  .max()) if bool(won.any()) else 0.0
    drops = int(stats['dropped'])
    if (share < 0.999 or depth_share < 0.999 or drops or n4[0] != SP
            or n1[0] != 1):
        raise AssertionError(f"sharded raster: ids agree on {share:.5f}, "
                             f"depth on {depth_share:.5f} of those, drops "
                             f"{drops}, K1 launches {n4[0]} (single "
                             f"{n1[0]})")
    single_inp = raster_cuda.fill_inputs(setup, records, bins, cfg,
                                         padded_io=True)
    single_ms = cuda_ms(lambda: raster_cuda.launch(single_inp), KERNEL_REPS)
    band_ms = []
    for i, (args, _, _) in enumerate(seen[raster_cuda]):
        st = hold_band(f"culled early fill, band {i} of {SP}", args[0])
        out['bands'][f"culled early fill, band {i} of {SP}"] = st
        band_ms.append(st['ms'])
    phase("sharded raster", path="culled, early fill", bands=SP,
          ids_agree=f"{share:.6f}",
          depth_within_1e5_of_agreeing=f"{depth_share:.6f}",
          depth_max_rel_diff=f"{z_rel:.3g}",
          drops=drops, binned_pairs=int(stats['binned_pairs']),
          single_binned_pairs=int(bins['counts'].sum()),
          band_pairs=json.dumps([int(a[0].lay['counts_eff'].sum())
                                 for a, _, _ in seen[raster_cuda]]),
          band_ms=json.dumps([round(m, 4) for m in band_ms]),
          band_ms_sum=f"{sum(band_ms):.4f}", single_ms=f"{single_ms:.4f}",
          card=json.dumps(card))
    out['single_k1_ms'], out['band_ms'] = single_ms, band_ms
    del seen, calls, early
    timing("culled", c_render, scene, c_pairs, fis[0], c_carry, mask_kw)
    phase("slice 11 timing", step="sharded raster, culled frame",
          seconds=f"{time.time() - t11:.1f}")

    # 47. the all-on update frame (frames 0-2 hold) on each mesh; its
    #     shadow and probe rays recorded from the frame without a mesh,
    #     then the same frame under TR_GI_GDIR=1, TR_GI_PAIRS=1 and
    #     TR_RT_CHUNKS=1 for the K5, K6 and K8 calls
    vol = a_kw['ddgi_volume']
    a_render = make_render_fn(a_set, **c_kw)
    a_carry = init_carry(scene, a_set, vol)
    for fi in fis[:3]:
        _, a_carry, _ = a_render(scene, *c_pairs, fi, a_carry, **a_kw)
    allon = sharded_frame("all-on update frame", a_render, scene, c_pairs,
                          fis[3], a_carry, a_kw, meshes, traced=True)
    add(allon[f'x{SP} repeated'][3])
    if not allon['x1'][1]['ddgi_updated']:
        raise AssertionError("slice 11: all-on frame 3 did not update")
    # the probe update sees no raster: its rays, sharded, are the same
    for name in meshes:
        if not torch.equal(allon[name][2]['ddgi_irradiance'],
                           allon['x1'][2]['ddgi_irradiance']):
            raise AssertionError(f"all-on update frame on {name}: probe "
                                 "irradiance differs from x1's")
    phase("sharded probes", path="all-on update frame",
          irradiance="bit-equal on every mesh")
    with ray_calls() as rc:
        a_render(scene, *c_pairs, fis[3], a_carry, **a_kw)
    shadow = next(c[1:] for c in rc if c[0] == 'shadows')
    for label, switch, kernel, pick in (
            ("all-on probe rays, TR_GI_GDIR=1", 'TR_GI_GDIR', 'K5',
             lambda kw: kw.get('group_dirs') is not None),
            ("all-on probe rays, TR_GI_PAIRS=1", 'TR_GI_PAIRS', 'K6',
             lambda kw: kw.get('pairs')),
            ("all-on probe rays, TR_RT_CHUNKS=1", 'TR_RT_CHUNKS', 'K8',
             lambda kw: kw.get('chunked'))):
        with env(**{switch: '1'}), ray_calls() as rc2:
            a_render(scene, *c_pairs, fis[3], a_carry, **a_kw)
            call = next(c[1:] for c in rc2 if c[0] == 'ddgi'
                        and pick(c[2]) and not c[2].get('any_hit'))
            st = hold_sharded_rays(label, *call, main, kernel)
        out['rays'][label] = st
        add(list(st['all_launches'].values()))
    st = hold_sharded_rays("shadow rays (all-on update frame)", *shadow,
                           main, 'K3')
    out['rays']["shadow rays"] = st
    add(list(st['all_launches'].values()))
    del rc
    timing("all-on update frame", a_render, scene, c_pairs, fis[3], a_carry,
           a_kw)
    phase("slice 11 timing", step="all-on frame and sharded rays",
          seconds=f"{time.time() - t11:.1f}")

    # 48. the glass frame (2 OIT layers) on each mesh and without a mesh:
    #     the mesh frames match the frame without one (the peel bound
    #     reaches every band)
    glass = sharded_frame("glass and emitters", g['render'], g['scene'],
                          g['pairs'], g['fi'], g['carry'], g['kw'], meshes,
                          plain=True, traced=True)
    add(glass[f'x{SP} repeated'][3])
    for name in meshes:
        close, worst = within_1(glass[name][0], glass['none'][0])
        close2 = float(((glass[name][0].int() - glass['none'][0].int())
                        .abs().amax(-1) <= 2).float().mean())
        if close2 < 0.995:
            raise AssertionError(f"glass frame on {name} vs no mesh: "
                                 f"within 2 on {close2:.5f}")
        phase("glass frame on a mesh vs no mesh", mesh=name,
              within_1=f"{close:.6f}", within_2=f"{close2:.6f}",
              max_diff=worst,
              oit_layers=2, trans_binned_pairs=int(
                  glass[name][1]['raster_trans_binned_pairs']))
    timing("glass and emitters", g['render'], g['scene'], g['pairs'],
           g['fi'], g['carry'], g['kw'])

    # 49. the view batch: VIEWS culled views on a ('dp', 'sp') = (2, 2)
    #     mesh, each against its view alone
    grid = Mesh(np.asarray([[dev, dev], [dev, dev]], object), ('dp', 'sp'))
    views = [fis[0], fis[3]]
    batch = make_view_batch_renderer(grid, c_set, **c_kw)
    (imgs, _), n = counted(lambda: batch(
        scene, *c_pairs, views, [init_carry(scene, c_set) for _ in views],
        **mask_kw))
    add(n)
    for k, fi in enumerate(views):
        alone, _, _ = c_render(scene, *c_pairs, fi, init_carry(scene, c_set),
                               **mask_kw)
        close, worst = within_1(imgs[k], alone)
        if close < 0.999:
            raise AssertionError(f"view batch view {k}: within 1 on "
                                 f"{close:.5f}")
        phase("view batch", view=k, mesh="dp 2 x sp 2",
              within_1_of_alone=f"{close:.6f}", max_diff=worst,
              launches=json.dumps(dict(zip(LAUNCH_NAMES, n))))
    phase("slice 11 timing", step="glass frame and view batch",
          seconds=f"{time.time() - t11:.1f}")

    # 50. the tools: fillbench (courtyard, 1080p), rtbench --scene stress,
    #     the shell on Cornell with its frames fetched over localhost
    fb = fillbench.run(["--reps", "3"])
    if any(fb['dropped'].values()) or not 0 < fb['coverage'] <= 1:
        raise AssertionError(f"fillbench: {fb}")
    phase("fillbench", line=json.dumps(fb))
    rows = rtbench.run(["--scene", "stress", "--reps", "3"])
    phase("rtbench stress", card=json.dumps(card), rows=json.dumps(
        {r['name']: round(r['mrays_s'], 2) for r in rows}))
    got = {}

    def fetch(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()

    def on_frame(n, image):
        if n == 3:
            got['jpg'], got['stats'] = (fetch(got['port'], "/frame.jpg"),
                                        fetch(got['port'], "/stats.json"))
            got['image'] = image
    res = {}
    th = threading.Thread(target=lambda: res.update(rc=shell.main(
        ["--scene", str(ROOT / "resources" / "cornell.gltf"), "--port", "0",
         "--max-frames", "3"], on_ready=lambda p: got.update(port=p),
        on_frame=on_frame)))
    th.start()
    th.join(timeout=300)
    if th.is_alive() or res.get('rc') != 0 or 'jpg' not in got:
        raise AssertionError(f"shell: rc {res.get('rc')}, fetched "
                             f"{sorted(got)}")
    (s1, jpg), (s2, stats) = got['jpg'], got['stats']
    dec = decode_jpeg(jpg)[..., :3]
    quality = psnr(dec, got['image'])
    stats = json.loads(stats)
    if s1 != 200 or s2 != 200 or quality < SHELL_PSNR or dec.shape != \
            got['image'].shape:
        raise AssertionError(f"shell: status {s1} {s2}, PSNR {quality:.2f}")
    phase("shell", scene="cornell", frames=3, jpeg_bytes=len(jpg),
          psnr_db=f"{quality:.2f}", psnr_floor=SHELL_PSNR,
          stats=json.dumps(stats['stats']))
    phase("slice 11 timing", step="all", seconds=f"{time.time() - t11:.1f}")
    return out


JPEG_TEXTURES = (3, 5, 8, 10)    # the courtyard's base colours of stone0,
#                                  stone2, brick and wood (opaque)
JPEG_DECODE_REPS = 3             # decodes of each stream: the best timed
JPEG_KINDS = {"baseline": b"\xff\xc0", "progressive": b"\xff\xc2",
              "arithmetic": b"\xff\xc9",
              "progressive arithmetic": b"\xff\xca"}


def slice12(dev, ctx: dict) -> dict:
    """Slice 12's phase, the JPEG decoder's every kind: 4 of the
    courtyard's base-colour textures encoded by scene/jpeg_encode.py,
    each transcoded by tests/jpeg_streams.py to progressive Huffman,
    sequential arithmetic and progressive arithmetic and decoded on the
    host, every stream bit-equal to the baseline decode; the decoders'
    host seconds per megapixel (the best of 3 decodes of each stream)
    beside the card's name and power limit;
    the culled courtyard frame at 1920x1080 with the progressive
    textures in place, bit-equal to the frame with the baseline ones,
    and unlike the PNG-textured frame (the textures are sampled).
    Returns the frames' launches."""
    import numpy as np
    import torch

    from toyrenderer_tpu_torch.engine import init_carry, make_render_fn
    from toyrenderer_tpu_torch.scene import textures as TX
    from toyrenderer_tpu_torch.scene.gltf import load_gltf
    from toyrenderer_tpu_torch.scene.jpeg import (
        decode_jpeg, read_coefficients)
    from toyrenderer_tpu_torch.scene.jpeg_encode import encode_jpeg
    from toyrenderer_tpu_torch.scene.png import decode_png
    sys.path.insert(0, str(ROOT / "tests"))
    import jpeg_streams
    host, scene, c_pairs, c_kw, c_set = (ctx['host'], ctx['scene'],
                                         ctx['c_pairs'], ctx['c_kw'],
                                         ctx['c_set'])
    mask_kw, fi_np, card = ctx['mask_kw'], ctx['fi_np'], ctx['card']
    t12 = time.time()
    doc = load_gltf(SCENE)
    streams = {k: {} for k in JPEG_KINDS}
    seconds = dict.fromkeys(JPEG_KINDS, 0.0)
    megapixels = 0.0
    for ti in JPEG_TEXTURES:
        rgb = np.ascontiguousarray(decode_png(doc.textures[ti].image_bytes)
                                   [..., :3])
        base = encode_jpeg(rgb)
        co = read_coefficients(base)
        streams["baseline"][ti] = base
        streams["progressive"][ti] = jpeg_streams.write(
            co, progression="default")
        streams["arithmetic"][ti] = jpeg_streams.write(co, "arithmetic")
        streams["progressive arithmetic"][ti] = jpeg_streams.write(
            co, "arithmetic", "default")
        megapixels += rgb.shape[0] * rgb.shape[1] / 1e6
        want = None
        for kind, sof in JPEG_KINDS.items():
            raw = streams[kind][ti]
            if sof not in raw:
                raise AssertionError(f"texture {ti}: the {kind} stream has "
                                     f"no {sof.hex()} frame")
            times = []
            for _ in range(JPEG_DECODE_REPS):
                t = time.perf_counter()
                img = decode_jpeg(raw)
                times.append(time.perf_counter() - t)
            seconds[kind] += min(times)
            if want is None:
                want = img
            elif not np.array_equal(img, want):
                raise AssertionError(
                    f"texture {ti}: the {kind} stream decodes to "
                    f"{int((img != want).any(-1).sum())} pixels unlike the "
                    "baseline's")
    phase("jpeg decode", card=json.dumps(card), textures=len(JPEG_TEXTURES),
          megapixels=f"{megapixels:.4f}", bit_equal=True,
          host_s_per_megapixel=json.dumps(
              {k: round(v / megapixels, 4) for k, v in seconds.items()}),
          stream_bytes=json.dumps({k: sum(len(r) for r in v.values())
                                   for k, v in streams.items()}))

    def textured(kind):
        """The courtyard's device scene with the kind's streams in place
        of the 4 textures (the port's loader decodes every texture)."""
        d = dataclasses.replace(doc, textures=list(doc.textures))
        for ti in JPEG_TEXTURES:
            d.textures[ti] = dataclasses.replace(
                d.textures[ti], image_bytes=streams[kind][ti])
        h = dataclasses.replace(host)
        atlas = TX.build_atlas(d)
        h.attach_atlas(atlas)
        return atlas.texels, h.to_device()
    render = make_render_fn(c_set, **c_kw)
    frames, launches = {}, dict.fromkeys(LAUNCH_NAMES, 0)
    texels = {}
    for kind in ("baseline", "progressive", None):
        if kind is None:
            sc = scene
        else:
            texels[kind], sc = textured(kind)
        (img, _, aux), n = counted(lambda: render(
            sc, *c_pairs, fi_np, init_carry(sc, c_set), **mask_kw))
        for k, v in zip(LAUNCH_NAMES, n):
            launches[k] += v
        if (n[0] < 1 or n[1] < 1 or drops_of(aux) != (0, 0)
                or not bool(torch.isfinite(aux['hdr']).all())):
            raise AssertionError(f"jpeg frame ({kind}): launches {n}, "
                                 f"drops {drops_of(aux)}")
        frames[kind] = (img, aux['hdr'], n)
    if not np.array_equal(texels["baseline"], texels["progressive"]):
        raise AssertionError("jpeg frame: the atlases differ")
    (ib, hb, nb), (ip, hp, np_) = frames["baseline"], frames["progressive"]
    if not (torch.equal(ib, ip) and torch.equal(hb, hp)) or nb != np_:
        raise AssertionError(
            f"jpeg frame: progressive textures give "
            f"{int((ib != ip).any(-1).sum())} pixels unlike the baseline's "
            f"(launches {np_} against {nb})")
    png_px = int((ib != frames[None][0]).any(-1).sum())
    if png_px == 0:
        raise AssertionError("jpeg frame: equal to the PNG-textured frame "
                             "(the textures are not sampled)")
    phase("jpeg frame", path="culled", size=f"{WIDTH}x{HEIGHT}",
          textures=json.dumps(list(JPEG_TEXTURES)), bit_equal=True,
          launches_k1=nb[0], launches_k2=nb[1],
          pixels_unlike_png_frame=png_px)
    phase("slice 12 timing", step="all", seconds=f"{time.time() - t12:.1f}")
    return dict(launches=launches)


def main() -> int:
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "toyrenderer_tpu_torch").is_dir() or not SCENE.exists():
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from toyrenderer_tpu_torch._build import BUILD_DIR
    from toyrenderer_tpu_torch.engine import (
        RenderSettings, View, default_frame_inputs, init_carry,
        make_render_fn)
    from toyrenderer_tpu_torch.engine.capacity import (
        culled_pair_counts, sized_culled_settings, sized_raster_config,
        sized_settings, tile_pair_counts)
    from toyrenderer_tpu_torch.ops import bvh as bvh_mod
    from toyrenderer_tpu_torch.ops import culling as cull_mod
    from toyrenderer_tpu_torch.ops import geometry as geo_mod
    from toyrenderer_tpu_torch.ops import raster as raster_mod
    from toyrenderer_tpu_torch.ops import (
        bvh_cuda, bvh_sah, chunks_cuda, ddgi, dense_cuda, pairs_cuda,
        peel_cuda, raster_cuda, rt_pairs, warp_cuda)
    from toyrenderer_tpu_torch.ops.gbuffer import pack_resolve_records
    from toyrenderer_tpu_torch.scene import load_scene
    from toyrenderer_tpu_torch.scene.gltf import (
        ALPHA_BLEND, ALPHA_MASK, load_gltf)
    from toyrenderer_tpu_torch.scene.png import decode_png
    from toyrenderer_tpu_torch.tools import rtbench
    from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())

    # 1. the card -----------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    phase("card", torch=torch.__version__, cuda=torch.version.cuda,
          name=torch.cuda.get_device_name(0))

    # 2. kernel builds: one nvcc per source, started together ---------------
    t = time.time()
    libs = {"fill_resolve": raster_cuda, "fill_peel": peel_cuda,
            "traverse": bvh_cuda, "warp": warp_cuda, "pairs": pairs_cuda,
            "fill_dense": dense_cuda, "chunks": chunks_cuda}
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(m.kernel_library) for m in libs.values()]:
            f.result()
    ptxas = {}
    for name in libs:
        log = BUILD_DIR / f"{name}.so.log"
        ptxas[name] = " | ".join(
            ln.strip() for ln in (log.read_text().splitlines()
                                  if log.exists() else [])
            if "registers" in ln or "spill" in ln)
    phase("build", kernels=",".join(f"{k}.cu" for k in libs),
          seconds=f"{time.time() - t:.1f}", ptxas=json.dumps(ptxas))

    # 3. scene build with the port's loader ---------------------------------
    t = time.time()
    host = load_scene(SCENE, use_cache=False)
    build_s = time.time() - t
    doc = load_gltf(SCENE)
    raws = [tx.image_bytes for tx in doc.textures]
    decoded = sum(decode_png(r).shape[-1] == 4 for r in raws
                  if r is not None)
    if decoded != len(raws):
        raise AssertionError(f"decoded {decoded} of {len(raws)} textures")
    scene = host.to_device()
    mk_i, mk_m = geo_mod.static_meshlet_pairs(host, 'mask')
    pi, pm = geo_mod.static_meshlet_pairs(host, 'not_mask')
    tris = int(host.meshlet_tri_count[pm].sum()
               + host.meshlet_tri_count[mk_m].sum())
    phase("scene", seconds=f"{build_s:.2f}", triangles=tris,
          instances=host.num_instances, opaque_pairs=len(pi),
          masked_pairs=len(mk_i), textures=f"{decoded}/{len(raws)}")
    pair_inst, pair_meshlet = (torch.from_numpy(a).to(dev) for a in (pi, pm))
    mask_inst, mask_meshlet = (torch.from_numpy(a).to(dev)
                               for a in (mk_i, mk_m))
    mask_kw = dict(mask_pair_inst=mask_inst, mask_pair_meshlet=mask_meshlet)

    # ======================= the default frame (slice 1) ====================
    # the view's binned content sizes the per-tile list capacity and, for
    # each set, the span-class caps (engine/capacity.py): the unculled
    # LOD0 view overflows the default K in its densest tiles, and its
    # masked set the default `rest` class cap
    view = View.from_scene(host, WIDTH, HEIGHT)
    fi_np = default_frame_inputs(host, view.matrices())
    fi = frame_inputs_from_numpy(fi_np, dev)
    default = RenderSettings(width=WIDTH, height=HEIGHT,
                             manual_exposure=0.25)
    counts = tile_pair_counts(scene, fi, default, {
        "opaque": (pair_inst, pair_meshlet),
        "masked": (mask_inst, mask_meshlet)})
    settings = sized_settings(default, counts)
    cfgs = {k: sized_raster_config(settings, {k: v})
            for k, v in counts.items()}
    cfg_kw = dict(raster_cfg=cfgs["opaque"], mask_raster_cfg=cfgs["masked"])
    phase("capacity", default_K=default.max_tris_per_tile,
          pairs_over_default_K=json.dumps(
              {k: v['over_k'] for k, v in counts.items()}),
          max_tile_pairs=json.dumps(
              {k: v['max_tile_pairs'] for k, v in counts.items()}),
          big_tris=json.dumps({k: v['big_tris'] for k, v in counts.items()}),
          class_counts=json.dumps({k: v['classes']
                                   for k, v in counts.items()}),
          default_cap_drops=json.dumps(
              {k: v['drop'] for k, v in counts.items()}),
          K=settings.max_tris_per_tile, B=settings.max_big_tris,
          class_fracs=json.dumps({k: [c.compact_frac, c.short_frac,
                                      c.rest_frac] for k, c in cfgs.items()}))

    # 4. K1 against its plain version on the inputs of each of the
    #    frame's launches: the opaque set, the masked set's two layers
    render = make_render_fn(settings, **cfg_kw)
    (k1_in, k2_in), _ = launch_inputs(
        render, scene, (pair_inst, pair_meshlet), fi_np,
        init_carry(scene, settings), mask_kw, (raster_cuda, peel_cuda))
    k1_in = [a[0] for a in k1_in]
    if (len(k1_in), len(k2_in)) != (3, 0):
        raise AssertionError(f"default frame: {len(k1_in)} K1 and "
                             f"{len(k2_in)} K2 launches; want 3 and 0")
    stats = {}
    for name, inp in zip(("opaque", "masked L0", "masked L1"), k1_in):
        stats[name] = hold_k1(name, inp)
    del k1_in

    # a small default frame on the card against the CPU.  Instances within
    # 8 units of the camera keep every 384x216 tile under its capacity
    # (tests/test_torch_frame.py renders the same view against the
    # reference package)
    world = geo_mod.node_world_matrices(
        scene, fi['node_translation'], fi['node_rotation'],
        fi['node_scale'])
    inst_world, inst_adj = geo_mod.instance_transforms(scene, world)
    iw = inst_world.cpu().numpy()
    centre = (np.einsum('nij,nj->ni', iw[:, :3, :3],
                        host.prim_center[host.inst_prim]) + iw[:, :3, 3])
    near = np.linalg.norm(centre - host.camera_position, axis=1) < 8.0
    small = RenderSettings(width=SMALL[0], height=SMALL[1],
                           manual_exposure=0.25, max_tris_per_tile=1376,
                           max_big_tris=416, pair_capacity=8192)
    close, max_diff = card_vs_cpu(
        host, scene, small,
        [pi[near[pi]], pm[near[pi]], mk_i[near[mk_i]], mk_m[near[mk_i]]],
        1, {})
    phase("small frame card vs cpu", size=f"{SMALL[0]}x{SMALL[1]}",
          within_1=f"{close:.6f}", max_diff=max_diff)

    # 5. the default frame at 1920x1080 through the entry points ------------
    times, walls, img, aux, carry, _ = drive(
        render, scene, (pair_inst, pair_meshlet), fi_np,
        init_carry(scene, settings), mask_kw, FRAMES, lambda a, c: None)
    k1_default, k2_default = raster_cuda.launches, peel_cuda.launches
    coverage = check_frame(img, aux, k1_default, k2_default, 3 * FRAMES, 0,
                           "default frame")
    np.save(BUILD_DIR / f"chip_smoke_frame_{WIDTH}x{HEIGHT}.npy",
            img.cpu().numpy())
    mask_drops = {k[len('raster_mask_'):]: int(v) for k, v in aux.items()
                  if k.startswith('raster_mask_drop')}
    k1_ms = statistics.mean(s['ms'] for s in stats.values())
    phase("frame", path="default", size=f"{WIDTH}x{HEIGHT}", frames=FRAMES,
          median_ms=f"{statistics.median(times):.3f}",
          all_ms=json.dumps([round(x, 3) for x in times]),
          host_wall_ms=json.dumps([round(x, 3) for x in walls]),
          k1_ms_per_launch=f"{k1_ms:.3f}",
          launches_k1=k1_default, launches_k2=k2_default,
          coverage=f"{coverage:.4f}", raster_dropped=drops_of(aux)[0],
          masked_tris=int(aux['raster_mask_tris']),
          masked_dropped=json.dumps(mask_drops),
          binned_pairs=int(aux['raster_binned_pairs']),
          big_tris=int(aux['raster_big_tris']))
    busy, by_op, _ = profile_frame(render, scene, (pair_inst, pair_meshlet),
                                fi_np, carry, mask_kw)
    phase("profile", path="default", device_busy_ms=f"{busy:.3f}",
          busy_share_of_median_frame=(
              f"{busy / statistics.median(times):.3f}" if busy
              else "not measured"),
          by_op_ms_calls=json.dumps(by_op[:14]))

    # ======================= the culled frame (slice 2) =====================
    # the bench's deferred configuration (bench.py:140-236): 2-phase
    # culling, screen-error LOD, the compact masked merge; the opaque pair
    # list (60% of LOD0) only sets the early phase's capacity
    cap1 = max(int(len(pi) * OPAQUE_PAIR_FRAC), 256)
    cpi, cpm = pi[:cap1], pm[:cap1]
    c_pairs = tuple(torch.from_numpy(a).to(dev) for a in (cpi, cpm))
    bench = RenderSettings(width=WIDTH, height=HEIGHT, manual_exposure=0.25,
                           enable_culling=True, peel_merge_frac=0.10)

    # 6. capacity (culled) ----------------------------------------------------
    c_counts = culled_pair_counts(scene, fi, bench, cap1,
                                  (mask_inst, mask_meshlet))
    c_set = sized_culled_settings(bench, c_counts)
    c_cfgs = {k: sized_raster_config(c_set, {k: v})
              for k, v in c_counts.items()}
    c_kw = dict(raster_cfg=c_cfgs["opaque"],
                mask_raster_cfg=c_cfgs["masked"])
    phase("capacity (culled)", early_list=cap1,
          pairs_wanted=c_counts['opaque']['pairs_wanted'],
          max_tile_pairs=json.dumps(
              {k: v['max_tile_pairs'] for k, v in c_counts.items()}),
          big_tris=json.dumps({k: v['big_tris']
                               for k, v in c_counts.items()}),
          binned_pairs=json.dumps({k: v['pairs']
                                   for k, v in c_counts.items()}),
          class_counts=json.dumps({k: v['classes']
                                   for k, v in c_counts.items()}),
          default_cap_drops=json.dumps(
              {k: v['drop'] for k, v in c_counts.items()}),
          K=c_set.max_tris_per_tile, B=c_set.max_big_tris,
          pair_capacity=c_set.pair_capacity,
          class_fracs=json.dumps({k: [c.compact_frac, c.short_frac,
                                      c.rest_frac]
                                  for k, c in c_cfgs.items()}))

    # 7. K1 and K2 against their plain versions on the inputs of each of
    #    the culled frame's launches, in a frame that culls against the
    #    previous frame's HZB as the timed frames do: K1's early fill and
    #    its late continuation of the early planes, and K2 with the
    #    frame's opaque depth as its occluder
    c_render = make_render_fn(c_set, **c_kw)
    _, c_carry, _ = c_render(scene, *c_pairs, fi_np,
                             init_carry(scene, c_set), **mask_kw)
    (k1_in, k2_in), _ = launch_inputs(c_render, scene, c_pairs, fi_np,
                                      c_carry, mask_kw,
                                      (raster_cuda, peel_cuda))
    k1_in, k2_in = [a[0] for a in k1_in], [a[0] for a in k2_in]
    if (len(k1_in), len(k2_in)) != (2, 1):
        raise AssertionError(f"culled frame: {len(k1_in)} K1 and "
                             f"{len(k2_in)} K2 launches; want 2 and 1")
    for name, inp in zip(("culled early", "culled late"), k1_in):
        stats[name] = hold_k1(name, inp)
    del k1_in

    # the late phase of a still view draws nothing (what the previous
    # frame's HZB hid stays hidden), so K1's continuation is also held
    # where it has content: the first frame's early list split in two,
    # the second half continuing the first half's planes
    def early_list(carry):
        c = cull_mod.cull_instances(
            scene, inst_world, fi['cull_frustum_planes'], fi['cull_cam_pos'],
            fi['proj_scale_px'], WIDTH, HEIGHT, hzb=carry['hzb'],
            hzb_view_proj=fi['prev_view_proj_nojitter'],
            hzb_inst_world=carry['prev_inst_world'],
            error_threshold_px=c_set.lod_error_px)
        a, b, v, _ = cull_mod.build_pairs(scene, c['visible'], c['lod'],
                                          cap1)
        return a, b, cull_mod.cull_meshlets(
            scene, a, b, v, inst_world, fi['cull_frustum_planes'],
            fi['cull_cam_pos'], WIDTH, HEIGHT)

    def set_inputs(a, b, v, cfg, **kw):
        geo = geo_mod.meshlet_clip_triangles(scene, inst_world,
                                             fi['view_proj'], a, b, v)
        setup = raster_mod.setup_triangles(geo, cfg)
        recs = pack_resolve_records(
            setup, scene, inst_world, inst_adj, inst_world,
            fi['prev_view_proj_nojitter'])
        return raster_cuda.fill_inputs(
            setup, recs, raster_mod.bin_pairs_stream(setup, cfg), cfg,
            padded_io=True, **kw), setup['valid'].shape[0]

    a, b, v = early_list(init_carry(scene, c_set))
    rank = torch.cumsum(v.to(torch.int32), 0)
    first = v & (rank <= int(v.sum()) // 2)
    inp, t1 = set_inputs(a, b, first, c_cfgs["opaque"])
    z1, id1, planes1 = raster_cuda.launch(inp)
    inp, _ = set_inputs(a, b, v & ~first, c_cfgs["opaque"], init_depth=z1,
                        init_tri_id=id1, init_rec=planes1, emit_base=t1)
    split = {"culled continuation (split early list)": hold_k1(
        "culled continuation (split early list)", inp)}
    del inp, z1, id1, planes1

    peels = {"occluder": k2_in[0],
             "no occluder": dataclasses.replace(k2_in[0], occluder=None)}
    del k2_in
    k2 = {}
    for name, peel in peels.items():
        z_k, id_k = peel_cuda.launch(peel)
        # the plain version at a larger tile batch: batching does not
        # change a tile's arithmetic
        plain_peel = dataclasses.replace(peel, cfg=dataclasses.replace(
            peel.cfg, tile_batch=256))
        t = time.time()
        z_p, id_p = peel_cuda.fill_peel_plain(plain_peel)
        torch.cuda.synchronize()
        plain_wall = time.time() - t
        if not torch.equal(id_k, id_p):
            raise AssertionError(f"K2 ({name}): ids differ at "
                                 f"{int((id_k != id_p).sum())} pixels")
        if not torch.equal(z_k, z_p):
            raise AssertionError(f"K2 ({name}): depth is not bit-equal")
        z_all, id_all = peel_cuda.fill_peel_plain(every_box(plain_peel))
        if not (torch.equal(id_all, id_k) and torch.equal(z_all, z_k)):
            raise AssertionError(f"K2 ({name}): the big-list bbox filter "
                                 "changed the fill")
        k2[name] = hold_k2_times(peel, plain_peel)
        k2[name]['err'] = float((z_k - z_p).abs().max())
        phase("K2 vs plain", input=json.dumps(f"masked set, {name}"),
              layers=peel.layers,
              fragments_per_layer=json.dumps(
                  [int((id_k[i] >= 0).sum()) for i in range(peel.layers)]),
              ids="equal", depth="bit-equal",
              big_tests_in_box=f"{int(big_box_tests(peel).sum())}"
              f"/{int(big_box_tests(every_box(peel)).sum())}",
              plain_first_wall_s=f"{plain_wall:.1f}",
              **k2_fields(k2[name]))
    del peels

    # 8. the culled frame at 1920x1080 through the entry points -------------
    #    frustum-only instances: what the early phase would draw with no
    #    HZB; the early pairs whose material is alpha-masked or blended
    #    (the reference's culled frame draws those instances in the
    #    opaque set too, with no alpha test)
    frustum = cull_mod.cull_instances(
        scene, inst_world, fi['cull_frustum_planes'], fi['cull_cam_pos'],
        fi['proj_scale_px'], WIDTH, HEIGHT,
        error_threshold_px=c_set.lod_error_px)
    frustum_only = int(frustum['visible'].sum())
    alpha_mode = torch.from_numpy(np.asarray(host.mat_alpha_mode)).to(dev)

    def non_opaque_early_pairs(carry):
        _, b, v = early_list(carry)
        mode = alpha_mode[scene.prim_material[
            scene.meshlet_prim[b.long()].long()].long()]
        return {"mask": int((v & (mode == ALPHA_MASK)).sum()),
                "blend": int((v & (mode == ALPHA_BLEND)).sum())}

    c_carry = init_carry(scene, c_set)
    non_opaque = non_opaque_early_pairs(c_carry)
    keys = ('early_instances', 'late_instances', 'early_pairs', 'late_pairs',
            'early_meshlets', 'late_meshlets')
    c_times, c_walls, c_img, c_aux, c_carry, c_rows = drive(
        c_render, scene, c_pairs, fi_np, c_carry, mask_kw, FRAMES,
        lambda a, c: {k: int(a[k]) for k in keys})
    k1_culled, k2_culled = raster_cuda.launches, peel_cuda.launches
    c_coverage = check_frame(c_img, c_aux, k1_culled, k2_culled, 2 * FRAMES,
                             FRAMES, "culled frame")
    if int(c_aux['early_instances']) <= 0:
        raise AssertionError("culled frame: no early instances")
    np.save(BUILD_DIR / f"chip_smoke_culled_{WIDTH}x{HEIGHT}.npy",
            c_img.cpu().numpy())
    phase("frame", path="culled", size=f"{WIDTH}x{HEIGHT}", frames=FRAMES,
          median_ms=f"{statistics.median(c_times):.3f}",
          all_ms=json.dumps([round(x, 3) for x in c_times]),
          host_wall_ms=json.dumps([round(x, 3) for x in c_walls]),
          counters=json.dumps(c_rows[-1]),
          hzb_culled_early_instances=json.dumps(
              [frustum_only - r['early_instances'] for r in c_rows]),
          frustum_instances=frustum_only,
          launches_k1=k1_culled, launches_k2=k2_culled,
          coverage=f"{c_coverage:.4f}",
          raster_dropped=drops_of(c_aux)[0],
          raster_mask_dropped=drops_of(c_aux)[1],
          first_frame_early_pairs_alpha_mode=json.dumps(non_opaque))

    # 9. small culled frames on the card against the CPU: every
    #    instance, 2 frames with the HZB carried, caps from the card's
    #    probe of the 384x216 view
    small_c = RenderSettings(width=SMALL[0], height=SMALL[1],
                             manual_exposure=0.25, enable_culling=True,
                             peel_merge_frac=0.10)
    s_fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, *SMALL).matrices()), dev)
    s_counts = culled_pair_counts(scene, s_fi, small_c, cap1,
                                  (mask_inst, mask_meshlet))
    small_c = sized_culled_settings(small_c, s_counts)
    close, max_diff = card_vs_cpu(
        host, scene, small_c, [cpi, cpm, mk_i, mk_m], 2, dict(
            raster_cfg=sized_raster_config(
                small_c, {"opaque": s_counts["opaque"]}),
            mask_raster_cfg=sized_raster_config(
                small_c, {"masked": s_counts["masked"]})))
    phase("small culled frames card vs cpu", size=f"{SMALL[0]}x{SMALL[1]}",
          frames=2, within_1=f"{close:.6f}", max_diff=max_diff)

    # 10. where the culled frame's device time goes ---------------------------
    c_busy, c_by_op, _ = profile_frame(c_render, scene, c_pairs, fi_np,
                                    c_carry, mask_kw)
    phase("profile", path="culled", device_busy_ms=f"{c_busy:.3f}",
          busy_share_of_median_frame=(
              f"{c_busy / statistics.median(c_times):.3f}" if c_busy
              else "not measured"),
          by_op_ms_calls=json.dumps(c_by_op[:16]))

    # ================= the shadowed culled frame (slice 3) ===================
    # the bench's all-on frame (bench.py:480-498) without AO and GI: the
    # culled frame with RT sun shadows (shadow_ray_scale 2, checkerboard),
    # the denoiser, bloom, auto-exposure and TAA, sized as the culled
    # frame; the RT tree holds the LOD0 pair list (rt_lod_pairs under a
    # 500k-triangle budget, bench.py:153-161) and the coverage-kept masked
    # pairs, and is refit every frame

    # 11. the RT topology: built once on the host, at scene load
    t = time.time()
    rpi, rpm, rlod = geo_mod.rt_lod_pairs(host, 'not_mask',
                                          budget_tris=500_000)
    rts = bvh_mod.build_rt_static(host, rpi, rpm, mask_pair_inst=mk_i,
                                  mask_pair_meshlet=mk_m, device=dev)
    rt_build_s = time.time() - t
    tree = bvh_mod.refit_bvh(rts, inst_world)
    mt = host.meshlet_tris.shape[1]
    masked_tris = int(host.meshlet_tri_count[mk_m].sum())
    masked_kept = int(rts.pair_keep[len(rpi) * mt:].sum())
    tree_mb = (tree.child_boxes.numel() + tree.leaf_rows.numel()) * 4 / 1e6
    phase("RT topology", host_build_s=f"{rt_build_s:.2f}", lod=rlod,
          pairs=len(rpi) + len(mk_i), n_mask_pairs=rts.n_mask_pairs,
          triangles_kept=int((rts.payload >= 0).sum()),
          masked_tris=masked_tris,
          masked_dropped_by_coverage=masked_tris - masked_kept,
          levels=rts.num_levels, node_rows=tree.child_boxes.shape[0],
          leaf_rows=tree.leaf_rows.shape[0], tree_mb=f"{tree_mb:.2f}")
    del tree
    s_set = dataclasses.replace(
        c_set, enable_shadows=True, shadow_technique='rt', enable_taa=True,
        enable_bloom=True, enable_auto_exposure=True)
    s_render = make_render_fn(s_set, **c_kw)
    s_kw = dict(mask_kw, rt_static=rts,
                rt_pair_inst=torch.from_numpy(rpi).to(dev),
                rt_pair_meshlet=torch.from_numpy(rpm).to(dev))
    # a slow pan, ~2 px a frame: TAA and the denoiser reproject real
    # motion, inside the warp's reach
    pan = View.from_scene(host, WIDTH, HEIGHT)
    pan_fi = []
    for _ in range(4 + FRAMES):
        mats = pan.matrices()
        pan_fi.append(default_frame_inputs(host, mats))
        pan.advance(mats)
        pan.rotate_yaw_pitch(SHADOW_YAW, 0.0)
    pan_fi.reverse()

    # 12. K3 and K4 against their plain versions on the inputs of one
    #     frame's launches, its history valid (the second frame)
    _, s_carry, _ = s_render(scene, *c_pairs, pan_fi.pop(),
                             init_carry(scene, s_set), **s_kw)
    (k3_in, k4_in), (_, s_carry, _) = launch_inputs(
        s_render, scene, c_pairs, pan_fi.pop(), s_carry, s_kw,
        (bvh_cuda, warp_cuda))
    if (len(k3_in), len(k4_in)) != (1, 2):
        raise AssertionError(f"shadowed frame: {len(k3_in)} K3 and "
                             f"{len(k4_in)} K4 launches; want 1 and 2")
    # the frame's any-hit launch, and its rays closest-hit
    args = k3_in[0]
    k3 = {mode: hold_trace("K3", args[:4] + (any_hit,) + args[5:])
          for mode, any_hit in (("any-hit", True), ("closest-hit", False))}
    k4 = {name: hold_k4(name, args) for name, args in zip(
        ("denoiser history, half res", "TAA history, full res"), k4_in)}
    del k3_in, k4_in

    # 13. the shadowed frame at 1920x1080 through the entry points: 1 + 5
    #     frames of the pan; every timed frame launches K1 twice, K2 once,
    #     K3 once and K4 twice, drops nothing, traces a lit side that is
    #     neither all lit nor all shadowed, and keeps a finite exposure
    def per_frame(aux, carry):
        return dict(launches=launch_counts()[:4],
                    drops=drops_of(aux), exposure=float(carry['exposure']),
                    target_exposure=float(aux['target_exposure']))
    with recorded((bvh_cuda,)) as traced:
        s_times, s_walls, s_img, s_aux, s_carry, s_rows = drive(
            s_render, scene, c_pairs, pan_fi.pop, s_carry, s_kw, FRAMES,
            per_frame)
    lit = []
    for args, _, res in traced[bvh_cuda][1:]:
        live = args[5] > 0
        lit.append(1.0 - float(res['hit'][live].float().mean()))
    prev = [0, 0, 0, 0]
    for i, r in enumerate(s_rows):
        per = [a - b for a, b in zip(r['launches'], prev)]
        prev = r['launches']
        if per != [2, 1, 1, 2] or r['drops'] != (0, 0):
            raise AssertionError(f"shadowed frame {i}: launches K1-K4 {per},"
                                 f" drops {r['drops']}")
        if not 0.01 < lit[i] < 0.99:
            raise AssertionError(f"shadowed frame {i}: lit share of the "
                                 f"traced lit side {lit[i]}")
        if not (np.isfinite(r['exposure']) and r['exposure'] > 0):
            raise AssertionError(f"shadowed frame {i}: exposure "
                                 f"{r['exposure']}")
    s_launches = prev
    s_coverage = check_frame(s_img, s_aux, s_launches[0], s_launches[1],
                             2 * FRAMES, FRAMES, "shadowed frame")
    motion = s_aux['motion'][s_aux['depth'] > 0].abs().amax(0)
    np.save(BUILD_DIR / f"chip_smoke_shadowed_{WIDTH}x{HEIGHT}.npy",
            s_img.cpu().numpy())
    phase("frame", path="shadowed", size=f"{WIDTH}x{HEIGHT}", frames=FRAMES,
          median_ms=f"{statistics.median(s_times):.3f}",
          all_ms=json.dumps([round(x, 3) for x in s_times]),
          host_wall_ms=json.dumps([round(x, 3) for x in s_walls]),
          launches_k1_k2_k3_k4=json.dumps(s_launches),
          coverage=f"{s_coverage:.4f}", raster_dropped=drops_of(s_aux)[0],
          raster_mask_dropped=drops_of(s_aux)[1],
          traced_lit_share=json.dumps([round(x, 4) for x in lit]),
          shadow_mean=f"{float(s_aux['shadow'].mean()):.4f}",
          exposure=json.dumps([round(r['exposure'], 5) for r in s_rows]),
          target_exposure=json.dumps(
              [round(r['target_exposure'], 5) for r in s_rows]),
          geometry_motion_max_px=json.dumps(
              [round(float(x), 3) for x in motion]))

    # 14. small shadowed frames on the card against the CPU: the whole
    #     RT tree, 2 frames of a pan of ~2 px a frame at this size
    small_s = dataclasses.replace(
        small_c, enable_shadows=True, enable_taa=True, enable_bloom=True,
        enable_auto_exposure=True)
    rts_cpu = rt_static_on(rts, torch.device("cpu"))
    close, max_diff = card_vs_cpu(
        host, scene, small_s, [cpi, cpm, mk_i, mk_m], 2, dict(
            raster_cfg=sized_raster_config(
                small_s, {"opaque": s_counts["opaque"]}),
            mask_raster_cfg=sized_raster_config(
                small_s, {"masked": s_counts["masked"]})),
        yaw=SHADOW_YAW * WIDTH / SMALL[0], min_share=0.995,
        kw_on=lambda d: dict(rt_static=rts if d.type == "cuda" else rts_cpu))
    phase("small shadowed frames card vs cpu", size=f"{SMALL[0]}x{SMALL[1]}",
          frames=2, within_1=f"{close:.6f}", max_diff=max_diff,
          min_share=0.995)

    # 15. where the shadowed frame's device time goes
    s_busy, s_by_op, _ = profile_frame(s_render, scene, c_pairs, pan_fi.pop(),
                                    s_carry, s_kw)
    phase("profile", path="shadowed", device_busy_ms=f"{s_busy:.3f}",
          busy_share_of_median_frame=(
              f"{s_busy / statistics.median(s_times):.3f}" if s_busy
              else "not measured"),
          by_op_ms_calls=json.dumps(s_by_op[:20]))

    # ===================== the all-on frame (slice 4) ========================
    # the bench's north-star frame (bench.py:480-540): the shadowed frame
    # with GTAO and DDGI (gi_update_phases 4, interval mode: the whole
    # probe volume is traced on every 4th frame and held on the others);
    # the probe rays trace their own tree -- the finest LOD under the
    # TR_GI_TRIS budget (100k triangles) with the coverage-kept masked
    # pairs, as an SAH tree -- built once on the host, refit on every
    # update frame; their sun taps are any-hit rays on the same tree

    # 16. the GI tree and the probe volume
    t = time.time()
    gi_rts, gpi_t, gpm_t, gi_lod = bvh_sah.build_rt_static_gi(
        host, 'not_mask', mask_pair_inst=mk_i, mask_pair_meshlet=mk_m,
        device=dev)
    gi_build_s = time.time() - t
    gi_tree = bvh_sah.refit_sah(gi_rts, inst_world)
    vol = ddgi.volume_from_aabb(*host.world_aabb)
    gi_mb = (gi_tree.node_rows.numel() + gi_tree.leaf_rows.numel()) * 4 / 1e6
    phase("GI tree", host_build_s=f"{gi_build_s:.2f}", lod=gi_lod,
          flavour="sah", pairs=len(gpi_t) + gi_rts.n_mask_pairs,
          n_mask_pairs=gi_rts.n_mask_pairs,
          triangles=int((gi_rts.payload >= 0).sum()),
          instances=len(gi_rts.seg_lens), depth=gi_tree.depth,
          stack_entries=bvh_cuda.stack_entries(gi_tree),
          node_rows=gi_tree.node_rows.shape[0],
          leaf_rows=gi_tree.leaf_rows.shape[0], tree_mb=f"{gi_mb:.2f}",
          probes=vol.num_probes, probe_counts=json.dumps(vol.counts),
          rays_per_probe=vol.rays_per_probe)
    del gi_tree
    a_set = dataclasses.replace(s_set, enable_ao=True, enable_gi=True,
                                gi_update_phases=4)
    a_render = make_render_fn(a_set, **c_kw)
    a_kw = dict(s_kw, ddgi_volume=vol, rt_static_gi=gi_rts,
                gi_pair_inst=gpi_t, gi_pair_meshlet=gpm_t)
    pan = View.from_scene(host, WIDTH, HEIGHT)
    a_fi = []
    for _ in range(4 + 1 + ALLON_FRAMES + 3):
        mats = pan.matrices()
        a_fi.append(default_frame_inputs(host, mats))
        pan.advance(mats)
        pan.rotate_yaw_pitch(SHADOW_YAW, 0.0)
    a_fi.reverse()

    # 17. K3-SAH and K5 against their plain versions on the rays of the
    #     first update frame (frame 3; frames 0-2 hold the probes): the
    #     probe rays closest-hit and their sun rays any-hit, in the cone
    #     layout (K3-SAH), then the same frame rendered again with
    #     TR_GI_GDIR=1 (K5 on the gdir layout), whose image must match
    a_carry = init_carry(scene, a_set, vol)
    for _ in range(3):
        _, a_carry, a_aux = a_render(scene, *c_pairs, a_fi.pop(), a_carry,
                                     **a_kw)
        if a_aux['ddgi_updated']:
            raise AssertionError("all-on frames 0-2 updated the probes")
    fi3, carry3 = a_fi.pop(), a_carry
    (k3s_in,), (img3, a_carry, aux3) = launch_inputs(
        a_render, scene, c_pairs, fi3, carry3, a_kw, (bvh_cuda,))
    if not aux3['ddgi_updated'] or len(k3s_in) != 3:
        raise AssertionError(f"all-on frame 3: updated "
                             f"{aux3['ddgi_updated']}, {len(k3s_in)} "
                             "traversal launches; want True and 3")
    sah_in = [a for a in k3s_in if isinstance(a[0], bvh_sah.BvhSah)]
    if ([a[4] for a in sah_in] != [False, True]
            or any(a[6] is not None for a in k3s_in)):
        raise AssertionError("all-on frame 3: want one closest-hit and "
                             "one any-hit SAH launch, no grouped one")
    k3s = {"probe rays, closest-hit": hold_trace("K3-SAH", sah_in[0]),
           "probe-hit sun rays, any-hit": hold_trace("K3-SAH", sah_in[1])}
    del k3s_in, sah_in
    os.environ['TR_GI_GDIR'] = '1'
    try:
        reset_launch_counts()
        (k5_in,), (img3g, carry3g, _) = launch_inputs(
            a_render, scene, c_pairs, fi3, carry3, a_kw, (bvh_cuda,))
        k5_launches = bvh_cuda.launches_by_kernel['K5']
    finally:
        del os.environ['TR_GI_GDIR']
    k5_in = [a for a in k5_in if a[6] is not None]
    if k5_launches != 2 or [a[4] for a in k5_in] != [False, True]:
        raise AssertionError(f"gdir frame: {k5_launches} K5 launches; "
                             "want a closest-hit and an any-hit one")
    k5 = {"probe rays, closest-hit": hold_trace("K5", k5_in[0]),
          "probe-hit sun rays, any-hit": hold_trace("K5", k5_in[1])}
    del k5_in
    gdiff = (img3.int() - img3g.int()).abs().amax(-1)
    g_close = float((gdiff <= 1).float().mean())
    if g_close < 0.999:
        raise AssertionError(f"gdir frame vs cone frame: within 1 on "
                             f"{g_close:.5f} of pixels")
    phase("gdir frame vs cone frame", frame=3, within_1=f"{g_close:.6f}",
          max_diff=int(gdiff.max()),
          bit_equal=bool(torch.equal(img3, img3g)),
          probes_bit_equal=bool(torch.equal(
              a_carry['ddgi_irradiance'], carry3g['ddgi_irradiance'])),
          min_share=0.999)
    del img3g, carry3g

    # 17b. the pair route (TR_GI_PAIRS=1): the same update frame rendered
    #      again through it.  K6's two launches (the probe rays closest-
    #      hit, their sun rays any-hit) held bit-equal to pair_fold_plain;
    #      each route call (box phase, pair list, K6, the overflowed
    #      blocks' K3-SAH) against K3-SAH on the same rays; the frame's
    #      image against the default route's; both update frames
    #      profiled
    os.environ['TR_GI_PAIRS'] = '1'
    try:
        reset_launch_counts()
        with recorded((rt_pairs,), "traverse_pairs") as routes:
            (k6_in,), (img3p, carry3p, _) = launch_inputs(
                a_render, scene, c_pairs, fi3, carry3, a_kw, (pairs_cuda,))
        p_launches = launch_counts()
        p_busy, p_by_op, _ = profile_frame(a_render, scene, c_pairs, fi3,
                                           carry3, a_kw)
    finally:
        del os.environ['TR_GI_PAIRS']
    calls = routes[rt_pairs]
    if (p_launches[4:8] != [2, 0, 0, 2] or len(calls) != 2
            or [c[1]['any_hit'] for c in calls] != [False, True]):
        raise AssertionError(f"pair frame: launches K3-SAH K5 K3-seeded K6 "
                             f"{p_launches[4:8]}, route calls "
                             f"{[c[1]['any_hit'] for c in calls]}; want "
                             "[2, 0, 0, 2] and [False, True]")
    k6, pair_route = {}, {}
    for name, args, call in zip(("probe rays, closest-hit",
                                 "probe-hit sun rays, any-hit"), k6_in,
                                calls):
        k6[name] = hold_k6(name, args)
        pair_route[name] = hold_pair_route(name, call, k6[name])
    del k6_in, calls, routes
    pdiff = (img3.int() - img3p.int()).abs().amax(-1)
    p_close = float((pdiff <= 1).float().mean())
    if p_close < 0.995:
        raise AssertionError(f"pair frame vs default frame: within 1 on "
                             f"{p_close:.5f} of pixels")
    d_busy, _, _ = profile_frame(a_render, scene, c_pairs, fi3, carry3, a_kw)
    irr_d = (carry3p['ddgi_irradiance'] - a_carry['ddgi_irradiance']).abs()
    phase("pair frame vs default frame", frame=3, within_1=f"{p_close:.6f}",
          max_diff=int(pdiff.max()), min_share=0.995,
          probe_irradiance_diff_mean=f"{float(irr_d.mean()):.3g}",
          probe_irradiance_diff_max=f"{float(irr_d.max()):.3g}",
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(
              p_launches),
          update_busy_ms_pairs=f"{p_busy:.3f}",
          update_busy_ms_default=f"{d_busy:.3f}",
          pairs_by_op_ms_calls=json.dumps(p_by_op[:12]))
    del img3p, carry3p

    # 17c. the same update frame rendered again with RT shadows off and
    #      gi_sun_technique='map': the probe hits' sun taps read the sun
    #      map (rendered once in the frame) instead of K3-SAH's any-hit
    #      rays, so K3-SAH launches once (the probe rays); 'auto' without
    #      RT shadows picks the map too (the same image)
    t_set = dataclasses.replace(a_set, enable_shadows=False,
                                gi_sun_technique='map')
    reset_launch_counts()
    img3m, carry3m, aux3m = make_render_fn(t_set, **c_kw)(
        scene, *c_pairs, fi3, carry3, **a_kw)
    torch.cuda.synchronize()
    t_launches = launch_counts()
    img3a, _, _ = make_render_fn(dataclasses.replace(
        t_set, gi_sun_technique='auto'), **c_kw)(
        scene, *c_pairs, fi3, carry3, **a_kw)
    irr_m = carry3m['ddgi_irradiance']
    if (t_launches != [2, 2, 0, 1, 1, 0, 0, 0, 0]
            or not aux3m['ddgi_updated']
            or int(aux3m['shadow_map_dropped']) != 0
            or not bool(torch.isfinite(irr_m).all())
            or float(irr_m.max()) <= 0 or not torch.equal(img3a, img3m)):
        raise AssertionError(
            f"map-taps update frame: launches K1 K2 K3 K4 K3-SAH K5 "
            f"K3-seeded K6 K7 {t_launches} (want [2, 2, 0, 1, 1, 0, 0, 0, "
            f"0]), updated {aux3m['ddgi_updated']}, sun-map drops "
            f"{int(aux3m['shadow_map_dropped'])}, irradiance max "
            f"{float(irr_m.max())}, auto = map {torch.equal(img3a, img3m)}")
    # the next frame holds the probes: it reads no sun tap, so it renders
    # no sun map (K2 once, for the masked set) and launches no K3-SAH
    reset_launch_counts()
    _, _, aux4m = make_render_fn(t_set, **c_kw)(
        scene, *c_pairs, fi3, carry3m, **a_kw)
    torch.cuda.synchronize()
    h_launches = launch_counts()
    if (h_launches != [2, 1, 0, 1, 0, 0, 0, 0, 0] or aux4m['ddgi_updated']
            or 'shadow_map_dropped' in aux4m):
        raise AssertionError(
            f"map-taps hold frame: launches K1 K2 K3 K4 K3-SAH K5 "
            f"K3-seeded K6 K7 {h_launches} (want [2, 1, 0, 1, 0, 0, 0, 0, "
            f"0]), updated {aux4m['ddgi_updated']}, sun map rendered "
            f"{'shadow_map_dropped' in aux4m}")
    del aux4m
    t_close = float(((img3.int() - img3m.int()).abs().amax(-1) <= 1)
                    .float().mean())
    irr_t = (irr_m - a_carry['ddgi_irradiance']).abs()
    phase("all-on update frame, map taps", frame=3,
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(
              t_launches),
          hold_frame_launches=json.dumps(h_launches),
          shadow_map_dropped=int(aux3m['shadow_map_dropped']),
          probe_irradiance_max=f"{float(irr_m.max()):.4f}",
          probe_irradiance_diff_vs_rt_taps_mean=f"{float(irr_t.mean()):.3g}",
          image_within_1_of_rt_frame=f"{t_close:.4f}",
          note="ungated: RT shadows and any-hit taps in the default frame",
          auto_equals_map=True)
    del img3, img3m, img3a, carry3, carry3m

    # 18. the all-on frame at 1920x1080 through the entry points: 1 + 8
    #     frames of the pan (frames 4-12: updates at 7 and 11); gates on
    #     every timed frame
    def a_per_frame(aux, carry):
        irr = carry['ddgi_irradiance']
        ao = aux['ao']
        return dict(launches=launch_counts(),
                    updated=aux['ddgi_updated'], drops=drops_of(aux),
                    irr_finite=bool(torch.isfinite(irr).all()),
                    irr_max=float(irr.max()),
                    variability=float(aux['ddgi_variability']),
                    active_probes=int(aux['ddgi_active_probes']),
                    ao=(float(ao.min()), float(ao.mean()), float(ao.max())),
                    exposure=float(carry['exposure']))
    a_times, a_walls, a_img, a_aux, a_carry, a_rows = drive(
        a_render, scene, c_pairs, a_fi.pop, a_carry, a_kw, ALLON_FRAMES,
        a_per_frame)
    prev = [0] * 9
    for i, r in enumerate(a_rows):
        per = [a - b for a, b in zip(r['launches'], prev)]
        prev = r['launches']
        want = [2, 1, 1, 2, 2 if r['updated'] else 0, 0, 0, 0, 0]
        if per != want or r['drops'] != (0, 0):
            raise AssertionError(
                f"all-on frame {i}: launches K1 K2 K3 K4 K3-SAH K5 "
                f"K3-seeded K6 K7 {per} (want {want}), drops {r['drops']}")
        lo, mean, hi = r['ao']
        if not (r['irr_finite'] and r['irr_max'] > 0
                and np.isfinite(r['variability'])
                and 0.0 <= lo and hi <= 1.0 and 0.0 < mean < 1.0
                and np.isfinite(r['exposure']) and r['exposure'] > 0):
            raise AssertionError(f"all-on frame {i}: {r}")
    a_launches = prev
    n_upd = sum(r['updated'] for r in a_rows)
    if n_upd < 2:
        raise AssertionError(f"all-on: {n_upd} update frames of "
                             f"{ALLON_FRAMES}")
    a_coverage = check_frame(a_img, a_aux, a_launches[0], a_launches[1],
                             2 * ALLON_FRAMES, ALLON_FRAMES, "all-on frame")
    np.save(BUILD_DIR / f"chip_smoke_allon_{WIDTH}x{HEIGHT}.npy",
            a_img.cpu().numpy())
    upd_ms = [x for x, r in zip(a_times, a_rows) if r['updated']]
    hold_ms = [x for x, r in zip(a_times, a_rows) if not r['updated']]
    phase("frame", path="all-on", size=f"{WIDTH}x{HEIGHT}",
          frames=ALLON_FRAMES, update_frames=n_upd,
          update_median_ms=f"{statistics.median(upd_ms):.3f}",
          hold_median_ms=f"{statistics.median(hold_ms):.3f}",
          all_ms=json.dumps([round(x, 3) for x in a_times]),
          updated=json.dumps([r['updated'] for r in a_rows]),
          host_wall_ms=json.dumps([round(x, 3) for x in a_walls]),
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(
              a_launches),
          coverage=f"{a_coverage:.4f}", raster_dropped=drops_of(a_aux)[0],
          raster_mask_dropped=drops_of(a_aux)[1],
          probe_irradiance_max=json.dumps(
              [round(r['irr_max'], 4) for r in a_rows]),
          variability=json.dumps([round(r['variability'], 5)
                                  for r in a_rows]),
          active_probes=json.dumps([r['active_probes'] for r in a_rows]),
          ao_min_mean_max=json.dumps([round(x, 4) for x in a_rows[-1]['ao']]),
          exposure=json.dumps([round(r['exposure'], 5) for r in a_rows]))

    # 19. where an update frame's and a hold frame's device time goes
    #     (frame 13 holds, 14 holds, 15 updates)
    h_busy, h_by_op, (_, a_carry, h_aux) = profile_frame(
        a_render, scene, c_pairs, a_fi.pop(), a_carry, a_kw)
    _, a_carry, _ = a_render(scene, *c_pairs, a_fi.pop(), a_carry, **a_kw)
    u_busy, u_by_op, (_, a_carry, u_aux) = profile_frame(
        a_render, scene, c_pairs, a_fi.pop(), a_carry, a_kw)
    if h_aux['ddgi_updated'] or not u_aux['ddgi_updated']:
        raise AssertionError("all-on profiles: frame 13 must hold and "
                             "frame 15 update")
    for kind, busy, by_op, med in (
            ("update", u_busy, u_by_op, statistics.median(upd_ms)),
            ("hold", h_busy, h_by_op, statistics.median(hold_ms))):
        phase("profile", path=f"all-on {kind} frame",
              device_busy_ms=f"{busy:.3f}",
              busy_share_of_median_frame=(f"{busy / med:.3f}" if busy
                                          else "not measured"),
              by_op_ms_calls=json.dumps(by_op[:20]))

    # 20. small all-on frames on the card against the CPU: 4 frames of a
    #     pan (the 4th updates the probes), the whole RT and GI trees, a
    #     smaller probe volume (8 probes on the longest side, 64 rays each)
    small_a = dataclasses.replace(small_s, enable_ao=True, enable_gi=True,
                                  gi_update_phases=4)
    small_vol = ddgi.volume_from_aabb(*host.world_aabb, max_probes_axis=8,
                                      rays_per_probe=64)
    gi_cpu = rt_static_on(gi_rts, torch.device("cpu"))

    def small_kw(d):
        on_card = d.type == "cuda"
        return dict(rt_static=rts if on_card else rts_cpu,
                    ddgi_volume=small_vol,
                    rt_static_gi=gi_rts if on_card else gi_cpu,
                    gi_pair_inst=gpi_t.to(d), gi_pair_meshlet=gpm_t.to(d))
    close, max_diff = card_vs_cpu(
        host, scene, small_a, [cpi, cpm, mk_i, mk_m], 4, dict(
            raster_cfg=sized_raster_config(
                small_a, {"opaque": s_counts["opaque"]}),
            mask_raster_cfg=sized_raster_config(
                small_a, {"masked": s_counts["masked"]})),
        yaw=SHADOW_YAW * WIDTH / SMALL[0], min_share=0.995, kw_on=small_kw,
        volume=small_vol)
    phase("small all-on frames card vs cpu", size=f"{SMALL[0]}x{SMALL[1]}",
          frames=4, probes=small_vol.num_probes,
          rays_per_probe=small_vol.rays_per_probe, within_1=f"{close:.6f}",
          max_diff=max_diff, min_share=0.995)


    # 20b. the ray-traversal bench (tools/rtbench.py) in this process, at
    #      its default 1,048,576 rays on the courtyard (the bench's 60%
    #      pair cut): K3-seeded's first-round launch of probe(binned) and
    #      of shadow(binned) held bit-equal to the plain seeded walk; each
    #      binned result against K3's root walk on the same rays: hit
    #      bit-equal, closest-hit t bit-equal, tri differing only on
    #      exact t ties (counted)
    reset_launch_counts()
    with recorded((bvh_cuda,)) as traced:
        rb_rows = rtbench.run(["--scene", "courtyard"])
    rb_launches = dict(bvh_cuda.launches_by_kernel)
    seeded_in = [a for a, _, _ in traced[bvh_cuda]
                 if len(a) > 7 and a[7] is not None]
    del traced
    first = {any_hit: next(a for a in seeded_in if a[4] == any_hit)
             for any_hit in (False, True)}
    del seeded_in
    k3seed = {"probe(binned), round 1": hold_trace("K3-seeded", first[False]),
              "shadow(binned), round 1": hold_trace("K3-seeded",
                                                    first[True])}
    del first
    for r in rb_rows:
        if "binned" not in r['name']:
            continue
        res, st = r['result'], r['stats']
        ref = bvh_cuda.traverse(r['tree'], r['o'], r['d'], rtbench.T_MAX,
                                r['any_hit'])
        if not torch.equal(res['hit'], ref['hit']):
            raise AssertionError(f"{r['name']}: hit differs from K3 on "
                                 f"{int((res['hit'] != ref['hit']).sum())}"
                                 " rays")
        ties = int((res['tri'] != ref['tri'])[res['hit']].sum())
        if not r['any_hit'] and not torch.equal(res['t'], ref['t']):
            raise AssertionError(f"{r['name']}: t differs from K3 on "
                                 f"{int((res['t'] != ref['t']).sum())} rays")
        phase("binned vs K3", row=r['name'], rays=r['o'].shape[0],
              mode="any-hit" if r['any_hit'] else "closest-hit",
              rounds=st['rounds'], entries=st['entries'],
              packets_per_round=json.dumps([int(x) for x in st['packets']]),
              cap_packets=st['cap_packets'],
              exactness_pass_live_rays=int(st['rest']),
              hit="bit-equal",
              t="bit-equal" if not r['any_hit'] else "any-hit: not compared",
              tri_differ_on_t_ties=ties if not r['any_hit'] else "n/a",
              binned_ms=f"{r['ms']:.3f}",
              hit_share=f"{float(res['hit'].float().mean()):.4f}")
    phase("rtbench", rows=json.dumps({r['name']: [round(r['mrays_s'], 2),
                                                  round(r['ms'], 4)]
                                      for r in rb_rows}),
          launches=json.dumps(rb_launches))
    del rb_rows

    # ================ the dense-table fill and the sun map (slice 6) =========

    # 21. the dense-table fill (K7) through raster.rasterize, on the
    #     default 1080p view at the capacity-sized K: every count set to
    #     0, the opaque set rasterized, then the masked set continuing its
    #     planes (ids offset by the opaque set's T), the counts read; each
    #     launch then held bit-equal to its plain version,
    #     raster.fill_visibility, on the launch's own arguments
    geo_o = geo_mod.meshlet_clip_triangles(scene, inst_world, fi['view_proj'],
                                           pair_inst, pair_meshlet)
    geo_m = geo_mod.meshlet_clip_triangles(scene, inst_world, fi['view_proj'],
                                           mask_inst, mask_meshlet)
    t_opaque = geo_o['tri_valid'].shape[0]
    reset_launch_counts()
    with recorded((dense_cuda,)) as seen:
        setup_o, z_o, id_o = raster_mod.rasterize(geo_o, cfgs["opaque"])
        setup_m, _, id_c = raster_mod.rasterize(
            geo_m, cfgs["masked"], init_depth=z_o, init_tri_id=id_o,
            tri_id_base=t_opaque)
        torch.cuda.synchronize()
    k7_launches = launch_counts()
    if k7_launches != [0] * 8 + [2]:
        raise AssertionError(f"rasterize: launches K1-K7 {k7_launches}; "
                             "want K7 2 and no other")
    dense_in = [a for a, _, _ in seen[dense_cuda]]
    del seen
    k7_drops = {name: {k: int(v) for k, v in raster_mod.bin_triangles(
        st, c)[3].items() if int(v)} for name, st, c in (
            ("opaque", setup_o, cfgs["opaque"]),
            ("masked", setup_m, cfgs["masked"]))}
    if any(k7_drops.values()):
        raise AssertionError(f"rasterize: drops {k7_drops}")
    k7 = {name: hold_k7(name, args) for name, args in zip(
        ("opaque", "masked set continuing the opaque planes"), dense_in)}
    # one call off the frames' domain: the masked set's, its init depth
    # at -2 left of column 640, where the plain fill's missed centres and
    # empty slots win with id -1 (the exact pass's units)
    setup, table, count, big, cfg_d, init_z, init_id, base = dense_in[1]
    col = torch.arange(init_z.shape[1], device=dev)
    k7_low = hold_k7("masked set, init depth -2 left of x = 640",
                     (setup, table, count, big, cfg_d,
                      torch.where(col < 640, -2.0, init_z), init_id, base))
    del dense_in, setup, table, init_z, init_id
    raster_ms = cuda_ms(lambda: raster_mod.rasterize(geo_o, cfgs["opaque"]),
                        3)
    phase("rasterize", size=f"{WIDTH}x{HEIGHT}",
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(
              k7_launches),
          drops=json.dumps(k7_drops), opaque_triangle_slots=t_opaque,
          covered_px=int((id_c >= 0).sum()),
          masked_won_px=int((id_c >= t_opaque).sum()),
          rasterize_ms=f"{raster_ms:.3f}",
          note="setup + bin_triangles + K7, opaque set")
    del geo_o, geo_m, setup_o, setup_m, z_o, id_o, id_c

    # 22. rasterize against the bruteforce oracle on the card: Cornell at
    #     448x256, the bound of tests/test_raster.py:141-144 (depth within
    #     1e-5, ids differing on < 0.1% of the pixels: exact depth ties)
    cb_host = load_scene(ROOT / "resources" / "cornell.gltf", use_cache=False)
    cb_scene = cb_host.to_device(dev)
    cb_fi = frame_inputs_from_numpy(default_frame_inputs(
        cb_host, View.from_scene(cb_host, 448, 256).matrices()), dev)
    cb_world = geo_mod.node_world_matrices(
        cb_scene, cb_fi['node_translation'], cb_fi['node_rotation'],
        cb_fi['node_scale'])
    cb_pairs = [torch.from_numpy(a).to(dev)
                for a in geo_mod.static_meshlet_pairs(cb_host, 'all')]
    cb_geo = geo_mod.meshlet_clip_triangles(
        cb_scene, geo_mod.instance_transforms(cb_scene, cb_world)[0],
        cb_fi['view_proj'], *cb_pairs)
    cb_cfg = raster_mod.RasterConfig(width=448, height=256,
                                     max_tris_per_tile=128, max_big_tris=64)
    _, zb, idb = raster_mod.rasterize(cb_geo, cb_cfg)
    _, zf, idf = raster_mod.rasterize_bruteforce(cb_geo, cb_cfg)
    torch.cuda.synchronize()
    z_diff = float((zb - zf).abs().max())
    id_share = float((idb != idf).float().mean())
    if z_diff > 1e-5 or id_share >= 1e-3:
        raise AssertionError(f"rasterize vs bruteforce: depth {z_diff}, "
                             f"ids differ on {id_share}")
    phase("rasterize vs bruteforce", scene="cornell", size="448x256",
          depth_max_abs=f"{z_diff:.3g}", ids_differ_share=f"{id_share:.5f}",
          covered=f"{float((idb >= 0).float().mean()):.4f}",
          bound="depth 1e-5, ids < 0.1%")
    del cb_geo, zb, idb, zf, idf

    # 23. the map-shadowed frame: the reference bench's shadowed_frame_ms
    #     configuration (bench.py:722-734), the culled frame with the sun
    #     shadow map (shadow_technique='map', 1024^2, over the RT pair
    #     stream with the coverage-kept masked pairs) and the denoiser;
    #     the sun map's K2 launch held against its plain version, then
    #     1 + 5 frames of the pan with per-frame gates, a profile
    m_set = dataclasses.replace(c_set, enable_shadows=True,
                                shadow_technique='map')
    m_render = make_render_fn(m_set, **c_kw)
    pan = View.from_scene(host, WIDTH, HEIGHT)
    m_fi = []
    for _ in range(4 + FRAMES):
        mats = pan.matrices()
        m_fi.append(default_frame_inputs(host, mats))
        pan.advance(mats)
        pan.rotate_yaw_pitch(SHADOW_YAW, 0.0)
    m_fi.reverse()
    # the sun map is cached (cache_sun_map, the default): frame 0 renders
    # it, the still frames after it read it from the carry
    (k2m_in,), (_, m_carry, _) = launch_inputs(
        m_render, scene, c_pairs, m_fi.pop(), init_carry(scene, m_set), s_kw,
        (peel_cuda,))
    sm_in = [a[0] for a in k2m_in
             if a[0].cfg.width == m_set.shadow_map_resolution]
    if len(k2m_in) != 2 or len(sm_in) != 1 or sm_in[0].layers != 1:
        raise AssertionError(f"map-shadowed frame: {len(k2m_in)} K2 "
                             "launches; want the masked set's and one "
                             "one-layer sun-map launch")
    sm_in = sm_in[0]
    del k2m_in
    z_k, id_k = peel_cuda.launch(sm_in)
    sm_plain = dataclasses.replace(sm_in, cfg=dataclasses.replace(
        sm_in.cfg, tile_batch=64))
    z_p, id_p = peel_cuda.fill_peel_plain(sm_plain)
    if not (torch.equal(z_k, z_p) and torch.equal(id_k, id_p)):
        raise AssertionError("K2 (sun map): not bit-equal to the plain "
                             "version")
    k2["sun map"] = hold_k2_times(sm_in, sm_plain)
    k2["sun map"]['err'] = float((z_k - z_p).abs().max())
    phase("K2 vs plain", input=json.dumps("sun map"), layers=1,
          map=f"{sm_in.cfg.width}x{sm_in.cfg.height}",
          K=sm_in.cfg.max_tris_per_tile, B=sm_in.cfg.max_big_tris,
          triangle_slots=sm_in.tri_rec.shape[0],
          binned_pairs=int(sm_in.bins['counts'].sum()),
          pairs_walked=int(sm_in.lay['counts_eff'].sum()),
          max_tile_pairs=int(sm_in.bins['counts'].max()),
          texels_covered=f"{float((id_k[0] >= 0).float().mean()):.4f}",
          ids="equal", depth="bit-equal", **k2_fields(k2["sun map"]))
    del sm_in, sm_plain, z_k, id_k, z_p, id_p

    def m_per_frame(aux, carry):
        lit = aux['shadow'][aux['depth'] > 0]
        return dict(launches=launch_counts(), drops=drops_of(aux),
                    sun_map_dropped=int(aux['shadow_map_dropped']),
                    lit=float(lit.mean()))
    m_times, m_walls, m_img, m_aux, m_carry, m_rows = drive(
        m_render, scene, c_pairs, m_fi.pop, m_carry, s_kw, FRAMES,
        m_per_frame)
    prev = [0] * 9
    for i, r in enumerate(m_rows):
        per = [a - b for a, b in zip(r['launches'], prev)]
        prev = r['launches']
        if (per != [2, 1, 0, 1, 0, 0, 0, 0, 0] or r['drops'] != (0, 0)
                or r['sun_map_dropped'] != 0 or not 0.01 < r['lit'] < 0.99):
            raise AssertionError(
                f"map-shadowed frame {i}: launches K1-K7 {per} (want [2, 1, "
                f"0, 1, 0, 0, 0, 0, 0]: the sun map cached), drops "
                f"{r['drops']}, sun-map drops {r['sun_map_dropped']}, lit "
                f"share {r['lit']}")
    m_launches = prev
    m_coverage = check_frame(m_img, m_aux, m_launches[0], m_launches[1],
                             2 * FRAMES, FRAMES, "map-shadowed frame")
    np.save(BUILD_DIR / f"chip_smoke_shadowed_map_{WIDTH}x{HEIGHT}.npy",
            m_img.cpu().numpy())
    phase("frame", path="shadowed-map", size=f"{WIDTH}x{HEIGHT}",
          frames=FRAMES, median_ms=f"{statistics.median(m_times):.3f}",
          all_ms=json.dumps([round(x, 3) for x in m_times]),
          host_wall_ms=json.dumps([round(x, 3) for x in m_walls]),
          launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(
              m_launches),
          coverage=f"{m_coverage:.4f}", raster_dropped=drops_of(m_aux)[0],
          raster_mask_dropped=drops_of(m_aux)[1],
          shadow_map_dropped=json.dumps([r['sun_map_dropped']
                                         for r in m_rows]),
          lit_share=json.dumps([round(r['lit'], 4) for r in m_rows]))
    m_busy, m_by_op, _ = profile_frame(m_render, scene, c_pairs, m_fi.pop(),
                                       m_carry, s_kw)
    phase("profile", path="shadowed-map", device_busy_ms=f"{m_busy:.3f}",
          busy_share_of_median_frame=(
              f"{m_busy / statistics.median(m_times):.3f}" if m_busy
              else "not measured"),
          by_op_ms_calls=json.dumps(m_by_op[:20]))
    del m_img, m_aux, m_carry

    # 24. the stored goldens (tests/goldens/*_allon_448x256.png), rendered
    #     as tests/test_goldens.py's _render_allon renders them: sun-map
    #     shadows, GTAO, DDGI on the per-frame morton tree (no static
    #     topology: K3 on bvh.build_bvh every frame) with the map's taps,
    #     TAA and bloom; Cornell 4 frames, unculled, gated at the golden
    #     test's tolerance; the courtyard 3 frames, culled, printed only:
    #     its golden was rendered with a sun map whose CPU branch (the
    #     dense fill, K clamped at 1024) dropped 71% of the casters, which
    #     the port draws (ROADMAP queue 3)
    goldens = {}
    for name, frames, culled, exposure in (("cornell", 4, False, 0.01),
                                           ("courtyard", 3, True, 0.25)):
        g_host = (cb_host if name == "cornell" else host)
        g_scene = cb_scene if name == "cornell" else scene
        g_mk = [np.asarray(a) for a in geo_mod.static_meshlet_pairs(
            g_host, 'mask')]
        g_pi = [np.asarray(a) for a in geo_mod.static_meshlet_pairs(
            g_host, 'not_mask' if len(g_mk[0]) else 'all')]
        g_on = [torch.from_numpy(a).to(dev) for a in (*g_pi, *g_mk)]
        g_kw = (dict(mask_pair_inst=g_on[2], mask_pair_meshlet=g_on[3])
                if len(g_mk[0]) else {})
        g_vol = ddgi.volume_from_aabb(*g_host.world_aabb)
        g_set = RenderSettings(
            width=448, height=256, manual_exposure=exposure,
            enable_culling=culled, enable_shadows=True,
            shadow_technique='map', enable_ao=True, enable_gi=True,
            enable_taa=True, enable_bloom=True)
        g_view = View.from_scene(g_host, 448, 256)
        g_fi0 = frame_inputs_from_numpy(default_frame_inputs(
            g_host, g_view.matrices()), dev)
        mask_pairs = (g_on[2], g_on[3]) if g_kw else None
        if culled:
            g_counts = culled_pair_counts(g_scene, g_fi0, g_set,
                                          len(g_pi[0]), mask_pairs)
            g_set = sized_culled_settings(g_set, g_counts)
        else:
            sets = {"opaque": (g_on[0], g_on[1])}
            if g_kw:
                sets["masked"] = mask_pairs
            g_counts = tile_pair_counts(g_scene, g_fi0, g_set, sets)
            g_set = sized_settings(g_set, g_counts)
        g_cfg = {f"{'mask_' if k == 'masked' else ''}raster_cfg":
                 sized_raster_config(g_set, {k: v})
                 for k, v in g_counts.items()}
        g_render = make_render_fn(g_set, **g_cfg)
        g_carry = init_carry(g_scene, g_set, g_vol)
        reset_launch_counts()
        sm_drops, g_drops = [], []
        for _ in range(frames):
            mats = g_view.matrices()
            g_img, g_carry, g_aux = g_render(
                g_scene, g_on[0], g_on[1], default_frame_inputs(
                    g_host, mats), g_carry, ddgi_volume=g_vol, **g_kw)
            g_view.advance(mats)
            sm_drops.append(int(g_aux['shadow_map_dropped']))
            g_drops.append(drops_of(g_aux) if g_kw else (
                sum(int(v) for k, v in g_aux.items()
                    if k.endswith('dropped')), 0))
        torch.cuda.synchronize()
        g_launches = launch_counts()
        gold = decode_png((ROOT / "tests" / "goldens"
                           / f"{name}_allon_448x256.png").read_bytes())
        mean, p99 = perceptual_diff(gold[..., :3], g_img.cpu().numpy())
        goldens[name] = dict(mean=mean, p99=p99, frames=frames,
                             launches=g_launches, sun_map_dropped=sm_drops,
                             drops=g_drops)
        if g_launches[2] < frames:
            raise AssertionError(f"golden {name}: K3 launched "
                                 f"{g_launches[2]} times in {frames} frames")
        held = name == "cornell"
        if held and not (mean < 0.010 and p99 < 0.060
                         and not any(sm_drops)):
            raise AssertionError(f"golden {name}: mean {mean:.4f}, p99 "
                                 f"{p99:.4f} (want < 0.010, < 0.060), "
                                 f"sun-map drops {sm_drops}")
        phase("golden", scene=name, size="448x256", frames=frames,
              culled=culled, mean=f"{mean:.5f}", p99=f"{p99:.5f}",
              gate="mean < 0.010, p99 < 0.060" if held else (
                  "none: the golden's CPU sun map dropped 71% of the "
                  "casters (ROADMAP queue 3)"),
              launches_k1_k2_k3_k4_k3sah_k5_k3seeded_k6_k7=json.dumps(
                  g_launches),
              shadow_map_dropped=json.dumps(sm_drops),
              raster_dropped=json.dumps([d[0] for d in g_drops]))

    # 25. the port's render CLI on the card, in its own process: Cornell
    #     at 448x256 with sun-map shadows, 2 frames; exit 0, a PNG that
    #     decodes, equal to the same frames rendered here, and the covered
    #     pixels it prints equal to that frame's
    cli_png = BUILD_DIR / "chip_smoke_cli.png"
    cli_args = ["--scene", "resources/cornell.gltf", "--displayresolution",
                "448x256", "--frames", "2", "--exposure", "0.01",
                "--shadows", "--shadowtechnique", "map", "--nocache"]
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "toyrenderer_tpu_torch.tools.render",
         *cli_args, "--output", str(cli_png)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    cli_s = time.time() - t
    if proc.returncode != 0:
        raise AssertionError(f"render CLI exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    covered_line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("[stats] covered pixels: ")]
    cli_covered = int(covered_line[-1].split(": ")[1].split("/")[0])
    cli_img = decode_png(cli_png.read_bytes())
    cb_set = RenderSettings(width=448, height=256, manual_exposure=0.01,
                            enable_shadows=True, shadow_technique='map')
    cb_render = make_render_fn(cb_set)
    cb_carry = init_carry(cb_scene, cb_set)
    cb_view = View.from_scene(cb_host, 448, 256)
    cb_rts = bvh_mod.build_rt_static(
        cb_host, *geo_mod.static_meshlet_pairs(cb_host, 'all'), device=dev)
    for _ in range(2):
        mats = cb_view.matrices()
        cb_img, cb_carry, cb_aux = cb_render(
            cb_scene, *cb_pairs, default_frame_inputs(cb_host, mats),
            cb_carry, rt_static=cb_rts)
        cb_view.advance(mats)
    cb_covered = int((cb_aux['tri_id'] >= 0).sum())
    same = np.array_equal(cli_img[..., :3], cb_img.cpu().numpy())
    if cli_covered != cb_covered or not same:
        raise AssertionError(f"render CLI: covered {cli_covered} vs "
                             f"{cb_covered}; image equal {same}")
    phase("cli", command=json.dumps(
        "python -m toyrenderer_tpu_torch.tools.render " + " ".join(cli_args)),
          rc=proc.returncode, wall_s=f"{cli_s:.1f}",
          png=f"{cli_img.shape[1]}x{cli_img.shape[0]}",
          covered_px=cli_covered, equals_in_process_frame=True,
          frame_lines=json.dumps([ln for ln in proc.stdout.splitlines()
                                  if ln.startswith("[frame")]))

    # ============ virtual-texture streaming on the plaza (slice 7) ==========
    plaza_k1, p_k1, p_k2 = slice7(dev, host, scene, (cpi, cpm),
                                  (mk_i, mk_m), cap1, k2)

    # ===== ReSTIR, OIT, the packed GBuffer, debug views (slice 8) ===========
    s8 = slice8(dev, dict(
        host=host, scene=scene, c_pairs=c_pairs, fi_np=fi_np,
        mask_kw=mask_kw, c_kw=c_kw, c_set=c_set, c_img=c_img,
        c_busy=c_busy, c_median=statistics.median(c_times), a_set=a_set,
        a_kw=a_kw, small_c=small_c, s_counts=s_counts,
        c_pairs_np=(cpi, cpm, mk_i, mk_m), small_kw=small_kw,
        small_vol=small_vol))

    # ===== the caches, GI's branch, the snapshot, pass tables (slice 9) ======
    glass = s8.pop('glass')
    s9 = slice9(dev, dict(
        host=host, scene=scene, c_pairs=c_pairs, c_kw=c_kw, c_set=c_set,
        s_set=s_set, m_set=m_set, a_set=a_set, s_kw=s_kw, a_kw=a_kw,
        mask_kw=mask_kw, card=card, glass=glass))

    # ===== the reference's opt-in ray paths (slice 10) =====================
    s10 = slice10(dev, dict(
        host=host, scene=scene, c_pairs=c_pairs, c_kw=c_kw, s_set=s_set,
        m_set=m_set, a_set=a_set, s_kw=s_kw, a_kw=a_kw, mask_kw=mask_kw,
        card=card, glass=glass, rpi=rpi, rpm=rpm, mk_i=mk_i, mk_m=mk_m))

    # ===== the multi-device frame and the last tools (slice 11) ============
    s11 = slice11(dev, dict(
        host=host, scene=scene, c_pairs=c_pairs, c_kw=c_kw, c_set=c_set,
        mask_kw=mask_kw, a_set=a_set, a_kw=a_kw, card=card, glass=glass))
    sl = s11['launches']

    # ===== every JPEG kind the reference decodes (slice 12) ================
    s12 = slice12(dev, dict(
        host=host, scene=scene, c_pairs=c_pairs, c_kw=c_kw, c_set=c_set,
        mask_kw=mask_kw, fi_np=fi_np, card=card))
    sl = {k: v + s12['launches'][k] for k, v in sl.items()}

    # 32. kernels -------------------------------------------------------------
    #     fill_resolve: the mean over the inputs of one frame of each main
    #     path (each launched once a frame), every input listed beside it;
    #     fill_peel: the input the culled frame launches it with;
    #     traverse: the shadowed frame's any-hit launch (closest-hit on
    #     the same rays listed beside it); warp: the mean over the
    #     shadowed frame's two launches, each listed; traverse_sah: the
    #     mean over an update frame's two launches (the probe rays
    #     closest-hit, their sun rays any-hit), each listed;
    #     traverse_gdir: the same probe rays in the gdir layout, from the
    #     update frame rendered again with TR_GI_GDIR=1 (an opt-in route,
    #     so its inputs are not the default all-on path's; its launches
    #     are that frame's); traverse_pairs: the mean over that frame's
    #     two K6 launches with TR_GI_PAIRS=1 (each input also carries its
    #     route's census and times); traverse_seeded: the mean over the
    #     first-round launches of rtbench's two binned rows (its launches
    #     are the whole rtbench run's); fill_peel also lists the sun map's
    #     launch; fill_dense: the mean over rasterize's two launches (the
    #     opaque set, the masked set continuing it), the call off the
    #     frames' domain listed beside them
    def row(name, st, main):
        extra = {k: st[k] for k in ('events_ms', 'walk_ms', 'check_ms',
                                    'exact_ms', 'census', 'live_share',
                                    'warps_launched', 'slots_fetched')
                 if k in st}
        if 'bound_all_px' in st:
            extra['bound_all_px_ms'] = st['bound_all_px']
        return dict(input=name, main_path=main, ms=st['ms'],
                    plain_ms=st['plain_ms'], bound_ms=st['bound'][0],
                    bound_by=st['bound'][1], max_abs_err=st['err'], **extra)
    main_in = list(stats.values())
    kernels = [
        dict(name="fill_resolve", route="cuda",
             source="toyrenderer_tpu_torch/csrc/fill_resolve.cu",
             replaces="toyrenderer_tpu/ops/raster_pallas.py:294",
             launches=k1_default + k1_culled + s_launches[0]
             + a_launches[0] + p_k1 + s8['glass_launches'][0]
             + s8['packed_launches'][0] + sl['K1'],
             max_abs_err=max(s['err'] for s in [*main_in, *split.values(),
                                                 *plaza_k1.values(),
                                                 *s8['k1'].values()]),
             ms=statistics.mean(s['ms'] for s in main_in),
             plain_ms=statistics.mean(s['plain_ms'] for s in main_in),
             bound_ms=statistics.mean(s['bound'][0] for s in main_in),
             bound_by=max(main_in, key=lambda s: s['bound'][0])['bound'][1],
             bound_all_px_ms=statistics.mean(s['bound_all_px']
                                             for s in main_in),
             library_ms=None,
             inputs=[row(k, v, True) for k, v in stats.items()]
             + [row(k, v, False) for k, v in split.items()]
             + [dict(row(k, v, True), path="plaza streamed")
                for k, v in plaza_k1.items()]
             + [dict(row(k, v, True), path="glass and emitters")
                for k, v in s8['k1'].items()]
             + [dict(row(k, v, True), path=f"sharded raster (x{SP} bands)",
                     single_fill_ms=s11['single_k1_ms'])
                for k, v in s11['bands'].items()]),
        dict(name="fill_peel", route="cuda",
             source="toyrenderer_tpu_torch/csrc/fill_peel.cu",
             replaces="toyrenderer_tpu/ops/raster_pallas.py:778",
             launches=k2_default + k2_culled + s_launches[1]
             + a_launches[1] + m_launches[1] + p_k2
             + s8['packed_launches'][1] + sl['K2'],
             max_abs_err=max(v['err'] for v in k2.values()),
             ms=k2['occluder']['ms'], plain_ms=k2['occluder']['plain_ms'],
             bound_ms=k2['occluder']['bound'][0],
             bound_by=k2['occluder']['bound'][1],
             bound_all_px_ms=k2['occluder']['bound_all_px'], library_ms=None,
             inputs=[row(k if k in ("sun map", "plaza masked set")
                         else f"masked set, {k}", v,
                         k != "no occluder") for k, v in k2.items()]),
        dict(name="traverse", route="cuda",
             source="toyrenderer_tpu_torch/csrc/traverse.cu",
             replaces="toyrenderer_tpu/ops/bvh_pallas.py:250",
             launches=s_launches[2] + a_launches[2]
             + s8['glass_launches'][2] + sl['K3'],
             max_abs_err=max(v['err'] for v in [*k3.values(),
                                                *s8['k3'].values()]),
             ms=k3['any-hit']['ms'], plain_ms=k3['any-hit']['plain_ms'],
             bound_ms=k3['any-hit']['bound'][0],
             bound_by=k3['any-hit']['bound'][1], library_ms=None,
             inputs=[dict(row(f"shadow rays, {k}", v, k == "any-hit"),
                          mrays_per_s=v['mrays_s']) for k, v in k3.items()]
             + [dict(row(k, v, True), path="glass and emitters",
                     mrays_per_s=v['mrays_s'], ray_slots=v['ray_slots'],
                     live_rays=v['live_rays'], visits_mean=v['visits_mean'],
                     visits_max=v['visits_max'])
                for k, v in s8['k3'].items()]),
        dict(name="warp", route="cuda",
             source="toyrenderer_tpu_torch/csrc/warp.cu",
             replaces="toyrenderer_tpu/ops/warp_pallas.py:41",
             launches=s_launches[3] + a_launches[3]
             + s8['glass_launches'][3] + sl['K4'],
             max_abs_err=max(v['err'] for v in k4.values()),
             ms=statistics.mean(v['ms'] for v in k4.values()),
             plain_ms=statistics.mean(v['plain_ms'] for v in k4.values()),
             bound_ms=statistics.mean(v['bound'][0] for v in k4.values()),
             bound_by="bytes",
             library_ms=statistics.mean(v['library_ms'] for v in k4.values()),
             inputs=[dict(row(k, v, True), library_ms=v['library_ms'])
                     for k, v in k4.items()]),
        dict(name="fill_dense", route="cuda",
             path="raster.rasterize, tools/profile_stages.py",
             source="toyrenderer_tpu_torch/csrc/fill_dense.cu",
             replaces="toyrenderer_tpu/ops/raster_pallas.py:66",
             launches=k7_launches[8] + s9['stages_k7'] + sl['K7'],
             max_abs_err=max(v['err'] for v in [*k7.values(), k7_low]),
             ms=statistics.mean(v['ms'] for v in k7.values()),
             plain_ms=statistics.mean(v['plain_ms'] for v in k7.values()),
             bound_ms=statistics.mean(v['bound'][0] for v in k7.values()),
             bound_by=max(k7.values(), key=lambda v: v['bound'][0])[
                 'bound'][1],
             bound_all_px_ms=statistics.mean(v['bound_all_px']
                                             for v in k7.values()),
             library_ms=None,
             inputs=[row(k, v, True) for k, v in k7.items()]
             + [dict(row("masked set, init depth -2 left of x = 640",
                         k7_low, False), exact_units=k7_low['exact_units'])]
             )]
    for name, line, st, n, path, extra in (
            ("traverse_sah", 250, k3s, a_launches[4] + sl['K3-SAH'],
             "all-on", s10['k3sah']),
            ("traverse_gdir", 595, k5, k5_launches + sl['K5'],
             "all-on, TR_GI_GDIR=1", s10['k5'])):
        main = path == "all-on"
        kernels.append(dict(
            name=name, route="cuda", path=path,
            source="toyrenderer_tpu_torch/csrc/traverse.cu",
            replaces=f"toyrenderer_tpu/ops/bvh_pallas.py:{line}",
            launches=n, max_abs_err=max(v['err'] for v in st.values()),
            ms=statistics.mean(v['ms'] for v in st.values()),
            plain_ms=statistics.mean(v['plain_ms'] for v in st.values()),
            bound_ms=statistics.mean(v['bound'][0] for v in st.values()),
            bound_by=max(st.values(), key=lambda v: v['bound'][0])[
                'bound'][1],
            library_ms=None,
            inputs=[dict(row(k, v, main), path=path,
                         mrays_per_s=v['mrays_s'],
                         ray_slots=v['ray_slots'], live_rays=v['live_rays'],
                         visits_mean=v['visits_mean'],
                         visits_max=v['visits_max'])
                    for k, v in st.items()]
            + [dict(row(k, v, False), path=("TR_RT_SAH=1" if "SAH" in k
                                            else "shadowed, TR_SHADOW_GDIR=1"),
                    mrays_per_s=v['mrays_s'], ray_slots=v['ray_slots'],
                    live_rays=v['live_rays'], visits_mean=v['visits_mean'],
                    visits_max=v['visits_max'])
               for k, v in extra.items()]))
    for name, src, line, st, n, path in (
            ("traverse_pairs", "pairs.cu", "rt_pairs.py:145", k6,
             p_launches[7] + sl['K6'], "all-on, TR_GI_PAIRS=1"),
            ("traverse_seeded", "traverse.cu", "bvh_pallas.py:250", k3seed,
             rb_launches['K3-seeded'] + sl['K3-seeded'], "rtbench binned")):
        kernels.append(dict(
            name=name, route="cuda", path=path, main_path=False,
            source=f"toyrenderer_tpu_torch/csrc/{src}",
            replaces=f"toyrenderer_tpu/ops/{line}",
            launches=n, max_abs_err=max(v['err'] for v in st.values()),
            ms=statistics.mean(v['ms'] for v in st.values()),
            plain_ms=statistics.mean(v['plain_ms'] for v in st.values()),
            bound_ms=statistics.mean(v['bound'][0] for v in st.values()),
            bound_by=max(st.values(), key=lambda v: v['bound'][0])[
                'bound'][1],
            library_ms=None,
            inputs=[dict(row(k, v, False), path=path) for k, v in st.items()]))
    kernels[-2]['inputs'] = [
        dict(i, **{k: v for k, v in pair_route[i['input']].items()})
        for i in kernels[-2]['inputs']]
    k8 = s10['k8']
    kernels.append(dict(
        name="chunk_fold", route="cuda", main_path=False,
        path="TR_RT_CHUNKS=1 (all-on probe rays, glass ReSTIR rays)",
        source="toyrenderer_tpu_torch/csrc/chunks.cu",
        replaces="none: toyrenderer_tpu/ops/rt_chunks.py:101-242 is XLA",
        launches=s10['k8_launches'] + sl['K8'],
        max_abs_err=max(v['err'] for v in k8.values()),
        ms=statistics.mean(v['ms'] for v in k8.values()),
        plain_ms=statistics.mean(v['plain_ms'] for v in k8.values()),
        bound_ms=statistics.mean(v['bound'][0] for v in k8.values()),
        bound_by=max(k8.values(), key=lambda v: v['bound'][0])['bound'][1],
        library_ms=None,
        inputs=[dict(row(k, v, False), plain_scope=v['plain_scope'],
                     census=v['census'], route=s10['routes'][k])
                for k, v in k8.items()]))
    # slice 11's sharded calls beside the kernel each launches
    by_kernel = {'K3': "traverse", 'K5': "traverse_gdir",
                 'K6': "traverse_pairs", 'K8': "chunk_fold"}
    for label, st in s11['rays'].items():
        kname = next(by_kernel[k] for k in by_kernel
                     if st['all_launches'][k] and (
                         k != 'K3' or label == "shadow rays"))
        k_row = next(k for k in kernels if k['name'] == kname)
        k_row.setdefault('sharded', []).append(dict(
            input=label, slices=SP, rays=st['rays'], ms=st['ms'],
            unsharded_ms=st['unsharded_ms'], launches=st['all_launches']))
    dense_row = next(k for k in kernels if k['name'] == "fill_dense")
    dense_row['stages_bound_ms'], dense_row['stages_bound_by'] = \
        s9['stages_k7_bound']
    print(json.dumps({"kernels": kernels,
                      "wall_s": round(time.time() - t_start, 1)}),
          flush=True)

    # 33. result --------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
