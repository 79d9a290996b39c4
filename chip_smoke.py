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
  frame on the card against the CPU, a profile.

It prints one line per phase, then a `kernels` JSON line and, last, an
`ok` JSON line.  Any failed phase raises: the script then exits nonzero
and prints no `ok` line.  Without a CUDA device, or outside a checkout
of the repo, it exits nonzero at once.
"""

from __future__ import annotations

import dataclasses
import json
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
KERNEL_REPS = 10                 # timed launches per kernel input
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
    """(tests, the stream entries walked, the triangles tested): each
    visited tile's own pairs, and the big triangles whose tile bbox
    holds it (a triangle covers no pixel outside its bbox)."""
    import torch
    lay, bins = inp.lay, inp.bins
    visited = lay['n_chunks'] > 0
    in_box = big_box_tests(inp)
    nb = in_box.shape[1]
    tests = int(lay['counts_eff'][visited].sum()) + int(in_box.sum())
    walked = torch.cat([bins['vals_s'][:0]] + [
        bins['vals_s'][o:o + c] for o, c in zip(
            bins['offs'][:-1][visited].tolist(),
            lay['counts_eff'][visited].tolist())])
    tested = torch.cat([walked, bins['big_list'][:nb][in_box.any(0)]])
    return tests, walked, tested


def bound(ops: float, bytes_: float) -> tuple[float, str]:
    """The larger of the operations and the bytes at the card's peaks."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def fill_bound_ms(inp, tid, won) -> tuple[float, str]:
    """Least time the card could take for one fill+resolve on these
    inputs, counted for this run's data.  Bytes: each input read once --
    the records of the triangles tested and of the winners, the pair
    stream, the per-tile tables, the init planes and peel bound this fill
    was given (the first layer is given none) -- and the 34 output planes
    written once."""
    import torch
    cfg = inp.cfg
    tests, walked, tested = walked_pairs(inp)
    n_won = int(won.sum())
    ops = (tests * cfg.tile_h * cfg.tile_w * OPS_PER_TEST
           + n_won * OPS_PER_RESOLVE)
    winners = torch.unique(tid[won] - inp.emit_base).numel()
    hp, wp = inp.padded_shape
    n_px = hp * wp
    nb = int((inp.bins['big_list'] >= 0).sum())
    given = [x for x in (inp.init_z, inp.init_id, inp.peel) if x is not None]
    bytes_ = (torch.unique(tested).numel() * 16 * 4   # raster records
              + walked.numel() * 4 + nb * 5 * 4       # stream, big list
              + cfg.num_tiles * 4 * 4                 # per-tile tables
              + winners * 64 * 4                      # resolve records
              + len(given) * n_px * 4
              + (0 if inp.init_rec is None else (n_px - n_won) * 32 * 4)
              + n_px * 34 * 4)                        # depth, ids, planes
    return bound(ops, bytes_)


def peel_bound_ms(inp) -> tuple[float, str]:
    """Least time the card could take for one L-layer peel fill on these
    inputs: every test runs the edge and depth evaluation and the
    cascade's L layers; bytes: the occluder read once, the records of
    the triangles tested, the pair stream and per-tile tables, and the
    2 L planes (depth, id) written once."""
    import torch
    cfg = inp.cfg
    tests, walked, tested = walked_pairs(inp)
    ops = (tests * cfg.tile_h * cfg.tile_w
           * (OPS_PER_TEST + OPS_PER_CASCADE_LAYER * inp.layers))
    hp, wp = inp.padded_shape
    nb = int((inp.bins['big_list'] >= 0).sum())
    bytes_ = (torch.unique(tested).numel() * 16 * 4
              + walked.numel() * 4 + nb * 5 * 4 + cfg.num_tiles * 4 * 4
              + (0 if inp.occluder is None else hp * wp * 4)
              + 2 * inp.layers * hp * wp * 4)
    return bound(ops, bytes_)


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
    """inp with every big bbox widened to the whole tile grid."""
    import torch
    cfg, box = inp.cfg, inp.lay['big_box']
    grid = torch.tensor([0, cfg.tiles_x - 1, 0, cfg.tiles_y - 1],
                        dtype=torch.int32, device=box.device)
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
    st = dict(err=err,
              ms=cuda_ms(lambda: raster_cuda.launch(inp), KERNEL_REPS),
              plain_ms=cuda_ms(lambda: raster_cuda.fill_resolve_plain(inp),
                               1),
              bound=fill_bound_ms(inp, want[1], won))
    phase("K1 vs plain", input=json.dumps(name), won_px=int(won.sum()),
          pairs_walked=int(inp.lay['counts_eff'].sum()),
          init_planes=inp.init_z is not None, emit_base=inp.emit_base,
          ids="equal", depth="bit-equal", planes_max_abs=f"{err:.3g}",
          big_tests_in_box=f"{int(big_box_tests(inp).sum())}"
          f"/{int(big_box_tests(every_box(inp)).sum())}",
          kernel_ms=f"{st['ms']:.3f}", plain_ms=f"{st['plain_ms']:.1f}",
          plain_first_wall_s=f"{plain_wall:.1f}",
          bound_ms=f"{st['bound'][0]:.4f}", bound_by=st['bound'][1])
    return st


def launch_inputs(render, scene, pairs, fi_np, carry, mask_kw):
    """The inputs of the kernel launches of one frame, in launch order:
    (K1 inputs, K2 inputs), recorded by wrapping each wrapper's launch
    for that frame; the kernels run as they do in any frame."""
    import torch
    from toyrenderer_tpu_torch.ops import peel_cuda, raster_cuda
    seen = {raster_cuda: [], peel_cuda: []}
    originals = {m: m.launch for m in seen}

    def recording(m):
        def launch(inp):
            seen[m].append(inp)
            return originals[m](inp)
        return launch
    try:
        for m in seen:
            m.launch = recording(m)
        render(scene, *pairs, fi_np, carry, **mask_kw)
        torch.cuda.synchronize()
    finally:
        for m, f in originals.items():
            m.launch = f
    return seen[raster_cuda], seen[peel_cuda]


def drops_of(aux) -> tuple[int, int]:
    """(raster_dropped, raster_mask_dropped): the sums of the frame's
    drop counters, as bench.py:333-335 sums the keys ending in
    'dropped' -- the opaque set's (reference keys) and, apart, the
    masked set's (the port's raster_mask_* keys)."""
    opaque = sum(int(v) for k, v in aux.items() if k.endswith('dropped')
                 and not k.startswith('raster_mask_'))
    return opaque, int(aux['raster_mask_dropped'])


def drive(render, scene, pairs, fi_np, carry, mask_kw, frames, per_frame):
    """One warm-up frame, then `frames` timed ones with the carry
    threaded.  Returns (device ms, host ms, last image, last aux, carry,
    per_frame(aux) of each timed frame)."""
    import torch
    img, carry, aux = render(scene, *pairs, fi_np, carry, **mask_kw)
    torch.cuda.synchronize()
    from toyrenderer_tpu_torch.ops import peel_cuda, raster_cuda
    raster_cuda.launches = 0
    peel_cuda.launches = 0
    times, walls, rows = [], [], []
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        img, carry, aux = render(scene, *pairs, fi_np, carry, **mask_kw)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        times.append(start.elapsed_time(end))
        rows.append(per_frame(aux))
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
    once) and (op, ms, calls) by the PyTorch op that launched them (the
    hand-written kernels, launched through ctypes, by their own
    names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render(scene, *pairs, fi_np, carry, **mask_kw)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    mine = ("fill_resolve_kernel", "fill_peel_kernel")

    def name(key):
        return next((m for m in mine if m in key), key)
    by_op = [(name(e.key), round(e.self_device_time_total / 1e3, 3),
              e.count) for e in events if e.self_device_time_total > 0 and (
                  e.device_type == DeviceType.CPU
                  or any(m in e.key for m in mine))]
    by_op.sort(key=lambda r: -r[1])
    return busy, by_op


def card_vs_cpu(host, scene, settings, pairs_np, frames, cfg_kw):
    """The same frames on the card (kernels) and on the CPU (plain
    versions): u8 images within 1 on >= 99.9% of the pixels (the two
    devices' 4x4 products may round apart by an ulp, so a few edge
    pixels may change triangle), no drops.  cfg_kw: the frame's
    raster_cfg / mask_raster_cfg.  Returns (share within 1, max
    difference)."""
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
        carry = init_carry(sc, settings)
        view = View.from_scene(host, w, h)
        out = []
        for _ in range(frames):
            mats = view.matrices()
            img, carry, aux = render(
                sc, p[0], p[1], default_frame_inputs(host, mats), carry,
                mask_pair_inst=p[2], mask_pair_meshlet=p[3])
            view.advance(mats)
            out.append(img.cpu().numpy().astype(int))
            drops.append(drops_of(aux))
        imgs.append(np.stack(out))
    diff = np.abs(imgs[0] - imgs[1]).max(-1)
    close = float((diff <= 1).mean())
    if close < 0.999 or any(x != (0, 0) for x in drops):
        raise AssertionError(f"{w}x{h} frames: card vs CPU within 1 on "
                             f"{close:.5f} of pixels, drops {drops}")
    return close, int(diff.max())


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
    from toyrenderer_tpu_torch.ops import culling as cull_mod
    from toyrenderer_tpu_torch.ops import geometry as geo_mod
    from toyrenderer_tpu_torch.ops import peel_cuda
    from toyrenderer_tpu_torch.ops import raster as raster_mod
    from toyrenderer_tpu_torch.ops import raster_cuda
    from toyrenderer_tpu_torch.ops.gbuffer import pack_resolve_records
    from toyrenderer_tpu_torch.scene import load_scene
    from toyrenderer_tpu_torch.scene.gltf import (
        ALPHA_BLEND, ALPHA_MASK, load_gltf)
    from toyrenderer_tpu_torch.scene.png import decode_png
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
    libs = {"fill_resolve": raster_cuda, "fill_peel": peel_cuda}
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
    phase("build", kernels="fill_resolve.cu,fill_peel.cu",
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
    k1_in, k2_in = launch_inputs(render, scene, (pair_inst, pair_meshlet),
                                 fi_np, init_carry(scene, settings), mask_kw)
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
        init_carry(scene, settings), mask_kw, FRAMES, lambda a: None)
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
    busy, by_op = profile_frame(render, scene, (pair_inst, pair_meshlet),
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
    k1_in, k2_in = launch_inputs(c_render, scene, c_pairs, fi_np, c_carry,
                                 mask_kw)
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
        k2[name] = dict(
            err=float((z_k - z_p).abs().max()),
            ms=cuda_ms(lambda: peel_cuda.launch(peel), KERNEL_REPS),
            plain_ms=cuda_ms(
                lambda: peel_cuda.fill_peel_plain(plain_peel), 1),
            bound=peel_bound_ms(peel))
        phase("K2 vs plain", input=json.dumps(f"masked set, {name}"),
              layers=peel.layers,
              fragments_per_layer=json.dumps(
                  [int((id_k[i] >= 0).sum()) for i in range(peel.layers)]),
              ids="equal", depth="bit-equal",
              big_tests_in_box=f"{int(big_box_tests(peel).sum())}"
              f"/{int(big_box_tests(every_box(peel)).sum())}",
              kernel_ms=f"{k2[name]['ms']:.4f}",
              plain_ms=f"{k2[name]['plain_ms']:.1f}",
              plain_first_wall_s=f"{plain_wall:.1f}",
              bound_ms=f"{k2[name]['bound'][0]:.4f}",
              bound_by=k2[name]['bound'][1])
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
        lambda a: {k: int(a[k]) for k in keys})
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
    c_busy, c_by_op = profile_frame(c_render, scene, c_pairs, fi_np,
                                    c_carry, mask_kw)
    phase("profile", path="culled", device_busy_ms=f"{c_busy:.3f}",
          busy_share_of_median_frame=(
              f"{c_busy / statistics.median(c_times):.3f}" if c_busy
              else "not measured"),
          by_op_ms_calls=json.dumps(c_by_op[:16]))

    # 11. kernels -------------------------------------------------------------
    #     fill_resolve: the mean over the inputs of one frame of each main
    #     path (each launched once a frame), every input listed beside it;
    #     fill_peel: the input the culled frame launches it with
    def row(name, st, main):
        return dict(input=name, main_path=main, ms=st['ms'],
                    plain_ms=st['plain_ms'], bound_ms=st['bound'][0],
                    bound_by=st['bound'][1], max_abs_err=st['err'])
    main_in = list(stats.values())
    kernels = [
        dict(name="fill_resolve", route="cuda",
             source="toyrenderer_tpu_torch/csrc/fill_resolve.cu",
             replaces="toyrenderer_tpu/ops/raster_pallas.py:294",
             launches=k1_default + k1_culled,
             max_abs_err=max(s['err'] for s in [*main_in, *split.values()]),
             ms=statistics.mean(s['ms'] for s in main_in),
             plain_ms=statistics.mean(s['plain_ms'] for s in main_in),
             bound_ms=statistics.mean(s['bound'][0] for s in main_in),
             bound_by=max(main_in, key=lambda s: s['bound'][0])['bound'][1],
             library_ms=None,
             inputs=[row(k, v, True) for k, v in stats.items()]
             + [row(k, v, False) for k, v in split.items()]),
        dict(name="fill_peel", route="cuda",
             source="toyrenderer_tpu_torch/csrc/fill_peel.cu",
             replaces="toyrenderer_tpu/ops/raster_pallas.py:778",
             launches=k2_default + k2_culled,
             max_abs_err=max(v['err'] for v in k2.values()),
             ms=k2['occluder']['ms'], plain_ms=k2['occluder']['plain_ms'],
             bound_ms=k2['occluder']['bound'][0],
             bound_by=k2['occluder']['bound'][1], library_ms=None,
             inputs=[row(f"masked set, {k}", v, k == "occluder")
                     for k, v in k2.items()])]
    print(json.dumps({"kernels": kernels,
                      "wall_s": round(time.time() - t_start, 1)}),
          flush=True)

    # 12. result --------------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
