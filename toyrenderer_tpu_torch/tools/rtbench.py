"""Ray-traversal benchmark: Mrays/s of the traversal kernels on the ray
populations the frame produces.

Counterpart of toyrenderer_tpu/tools/rtbench.py.  Its scenes: `stress`
(the default, as the reference's: the procedural stress scene of
--objects objects, sphere_res 24, untextured, every pair, rtbench.py:
132-135) and `courtyard` (with the bench's 60% pair cut, bench.py
parity).  Its rows:
  shadow(any-hit)   64x64-tile-ordered any-hit sun rays from ground points
                    (the shadow pass's packing), complete tree: K3
  probe(closest)    direction-major DDGI probe rays in the cone layout
                    (16 similar directions x a brick of probes): K3
  probe(gdir)       the same rays in the gdir layout (32 directions x 128
                    probes, one direction per 128 rays): K5
  probe(binned)     the probe rays through bvh_cuda.traverse_binned:
  shadow(binned)    K3-seeded, then K3 for the exactness pass
  probe(sah)        the SAH tree (K3-SAH), per-ray directions
  probe(sah+gdir)   the SAH tree, grouped directions (K5)
  shadow(sah)       the SAH tree (K3-SAH), any-hit
The binned traversal's knobs are TR_BIN_ROUNDS (2), TR_BIN_PACKET (1024)
and TR_BIN_ENTRIES (128).  Each row prints Mrays/s, the hit share, the
mean visits per ray (zero for the binned rows, whose `steps` are zero)
and ms: on the card the least of --reps timings by CUDA events after a
warm-up; with --device cpu the plain versions' wall time.  The
reference's --packet and --noprefilter set its packet kernel's layout,
which a one-thread-per-ray walk does not have; the stress scene
(--scene stress) is not ported yet.

Usage:
  python -m toyrenderer_tpu_torch.tools.rtbench --scene courtyard \\
      [--rays 1048576] [--reps 3] [--nosah] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from toyrenderer_tpu_torch.device import resolve_device
from toyrenderer_tpu_torch.ops import bvh_cuda
from toyrenderer_tpu_torch.ops import geometry as G
from toyrenderer_tpu_torch.ops.bvh import build_rt_static, refit_bvh
from toyrenderer_tpu_torch.ops.bvh_sah import build_rt_static_sah, refit_sah
from toyrenderer_tpu_torch.ops.ddgi import (
    GDIR_BRICK, GDIR_DIRS, _cone_block, _cone_order, cone_layout)
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.procedural import make_stress_scene

COURTYARD = (Path(__file__).resolve().parent.parent.parent / "resources"
             / "courtyard.glb")
PAIR_CUT = 0.6          # bench.py:140-146: the opaque pair list's share
T_MAX = 1e4


def _blocked(x, r, pbp, brick, dirs):
    return _cone_block(torch.from_numpy(x), r, pbp, brick, dirs).numpy()


def ray_sets(n_rays, aabb_lo, aabb_hi, sun_dir):
    """Shadow-style and probe-style ray sets over the scene bounds, as
    numpy arrays: ((sh_o, sh_d), (pr_o, pr_d), (gd_o, gd_d, gd_g)) --
    the reference's, element for element, in the cone layout of
    TR_CONE_DIRS / TR_CONE_BRICK (ddgi.cone_layout)."""
    cone_dirs, cone_brick = cone_layout()
    ext = aabb_hi - aabb_lo
    side = int(np.sqrt(n_rays))

    # shadow: ground-plane origins in 64x64 tiles, the shared sun
    # direction with a small per-ray jitter
    t = 64
    g = side // t
    ty, tx = np.divmod(np.arange(g * g), g)
    yy, xx = np.divmod(np.arange(t * t), t)
    gy = (ty[:, None] * t + yy[None, :]).reshape(-1)
    gx = (tx[:, None] * t + xx[None, :]).reshape(-1)
    ox = aabb_lo[0] + (gx + 0.5) / side * ext[0]
    oz = aabb_lo[2] + (gy + 0.5) / side * ext[2]
    oy = np.full_like(ox, aabb_lo[1] + 0.02 * ext[1])
    sh_o = np.stack([ox, oy, oz], -1).astype(np.float32)
    rng = np.random.default_rng(0)
    jit = rng.normal(scale=0.004, size=(len(ox), 3))
    d = -sun_dir[None] + jit
    sh_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    # probe: Fibonacci directions in cone order, probes in grid order,
    # direction-major, then cone-blocked as ops/ddgi.py traces them
    n_dirs = 256
    k = np.arange(n_dirs)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * k
    z = 1.0 - 2.0 * (k + 0.5) / n_dirs
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    -1)[_cone_order(n_dirs)]
    n_probes = n_rays // n_dirs
    pbp = -(-n_probes // cone_brick) * cone_brick
    side_p = max(int(round(pbp ** (1.0 / 3.0))), 1)
    ii = np.arange(pbp)
    px = (ii % side_p + 0.5) / side_p
    py = ((ii // side_p) % side_p + 0.5) / side_p
    pz = (ii // (side_p * side_p) % side_p + 0.5) / side_p
    pp = aabb_lo[None] + np.stack([px, py, pz], -1) * ext[None]
    pr_o = np.tile(pp, (n_dirs, 1)).astype(np.float32)
    pr_d = np.repeat(dirs, pbp, axis=0).astype(np.float32)
    # the gdir layout of the same rays: 32 cone directions x 128 probes
    # a block, one direction per 128 rays
    pbg = -(-n_probes // GDIR_BRICK) * GDIR_BRICK
    og = np.tile(pp[:pbg], (n_dirs, 1)).astype(np.float32)
    dg = np.repeat(dirs, pbg, axis=0).astype(np.float32)
    gd_o = _blocked(og, n_dirs, pbg, GDIR_BRICK, GDIR_DIRS)
    gd_d = _blocked(dg, n_dirs, pbg, GDIR_BRICK, GDIR_DIRS)
    gd_g = gd_d.reshape(-1, GDIR_BRICK, 3)[:, 0].copy()
    pr_o = _blocked(pr_o, n_dirs, pbp, cone_brick, cone_dirs)
    pr_d = _blocked(pr_d, n_dirs, pbp, cone_brick, cone_dirs)
    return (sh_o[:n_rays], sh_d[:n_rays]), (pr_o, pr_d), (gd_o, gd_d, gd_g)


def scene_pairs(name: str, objects: int = 192):
    """(host scene, pair_inst, pair_meshlet) of a row set: the stress
    scene with every pair, or the courtyard's opaque pairs cut to 60%."""
    if name == "stress":
        if objects < 1:
            raise ValueError(f"--objects must be >= 1, got {objects}")
        host = make_stress_scene(n_objects=objects, sphere_res=24,
                                 textured=False)
        return (host, *G.static_meshlet_pairs(host))
    host = load_scene(COURTYARD)
    mk_i, _ = G.static_meshlet_pairs(host, 'mask')
    pi, pm = G.static_meshlet_pairs(host, 'not_mask' if len(mk_i) else 'all')
    cap = max(int(len(pi) * PAIR_CUT), 256)
    return host, pi[:cap], pm[:cap]


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=1 << 20)
    p.add_argument("--scene", default="stress",
                   choices=("stress", "courtyard"))
    p.add_argument("--objects", type=int, default=192,
                   help="the stress scene's objects")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--nosah", action="store_true",
                   help="skip the SAH tree rows")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
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


def run(argv=None) -> list[dict]:
    """Build the trees and the ray sets, time every row and print it.
    Returns one dict per row: name, tree, o, d, any_hit, the last run's
    result, ms, mrays_s (and, for the binned rows, the first run's
    `stats` of traverse_binned)."""
    args = _parse(argv)
    dev = resolve_device(args.device)
    print("[stage] scene build...", flush=True)
    host, pi, pm = scene_pairs(args.scene, args.objects)
    scene = host.to_device(dev)

    def on(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    world = G.node_world_matrices(scene, on(host.node_translation),
                                  on(host.node_rotation), on(host.node_scale))
    inst_world = G.instance_transforms(scene, world)[0]
    print("[stage] rt_static...", flush=True)
    rts = build_rt_static(host, pi, pm, device=dev)
    bvh = refit_bvh(rts, inst_world)
    print(f"[scene] {int((rts.payload >= 0).sum())} tris, "
          f"levels={rts.num_levels}, cb={tuple(bvh.child_boxes.shape)} "
          f"leaf={tuple(bvh.leaf_rows.shape)}", flush=True)
    sah = None
    if not args.nosah:
        t = time.time()
        sah = refit_sah(build_rt_static_sah(host, pi, pm, device=dev),
                        inst_world)
        print(f"[sah] nodes={sah.node_rows.shape[0]} "
              f"leaves={sah.leaf_rows.shape[0]} depth={sah.depth} "
              f"({time.time() - t:.1f}s)", flush=True)

    lo, hi = (np.asarray(x) for x in host.world_aabb)
    ((sh_o, sh_d), (pr_o, pr_d), (gd_o, gd_d, gd_g)) = [
        [torch.from_numpy(a).to(dev) for a in s] for s in ray_sets(
            args.rays, lo, hi, np.asarray(host.sun_direction))]
    bins = dict(rounds=int(os.environ.get('TR_BIN_ROUNDS', '2')),
                packet=int(os.environ.get('TR_BIN_PACKET', '1024')),
                max_entries=int(os.environ.get('TR_BIN_ENTRIES', '128')))

    def per_ray(b, o, d, ah, stats):
        return bvh_cuda.traverse(b, o, d, T_MAX, ah)

    def grouped(b, o, d, ah, stats):
        return bvh_cuda.traverse(b, o, d, T_MAX, ah, group_dirs=gd_g)

    def binned(b, o, d, ah, stats):
        return bvh_cuda.traverse_binned(b, o, d, T_MAX, ah, stats=stats,
                                        **bins)

    rows = [("shadow(any-hit)", bvh, sh_o, sh_d, True, per_ray),
            ("probe(closest)", bvh, pr_o, pr_d, False, per_ray),
            ("probe(gdir)", bvh, gd_o, gd_d, False, grouped),
            ("probe(binned)", bvh, pr_o, pr_d, False, binned),
            ("shadow(binned)", bvh, sh_o, sh_d, True, binned)]
    if sah is not None:
        rows += [("probe(sah)", sah, pr_o, pr_d, False, per_ray),
                 ("probe(sah+gdir)", sah, gd_o, gd_d, False, grouped),
                 ("shadow(sah)", sah, sh_o, sh_d, True, per_ray)]
    if dev.type == 'cpu':
        print("[device] cpu: the kernels' plain versions, host wall time",
              flush=True)
    out = []
    for name, tree, o, d, any_hit, fn in rows:
        stats = {}
        res, ms = _timed(lambda: fn(tree, o, d, any_hit, stats), dev,
                         args.reps)
        mrays = o.shape[0] / ms / 1e3
        hit = float(res['hit'].float().mean())
        steps = float(res['steps'].float().mean())
        print(f"{name:18s} {mrays:8.2f} Mrays/s   hit={hit:.3f} "
              f"visits/ray={steps:.1f}  ({ms:.2f} ms)", flush=True)
        out.append(dict(name=name, tree=tree, o=o, d=d, any_hit=any_hit,
                        result=res, ms=ms, mrays_s=mrays, stats=stats))
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
