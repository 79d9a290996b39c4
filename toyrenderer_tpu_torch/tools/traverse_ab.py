"""Time the traversal kernel's schedule against one thread per ray.

csrc/traverse.cu runs persistent warps that take ray slots 32 at a time
from a per-launch counter into a pool of live rays, and refill a lane
from the pool whenever its ray ends (ops/bvh_cuda.py).  This tool builds
it beside a variant made from the same source, `one_thread_per_ray`:
the same walk, the same shared-memory stacks and the same C interface,
but each thread takes the one ray slot of its index, on a grid of
ceil(n / 128) blocks, with no pool and no counter.  On each set of rays
it holds the variant's t, tri and steps bit-equal to the kernel's, then
times both by CUDA events over --reps launches each, in the order
kernel, variant, variant, kernel, and prints one `[ab]` line: each
build's two times (ms per launch) and the variant's change against the
kernel's mean.

Rays: rtbench's courtyard sets -- its shadow rays any-hit and its probe
rays closest-hit on the complete tree (K3), both on the SAH tree
(K3-SAH), the probe rays in the gdir layout (K5) -- each with every slot
live, with 40% of the slots live at random, and with 40% live in runs
of 1024 slots.  With --frames it also runs chip_smoke.py (from the root
of the checkout) with its hold_trace wrapped, and times every traversal
launch that script holds against its plain version: the shadowed
frame's (K3), the all-on update frame's (K3-SAH, K5) and the first
rounds of rtbench's binned rows (K3-seeded).

Usage, on the card:
  python -m toyrenderer_tpu_torch.tools.traverse_ab [--rays 1048576]
      [--reps 20] [--frames]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import sys
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import BUILD_DIR, shared_library
from toyrenderer_tpu_torch.ops import bvh_cuda

ROOT = Path(__file__).resolve().parent.parent.parent

# The persistent kernel's body, from its signature to the launch, and
# the launch's grid: what one_thread_per_ray replaces.
_BODY_START = "  extern __shared__ int stacks[];\n  __shared__ Pool pools[kWarps];"
_BODY_END = "// The launch: as many blocks"
_GRID = "  const int blocks = max(1, min(need, resident));\n"
_RESET = ("  err = cudaMemsetAsync(counter, 0, sizeof(int), s);\n"
          "  if (err != cudaSuccess) return err;\n")
_ONE_RAY = """  extern __shared__ int stacks[];
  __shared__ Pool pools[kWarps];
  const int lane = threadIdx.x % 32;
  int* stk = stacks + (threadIdx.x / 32) * 32 * stack_n + lane;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rays.n) return;
  const float t = rays.t_max[i];
  const int entry = kSeeded ? rays.seeds[i / rays.packet] : 0;
  if (!(rays.live[i] > 0.0f && t > 0.0f && entry >= 0)) {
    rays.t_out[i] = t;
    rays.tri_out[i] = -1;
    rays.steps_out[i] = 0;
    return;
  }
  // the lane's own pool entry, so that the walk starts as take() starts it
  Pool& pool = pools[threadIdx.x / 32];
  const int di = kGroupDirs ? i / kGroup : i;
  pool.slot[lane] = i;
  pool.entry[lane] = entry;
  pool.t_max[lane] = t;
  for (int c = 0; c < 3; ++c) {
    pool.o[c][lane] = rays.origins[3 * i + c];
    pool.d[c][lane] = rays.dirs[3 * di + c];
  }
  Ray r;
  take(pool, lane, r, stk);
  do {
    visit<kSah>(tree, r, stk);
  } while (r.sp > 0 && !(kAnyHit && r.best_tri >= 0.0f));
  finish(rays, r);
}

"""


def one_thread_per_ray(src: str) -> str:
    """traverse.cu's source with its kernel body and grid replaced: a
    thread per ray slot, ceil(n / 128) blocks, the counter unused."""
    a = src.index(_BODY_START)
    b = src.index(_BODY_END)
    if src.count(_GRID) != 1 or src.count(_RESET) != 1:
        raise ValueError("traverse.cu's launch is not the one this tool "
                         "rewrites")
    src = src[:a] + _ONE_RAY + src[b:]
    return (src.replace(_GRID, "  const int blocks = need;\n")
            .replace(_RESET, ""))


def _variant_library():
    """The one-thread-per-ray build, loaded with the kernel's C types."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / "traverse_one_ray.cu"
    src.write_text(one_thread_per_ray(bvh_cuda.SOURCE.read_text()))
    so = shared_library([bvh_cuda.nvcc_path(), *bvh_cuda.NVCC_FLAGS], src,
                        "traverse_one_ray.so")
    lib = ctypes.CDLL(str(so))
    ref = bvh_cuda.kernel_library().traverse_launch
    lib.traverse_launch.restype = ref.restype
    lib.traverse_launch.argtypes = ref.argtypes
    return lib


def compare(label: str, args: tuple, variant, reps: int) -> dict:
    """Hold the variant bit-equal to the kernel on bvh_cuda.launch(*args)
    and time both (kernel, variant, variant, kernel); print the `[ab]`
    line and return its numbers.  The wrapper's launch counts are left
    as they were."""
    counts = dict(bvh_cuda.launches_by_kernel)
    kernel = bvh_cuda.kernel_library
    libs = dict(persistent=kernel, one_ray=lambda: variant)

    def run(name):
        bvh_cuda.kernel_library = libs[name]
        try:
            return bvh_cuda.launch(*args)
        finally:
            bvh_cuda.kernel_library = kernel

    want, got = run("persistent"), run("one_ray")
    for k in ('t', 'tri', 'steps'):
        if not torch.equal(want[k], got[k]):
            raise AssertionError(f"{label}: {k} of one thread per ray "
                                 f"differs on "
                                 f"{int((want[k] != got[k]).sum())} rays")
    times = {name: [] for name in libs}
    for name in ("persistent", "one_ray", "one_ray", "persistent"):
        run(name)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run(name)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / reps)
    bvh_cuda.launches_by_kernel.clear()
    bvh_cuda.launches_by_kernel.update(counts)
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    change = mean["one_ray"] / mean["persistent"] - 1.0
    live = args[5]
    n, n_live = live.shape[0], int((live > 0).sum())
    print(f"[ab] {label} slots={n} live={n_live / n:.3f} persistent="
          + "/".join(f"{x:.4f}" for x in times["persistent"])
          + " one_ray=" + "/".join(f"{x:.4f}" for x in times["one_ray"])
          + f" one_ray_vs_persistent={change:+.1%}", flush=True)
    return dict(label=label, times=times, change=change)


def _liveness(n: int) -> dict:
    """Each slot pattern: every slot live, 40% at random, 40% in runs of
    1024 slots."""
    g = torch.Generator(device='cpu').manual_seed(5)
    runs = (torch.arange(n) // 1024 % 5 < 2)
    return {"all live": torch.ones(n),
            "40% live, random": (torch.rand(n, generator=g) < 0.4).float(),
            "40% live, runs of 1024": runs.float()}


def rtbench_rows(variant, rays: int, reps: int) -> list[dict]:
    """compare() on rtbench's ray sets under each slot pattern."""
    from toyrenderer_tpu_torch.tools import rtbench
    rows = {r['name']: r for r in rtbench.run(["--rays", str(rays),
                                               "--reps", "1"])}
    dev = rows["shadow(any-hit)"]['o'].device
    out = []
    for name, kernel in (("shadow(any-hit)", "K3"),
                         ("probe(closest)", "K3"),
                         ("shadow(sah)", "K3-SAH"),
                         ("probe(sah)", "K3-SAH"),
                         ("probe(gdir)", "K5")):
        r = rows[name]
        o, d = r['o'], r['d']
        gd = (d.reshape(-1, bvh_cuda.GROUP, 3)[:, 0].contiguous()
              if kernel == "K5" else None)
        t_max = torch.full((o.shape[0],), rtbench.T_MAX, device=dev)
        for pattern, live in _liveness(o.shape[0]).items():
            args = (r['tree'], o, d, t_max, r['any_hit'], live.to(dev), gd)
            out.append(compare(f"{kernel} rtbench {name}, {pattern}", args,
                               variant, reps))
    return out


def frame_rows(variant, reps: int) -> int:
    """Run chip_smoke.py with compare() after each hold_trace; returns
    its exit code."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    held = smoke.hold_trace

    def hold_and_compare(label, args):
        st = held(label, args)
        mode = "any-hit" if args[4] else "closest-hit"
        compare(f"{label} chip_smoke {mode}", args, variant, reps)
        return st
    smoke.hold_trace = hold_and_compare
    return smoke.main()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=1 << 20)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--frames", action="store_true",
                   help="also time chip_smoke.py's traversal launches")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("traverse_ab: needs a CUDA device", file=sys.stderr)
        return 2
    variant = _variant_library()
    rtbench_rows(variant, args.rays, args.reps)
    return frame_rows(variant, args.reps) if args.frames else 0


if __name__ == "__main__":
    sys.exit(main())
