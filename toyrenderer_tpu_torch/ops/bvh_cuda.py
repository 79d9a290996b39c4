"""Ray traversal of the two trees -- the complete 8-ary tree (ops/bvh.py)
and the SAH tree (ops/bvh_sah.py) -- with per-ray or grouped directions:
the CUDA kernel's wrapper, its plain PyTorch version, the dispatch the
frame calls, and the binned traversal.

Counterpart of toyrenderer_tpu/ops/bvh_pallas.py's `traverse_auto`,
`traverse_pallas`, `traverse_pallas_gdir` and `traverse_binned`.  The
TPU kernels it replaces, `_traverse_kernel` (bvh_pallas.py:250) on the
complete tree (K3), in its explicit-refs mode on the SAH tree (K3-SAH)
and in its seeded mode (K3-seeded: every packet of `packet` rays starts
at its own subtree, `seeds[i // packet]`), and `_traverse_kernel_gdir`
(bvh_pallas.py:595, K5: ray i's direction is `group_dirs[i // 128]`),
become one source, csrc/traverse.cu, built by nvcc into the build
directory at first use and called through ctypes.

The contract is the reference kernel's: `traverse(bvh, origins (N, 3),
directions (N, 3), t_max (N,) or scalar, any_hit, live)` returns
dict(hit (N,) bool, t (N,) f32 -- the hit distance, t_max on a miss --,
tri (N,) i32 -- the hit triangle's payload, -1 on a miss --, steps (N,)
i32 -- nodes the ray visited).  Every node a ray needs is visited: there
is no step budget.  Any-hit rays stop at the first leaf that gives a hit,
so their `t` / `tri` are that leaf's nearest, not the scene's.

The kernel runs persistent warps that take ray slots 32 at a time into
a pool of the live ones (a dead slot writes its miss at once) and
refill a lane from it whenever its ray ends; each ray is walked
depth-first with its own stack, the nearest
child popping first (the complete tree: children pushed far-to-near by
the ray's direction signs; the SAH tree: in split-axis order, reversed
when the ray runs negative on the node's axis); `traverse_plain` walks
every ray in exactly that order, lockstep over the rays (one node per
ray per step, until every stack is empty), with the kernel's arithmetic
operation for operation, so hit, t, tri and steps are bit-equal between
them.  It is the port of the reference package's lockstep `bvh.traverse`,
with the kernel's semantics, and the oracle the kernel is held against.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from toyrenderer_tpu_torch._build import shared_library
from toyrenderer_tpu_torch.ops.bvh import ARITY, LEAF_TRIS
from toyrenderer_tpu_torch.ops.bvh_sah import BvhSah
from toyrenderer_tpu_torch.ops.raster_cuda import NVCC_FLAGS, _check, nvcc_path

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "traverse.cu"
MAX_LEVELS = 9          # the complete tree's stack bound; node << 4 fits
SAH_STACK = 160         # the SAH kernels' stack: depth <= 22
GROUP = 128             # rays per grouped direction (K5)
BIN_PACKET = 1024       # rays per seeded packet (K3-seeded)
ABSENT_CUT = -1.0e8     # SAH child refs above it are real
_LEVEL_BITS = 4         # complete-tree stack entry = (node << 4) | level
_EPS_DIR = 1e-12

# launches of the CUDA kernels since the last reset, by the TPU kernel
# each flavour replaces (K3: the complete tree, K3-SAH: the SAH tree, K5:
# grouped directions on either tree, K3-seeded: seeded packets on the
# complete tree; K6: the pair route's fold, ops/pairs_cuda.py; K8: the
# chunk route's fold, ops/chunks_cuda.py); the plain versions never count
launches_by_kernel = {'K3': 0, 'K3-SAH': 0, 'K5': 0, 'K3-seeded': 0,
                      'K6': 0, 'K8': 0}


def reset_launches():
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def stack_entries(bvh) -> int:
    """The DFS stack a walk of `bvh` needs: 7 per internal level + 1."""
    if isinstance(bvh, BvhSah):
        return bvh.depth * (ARITY - 1) + 1
    return (bvh.num_levels - 1) * (ARITY - 1) + 1


def _check_depth(bvh):
    if isinstance(bvh, BvhSah):
        if stack_entries(bvh) > SAH_STACK:
            raise ValueError(f"SAH tree of depth {bvh.depth}: the kernel's "
                             f"stack holds {SAH_STACK} entries, the walk "
                             f"needs {stack_entries(bvh)}")
    elif bvh.num_levels > MAX_LEVELS:
        raise ValueError(f"tree of {bvh.num_levels} levels: at most "
                         f"{MAX_LEVELS}")


def expand_group_dirs(group_dirs, n: int):
    """(N / 128, 3) grouped directions -> (N, 3): ray i's direction is
    group_dirs[i // 128]."""
    if group_dirs.shape[0] * GROUP != n:
        raise ValueError(f"{group_dirs.shape[0]} grouped directions for "
                         f"{n} rays: want one per {GROUP}")
    return group_dirs.repeat_interleave(GROUP, dim=0)


def _rays(origins, t_max, live):
    """(t_max (N,) f32, live (N,) f32) broadcast to the ray count."""
    n = origins.shape[0]
    dev = origins.device
    if isinstance(t_max, torch.Tensor):
        t_max = t_max.to(dev, torch.float32).expand(n).contiguous()
    else:                       # a fill on the device, no host copy
        t_max = torch.full((n,), float(t_max), device=dev)
    if live is None:
        live = torch.ones(n, dtype=torch.float32, device=dev)
    return t_max, live.to(dev, torch.float32).contiguous()


def _slab_mask(rows, inv, oinv, best_t):
    """(m, 8) bool: the children of parent rows (m, 48) the rays enter
    before best_t; the kernel's slab test, t = lo * inv - o * inv."""
    b = rows.reshape(-1, 6, ARITY)
    t0 = [b[:, c] * inv[:, c, None] - oinv[:, c, None] for c in range(3)]
    t1 = [b[:, 3 + c] * inv[:, c, None] - oinv[:, c, None]
          for c in range(3)]
    mn = [torch.minimum(a, z) for a, z in zip(t0, t1)]
    mx = [torch.maximum(a, z) for a, z in zip(t0, t1)]
    tmin = torch.maximum(torch.maximum(mn[0], mn[1]),
                         torch.clamp(mn[2], min=0.0))
    tmax = torch.minimum(torch.minimum(mx[0], mx[1]),
                         torch.minimum(mx[2], best_t[:, None]))
    return tmax >= tmin


def _leaf_fold(rows, o, d, best_t, best_tri):
    """Moller-Trumbore of rays (m,) against leaf rows (m, 120), the nearest
    hit folded in triangle order (strict t < best_t).  Returns the new
    (best_t, best_tri)."""
    r = rows.reshape(-1, 10, LEAF_TRIS)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, pay = r.unbind(1)
    ox, oy, oz = (o[:, c, None] for c in range(3))
    dx, dy, dz = (d[:, c, None] for c in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) < 1e-7, 0.0, 1.0 / det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (tt > 1e-7) & (pay >= 0.0))
    for j in range(LEAF_TRIS):
        upd = ok[:, j] & (tt[:, j] < best_t)
        best_t = torch.where(upd, tt[:, j], best_t)
        best_tri = torch.where(upd, pay[:, j], best_tri)
    return best_t, best_tri


def traverse_plain(bvh, origins, directions, t_max, any_hit=False,
                   live=None, census: bool = False,
                   group_dirs=None, seeds=None,
                   packet: int = BIN_PACKET) -> dict:
    """The kernel's function in plain PyTorch, on any device and either
    tree: each ray's depth-first walk, in the kernel's order, lockstep
    over the rays.  With `group_dirs` (N / 128, 3), ray i's direction is
    group_dirs[i // 128] and `directions` is not read.  With `seeds`
    (P,) i32 (the complete tree only), ray i's walk starts at the stack
    entry seeds[i // packet], (node << 4) | level, instead of the root;
    a negative seed leaves its stack empty (a miss).  Returns the
    contract's dict (see the module docstring); with `census`, also what
    the walk read, for a bound on the work: `leaf_steps` (N,) i32 (the
    leaf visits among `steps`) and `box_rows_read` (R,) / `leaf_rows_read`
    (G,) bool (the node and leaf rows some ray read)."""
    _check_depth(bvh)
    dev = origins.device
    n = origins.shape[0]
    if group_dirs is not None:
        directions = expand_group_dirs(group_dirs, n)
    if seeds is not None:
        _check_seeds(bvh, seeds, n, packet, group_dirs)
    t_max, live = _rays(origins, t_max, live)
    o, d = origins, directions
    sd = torch.where(torch.abs(d) < _EPS_DIR,
                     torch.where(d < 0.0, -_EPS_DIR, _EPS_DIR), d)
    inv = 1.0 / sd
    oinv = o * inv
    neg = (d < 0.0).to(torch.int64)
    flip = (neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]

    sah = isinstance(bvh, BvhSah)
    nodes = bvh.node_rows if sah else bvh.child_boxes
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1.0, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = (live > 0.0) & (t_max > 0.0)
    # one spare entry: the push loop writes its candidate at the top
    stack = torch.zeros((n, stack_entries(bvh) + 1), dtype=torch.int64,
                        device=dev)
    sp = alive.to(torch.int64)              # the root, entry 0, pushed
    if seeds is not None:
        seed = seeds.long()[torch.arange(n, device=dev) // packet]
        stack[:, 0] = torch.clamp(seed, min=0)
        sp = sp * (seed >= 0)
    if not sah:
        offsets = torch.tensor(list(bvh.level_offset) or [0],
                               dtype=torch.int64, device=dev)
        leaf_level = bvh.num_levels - 1
    n_box, n_leaf = nodes.shape[0], bvh.leaf_rows.shape[0]
    if census:
        leaf_steps = torch.zeros(n, dtype=torch.int32, device=dev)
        box_read = torch.zeros(n_box, dtype=torch.bool, device=dev)
        leaf_read = torch.zeros(n_leaf, dtype=torch.bool, device=dev)
    run = torch.nonzero(sp > 0).flatten()
    while run.numel() > 0:
        top = sp[run] - 1
        entry = stack[run, top]
        sp[run] = top
        steps[run] += 1
        if sah:
            is_leaf = (entry & 1) == 1
            node = entry >> 1
        else:
            level = entry & ((1 << _LEVEL_BITS) - 1)
            node = entry >> _LEVEL_BITS
            is_leaf = level == leaf_level

        sel = is_leaf & (node < n_leaf)
        rl = run[sel]
        if census:
            leaf_steps[rl] += 1
            leaf_read[node[sel]] = True
        if rl.numel() > 0:
            best_t[rl], best_tri[rl] = _leaf_fold(
                bvh.leaf_rows[node[sel]], o[rl], d[rl], best_t[rl],
                best_tri[rl])

        inner = ~is_leaf
        ri, ni = run[inner], node[inner]
        if sah:
            row = ni
        else:
            li = level[inner]
            row = offsets[torch.clamp(li, max=offsets.numel() - 1)] + ni
        there = row < n_box                 # not on a well-formed tree
        ri, ni, row = ri[there], ni[there], row[there]
        if census:
            box_read[row] = True
        if ri.numel() > 0:
            rows = nodes[row]
            want = _slab_mask(rows[:, :6 * ARITY], inv[ri], oinv[ri],
                              best_t[ri])
            spi = sp[ri]
            if sah:
                refs = rows[:, 6 * ARITY:7 * ARITY]
                axis = rows[:, 7 * ARITY].long()
                rev = torch.gather(d[ri], 1, axis[:, None])[:, 0] < 0.0
                for jj in range(ARITY - 1, -1, -1):
                    kk = torch.where(rev, ARITY - 1 - jj, jj)[:, None]
                    ref = torch.gather(refs, 1, kk)[:, 0]
                    bit = torch.gather(want, 1, kk)[:, 0] & (ref > ABSENT_CUT)
                    lf = ref < -0.5
                    idx = torch.where(lf, -(ref + 1.0), ref).long()
                    stack[ri, spi] = (idx << 1) | lf.to(torch.int64)
                    spi = spi + bit.to(torch.int64)
            else:
                li = li[there]
                fl = flip[ri]
                for jj in range(ARITY - 1, -1, -1):
                    k = jj ^ fl
                    bit = torch.gather(want, 1, k[:, None])[:, 0]
                    # written at the top either way; kept only when pushed
                    stack[ri, spi] = (((ni * ARITY + k) << _LEVEL_BITS)
                                      | (li + 1))
                    spi = spi + bit.to(torch.int64)
            sp[ri] = spi

        go = sp[run] > 0
        if any_hit:
            go = go & (best_tri[run] < 0.0)
        run = run[go]
    tri = best_tri.to(torch.int32)
    out = dict(hit=tri >= 0, t=best_t, tri=tri, steps=steps)
    if census:
        out.update(leaf_steps=leaf_steps, box_rows_read=box_read,
                   leaf_rows_read=leaf_read)
    return out


@functools.lru_cache(maxsize=1)
def kernel_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    so = shared_library([nvcc_path(), *NVCC_FLAGS], SOURCE, "traverse.so")
    lib = ctypes.CDLL(str(so))
    fn = lib.traverse_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                      ctypes.c_void_p])
    return lib


def _check_seeds(bvh, seeds, n: int, packet: int, group_dirs):
    if isinstance(bvh, BvhSah) or group_dirs is not None:
        raise ValueError("seeded packets walk the complete tree with "
                         "per-ray directions")
    if packet <= 0 or seeds.dim() != 1 or seeds.shape[0] * packet < n:
        raise ValueError(f"{tuple(seeds.shape)} seeds of {packet} rays "
                         f"for {n} rays")


def launch(bvh, origins, directions, t_max, any_hit=False, live=None,
           group_dirs=None, seeds=None, packet: int = BIN_PACKET,
           schedule: dict | None = None) -> dict:
    """One launch of the CUDA kernel on the current stream, on either
    tree; with `group_dirs` (N / 128, 3) the grouped-direction kernel
    (K5), which reads them in place of `directions`; with `seeds` (P,)
    i32 the seeded kernel (K3-seeded, see traverse_plain).  Returns the
    contract's dict.  With `schedule` (a dict), it also receives the
    persistent warps launched (`warps`) and the ray slots they took
    (`fetched`, a device tensor: each warp's own 32, then 32 at a time
    from the launch's counter, the last, empty fetch included)."""
    _check_depth(bvh)
    dev = origins.device
    n = origins.shape[0]
    f32 = torch.float32
    t_max, live = _rays(origins, t_max, live)
    sah = isinstance(bvh, BvhSah)
    nodes, leaves = (bvh.node_rows if sah else bvh.child_boxes), bvh.leaf_rows
    _check(nodes, 'node rows', f32,
           (nodes.shape[0], (8 if sah else 6) * ARITY), dev)
    _check(leaves, 'leaf_rows', f32, (leaves.shape[0], 10 * LEAF_TRIS), dev)
    _check(origins, 'origins', f32, (n, 3), dev)
    if group_dirs is None:
        dirs = directions
        _check(dirs, 'directions', f32, (n, 3), dev)
    else:
        dirs = group_dirs
        if n % GROUP:
            raise ValueError(f"grouped directions need whole groups of "
                             f"{GROUP} rays, got {n}")
        _check(dirs, 'group_dirs', f32, (n // GROUP, 3), dev)
    if nodes.data_ptr() % 16 or leaves.data_ptr() % 16:
        raise ValueError("tree rows must be 16-byte aligned")
    offs = [] if sah else list(bvh.level_offset)
    if not sah and len(offs) != bvh.num_levels - 1:
        raise ValueError(f"level_offset has {len(offs)} entries for "
                         f"{bvh.num_levels} levels")
    t = torch.empty(n, dtype=f32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev)
    offs_c = (ctypes.c_int * max(len(offs), 1))(*offs)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    warps = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if seeds is not None:
        _check_seeds(bvh, seeds, n, packet, group_dirs)
        _check(seeds, 'seeds', torch.int32, (seeds.shape[0],), dev)
    err = kernel_library().traverse_launch(
        nodes.data_ptr(), nodes.shape[0], leaves.data_ptr(),
        leaves.shape[0], 1 if sah else bvh.num_levels, offs_c,
        origins.data_ptr(), dirs.data_ptr(), t_max.data_ptr(),
        live.data_ptr(), None if seeds is None else seeds.data_ptr(),
        packet, t.data_ptr(), tri.data_ptr(), steps.data_ptr(), n,
        int(any_hit), bvh.depth if sah else 0, int(group_dirs is not None),
        counter.data_ptr(), ctypes.byref(warps), stream)
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {err}")
    if schedule is not None:
        schedule.update(warps=warps.value,
                        fetched=counter[0] + 32 * warps.value)
    launches_by_kernel['K3-seeded' if seeds is not None
                       else 'K5' if group_dirs is not None
                       else 'K3-SAH' if sah else 'K3'] += 1
    return dict(hit=tri >= 0, t=t, tri=tri, steps=steps)


def traverse(bvh, origins, directions, t_max, any_hit=False, live=None,
             group_dirs=None, seeds=None, packet: int = BIN_PACKET) -> dict:
    """Trace rays through either tree: CUDA tensors launch the kernel,
    CPU tensors run the plain version."""
    dev = origins.device
    if dev.type == 'cuda':
        return launch(bvh, origins, directions, t_max, any_hit, live,
                      group_dirs, seeds, packet)
    if dev.type == 'cpu':
        return traverse_plain(bvh, origins, directions, t_max, any_hit,
                              live, group_dirs=group_dirs, seeds=seeds,
                              packet=packet)
    raise ValueError(f"traverse: unsupported device {dev}")


def traverse_auto(bvh, origins, directions, t_max, any_hit: bool = False,
                  max_steps: int = 128, live=None, sp_mesh=None,
                  group_dirs=None, chunked: bool = False,
                  pairs: bool = False, pair_tables=None) -> dict:
    """The frame's entry to the traversal (bvh_pallas.py:96): `traverse`
    on either tree.  `group_dirs` (N / 128, 3) routes to the grouped-
    direction kernel when N is a multiple of 128, as the reference does;
    otherwise the per-ray `directions` are traced.  `pairs` routes to
    the pair route (ops/rt_pairs.traverse_pairs, K6) with `pair_tables`
    (its mt_tables, built by the caller once per refit); `chunked` to the
    chunk route (ops/rt_chunks.traverse_chunks, K8), which builds its
    chunk table, and takes precedence over `pairs`, as the reference's
    probe trace gives it (its ddgi.py:665, 718-730).  The reference
    takes the pair route only on the TPU (or in interpret mode) and
    falls through to its lockstep traversal elsewhere; the port takes
    its accelerator branch on every device, so on the CPU the routes run
    their plain folds.  `max_steps` is accepted and, as for the
    reference's kernel, does not bound the walk.  `sp_mesh` = (Mesh,
    axis) with more than one device on the axis traces the rays in
    slices, one per device (_traverse_sharded)."""
    if sp_mesh is not None:
        mesh, axis = _mesh_axis(sp_mesh)
        if mesh.shape[axis] > 1:
            return _traverse_sharded(
                bvh, origins, directions, t_max, any_hit, live, mesh, axis,
                group_dirs=group_dirs, chunked=chunked, pairs=pairs,
                pair_tables=pair_tables)
    if chunked:
        from toyrenderer_tpu_torch.ops import rt_chunks
        return rt_chunks.traverse_chunks(bvh, origins, directions, t_max,
                                         any_hit=any_hit, live=live)
    if pairs:
        from toyrenderer_tpu_torch.ops import rt_pairs
        return rt_pairs.traverse_pairs(bvh, origins, directions, t_max,
                                       any_hit=any_hit, live=live,
                                       tables=pair_tables)
    if group_dirs is not None and origins.shape[0] % GROUP:
        group_dirs = None
    return traverse(bvh, origins, directions, t_max, any_hit, live,
                    group_dirs)


def _mesh_axis(sp_mesh):
    """(mesh, axis) of an sp_mesh argument, or TypeError."""
    try:
        mesh, axis = sp_mesh
        mesh.shape[axis]
    except (TypeError, ValueError, KeyError, AttributeError) as e:
        raise TypeError(f"sp_mesh must be (parallel.Mesh, axis name), got "
                        f"{sp_mesh!r}") from e
    return mesh, axis


def _traverse_sharded(bvh, origins, directions, t_max, any_hit, live, mesh,
                      axis, group_dirs=None, chunked: bool = False,
                      pairs: bool = False, pair_tables=None) -> dict:
    """traverse_auto over the devices of `axis` (bvh_pallas.py:189-260):
    the rays, padded with dead rays to a multiple of the axis, are cut
    into one slice per device, each traced against that device's copy of
    the tree (Mesh.put: copied once per tree) in the asked route, the
    results gathered onto the mesh's first device and cut back to N.
    With grouped directions the multiple is axis x 128, so no slice
    splits a 128-ray group; the pair and chunk routes, which fold blocks
    of 128 rays, get the same multiple, so each slice holds whole blocks
    of the unsharded call.  Their pair list has a capacity for the whole
    call (rt_pairs.pair_list): each slice continues the list of the
    slices before it (its offset, the pairs they listed, passes from
    device to device without a host read), so the same blocks overflow
    to the per-ray fallback as in the unsharded call, where the
    reference caps each shard's list on its own.  Nothing else mixes
    rays, so the result is the unsharded call's bit for bit.  The pair
    and chunk routes' tables are built once per device."""
    from toyrenderer_tpu_torch.ops import rt_chunks, rt_pairs
    from toyrenderer_tpu_torch.parallel.mesh import gather, run_on, to_device
    devices = mesh.along(axis)
    nsp = len(devices)
    n = origins.shape[0]
    grouped = group_dirs is not None and n % GROUP == 0
    blocked = pairs or chunked
    quant = nsp * GROUP if (grouped or blocked) else nsp
    n_pad = -(-n // quant) * quant
    per = n_pad // nsp
    t_max, live_f = _rays(origins, t_max, live)

    def pad(x):
        return torch.nn.functional.pad(
            x, (0, 0, 0, n_pad - n) if x.dim() == 2 else (0, n_pad - n))
    o_p, d_p, t_p, l_p = (pad(x) for x in (origins, directions, t_max,
                                           live_f))
    g_p = pad(group_dirs) if grouped else None
    # the unsharded call's list capacity and each slice's place in it
    cap = rt_pairs.list_capacity(-(-n // GROUP), rt_pairs.PAIR_FACTOR)
    offset = 0
    tables = {}
    parts = []
    for i, dev in enumerate(devices):
        sl = slice(i * per, (i + 1) * per)
        with run_on(dev):
            tree = mesh.put(bvh, dev)
            o, d, t, lv = (to_device(x[sl], dev).contiguous()
                           for x in (o_p, d_p, t_p, l_p))
            key = str(dev)
            if blocked:
                if key not in tables:
                    tables[key] = (
                        rt_chunks.chunk_table(tree) if chunked
                        else mesh.put(pair_tables, dev)
                        if pair_tables is not None
                        else rt_pairs.mt_tables(tree))
                route = (rt_chunks.traverse_chunks if chunked
                         else rt_pairs.traverse_pairs)
                st = {}
                res = route(tree, o, d, t, any_hit=any_hit, live=lv,
                            tables=tables[key], stats=st,
                            budget=(to_device(offset, dev), cap))
                offset = to_device(offset, dev) + st['counts'].sum()
            else:
                kw = {}
                if grouped:
                    kw['group_dirs'] = to_device(
                        g_p[i * per // GROUP:(i + 1) * per // GROUP],
                        dev).contiguous()
                res = traverse_auto(tree, o, d, t, any_hit=any_hit, live=lv,
                                    **kw)
        parts.append(res)
    out_dev = mesh.first
    return {k: gather([p[k] for p in parts], out_dev, 0)[:n]
            for k in parts[0]}


def _entry_nodes_complete(bvh, max_entries: int = 128):
    """The deepest internal level of the complete tree with at most
    max_entries nodes (bvh_pallas.py:1125) -> (boxes (E, 6) f32
    [lo.xyz hi.xyz], seeds (E,) i32 stack entries (node << 4) | level,
    level), or None when no internal level below the root fits.  The
    boxes come from the parent rows one level up; the prefix-truncated
    tree's padding children carry sealed far-point boxes and are never
    entered."""
    offs = list(bvh.level_offset) + [bvh.child_boxes.shape[0]]
    best = None
    for lvl in range(1, bvh.num_levels - 1):
        if (offs[lvl] - offs[lvl - 1]) * ARITY <= max_entries:
            best = lvl
    if best is None:
        return None
    rows = bvh.child_boxes[offs[best - 1]:offs[best]]
    boxes = rows.reshape(-1, 6, ARITY).transpose(1, 2).reshape(-1, 6)
    ids = torch.arange(boxes.shape[0], dtype=torch.int32,
                       device=boxes.device)
    return boxes.contiguous(), (ids << _LEVEL_BITS) | best, best


def traverse_binned(bvh, origins, directions, t_max, any_hit: bool = False,
                    live=None, rounds: int = 2, packet: int = BIN_PACKET,
                    max_entries: int = 128, stats: dict | None = None
                    ) -> dict:
    """The binned traversal of the complete tree (bvh_pallas.py:1150),
    exact for closest and any hit; `steps` all zeros, as in the
    reference.

    1. Phase A tests every ray against the entry subtrees' boxes (the
       deepest level with at most max_entries nodes), with the kernel's
       slab arithmetic.
    2. Each round sorts the still-active rays by their nearest unvisited
       entry, pads each entry's run to whole packets of `packet` slots
       (capacity (ceil(N / packet) + E) * packet), and walks each packet
       from its entry (K3-seeded; padding packets get a negative seed),
       the ray's best t so far as its t_max; a strictly nearer hit
       replaces the best.  A ray whose best hit precedes every unvisited
       entry drops out.
    3. Rays that could still find a nearer hit take one root-seeded
       walk (K3), live-masked, so the result is exact for any `rounds`.

    A tree with no usable entry level goes straight to `traverse`.  With
    `stats` (a dict), it also receives the entry count, the packets of
    each round (`packets`: with a non-negative seed; `cap_packets`) and
    the exactness pass's live rays (`rest`), as tensors."""
    if isinstance(bvh, BvhSah):
        raise ValueError("traverse_binned walks the complete tree: its "
                         "entry level reads level_offset")
    n = origins.shape[0]
    dev = origins.device
    ent = _entry_nodes_complete(bvh, max_entries)
    if ent is None:
        return traverse(bvh, origins, directions, t_max, any_hit, live)
    boxes, seeds, _ = ent
    e_n = boxes.shape[0]
    t_max, live_f = _rays(origins, t_max, live)
    live_b = live_f > 0.0

    # phase A: the entry intervals, as the kernel tests a child box
    d = directions
    sd = torch.where(torch.abs(d) < _EPS_DIR,
                     torch.where(d < 0.0, -_EPS_DIR, _EPS_DIR), d)
    inv = 1.0 / sd
    oinv = origins * inv
    tn = torch.zeros((n, e_n), device=dev)
    tf = torch.full((n, e_n), torch.inf, device=dev)
    for c in range(3):
        t0 = boxes[None, :, c] * inv[:, c, None] - oinv[:, c, None]
        t1 = boxes[None, :, 3 + c] * inv[:, c, None] - oinv[:, c, None]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    ok = ((tf >= tn) & live_b[:, None] & (tn <= t_max[:, None])
          & (tn < 1e30))
    tmins = torch.where(ok, tn, torch.inf)                      # (N, E)

    cap_p = -(-n // packet) + e_n
    cap_slots = cap_p * packet
    ids = torch.arange(n, device=dev)
    e_ar = torch.arange(e_n, device=dev)
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    packets = []
    for _ in range(rounds):
        active = live_b & (tmins.amin(1) < best_t)
        if any_hit:
            active = active & (best_tri < 0)
        sel = torch.argmin(tmins, 1)
        key = torch.where(active, sel, e_n)
        skey, sid = torch.sort(key, stable=True)
        bounds = torch.searchsorted(skey, torch.arange(e_n + 1, device=dev))
        counts = bounds[1:] - bounds[:-1]
        padded = -(-counts // packet) * packet
        cum = torch.cumsum(padded, 0)
        sk = torch.clamp(skey, max=e_n - 1)
        slot = torch.where(skey < e_n, cum[sk] - padded[sk] + ids
                           - bounds[sk], cap_slots)
        slot_of_ray = torch.empty_like(slot)
        slot_of_ray[sid] = slot
        ray_slot = torch.full((cap_slots + 1,), -1, dtype=torch.int64,
                              device=dev)
        ray_slot.scatter_(0, slot, sid)          # cap_slots: a dump slot
        ray_slot = ray_slot[:cap_slots]
        e_of_p = torch.searchsorted(
            cum, torch.arange(cap_p, device=dev) * packet, right=True)
        seed_p = torch.where(e_of_p < e_n,
                             seeds[torch.clamp(e_of_p, max=e_n - 1)], -1)
        packets.append((seed_p >= 0).sum())

        ridx = torch.clamp(ray_slot, min=0)
        out = traverse(bvh, origins[ridx].contiguous(),
                       d[ridx].contiguous(), best_t[ridx].contiguous(),
                       any_hit, (ray_slot >= 0).to(torch.float32),
                       seeds=seed_p.to(torch.int32).contiguous(),
                       packet=packet)
        sl = torch.clamp(slot_of_ray, max=cap_slots - 1)
        t_r, tri_r = out['t'][sl], out['tri'][sl]
        upd = (slot_of_ray < cap_slots) & (tri_r >= 0) & (t_r < best_t)
        best_t = torch.where(upd, t_r, best_t)
        best_tri = torch.where(upd, tri_r, best_tri)
        tmins = torch.where(active[:, None] & (e_ar == sel[:, None]),
                            torch.inf, tmins)

    rest = live_b & (tmins.amin(1) < best_t)
    if any_hit:
        rest = rest & (best_tri < 0)
    res = traverse(bvh, origins, directions, best_t, any_hit,
                   rest.to(torch.float32))
    upd = rest & res['hit'] & (res['t'] < best_t)
    best_t = torch.where(upd, res['t'], best_t)
    best_tri = torch.where(upd, res['tri'], best_tri)
    if stats is not None:
        stats.update(entries=e_n, rounds=rounds, packets=packets,
                     cap_packets=cap_p, rest=rest.sum())
    hit = best_tri >= 0
    return dict(hit=hit, t=torch.where(hit, best_t, t_max), tri=best_tri,
                steps=torch.zeros(n, dtype=torch.int32, device=dev))
