// 8-ary BVH ray traversal, any-hit or closest-hit, for Hopper (sm_90a),
// on either tree flavour and with per-ray or grouped directions.
//
// Replaces the TPU kernels _traverse_kernel
// (toyrenderer_tpu/ops/bvh_pallas.py:250), on the complete tree (K3),
// on the SAH tree (its explicit_refs mode, K3-SAH) and seeded (its
// seeded mode, K3-seeded: the binned traversal's packets each start at
// their own subtree), and _traverse_kernel_gdir (bvh_pallas.py:595, K5),
// which is K3 with ray i's direction group_dirs[i / 128].
//
// Trees.  The complete tree of ops/bvh.py: child rows (R, 48) f32,
// component-major [lo.x x8 | lo.y x8 | lo.z x8 | hi.x x8 | hi.y x8 |
// hi.z x8], stored per level as its reachable prefix from
// level_offset[level]; child k of node i is node 8i+k one level down.
// The SAH tree of ops/bvh_sah.py: node rows (PR, 64) f32, the same 48
// box floats, then 8 child refs as floats (>= 0 node row, < -0.5 leaf
// row -(ref+1), <= -1e8 empty slot), the split axis (the children are
// sorted along it) and padding.  Leaf rows (G, 120) f32 of both:
// [v0.x x12 | v0.y | v0.z | e1.x .. e2.z | payload x12].
//
// The TPU kernel walks packets of 4096 rays with one shared scalar DFS
// stack, because a TPU core has no per-lane control flow; every visit
// evaluates the whole packet.  Here each lane of a warp walks its own ray
// with its own DFS stack: pop a node; at an internal node slab-test its
// 8 children from one row (12 16-byte loads) and push the ones the ray
// enters so that the nearest pops first -- on the complete tree child
// k ^ flip by the ray's direction signs, on the SAH tree the children in
// split-axis order, reversed when the ray's own direction is negative on
// that axis (the TPU uses the packet's summed sign); at a leaf,
// Moller-Trumbore against its 12 triangles, read four at a time as
// 16-byte loads of each component, folding the nearest hit in triangle
// order with a strict t < best_t.  Any-hit rays leave at the first leaf
// that gives a hit; closest-hit rays run until their stack is empty.
//
// The warps are persistent: the launch holds as many as the SMs keep
// resident.  Each warp takes its own first 32 ray slots, then 32 at a
// time from a per-launch counter (reset by the launch with
// cudaMemsetAsync), loading them a slot a lane: a dead slot (live <= 0,
// t_max <= 0, or a negative seed) writes its miss at once, and the live
// ones go, packed in slot order, into the warp's pool in shared memory.
// Whenever a lane's ray ends the lane takes the pool's next ray (a ballot
// ranks the idle lanes), so the dead slots hold no lane and a warp runs
// rays until the slots run out, instead of as long as its longest ray.
// Each warp keeps its 32 stacks in shared memory, entry-major (entry e
// of lane l at e * 32 + l, so the lanes hit 32 distinct banks), sized for
// the tree at hand: 7 entries per internal level + 1 ((levels-1)*7+1 on
// the complete tree, at most 9 levels; depth*7+1 on the SAH tree, up to
// the reference's STACK_CAP of 160 entries, depth <= 22; a deeper tree is
// refused).  A walk touches only the entries it uses.  With grouped
// directions each ray reads its group's direction (one 12-byte row per
// 128 rays) instead of its own; everything else is the same, so K5 gives
// exactly what K3 gives on the expanded directions.  Seeded (complete tree, per-ray
// directions only): stack entry 0 is the seed of the ray's packet,
// seeds[i / packet], in the reference's encoding (node << 4) | level; a
// negative seed leaves the stack empty and the ray reports a miss; the
// walk below the seed is K3's.  The instances: any-hit x (complete, SAH)
// x (per-ray, grouped) directions, and any-hit x seeded on the complete
// tree -- 10 in all.
//
// Arithmetic is the TPU kernel's, operation for operation: the
// direction guard |d| < 1e-12 -> +-1e-12, the slab t = lo * inv - o * inv
// with tmin clamped at 0 and tmax at the best t, Moller-Trumbore with
// |det| < 1e-7 -> no hit and t > 1e-7, sums left to right.  Built with
// -fmad=false, so hit, t and tri are bit-equal to traverse_plain, which
// walks each ray in this same order.
//
// Each ray's walk is the same whichever lane and warp run it, so hit, t,
// tri and the visit count do not depend on the schedule.
//
// Bound: operations for coherent rays (slab tests and triangle tests of
// the nodes each ray visits), the tree's bytes read once; the tree
// stays resident in the 50 MB L2.  What holds it back on an H100 is
// the latency of each visit's row loads (12 or 30 16-byte loads, then
// the tests that need them) at 20 resident warps an SM, not idle lanes:
// packing the live rays sped the closest-hit probe rays up by a tenth
// to a fifth and moved the any-hit rays by a few percent either way
// (PERF.md, PR 12).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kArity = 8;
constexpr int kLeafTris = 12;
constexpr int kMaxLevels = 9;                  // node << 4 stays in an int
constexpr int kLevelBits = 4;
constexpr int kGroup = 128;                    // rays per grouped direction
constexpr int kSahStack = 160;                 // SAH tree: depth <= 22
constexpr float kAbsentCut = -1.0e8f;          // SAH refs above it are real

struct Tree {
  const float4* boxes;      // complete: (R, 12) float4; SAH: (PR, 16)
  const float4* leaves;     // (G, 30) float4
  int n_box_rows, n_leaf_rows, n_levels;
  int level_offset[kMaxLevels];
};

struct Rays {
  const float* origins;                        // (N, 3)
  const float* dirs;                           // (N, 3), or (N / 128, 3)
  const float* t_max;                          // (N,)
  const float* live;                           // (N,)
  float* t_out;                                // (N,)
  int* tri_out;                                // (N,) payload, -1 = miss
  int* steps_out;                              // (N,) nodes visited
  const int* seeds;                            // (N / packet,) or null
  int packet;                                  // rays per seeded packet
  int n;
};

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// the 8 children of one parent row that the ray enters before best_t
__device__ __forceinline__ int child_mask(const float4* row, float ix,
                                          float iy, float iz, float oxi,
                                          float oyi, float ozi,
                                          float best_t) {
  float4 b[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) b[q] = __ldg(row + q);
  int mask = 0;
#pragma unroll
  for (int k = 0; k < kArity; ++k) {
    const int h = k >> 2;
    const int j = k & 3;
    const float lox = lane(b[0 + h], j), loy = lane(b[2 + h], j);
    const float loz = lane(b[4 + h], j), hix = lane(b[6 + h], j);
    const float hiy = lane(b[8 + h], j), hiz = lane(b[10 + h], j);
    const float t0x = lox * ix - oxi, t1x = hix * ix - oxi;
    const float t0y = loy * iy - oyi, t1y = hiy * iy - oyi;
    const float t0z = loz * iz - ozi, t1z = hiz * iz - ozi;
    const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), 0.0f));
    const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), best_t));
    if (tmax >= tmin) mask |= 1 << k;
  }
  return mask;
}

// Moller-Trumbore against one leaf row's 12 triangles, nearest first in
// triangle order
__device__ __forceinline__ void leaf_test(const float4* row, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float& best_t,
                                          float& best_tri) {
#pragma unroll
  for (int q = 0; q < kLeafTris / 4; ++q) {
    float4 c[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) c[k] = __ldg(row + k * 3 + q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v0x = lane(c[0], j), v0y = lane(c[1], j);
      const float v0z = lane(c[2], j), e1x = lane(c[3], j);
      const float e1y = lane(c[4], j), e1z = lane(c[5], j);
      const float e2x = lane(c[6], j), e2y = lane(c[7], j);
      const float e2z = lane(c[8], j), pay = lane(c[9], j);
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float inv_det = fabsf(det) < 1e-7f ? 0.0f : 1.0f / det;
      const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool ok = inv_det != 0.0f && u >= 0.0f && v >= 0.0f &&
                      u + v <= 1.0f && tt > 1e-7f && pay >= 0.0f;
      if (ok && tt < best_t) {
        best_t = tt;
        best_tri = pay;
      }
    }
  }
}

__device__ __forceinline__ float guard(float d) {
  return fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d;
}

// One ray's walk state: its slot (-1: the lane is idle), its origin and
// direction, the slab test's reciprocals, and the fold so far.
struct Ray {
  int i, sp, visits;
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, oxi, oyi, ozi, best_t, best_tri;
  int flip;
};

__device__ __forceinline__ void finish(const Rays& rays, Ray& r) {
  rays.t_out[r.i] = r.best_t;
  rays.tri_out[r.i] = static_cast<int>(r.best_tri);
  rays.steps_out[r.i] = r.visits;
  r.i = -1;
}

// A warp's pool: the live slots of its last fetch, in slot order, with
// what their walks start from (field-major, so the lanes that fill and
// read it hit distinct banks).
struct Pool {
  int slot[32], entry[32];
  float t_max[32], o[3][32], d[3][32];
};

// Fetch the warp's next 32 slots into its pool -- its own first, then
// each time the next 32 from the counter -- each lane loading one; a dead slot (live <= 0, t_max <= 0 or a negative seed)
// writes its miss at once; the live ones are packed in slot order.
// Returns how many are live; sets `drained` when the counter is past n.
// Every lane of the warp calls it.
template <bool kGroupDirs, bool kSeeded>
__device__ __forceinline__ int fetch(const Rays& rays, int* counter,
                                     Pool& pool, bool& first, bool& drained) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * kWarps;
  int base = 0;
  if (first) {                      // slots 32 w .. 32 w + 31 of warp w
    base = 32 * (blockIdx.x * kWarps + threadIdx.x / 32);
    first = false;
  } else {                          // then 32 at a time past those
    if (lane == 0) base = 32 * warps + atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
  }
  if (base >= rays.n) {
    drained = true;
    return 0;
  }
  const int i = base + lane;
  bool alive = false;
  float t = 0.0f;
  int entry = 0;                               // the root: row / node 0
  if (i < rays.n) {
    t = rays.t_max[i];
    if (kSeeded) entry = rays.seeds[i / rays.packet];
    alive = rays.live[i] > 0.0f && t > 0.0f && entry >= 0;
    if (!alive) {
      rays.t_out[i] = t;
      rays.tri_out[i] = -1;
      rays.steps_out[i] = 0;
    }
  }
  const unsigned m = __ballot_sync(0xffffffffu, alive);
  __syncwarp();                     // the lanes have read the last pool
  if (alive) {
    const int k = __popc(m & ((1u << lane) - 1u));
    const int di = kGroupDirs ? i / kGroup : i;
    pool.slot[k] = i;
    pool.entry[k] = entry;
    pool.t_max[k] = t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pool.o[c][k] = rays.origins[3 * i + c];
      pool.d[c][k] = rays.dirs[3 * di + c];
    }
  }
  __syncwarp();
  return __popc(m);
}

// Start the walk of pool entry k in r.  stk: the lane's stack, entry e at
// stk[e * 32].
__device__ __forceinline__ void take(const Pool& pool, int k, Ray& r,
                                     int* stk) {
  r.i = pool.slot[k];
  r.best_t = pool.t_max[k];
  r.best_tri = -1.0f;
  r.visits = 0;
  r.ox = pool.o[0][k];
  r.oy = pool.o[1][k];
  r.oz = pool.o[2][k];
  r.dx = pool.d[0][k];
  r.dy = pool.d[1][k];
  r.dz = pool.d[2][k];
  r.ix = 1.0f / guard(r.dx);
  r.iy = 1.0f / guard(r.dy);
  r.iz = 1.0f / guard(r.dz);
  r.oxi = r.ox * r.ix;
  r.oyi = r.oy * r.iy;
  r.ozi = r.oz * r.iz;
  r.flip = ((r.dx < 0.0f) << 2) | ((r.dy < 0.0f) << 1) | (r.dz < 0.0f);
  stk[0] = pool.entry[k];
  r.sp = 1;
}

// Pop one stack entry of r and visit it.
template <bool kSah>
__device__ __forceinline__ void visit(const Tree& tree, Ray& r, int* stk) {
  const int e = stk[--r.sp * 32];
  ++r.visits;
  if (kSah) {
    const int idx = e >> 1;
    if (e & 1) {
      if (idx < tree.n_leaf_rows)
        leaf_test(tree.leaves + static_cast<long long>(idx) * 30, r.ox, r.oy,
                  r.oz, r.dx, r.dy, r.dz, r.best_t, r.best_tri);
      return;
    }
    if (idx >= tree.n_box_rows) return;        // not on a well-formed tree
    const float4* row = tree.boxes + static_cast<long long>(idx) * 16;
    const int want = child_mask(row, r.ix, r.iy, r.iz, r.oxi, r.oyi, r.ozi,
                                r.best_t);
    const float4 r0 = __ldg(row + 12), r1 = __ldg(row + 13);
    const float axis = __ldg(row + 14).x;
    const float refs[kArity] = {r0.x, r0.y, r0.z, r0.w,
                                r1.x, r1.y, r1.z, r1.w};
    const bool rev = (axis == 0.0f ? r.dx : axis == 1.0f ? r.dy : r.dz)
                     < 0.0f;
#pragma unroll
    for (int jj = kArity - 1; jj >= 0; --jj) {
      const int kk = rev ? kArity - 1 - jj : jj;
      const float ref = rev ? refs[kArity - 1 - jj] : refs[jj];
      if (((want >> kk) & 1) && ref > kAbsentCut) {
        const bool lf = ref < -0.5f;
        const int c = lf ? static_cast<int>(-(ref + 1.0f))
                         : static_cast<int>(ref);
        stk[r.sp++ * 32] = (c << 1) | static_cast<int>(lf);
      }
    }
  } else {
    const int level = e & ((1 << kLevelBits) - 1);
    const int node = e >> kLevelBits;
    if (level == tree.n_levels - 1) {
      if (node < tree.n_leaf_rows)
        leaf_test(tree.leaves + static_cast<long long>(node) * 30, r.ox,
                  r.oy, r.oz, r.dx, r.dy, r.dz, r.best_t, r.best_tri);
      return;
    }
    const int row = tree.level_offset[level] + node;
    if (row >= tree.n_box_rows) return;        // not on a well-formed tree
    const int want = child_mask(
        tree.boxes + static_cast<long long>(row) * 12, r.ix, r.iy, r.iz,
        r.oxi, r.oyi, r.ozi, r.best_t);
#pragma unroll
    for (int jj = kArity - 1; jj >= 0; --jj) {
      const int k = jj ^ r.flip;
      if ((want >> k) & 1)
        stk[r.sp++ * 32] = ((node * kArity + k) << kLevelBits) | (level + 1);
    }
  }
}

// kSah: the SAH tree (stack entry (row << 1) | is_leaf) or the complete
// tree (entry (node << 4) | level); kGroupDirs: ray i's direction is
// dirs[i / 128]; kSeeded: the walk starts at seeds[i / packet].  Dynamic
// shared memory: kWarps * 32 * stack_n ints.  counter: the slots taken,
// 0 at the launch.
template <bool kAnyHit, bool kSah, bool kGroupDirs, bool kSeeded>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const __grid_constant__ Tree tree,
                const __grid_constant__ Rays rays,
                int* __restrict__ counter, int stack_n) {
  extern __shared__ int stacks[];
  __shared__ Pool pools[kWarps];
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int* stk = stacks + (threadIdx.x / 32) * 32 * stack_n + lane;
  Pool& pool = pools[threadIdx.x / 32];
  Ray r;
  r.i = -1;
  int pool_n = 0, pool_next = 0;               // the pool's live entries
  bool first = true;                           // no fetch yet
  bool drained = false;                        // the counter is past n
  for (;;) {
    // refill: the idle lanes take the pool's next entries, in lane order
    unsigned idle = __ballot_sync(0xffffffffu, r.i < 0);
    while (idle != 0u && !drained) {
      if (pool_next == pool_n) {
        pool_n = fetch<kGroupDirs, kSeeded>(rays, counter, pool, first,
                                            drained);
        pool_next = 0;
        continue;
      }
      const int rank = __popc(idle & below);
      if (r.i < 0 && rank < pool_n - pool_next)
        take(pool, pool_next + rank, r, stk);
      pool_next += min(__popc(idle), pool_n - pool_next);
      idle = __ballot_sync(0xffffffffu, r.i < 0);
    }
    if (idle == 0xffffffffu) break;            // drained, every lane idle
    if (r.i >= 0) {
      visit<kSah>(tree, r, stk);
      if (r.sp == 0 || (kAnyHit && r.best_tri >= 0.0f)) finish(rays, r);
    }
  }
}

// The launch: as many blocks as the SMs keep resident at this stack
// size (no more than the slots need), the counter reset first.  The
// residency is asked once per instance, device and stack size (the
// shared-memory attribute is set on the current device).
constexpr int kMaxDevices = 64;

template <bool kAnyHit, bool kSah, bool kGroupDirs, bool kSeeded>
cudaError_t launch_one(const Tree& tree, const Rays& rays, int* counter,
                       int stack_n, cudaStream_t s, int* warps) {
  auto kernel = traverse_kernel<kAnyHit, kSah, kGroupDirs, kSeeded>;
  const int smem = kWarps * 32 * stack_n * static_cast<int>(sizeof(int));
  static int known_smem[kMaxDevices], resident[kMaxDevices];
  static bool asked[kMaxDevices];
  cudaError_t err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!asked[device] || smem != known_smem[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    known_smem[device] = smem;
    resident[device] = per_sm * sms;
    asked[device] = true;
  }
  const int need = (rays.n + kThreads - 1) / kThreads;
  const int blocks = max(1, min(need, resident[device]));
  *warps = blocks * kWarps;
  err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, s>>>(tree, rays, counter, stack_n);
  return cudaGetLastError();
}

template <bool kSah>
cudaError_t launch_flavour(const Tree& tree, const Rays& rays, bool any_hit,
                           bool group_dirs, int* counter, int stack_n,
                           cudaStream_t s, int* warps) {
  if constexpr (!kSah) {
    if (rays.seeds != nullptr)
      return any_hit ? launch_one<true, false, false, true>(
                           tree, rays, counter, stack_n, s, warps)
                     : launch_one<false, false, false, true>(
                           tree, rays, counter, stack_n, s, warps);
  }
  if (any_hit && group_dirs)
    return launch_one<true, kSah, true, false>(tree, rays, counter, stack_n,
                                               s, warps);
  if (any_hit)
    return launch_one<true, kSah, false, false>(tree, rays, counter,
                                                stack_n, s, warps);
  if (group_dirs)
    return launch_one<false, kSah, true, false>(tree, rays, counter,
                                                stack_n, s, warps);
  return launch_one<false, kSah, false, false>(tree, rays, counter, stack_n,
                                               s, warps);
}

}  // namespace

// Tree rows and rays as described above, contiguous on the device (tree
// rows 16-byte aligned).  sah_depth = 0: the complete tree, with
// n_levels levels and level_offset a host array of n_levels - 1 ints;
// sah_depth > 0: the SAH tree of that many node levels (boxes = its node
// rows; n_levels and level_offset are not read).  group_dirs != 0: dirs
// holds one direction per 128 rays (n a multiple of 128).  seeds: null
// for the walk from the root, or (complete tree, per-ray directions) a
// device array of ceil(n / packet) ints, each packet's first stack entry
// (node << 4) | level, negative for an empty packet.  counter: one device
// int of scratch (the slots taken; reset here).  *warps: the warps
// launched.  Launches on `stream`; returns the launch's cudaError_t (0 =
// queued), or cudaErrorInvalidValue for a tree deeper than the stack, a
// ray count that is not whole groups, or seeds with packet < 1, the SAH
// tree or grouped directions.
extern "C" int traverse_launch(const void* boxes, int n_box_rows,
                               const void* leaves, int n_leaf_rows,
                               int n_levels, const int* level_offset,
                               const void* origins, const void* dirs,
                               const void* t_max, const void* live,
                               const void* seeds, int packet,
                               void* t_out, void* tri_out, void* steps_out,
                               int n, int any_hit, int sah_depth,
                               int group_dirs, void* counter, int* warps,
                               void* stream) {
  *warps = 0;
  if (sah_depth <= 0 && (n_levels < 1 || n_levels > kMaxLevels))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sah_depth > 0 && sah_depth * 7 + 1 > kSahStack)
    return static_cast<int>(cudaErrorInvalidValue);
  if (group_dirs && n % kGroup != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seeds != nullptr && (packet < 1 || sah_depth > 0 || group_dirs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  Tree tree;
  tree.boxes = static_cast<const float4*>(boxes);
  tree.leaves = static_cast<const float4*>(leaves);
  tree.n_box_rows = n_box_rows;
  tree.n_leaf_rows = n_leaf_rows;
  tree.n_levels = sah_depth > 0 ? 1 : n_levels;
  for (int l = 0; l < kMaxLevels; ++l)
    tree.level_offset[l] =
        (sah_depth <= 0 && l < n_levels - 1) ? level_offset[l] : 0;
  Rays rays;
  rays.origins = static_cast<const float*>(origins);
  rays.dirs = static_cast<const float*>(dirs);
  rays.t_max = static_cast<const float*>(t_max);
  rays.live = static_cast<const float*>(live);
  rays.t_out = static_cast<float*>(t_out);
  rays.tri_out = static_cast<int*>(tri_out);
  rays.steps_out = static_cast<int*>(steps_out);
  rays.seeds = static_cast<const int*>(seeds);
  rays.packet = seeds != nullptr ? packet : 1;
  rays.n = n;
  // the walk's deepest stack: 7 entries per internal level + 1
  const int stack_n = (sah_depth > 0 ? sah_depth : n_levels - 1) * 7 + 1;
  int* ctr = static_cast<int*>(counter);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      sah_depth <= 0
          ? launch_flavour<false>(tree, rays, any_hit, group_dirs, ctr,
                                  stack_n, s, warps)
          : launch_flavour<true>(tree, rays, any_hit, group_dirs, ctr,
                                 stack_n, s, warps);
  return static_cast<int>(err);
}
