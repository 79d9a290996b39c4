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
// evaluates the whole packet.  Here each thread walks its own ray with
// its own DFS stack in local memory: pop a node; at an internal node
// slab-test its 8 children from one row (12 16-byte loads) and push the
// ones the ray enters so that the nearest pops first -- on the complete
// tree child k ^ flip by the ray's direction signs, on the SAH tree the
// children in split-axis order, reversed when the ray's own direction
// is negative on that axis (the TPU uses the packet's summed sign); at
// a leaf, Moller-Trumbore against its 12 triangles, read four at a time
// as 16-byte loads of each component, folding the nearest hit in
// triangle order with a strict t < best_t.  Any-hit rays leave at the
// first leaf that gives a hit; closest-hit rays run until their stack is
// empty.  Dead rays (live <= 0 or t_max <= 0) report a miss at once.
// The stack holds (levels-1)*7+1 entries on the complete tree (at most
// 9 levels) and depth*7+1 on the SAH tree, whose depth varies: the SAH
// kernels are built for 160 entries (depth <= 22, the reference's
// STACK_CAP) and a deeper tree is refused.  A thread touches only the
// entries its walk uses.  With grouped
// directions each thread reads its group's direction (one 12-byte row
// per 128 rays) instead of its own; everything else is the same, so K5
// gives exactly what K3 gives on the expanded directions.  Seeded
// (complete tree, per-ray directions only): stack entry 0 is the seed of
// the ray's packet, seeds[i / packet], in the reference's encoding
// (node << 4) | level; a negative seed leaves the stack empty and the
// ray reports a miss; the walk below the seed is K3's.  The instances:
// any-hit x (complete, SAH) x (per-ray, grouped) directions, and
// any-hit x seeded on the complete tree -- 10 in all.
//
// Arithmetic is the TPU kernel's, operation for operation: the
// direction guard |d| < 1e-12 -> +-1e-12, the slab t = lo * inv - o * inv
// with tmin clamped at 0 and tmax at the best t, Moller-Trumbore with
// |det| < 1e-7 -> no hit and t > 1e-7, sums left to right.  Built with
// -fmad=false, so hit, t and tri are bit-equal to traverse_plain, which
// walks each ray in this same order.
//
// Bound: operations for coherent rays (slab tests and triangle tests of
// the nodes each ray visits), the tree's bytes read once; the tree
// stays resident in the 50 MB L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kArity = 8;
constexpr int kLeafTris = 12;
constexpr int kMaxLevels = 9;                  // node << 4 stays in an int
constexpr int kStack = (kMaxLevels - 1) * 7 + 1;
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

// kSah: the SAH tree (stack entry (row << 1) | is_leaf) or the complete
// tree (entry (node << 4) | level); kGroupDirs: ray i's direction is
// dirs[i / 128]; kSeeded: the walk starts at seeds[i / packet]; kStackN:
// the stack's entries
template <bool kAnyHit, bool kSah, bool kGroupDirs, bool kSeeded,
          int kStackN>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(Tree tree, Rays rays) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= rays.n) return;
  const float t_cap = rays.t_max[i];
  float best_t = t_cap;
  float best_tri = -1.0f;
  int visits = 0;
  if (rays.live[i] > 0.0f && t_cap > 0.0f) {
    const float ox = rays.origins[3 * i], oy = rays.origins[3 * i + 1];
    const float oz = rays.origins[3 * i + 2];
    const int di = kGroupDirs ? i / kGroup : i;
    const float dx = rays.dirs[3 * di], dy = rays.dirs[3 * di + 1];
    const float dz = rays.dirs[3 * di + 2];
    const float ix = 1.0f / guard(dx), iy = 1.0f / guard(dy);
    const float iz = 1.0f / guard(dz);
    const float oxi = ox * ix, oyi = oy * iy, ozi = oz * iz;
    const int flip = ((dx < 0.0f) << 2) | ((dy < 0.0f) << 1) | (dz < 0.0f);
    const int leaf_level = tree.n_levels - 1;
    int stack[kStackN];
    int sp = 1;
    stack[0] = 0;                              // the root: row / node 0
    if (kSeeded) {
      const int seed = rays.seeds[i / rays.packet];
      stack[0] = seed;
      sp = seed >= 0 ? 1 : 0;
    }
    while (sp > 0) {
      const int e = stack[--sp];
      ++visits;
      if (kSah) {
        const int idx = e >> 1;
        if (e & 1) {
          if (idx < tree.n_leaf_rows) {
            leaf_test(tree.leaves + static_cast<long long>(idx) * 30, ox,
                      oy, oz, dx, dy, dz, best_t, best_tri);
            if (kAnyHit && best_tri >= 0.0f) break;
          }
          continue;
        }
        if (idx >= tree.n_box_rows) continue;  // not on a well-formed tree
        const float4* row = tree.boxes + static_cast<long long>(idx) * 16;
        const int want = child_mask(row, ix, iy, iz, oxi, oyi, ozi, best_t);
        const float4 r0 = __ldg(row + 12), r1 = __ldg(row + 13);
        const float axis = __ldg(row + 14).x;
        const float refs[kArity] = {r0.x, r0.y, r0.z, r0.w,
                                    r1.x, r1.y, r1.z, r1.w};
        const bool rev = (axis == 0.0f ? dx : axis == 1.0f ? dy : dz) < 0.0f;
#pragma unroll
        for (int jj = kArity - 1; jj >= 0; --jj) {
          const int kk = rev ? kArity - 1 - jj : jj;
          const float ref = rev ? refs[kArity - 1 - jj] : refs[jj];
          if (((want >> kk) & 1) && ref > kAbsentCut) {
            const bool lf = ref < -0.5f;
            const int c = lf ? static_cast<int>(-(ref + 1.0f))
                             : static_cast<int>(ref);
            stack[sp++] = (c << 1) | static_cast<int>(lf);
          }
        }
      } else {
        const int level = e & ((1 << kLevelBits) - 1);
        const int node = e >> kLevelBits;
        if (level == leaf_level) {
          if (node < tree.n_leaf_rows) {
            leaf_test(tree.leaves + static_cast<long long>(node) * 30, ox,
                      oy, oz, dx, dy, dz, best_t, best_tri);
            if (kAnyHit && best_tri >= 0.0f) break;
          }
          continue;
        }
        const int row = tree.level_offset[level] + node;
        if (row >= tree.n_box_rows) continue;  // not on a well-formed tree
        const int want = child_mask(
            tree.boxes + static_cast<long long>(row) * 12, ix, iy, iz, oxi,
            oyi, ozi, best_t);
#pragma unroll
        for (int jj = kArity - 1; jj >= 0; --jj) {
          const int k = jj ^ flip;
          if ((want >> k) & 1)
            stack[sp++] = ((node * kArity + k) << kLevelBits) | (level + 1);
        }
      }
    }
  }
  rays.t_out[i] = best_t;
  rays.tri_out[i] = static_cast<int>(best_tri);
  rays.steps_out[i] = visits;
}

template <bool kSah, int kStackN>
void launch_flavour(const Tree& tree, const Rays& rays, bool any_hit,
                    bool group_dirs, int blocks, cudaStream_t s) {
  if constexpr (!kSah) {
    if (rays.seeds != nullptr) {
      if (any_hit)
        traverse_kernel<true, false, false, true, kStackN>
            <<<blocks, kThreads, 0, s>>>(tree, rays);
      else
        traverse_kernel<false, false, false, true, kStackN>
            <<<blocks, kThreads, 0, s>>>(tree, rays);
      return;
    }
  }
  if (any_hit && group_dirs)
    traverse_kernel<true, kSah, true, false, kStackN>
        <<<blocks, kThreads, 0, s>>>(tree, rays);
  else if (any_hit)
    traverse_kernel<true, kSah, false, false, kStackN>
        <<<blocks, kThreads, 0, s>>>(tree, rays);
  else if (group_dirs)
    traverse_kernel<false, kSah, true, false, kStackN>
        <<<blocks, kThreads, 0, s>>>(tree, rays);
  else
    traverse_kernel<false, kSah, false, false, kStackN>
        <<<blocks, kThreads, 0, s>>>(tree, rays);
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
// (node << 4) | level, negative for an empty packet.  Launches on
// `stream`; returns the launch's cudaError_t (0 = queued), or
// cudaErrorInvalidValue for a tree deeper than the stack, a ray count
// that is not whole groups, or seeds with packet < 1, the SAH tree or
// grouped directions.
extern "C" int traverse_launch(const void* boxes, int n_box_rows,
                               const void* leaves, int n_leaf_rows,
                               int n_levels, const int* level_offset,
                               const void* origins, const void* dirs,
                               const void* t_max, const void* live,
                               const void* seeds, int packet,
                               void* t_out, void* tri_out, void* steps_out,
                               int n, int any_hit, int sah_depth,
                               int group_dirs, void* stream) {
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
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sah_depth <= 0)
    launch_flavour<false, kStack>(tree, rays, any_hit, group_dirs, blocks, s);
  else
    launch_flavour<true, kSahStack>(tree, rays, any_hit, group_dirs, blocks,
                                    s);
  return static_cast<int>(cudaGetLastError());
}
