// The chunk route's dense Moller-Trumbore fold (K8), for Hopper (sm_90a).
//
// It replaces no TPU kernel.  Its source is the reference's XLA code
// (toyrenderer_tpu/ops/rt_chunks.py:160-214): the dense phase of the
// block-pair chunk traversal, which XLA fuses into (pairs, 128, 96)
// elementwise work and which eager PyTorch would build in memory (tens of
// GB for a 1080p frame's rays).  Inputs, as ops/rt_chunks.py lays them
// out:
//   rays     (B, 128, 8) f32 ray slots [o.xyz, d.xyz, t_max, live];
//   data     (C, 960) f32: chunk c's 96 triangles component-major,
//            [v0x x96 | v0y | v0z | e1x | e1y | e1z | e2x | e2y | e2z |
//            payload x96], payload -1 in padding slots;
//   pchk     (L,) i32 the chunk of each listed pair;
//   starts   (B,) i32, walk_end (B,) i32: block b walks pairs starts[b]
//            .. starts[b] + n_walk[b] - 1, walk_end the inclusive prefix
//            sums of n_walk (ops/pairs_cuda.walk_ends).
// Output: keys (B * 128,) u64, which the wrapper fills with
// (inf bits << 32) | 0x7fffffff and reads back as (best_t, best_pay).
//
// The fold is the reference's, with its two-level tie rule: within a
// pair, the first of the 96 slots with the least t (its `argmin`); across
// the pairs of a block, the least payload among the pairs whose winner has
// the least t.  A thread folds each pair of a run to (t, payload) and keeps
// the least (t, payload) of the run's pairs; at the run's end it merges
// that into the ray's key with one 64-bit atomicMin: (t bits << 32) |
// payload orders like (t, payload), since an accepted t is positive and a
// payload is not negative, so the merge is exact in any order.  A 64-bit
// atomicMin over every triangle would give the least payload among the
// tied slots of one pair instead of the first, so the pair fold comes
// first.
//
// Work split as in K6 (csrc/pairs.cu): the walked pairs -- block 0's,
// then block 1's, ..., as walk_end lays them end to end -- are cut into
// work items of kItem positions, one item per CTA of 128 threads (a
// thread per ray of the current block); a CTA finds each position's block
// by a binary search over walk_end.  Per position the CTA stages the
// chunk's 960 floats (3.75 KB) into one of two shared buffers with
// cp.async while it tests the previous chunk; every thread of a warp reads
// the same slot, a broadcast.  A dead ray (live <= 0) skips the tests: its
// key stays at inf, and the caller masks its hit off in any case.
//
// Arithmetic: float32, the reference's expressions in its order, built
// with -fmad=false (no contraction), IEEE division: bit-equal to
// rt_chunks.chunk_fold_plain.  The tests are the reference's: |det| <
// 1e-7 rejects, u, v >= 0, u + v <= 1, 1e-7 < t < t_max, payload >= 0.
//
// Bound: operations -- per (walked pair, live ray, slot) the MT's float
// operations; the bytes are each distinct chunk walked and each ray slot
// once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;        // rays per block = threads per CTA
constexpr int kTris = 96;          // triangles per chunk
constexpr int kFloats = 10 * kTris;
constexpr int kItem = 16;          // walked positions per work item

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage chunk `chunk`'s 960 floats into buf.
__device__ __forceinline__ void stage(float* buf, const float* data,
                                      int chunk) {
  const float* src = data + static_cast<long long>(chunk) * kFloats;
  for (int q = threadIdx.x; q < kFloats / 4; q += kBlock)
    cp_async16(buf + 4 * q, src + 4 * q);
}

// the first block whose walk ends past position q
__device__ __forceinline__ int block_of(const int* walk_end, int n_blocks,
                                        int q) {
  int lo = 0, hi = n_blocks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(walk_end + mid) > q) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// One pair: the ray against the staged chunk's 96 slots, the reference's
// Moller-Trumbore; returns the first slot with the least accepted t in
// (t, pay), t = inf when none is accepted.
__device__ __forceinline__ void fold_pair(const float* m, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float cap, float& t,
                                          float& pay) {
  t = __int_as_float(0x7f800000);
  pay = -1.0f;
  for (int j = 0; j < kTris; ++j) {
    const float v0x = m[0 * kTris + j], v0y = m[1 * kTris + j],
                v0z = m[2 * kTris + j];
    const float e1x = m[3 * kTris + j], e1y = m[4 * kTris + j],
                e1z = m[5 * kTris + j];
    const float e2x = m[6 * kTris + j], e2y = m[7 * kTris + j],
                e2z = m[8 * kTris + j];
    const float p = m[9 * kTris + j];
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
                    u + v <= 1.0f && tt > 1e-7f && p >= 0.0f && tt < cap;
    if (ok && tt < t) {             // strict: the first least slot stays
      t = tt;
      pay = p;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
chunks_kernel(const float4* __restrict__ rays, const float* __restrict__ data,
              int n_chunks, const int* __restrict__ pchk, int n_list,
              const int* __restrict__ starts,
              const int* __restrict__ walk_end, int n_blocks,
              unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float sm[2][kFloats];
  __shared__ int pos_block[kItem], pos_chunk[kItem];
  const int r = threadIdx.x;
  const int total = __ldg(walk_end + n_blocks - 1);
  for (int q0 = blockIdx.x * kItem; q0 < total; q0 += gridDim.x * kItem) {
    const int n = min(kItem, total - q0);
    __syncthreads();                  // the previous item's reads are done
    if (r < n) {
      const int b = block_of(walk_end, n_blocks, q0 + r);
      const int begin = b > 0 ? __ldg(walk_end + b - 1) : 0;
      const int at = __ldg(starts + b) + (q0 + r - begin);
      const int c = at >= 0 && at < n_list ? __ldg(pchk + at) : -1;
      pos_block[r] = b;
      pos_chunk[r] = c >= 0 && c < n_chunks ? c : -1;   // -1: skipped
    }
    __syncthreads();

    int block = -1;
    bool live = false;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float cap = 0.f, best_t = 0.f;
    int best_pay = -1;
    auto flush = [&]() {
      if (best_pay >= 0)
        atomicMin(keys + static_cast<long long>(block) * kBlock + r,
                  (static_cast<unsigned long long>(__float_as_uint(best_t))
                   << 32) | static_cast<unsigned>(best_pay));
    };
    if (pos_chunk[0] >= 0) stage(sm[0], data, pos_chunk[0]);
    cp_commit();
    for (int j = 0; j < n; ++j) {
      if (j + 1 < n && pos_chunk[j + 1] >= 0)
        stage(sm[(j + 1) & 1], data, pos_chunk[j + 1]);
      cp_commit();
      if (pos_block[j] != block) {    // a new run: this block's ray r
        if (block >= 0) flush();
        block = pos_block[j];
        const float4* slot =
            rays + (static_cast<long long>(block) * kBlock + r) * 2;
        const float4 ra = __ldg(slot), rb = __ldg(slot + 1);
        ox = ra.x; oy = ra.y; oz = ra.z;
        dx = ra.w; dy = rb.x; dz = rb.y;
        cap = rb.z;
        live = rb.w > 0.0f;
        best_t = __int_as_float(0x7f800000);
        best_pay = -1;
      }
      cp_wait<1>();
      __syncthreads();                // chunk j's stage has landed
      if (pos_chunk[j] >= 0 && live) {
        float t, pay;
        fold_pair(sm[j & 1], ox, oy, oz, dx, dy, dz, cap, t, pay);
        const int p = static_cast<int>(pay);
        if (p >= 0 && (t < best_t || (t == best_t && p < best_pay))) {
          best_t = t;
          best_pay = p;
        }
      }
      __syncthreads();                // its buffer is free for chunk j + 2
    }
    if (block >= 0) flush();
  }
}

}  // namespace

// Arrays as described above, contiguous on the device (rays and data
// 16-byte aligned); n_chunks rows of data, n_blocks ray blocks, n_list
// entries of pchk.  The grid has one CTA per kItem entries of pchk, which
// the walked positions fill at most (a CTA takes further items in turn
// where they are more).  keys holds the wrapper's initial keys.  Launches
// on `stream`; returns the launch's cudaError_t (0 = queued), or
// cudaErrorInvalidValue for a negative size.
extern "C" int chunks_launch(const void* rays, const void* data,
                             int n_chunks, const void* pchk, int n_list,
                             const void* starts, const void* walk_end,
                             int n_blocks, void* keys, void* stream) {
  if (n_chunks < 0 || n_list < 0 || n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = (n_list + kItem - 1) / kItem;
  if (n_blocks == 0 || items == 0) return 0;
  chunks_kernel<<<items, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rays), static_cast<const float*>(data),
      n_chunks, static_cast<const int*>(pchk), n_list,
      static_cast<const int*>(starts), static_cast<const int*>(walk_end),
      n_blocks, static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}
