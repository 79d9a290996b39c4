// The pair route's dense Moller-Trumbore fold, for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_pairs_kernel
// (toyrenderer_tpu/ops/rt_pairs.py:145, K6).  Inputs, as
// ops/rt_pairs.py lays them out:
//   rays     (B, 128, 8) f32 ray slots [o.xyz, d.xyz, t_max, live];
//   feat     (C + 1, 16, 512) f32: chunk c's 96 triangles as four
//            bilinear forms (det, u_num, v_num, t_num), feat[c][k][s * 128
//            + t] the k-th coefficient of form s for triangle t (lanes
//            96..127 are padding and never read);
//   pchk     (L,) i32 the chunk of each listed pair;
//   starts   (B,) i32, walk_end (B,) i32: block b walks pairs starts[b]
//            .. starts[b] + n_walk[b] - 1, walk_end the inclusive prefix
//            sums of n_walk (ops/pairs_cuda.walk_ends).
// Output: keys (B * 128,) u64, which the wrapper fills with
// (inf bits << 32) | 0x7fffffff and reads back as
// (best_t, best_ord): each ray's least t over the walked triangles, and
// the least ordinal chunk * 128 + t that gives it.
//
// The contract on feat: mt_tables' layout, in which 39 of the 64
// (form, coefficient) rows are zero by construction -- det has only its
// d terms (k 4-6), u_num and v_num their d terms and the off-diagonal
// o (x) d terms (k 4-6, 8-10, 12-14), t_num its 1 and o terms (k 0-3).
// A ray whose 16 features [1, o, d, o (x) d] are finite sums only the
// other 25 rows, left to right: adding f * 0 to a sum changes at most
// the sign of a zero, and the tests read no zero's sign (|det| < 1e-7
// rejects, u >= 0 and v >= 0 hold for -0, t > 1e-7 fails for both).  A
// live ray with a feature that is not finite (f * 0 is NaN then) sums
// all 16 terms of each form, reading the rest from global memory, as
// pair_fold_plain does.  So best_t and best_ord are bit-equal to
// pair_fold_plain's on every input laid out as mt_tables lays it out.
//
// The TPU kernel runs a sequential grid over groups of 16 pairs of one
// block, multiplies the block's (128, 16) features by the chunks'
// (16, 512) coefficients on the matrix unit (a bf16x3 split) and folds
// into an output block that consecutive grid steps revisit.  Here the
// walked pairs -- block 0's, then block 1's, ..., as walk_end lays them
// end to end -- are cut into work items of kItem positions, one item
// per CTA of 128 threads (a thread per ray of the current block), so
// every SM gets an even share however the lists are spread over the
// blocks; a CTA finds each position's block by a binary search over
// walk_end.  An item that spans blocks folds a run of positions per
// block and merges each run into the rays' keys with one 64-bit
// atomicMin per ray that hit: (t bits << 32) | ordinal orders like
// (t, ordinal), since an accepted t is positive, so the merge is exact
// in any order.  Per position the CTA stages the chunk's 25 used rows
// (96 floats each, 9.6 KB) into one of two shared buffers with cp.async
// while it evaluates the previous chunk; a warp reads four triangles'
// coefficients of a row as one 16-byte broadcast.  At the start of a run
// the CTA packs the block's live rays onto its first threads, so a warp
// past them skips the arithmetic: the sun rays of probe hits are a
// quarter live.  The tests are the reference's:
// |det| < 1e-7 rejects, u, v >= 0, u + v <= 1, 1e-7 < t < t_max.
//
// Arithmetic: float32, each form summed left to right, built with
// -fmad=false.
//
// Bound: operations -- per (pair, live ray, triangle) the 25 used
// multiply-adds (two operations each, under -fmad=false two
// instructions, so at most half the FMA peak) and the epilogue; the
// bytes are each distinct chunk's used coefficients and each ray slot
// once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;        // rays per block = threads per CTA
constexpr int kFeat = 16;          // [1, o, d, o (x) d]
constexpr int kForms = 4;          // det, u_num, v_num, t_num
constexpr int kSlab = 128;         // lanes per form in a feat row
constexpr int kTris = 96;          // triangles per chunk
constexpr int kItem = 16;          // walked positions per work item
constexpr int kUsed = 25;          // (form, coefficient) rows not zero
constexpr int kRowVecs = kTris / 4;            // 16-byte pieces per row

// The used rows: form s's j-th, its coefficient used_k<s>(j), ascending
// (det: d; u_num, v_num: d and the off-diagonal o (x) d; t_num: 1 and o),
// staged at row used_row0<s>() + j.
template <int kForm>
__device__ __forceinline__ constexpr int used_n() {
  return kForm == 0 ? 3 : kForm == 3 ? 4 : 9;
}
template <int kForm>
__device__ __forceinline__ constexpr int used_row0() {
  return kForm == 0 ? 0 : kForm == 1 ? 3 : kForm == 2 ? 12 : 21;
}
template <int kForm>
__device__ __forceinline__ constexpr int used_k(int j) {
  return kForm == 0 ? 4 + j
         : kForm == 3 ? j
         : j < 3 ? 4 + j : j < 6 ? 5 + j : 6 + j;
}
// staged row r: its form and coefficient
__device__ __forceinline__ void row_of(int r, int& form, int& k) {
  if (r < 3) {
    form = 0;
    k = used_k<0>(r);
  } else if (r < 21) {
    form = r < 12 ? 1 : 2;
    k = used_k<1>(r - (r < 12 ? 3 : 12));
  } else {
    form = 3;
    k = used_k<3>(r - 21);
  }
}

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

// Stage chunk `chunk`'s used rows into buf ([row][triangle]).
__device__ __forceinline__ void stage(float (*buf)[kTris], const float* feat,
                                      int chunk) {
  const float* src = feat + static_cast<long long>(chunk) * kFeat * kForms *
                                kSlab;
  for (int q = threadIdx.x; q < kUsed * kRowVecs; q += kBlock) {
    const int r = q / kRowVecs, v = q - r * kRowVecs;
    int form, k;
    row_of(r, form, k);
    cp_async16(&buf[r][4 * v], src + k * kForms * kSlab + form * kSlab + 4 * v);
  }
}

__device__ __forceinline__ float4 fmul4(float f, float4 m) {
  return make_float4(f * m.x, f * m.y, f * m.z, f * m.w);
}
__device__ __forceinline__ float4 fadd4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Form kForm of triangles t..t+3 over its used rows of the stage: the
// sum of f[k] * m[k] over its used k, left to right.
template <int kForm>
__device__ __forceinline__ float4 form4(const float* f, float (*buf)[kTris],
                                        int t) {
  constexpr int r0 = used_row0<kForm>();
  float4 acc = fmul4(f[used_k<kForm>(0)],
                     *reinterpret_cast<const float4*>(&buf[r0][t]));
#pragma unroll
  for (int j = 1; j < used_n<kForm>(); ++j)
    acc = fadd4(acc, fmul4(f[used_k<kForm>(j)],
                           *reinterpret_cast<const float4*>(&buf[r0 + j][t])));
  return acc;
}

// One form of triangle t, all 16 terms from global memory.
__device__ __forceinline__ float form16(const float* f, const float* src,
                                        int s, int t) {
  float acc = f[0] * __ldg(src + s * kSlab + t);
#pragma unroll
  for (int k = 1; k < kFeat; ++k)
    acc = acc + f[k] * __ldg(src + k * kForms * kSlab + s * kSlab + t);
  return acc;
}

// The reference's tests on one triangle; the fold keeps the least
// (t, ordinal).
__device__ __forceinline__ void test(float det, float u_n, float v_n,
                                     float t_n, float cap, int ord,
                                     float& best_t, int& best_ord) {
  const float inv_det = fabsf(det) < 1e-7f ? 0.0f : 1.0f / det;
  const float u = u_n * inv_det;
  const float v = v_n * inv_det;
  const float tt = t_n * inv_det;
  const bool ok = inv_det != 0.0f && u >= 0.0f && v >= 0.0f &&
                  u + v <= 1.0f && tt > 1e-7f && tt < cap;
  if (ok && (tt < best_t || (tt == best_t && ord < best_ord))) {
    best_t = tt;
    best_ord = ord;
  }
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

// Fold one work item: its n positions, position j a pair of ray block
// pos_block[j] with chunk pos_chunk[j] (-1: skipped), the positions of a
// block consecutive.  Every thread of the CTA calls it; thread r owns ray
// r of the current block and merges its best of each run into keys.
__device__ __forceinline__ void fold_item(
    const float4* __restrict__ rays, const float* __restrict__ feat,
    const int* pos_block, const int* pos_chunk, int n,
    float (*sm)[kUsed][kTris], int* live_rays, int* warp_live_n,
    unsigned long long* __restrict__ keys) {
  const int r = threadIdx.x;
  const int lane = r % 32, warp = r / 32;
  int block = -1, ray = 0;
  float f[kFeat];
  float cap = 0.0f, best_t = 0.0f;
  int best_ord = -1;
  bool live = false, warp_live = false, warp_slow = false;
  auto flush = [&]() {
    if (best_ord >= 0)
      atomicMin(keys + static_cast<long long>(block) * kBlock + ray,
                (static_cast<unsigned long long>(__float_as_uint(best_t))
                 << 32) | static_cast<unsigned>(best_ord));
  };

  if (pos_chunk[0] >= 0) stage(sm[0], feat, pos_chunk[0]);
  cp_commit();
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n && pos_chunk[j + 1] >= 0)
      stage(sm[(j + 1) & 1], feat, pos_chunk[j + 1]);
    cp_commit();
    if (pos_block[j] != block) {      // a new run: this block's live rays
      if (block >= 0) flush();
      block = pos_block[j];
      const float4* slots = rays + static_cast<long long>(block) * kBlock * 2;
      // pack the block's live rays onto the first threads, so the warps
      // past them skip the arithmetic
      const bool mine = __ldg(slots + 2 * r + 1).w > 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (lane == 0) warp_live_n[warp] = __popc(m);
      __syncthreads();
      int at = __popc(m & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) at += warp_live_n[w];
      if (mine) live_rays[at] = r;
      const int n_live = warp_live_n[0] + warp_live_n[1] + warp_live_n[2] +
                         warp_live_n[3];
      __syncthreads();
      live = r < n_live;
      ray = live ? live_rays[r] : r;
      const float4 ra = __ldg(slots + 2 * ray);
      const float4 rb = __ldg(slots + 2 * ray + 1);
      const float ox = ra.x, oy = ra.y, oz = ra.z;
      const float dx = ra.w, dy = rb.x, dz = rb.y;
      const float g[kFeat] = {1.0f,    ox,      oy,      oz,
                              dx,      dy,      dz,      ox * dx,
                              ox * dy, ox * dz, oy * dx, oy * dy,
                              oy * dz, oz * dx, oz * dy, oz * dz};
      bool finite = true;
#pragma unroll
      for (int k = 0; k < kFeat; ++k) {
        f[k] = g[k];
        finite &= isfinite(g[k]);
      }
      cap = rb.z;
      best_t = __int_as_float(0x7f800000);
      best_ord = -1;
      warp_live = __any_sync(0xffffffffu, live);
      warp_slow = __any_sync(0xffffffffu, live && !finite);
    }
    cp_wait<1>();
    __syncthreads();                  // chunk j's stage has landed
    const int chunk = pos_chunk[j];
    if (chunk >= 0 && warp_live) {
      float (*buf)[kTris] = sm[j & 1];
      if (!warp_slow) {
        for (int t = 0; t < kTris; t += 4) {
          const float4 det = form4<0>(f, buf, t);
          const float4 u_n = form4<1>(f, buf, t);
          const float4 v_n = form4<2>(f, buf, t);
          const float4 t_n = form4<3>(f, buf, t);
          if (live) {
            const int ord = chunk * kSlab + t;
            test(det.x, u_n.x, v_n.x, t_n.x, cap, ord, best_t, best_ord);
            test(det.y, u_n.y, v_n.y, t_n.y, cap, ord + 1, best_t, best_ord);
            test(det.z, u_n.z, v_n.z, t_n.z, cap, ord + 2, best_t, best_ord);
            test(det.w, u_n.w, v_n.w, t_n.w, cap, ord + 3, best_t, best_ord);
          }
        }
      } else if (live) {              // the full sums (see the header)
        const float* src = feat + static_cast<long long>(chunk) * kFeat *
                                      kForms * kSlab;
        for (int t = 0; t < kTris; ++t)
          test(form16(f, src, 0, t), form16(f, src, 1, t),
               form16(f, src, 2, t), form16(f, src, 3, t), cap,
               chunk * kSlab + t, best_t, best_ord);
      }
    }
    __syncthreads();                  // its buffer is free for chunk j + 2
  }
  if (block >= 0) flush();
}

__global__ void __launch_bounds__(kBlock)
pairs_kernel(const float4* __restrict__ rays, const float* __restrict__ feat,
             int n_chunks, const int* __restrict__ pchk, int n_list,
             const int* __restrict__ starts,
             const int* __restrict__ walk_end, int n_blocks,
             unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float sm[2][kUsed][kTris];
  __shared__ int pos_block[kItem], pos_chunk[kItem];
  __shared__ int live_rays[kBlock], warp_live_n[kBlock / 32];
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
    fold_item(rays, feat, pos_block, pos_chunk, n, sm, live_rays,
              warp_live_n, keys);
  }
}

}  // namespace

// Arrays as described above, contiguous on the device (rays and feat
// 16-byte aligned); n_chunks = C + 1 rows of feat, n_blocks ray blocks,
// n_list entries of pchk.  The grid has one CTA per kItem entries of
// pchk, which the walked positions fill at most in the pair route (a CTA
// takes further items in turn where they are more).  keys holds the
// wrapper's initial keys.  Launches on `stream`; returns the launch's
// cudaError_t (0 = queued), or cudaErrorInvalidValue for a negative
// size.
extern "C" int pairs_launch(const void* rays, const void* feat, int n_chunks,
                            const void* pchk, int n_list, const void* starts,
                            const void* walk_end, int n_blocks, void* keys,
                            void* stream) {
  if (n_chunks < 0 || n_list < 0 || n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = (n_list + kItem - 1) / kItem;
  if (n_blocks == 0 || items == 0) return 0;
  pairs_kernel<<<items, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rays), static_cast<const float*>(feat),
      n_chunks, static_cast<const int*>(pchk), n_list,
      static_cast<const int*>(starts), static_cast<const int*>(walk_end),
      n_blocks, static_cast<unsigned long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}
