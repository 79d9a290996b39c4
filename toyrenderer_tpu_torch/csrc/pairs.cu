// The pair route's dense Moller-Trumbore fold, for Hopper (sm_90a).
//
// Replaces the TPU kernel _make_pairs_kernel
// (toyrenderer_tpu/ops/rt_pairs.py:145, K6).  Inputs, as
// ops/rt_pairs.py lays them out:
//   rays   (B, 128, 8) f32 ray slots [o.xyz, d.xyz, t_max, live];
//   feat   (C + 1, 16, 512) f32: chunk c's 96 triangles as four bilinear
//          forms (det, u_num, v_num, t_num), feat[c][k][s * 128 + t] the
//          k-th coefficient of form s for triangle t (lanes 96..127 are
//          padding and never read);
//   pchk   (L,) i32 the chunk of each listed pair, block-major, chunks
//          ascending within a block; block b walks pairs
//          starts[b] .. starts[b] + n_walk[b] - 1.
// Output per ray: best_t, the least t over the walked triangles
// (inf without a hit), and best_ord, the least ordinal chunk * 128 + t
// that gives it (-1 without a hit).
//
// The TPU kernel runs a sequential grid over groups of 16 pairs of one
// block, multiplies the block's (128, 16) features by the chunks'
// (16, 512) coefficients on the matrix unit (a bf16x3 split) and folds
// into an output block that consecutive grid steps revisit.  Here one
// CTA of 128 threads owns one ray block, one thread per ray, and loops
// over the block's own chunk list, so nothing is carried between CTAs.
// Per chunk the CTA stages its 4 x 96 x 16 used coefficients in shared
// memory (24 KB), transposed so a triangle's 16 coefficients of a form
// are four 16-byte loads that every thread of a warp reads from the same
// address (a broadcast).  Each thread keeps its ray's 16 features in
// registers, evaluates the four forms as 16-term sums in a fixed order,
// and applies the reference's tests: |det| < 1e-7 rejects, u, v >= 0,
// u + v <= 1, 1e-7 < t < t_max, the ray live.  The fold keeps a strict
// t < best over ascending chunks and lanes, so the winner is the least
// t with ties to the least ordinal (the reference's tt <= btj within a
// slab and strict < across chunks give the same).  Dead rays skip the
// tests.  Blocks whose list overflowed the pair capacity get n_walk
// covering only their pairs inside it; the wrapper completes their rays
// through the traversal kernel.
//
// Arithmetic: float32, each form summed left to right, built with
// -fmad=false, so best_t and best_ord are bit-equal to
// pair_fold_plain, which sums in the same order.
//
// Bound: operations -- per (pair, live ray, triangle) the forms'
// multiply-adds on their coefficients that are not zero by construction
// (3 + 9 + 9 + 4 of the 64 this kernel evaluates; two operations each,
// under -fmad=false two instructions, so at most half the FMA peak) and
// the epilogue; the bytes are each distinct chunk's used coefficients
// (24 KB) and each ray slot once.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;        // rays per block = threads per CTA
constexpr int kFeat = 16;          // [1, o, d, o (x) d]
constexpr int kForms = 4;          // det, u_num, v_num, t_num
constexpr int kSlab = 128;         // lanes per form in a feat row
constexpr int kTris = 96;          // triangles per chunk

// one form of triangle t: f . m, summed left to right
__device__ __forceinline__ float form(const float* f, const float4* m) {
  const float4 a = m[0], b = m[1], c = m[2], d = m[3];
  float acc = f[0] * a.x;
  acc = acc + f[1] * a.y;
  acc = acc + f[2] * a.z;
  acc = acc + f[3] * a.w;
  acc = acc + f[4] * b.x;
  acc = acc + f[5] * b.y;
  acc = acc + f[6] * b.z;
  acc = acc + f[7] * b.w;
  acc = acc + f[8] * c.x;
  acc = acc + f[9] * c.y;
  acc = acc + f[10] * c.z;
  acc = acc + f[11] * c.w;
  acc = acc + f[12] * d.x;
  acc = acc + f[13] * d.y;
  acc = acc + f[14] * d.z;
  acc = acc + f[15] * d.w;
  return acc;
}

__global__ void __launch_bounds__(kBlock)
pairs_kernel(const float4* __restrict__ rays, const float* __restrict__ feat,
             int n_chunks, const int* __restrict__ pchk, int n_list,
             const int* __restrict__ starts, const int* __restrict__ n_walk,
             float* __restrict__ t_out, int* __restrict__ ord_out) {
  // [form][triangle][coefficient]
  __shared__ float4 sm[kForms * kTris * kFeat / 4];
  const int r = threadIdx.x;
  const long long slot = static_cast<long long>(blockIdx.x) * kBlock + r;
  const float4 ra = rays[2 * slot], rb = rays[2 * slot + 1];
  const float ox = ra.x, oy = ra.y, oz = ra.z;
  const float dx = ra.w, dy = rb.x, dz = rb.y;
  const float cap = rb.z;
  const bool live = rb.w > 0.0f;
  const float f[kFeat] = {1.0f,    ox,      oy,      oz,      dx,      dy,
                          dz,      ox * dx, ox * dy, ox * dz, oy * dx, oy * dy,
                          oy * dz, oz * dx, oz * dy, oz * dz};
  float best_t = __int_as_float(0x7f800000);
  int best_ord = -1;
  const int start = starts[blockIdx.x];
  const int n = min(n_walk[blockIdx.x], n_list - start);
  for (int j = 0; j < n; ++j) {
    const int chunk = pchk[start + j];
    if (chunk < 0 || chunk >= n_chunks) continue;    // uniform in the CTA
    __syncthreads();                   // the previous chunk's reads are done
    const float* src = feat + static_cast<long long>(chunk) * kFeat *
                                  kForms * kSlab;
    for (int q = r; q < kForms * kTris; q += kBlock) {
      const int s = q / kTris, t = q - s * kTris;
      float v[kFeat];
#pragma unroll
      for (int k = 0; k < kFeat; ++k) v[k] = __ldg(src + k * kForms * kSlab +
                                                   s * kSlab + t);
      float4* dst = sm + q * (kFeat / 4);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      dst[2] = make_float4(v[8], v[9], v[10], v[11]);
      dst[3] = make_float4(v[12], v[13], v[14], v[15]);
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < kTris; ++t) {
      const float det = form(f, sm + (0 * kTris + t) * (kFeat / 4));
      const float u_n = form(f, sm + (1 * kTris + t) * (kFeat / 4));
      const float v_n = form(f, sm + (2 * kTris + t) * (kFeat / 4));
      const float t_n = form(f, sm + (3 * kTris + t) * (kFeat / 4));
      const float inv_det = fabsf(det) < 1e-7f ? 0.0f : 1.0f / det;
      const float u = u_n * inv_det;
      const float v = v_n * inv_det;
      const float tt = t_n * inv_det;
      const bool ok = inv_det != 0.0f && u >= 0.0f && v >= 0.0f &&
                      u + v <= 1.0f && tt > 1e-7f && tt < cap;
      if (ok && tt < best_t) {
        best_t = tt;
        best_ord = chunk * kSlab + t;
      }
    }
  }
  t_out[slot] = best_t;
  ord_out[slot] = best_ord;
}

}  // namespace

// Arrays as described above, contiguous on the device (rays 16-byte
// aligned); n_chunks = C + 1 rows of feat, n_list entries of pchk,
// n_blocks ray blocks.  Launches on `stream`; returns the launch's
// cudaError_t (0 = queued), or cudaErrorInvalidValue for a negative
// size.
extern "C" int pairs_launch(const void* rays, const void* feat, int n_chunks,
                            const void* pchk, int n_list, const void* starts,
                            const void* n_walk, int n_blocks, void* t_out,
                            void* ord_out, void* stream) {
  if (n_chunks < 0 || n_list < 0 || n_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  pairs_kernel<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rays), static_cast<const float*>(feat),
      n_chunks, static_cast<const int*>(pchk), n_list,
      static_cast<const int*>(starts), static_cast<const int*>(n_walk),
      static_cast<float*>(t_out), static_cast<int*>(ord_out));
  return static_cast<int>(cudaGetLastError());
}
