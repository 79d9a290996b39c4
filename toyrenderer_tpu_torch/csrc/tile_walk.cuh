// The tile walk shared by the fill kernels (fill_resolve.cu, fill_peel.cu).
//
// One 256-thread block renders one 16x128 screen tile, the tiles taken
// heaviest first (tile_order); each thread owns 8 pixels of one column.
// A visited tile walks its own (tile, triangle) pairs in stream order,
// then the big triangles whose tile bbox holds it: warp 0 keeps those,
// in list order, by a ballot over 32 list entries at a time (a triangle
// covers no pixel outside its bbox, so the filter changes no pixel).
// Each batch of up to 32 raster records is staged in shared memory and
// handed to the kernel's per-pixel body.  The plain PyTorch versions walk
// the same tables (raster_cuda.walk_tables) and round the pixel centres
// the same way, which the kernels' bit-equality with them relies on.

#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace tile_walk {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRows = kTileH * kTileW / kThreads;   // pixels per thread
constexpr int kBatch = 32;                          // records per stage
static_assert(kBatch == 32, "the big-list filter is one warp ballot");
constexpr int kRec = 16;                            // raster record floats

// The pair stream and its per-tile tables (raster_cuda.stream_layout).
struct Stream {
  const float* tri_rec;      // (T, 16) edges | num coeffs | den coeffs | id
  const int* vals_s;         // sorted pair stream: triangle ids
  const int* offs;           // (tiles,) first stream entry of each tile
  const int* counts_eff;     // (tiles,) pairs each tile walks
  const int* n_chunks;       // (tiles,) 0 = tile not visited (keeps init)
  const int* bighit;         // (tiles,) 1 = a big triangle's bbox touches
  const int* big_list;       // (B,) big triangle ids, -1 after the last
  const int4* big_box;       // (B,) their tile bbox: tx0, tx1, ty0, ty1
  const int* tile_order;     // (tiles,) the tile each block renders
  int big_cap;
  int tiles_x, wp;
  float inv_w, inv_h;
};

struct Shared {
  float rec[kBatch][kRec];
  int tri[kBatch];
  int n_hit, list_end;
};

// This thread's tile and pixels: the tile, its coordinates, the column,
// the first of the thread's rows, and the flat index of each pixel.
struct Pixels {
  int tile, tx, ty, col, row0, x;
  size_t pix[kRows];

  __device__ __forceinline__ explicit Pixels(const Stream& s) {
    tile = s.tile_order[blockIdx.x];
    tx = tile % s.tiles_x;
    ty = tile / s.tiles_x;
    col = threadIdx.x % kTileW;
    row0 = (threadIdx.x / kTileW) * kRows;
    x = tx * kTileW + col;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      pix[i] = (size_t)(ty * kTileH + row0 + i) * s.wp + x;
  }

  // normalized pixel centres, rounded as the plain versions round them
  __device__ __forceinline__ float centre_x(const Stream& s) const {
    return ((float)tx * (float)kTileW + ((float)col + 0.5f)) * s.inv_w;
  }
  __device__ __forceinline__ float centre_y(const Stream& s, int i) const {
    return ((float)ty * (float)kTileH + ((float)(row0 + i) + 0.5f))
           * s.inv_h;
  }
};

// Stage records of the n triangles tri[0..n) into shared memory.
__device__ __forceinline__ void stage(const float* tri_rec,
                                      float (*rec)[kRec], const int* tri,
                                      int n) {
  for (int j = threadIdx.x; j < n * kRec; j += kThreads)
    rec[j / kRec][j % kRec] = tri_rec[(size_t)tri[j / kRec] * kRec
                                      + j % kRec];
}

// Walk a visited tile: body(rec, tri, n) for each staged batch of its
// own pairs, then of the big triangles whose tile bbox holds it.  Every
// thread of the block calls it.
template <class Body>
__device__ __forceinline__ void walk(const Stream& s, const Pixels& px,
                                     Shared& sh, Body body) {
  const int first = s.offs[px.tile];
  const int count = s.counts_eff[px.tile];
  for (int b0 = 0; b0 < count; b0 += kBatch) {
    const int n = min(kBatch, count - b0);
    if (threadIdx.x < n)
      sh.tri[threadIdx.x] = s.vals_s[first + b0 + threadIdx.x];
    __syncthreads();
    stage(s.tri_rec, sh.rec, sh.tri, n);
    __syncthreads();
    body(sh.rec, sh.tri, n);
    __syncthreads();
  }

  if (s.bighit[px.tile] <= 0) return;
  for (int b0 = 0; b0 < s.big_cap; b0 += kBatch) {
    if (threadIdx.x < kBatch) {
      const int j = b0 + threadIdx.x;
      const int t = j < s.big_cap ? s.big_list[j] : -1;
      bool hit = false;
      if (t >= 0) {
        const int4 b = s.big_box[j];
        hit = px.tx >= b.x && px.tx <= b.y && px.ty >= b.z && px.ty <= b.w;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      const unsigned ended = __ballot_sync(0xffffffffu, t < 0);
      if (hit) sh.tri[__popc(m & ((1u << threadIdx.x) - 1u))] = t;
      if (threadIdx.x == 0) {
        sh.n_hit = __popc(m);
        sh.list_end = ended != 0u;
      }
    }
    __syncthreads();
    const int n = sh.n_hit;
    const bool done = sh.list_end;
    stage(s.tri_rec, sh.rec, sh.tri, n);
    __syncthreads();
    body(sh.rec, sh.tri, n);
    __syncthreads();
    if (done) break;
  }
}

// The Stream of a launch's plain C arguments.
inline Stream make_stream(const void* tri_rec, const void* vals_s,
                          const void* offs, const void* counts_eff,
                          const void* n_chunks, const void* bighit,
                          const void* big_list, const void* big_box,
                          const void* tile_order, int big_cap, int tiles_x,
                          int wp, float inv_w, float inv_h) {
  Stream s;
  s.tri_rec = static_cast<const float*>(tri_rec);
  s.vals_s = static_cast<const int*>(vals_s);
  s.offs = static_cast<const int*>(offs);
  s.counts_eff = static_cast<const int*>(counts_eff);
  s.n_chunks = static_cast<const int*>(n_chunks);
  s.bighit = static_cast<const int*>(bighit);
  s.big_list = static_cast<const int*>(big_list);
  s.big_box = static_cast<const int4*>(big_box);
  s.tile_order = static_cast<const int*>(tile_order);
  s.big_cap = big_cap;
  s.tiles_x = tiles_x;
  s.wp = wp;
  s.inv_w = inv_w;
  s.inv_h = inv_h;
  return s;
}

}  // namespace tile_walk
