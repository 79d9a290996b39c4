// L-layer depth-peel fill over the tile-sorted pair stream, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _fill_peel_stream_kernel
// (toyrenderer_tpu/ops/raster_pallas.py:778): for every 16x128 screen
// tile, walk the tile's (tile, triangle) pairs in stream order, then the
// big triangles whose tile bbox holds the tile, and keep per pixel the L
// nearest fragments in front of an occluder (reverse-Z: larger is
// nearer), nearest first, by an insertion cascade.  No resolve: the
// masked set's textured resolve runs downstream on compacted quads.
//
// What bounds it: the (pair, pixel) edge and depth tests and the
// cascade's L steps, under -fmad=false; the sun map (1024^2, one layer,
// ~542k pairs, the densest 16x128 tile ~6.7k of them) is the largest
// launch.  The design is the fill+resolve kernel's: the warp walk of
// tile_walk.cuh (a warp owns a 32x8 region of a tile and walks the
// tile's pairs by itself, the units dealt heaviest tile first across
// blocks so that the densest tile's eight regions run on eight SMs;
// records that fail the region's corner test, tile_walk::region_rejects,
// are dropped before the per-pixel tests; the big list filtered by tile
// bbox), each lane keeping its 8 pixels' L x (depth, id) in registers.
// A rejected record covers no pixel of the region, so the cascade sees
// exactly the fragments of the full walk, in stream order.  The TPU
// kernel re-reads and re-writes its (L, 16, 128) output block per chunk
// of 32 pairs; here the cascade never leaves registers and each layer
// is written once.
//
// The cascade is the TPU kernel's, step for step: at each layer a
// fragment within the PEEL_BOUND band at or below the layer's depth is
// dropped, then a strictly nearer one takes the layer and the displaced
// fragment carries on down.  Built with -fmad=false and without fast
// math, so edge and depth arithmetic round exactly as the plain PyTorch
// version does: ids and depth are bit-equal to fill_peel_plain.

#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace {

using tile_walk::kRec;
using tile_walk::kRows;

struct Params {
  tile_walk::Stream s;
  const float* occluder;     // (Hp, Wp) seeds every layer, or null: 0
  float* z_out;              // (L, Hp, Wp)
  int* id_out;               // (L, Hp, Wp)
  int hp, emit_base;
  float peel_bound;
};

template <int L>
__device__ __forceinline__ void insert(float cz, int ci, float* z, int* id,
                                       float peel_bound) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (cz <= z[l] && cz >= z[l] * peel_bound) cz = -1.0f;
    if (cz > z[l]) {
      const float tz = z[l];
      const int ti = id[l];
      z[l] = cz;
      id[l] = ci;
      cz = tz;
      ci = ti;
    }
  }
}

// Test one staged batch of raster records against this thread's pixels.
template <int L>
__device__ __forceinline__ void peel_batch(
    float (*rec)[kRec], const int* tri, int n, float px, const float* py,
    int emit_base, float peel_bound, float (*z)[L], int (*id)[L]) {
  for (int r = 0; r < n; ++r) {
    const float* e = rec[r];
    const int ci = tri[r] + emit_base;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float l0 = e[0] * px + e[1] * py[i] + e[2];
      float l1 = e[3] * px + e[4] * py[i] + e[5];
      float l2 = e[6] * px + e[7] * py[i] + e[8];
      float num = e[9] * px + e[10] * py[i] + e[11];
      float den = e[12] * px + e[13] * py[i] + e[14];
      if (l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && den > 0.0f)
        insert<L>(num / den, ci, z[i], id[i], peel_bound);
    }
  }
}

template <int L>
__global__ void __launch_bounds__(tile_walk::kWalkThreads)
fill_peel_kernel(Params p) {
  __shared__ tile_walk::Slot slots[tile_walk::kWalkWarps];
  const tile_walk::Pixels px = tile_walk::region_pixels(p.s);
  const size_t plane = (size_t)p.hp * p.s.wp;
  float z[kRows][L];
  int id[kRows][L];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float occ = p.occluder ? __ldg(p.occluder + px.pix[i]) : 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z[i][l] = occ;
      id[i][l] = -1;
    }
  }

  if (p.s.n_chunks[px.tile] > 0) {
    const float cx = px.centre_x(p.s);
    float cy[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) cy[i] = px.centre_y(p.s, i);
    tile_walk::walk_region(
        p.s, px, slots[threadIdx.x / 32],
        [&](float (*rec)[kRec], const int* tri, int n) {
          peel_batch<L>(rec, tri, n, cx, cy, p.emit_base, p.peel_bound, z,
                        id);
        });
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      p.z_out[l * plane + px.pix[i]] = z[i][l];
      p.id_out[l * plane + px.pix[i]] = id[i][l];
    }
  }
}

template <int L>
int launch(const Params& p, int num_tiles, cudaStream_t stream) {
  fill_peel_kernel<L><<<tile_walk::walk_blocks(num_tiles),
                        tile_walk::kWalkThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fill_peel_launch(
    const void* tri_rec, const void* vals_s, const void* offs,
    const void* counts_eff, const void* n_chunks, const void* bighit,
    const void* big_list, const void* big_box, const void* tile_order,
    int big_cap, const void* occluder, void* z_out, void* id_out,
    int num_tiles, int tiles_x, int wp, int hp, int emit_base, int layers,
    float inv_w, float inv_h, float peel_bound, void* stream) {
  Params p;
  p.s = tile_walk::make_stream(tri_rec, vals_s, offs, counts_eff, n_chunks,
                               bighit, big_list, big_box, tile_order,
                               big_cap, tiles_x, wp, inv_w, inv_h);
  p.occluder = static_cast<const float*>(occluder);
  p.z_out = static_cast<float*>(z_out);
  p.id_out = static_cast<int*>(id_out);
  p.hp = hp;
  p.emit_base = emit_base;
  p.peel_bound = peel_bound;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layers) {
    case 1: return launch<1>(p, num_tiles, s);
    case 2: return launch<2>(p, num_tiles, s);
    case 3: return launch<3>(p, num_tiles, s);
    case 4: return launch<4>(p, num_tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
