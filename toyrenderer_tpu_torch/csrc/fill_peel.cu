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
//
// The plain version also inserts a missed centre, and each empty slot up
// to the longest list of the tile's batch, at depth -1 (the reference's
// peel_tiles, raster_pallas.py:892-897).  Such an insert changes no
// layer while every layer is at least -1, as it is wherever the occluder
// is (the layers only grow), so the fast walk skips misses and rejected
// records.  Where a warp's region holds an occluder below -1 -- no
// frame's -- the walk leaves the region to a second kernel of the same
// launch (fill_peel_exact_kernel), which walks it exactly as the plain
// version does: every record in stream order, each inserted, then the
// empty slots.  A NaN depth changes no layer in either (every comparison
// fails).

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
  int* exact_list;           // tile_walk.cuh, kListHead
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
      float d;
      if (tile_walk::covers(e, px, py[i], d))
        insert<L>(d, ci, z[i], id[i], peel_bound);
    }
  }
}

template <int L>
__device__ __forceinline__ void store_layers(const Params& p,
                                             const tile_walk::Pixels& px,
                                             float (*z)[L], int (*id)[L]) {
  const size_t plane = (size_t)p.hp * p.s.wp;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      p.z_out[l * plane + px.pix[i]] = z[i][l];
      p.id_out[l * plane + px.pix[i]] = id[i][l];
    }
  }
}

// This warp's unit as the plain version peels it (peel_cuda.peel_tiles):
// every record of a visited tile in stream order, no reject, each
// inserted at its depth or, where it misses the centre, at -1; then an
// empty slot (id emit_base - 1, depth -1) for each position up to the
// batch's longest list -- after L of them, one more changes nothing.
template <int L>
__device__ __forceinline__ void exact_unit(const Params& p,
                                           tile_walk::Slot& slot, int unit) {
  const tile_walk::Pixels px = tile_walk::region_pixels(p.s, unit);
  float z[kRows][L];
  int id[kRows][L];
  float cy[kRows];
  const float cx = px.centre_x(p.s);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float occ = p.occluder ? __ldg(p.occluder + px.pix[i]) : 0.0f;
    cy[i] = px.centre_y(p.s, i);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z[i][l] = occ;
      id[i][l] = -1;
    }
  }
  int pos = 0;
  if (p.s.n_chunks[px.tile] > 0)
    tile_walk::walk_region<false>(
        p.s, px, slot, [&](float (*rec)[kRec], const int* tri, int n) {
          for (int r = 0; r < n; ++r) {
            const float* e = rec[r];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              float d = -1.0f;
              tile_walk::covers(e, cx, cy[i], d);
              insert<L>(d, tri[r] + p.emit_base, z[i], id[i], p.peel_bound);
            }
          }
          pos += n;
        });
  const int slots = min(tile_walk::batch_slots(p.s, px.tile), pos + L);
  for (; pos < slots; ++pos) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      insert<L>(-1.0f, p.emit_base - 1, z[i], id[i], p.peel_bound);
  }
  store_layers<L>(p, px, z, id);
}

template <int L>
__global__ void __launch_bounds__(tile_walk::kWalkThreads)
fill_peel_kernel(const __grid_constant__ Params p) {
  __shared__ tile_walk::Slot slots[tile_walk::kWalkWarps];
  tile_walk::Slot& slot = slots[threadIdx.x / 32];
  const tile_walk::Pixels px =
      tile_walk::region_pixels(p.s, tile_walk::region_unit());
  float z[kRows][L];
  int id[kRows][L];
  float occ[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    occ[i] = p.occluder ? __ldg(p.occluder + px.pix[i]) : 0.0f;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z[i][l] = occ[i];
      id[i][l] = -1;
    }
  }
  // off the fills' domain (no frame's occluder is below -1): the exact
  // pass
  const bool low = p.occluder != nullptr && tile_walk::below_floor(occ);
  if (low) {
    if (threadIdx.x % 32 == 0)
      tile_walk::leave_unit(p.exact_list, tile_walk::region_unit());
    return;
  }

  if (p.s.n_chunks[px.tile] > 0) {
    const float cx = px.centre_x(p.s);
    float cy[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) cy[i] = px.centre_y(p.s, i);
    tile_walk::walk_region<true>(
        p.s, px, slot, [&](float (*rec)[kRec], const int* tri, int n) {
          peel_batch<L>(rec, tri, n, cx, cy, p.emit_base, p.peel_bound, z,
                        id);
        });
  }
  store_layers<L>(p, px, z, id);
}

// The exact pass: the units fill_peel_kernel left to it, walked as the
// plain version walks them (exact_unit).
template <int L>
__global__ void __launch_bounds__(tile_walk::kWalkThreads)
fill_peel_exact_kernel(const __grid_constant__ Params p, int units) {
  __shared__ tile_walk::Slot slots[tile_walk::kWalkWarps];
  tile_walk::for_exact_units(p.exact_list, units, [&](int unit) {
    exact_unit<L>(p, slots[threadIdx.x / 32], unit);
  });
}

template <int L>
int launch(const Params& p, int num_tiles, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      p.exact_list, 0, tile_walk::kListHead * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_peel_kernel<L><<<tile_walk::walk_blocks(num_tiles),
                        tile_walk::kWalkThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  fill_peel_exact_kernel<L><<<tile_walk::exact_blocks(num_tiles),
                              tile_walk::kWalkThreads, 0, stream>>>(
      p, num_tiles * tile_walk::kWarps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fill_peel_launch(
    const void* tri_rec, const void* vals_s, const void* offs,
    const void* counts_eff, const void* n_chunks, const void* bighit,
    const void* big_list, const void* big_box, const void* tile_order,
    const void* tile_len, int big_cap, const void* occluder, void* z_out,
    void* id_out, void* exact_list, int num_tiles, int tiles_x, int wp,
    int hp, int emit_base,
    int layers, int chunk, int tile_batch, float inv_w, float inv_h,
    float peel_bound, void* stream) {
  if (chunk < 1 || tile_batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.s = tile_walk::make_stream(tri_rec, vals_s, offs, counts_eff, n_chunks,
                               bighit, big_list, big_box, tile_order,
                               big_cap, tiles_x, wp, inv_w, inv_h);
  tile_walk::set_chunk_grid(p.s, tile_len, num_tiles, chunk, tile_batch);
  p.occluder = static_cast<const float*>(occluder);
  p.z_out = static_cast<float*>(z_out);
  p.id_out = static_cast<int*>(id_out);
  p.exact_list = static_cast<int*>(exact_list);
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
