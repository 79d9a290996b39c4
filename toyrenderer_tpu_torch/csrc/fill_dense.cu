// Dense-table visibility fill for Hopper (sm_90a).
//
// Replaces the TPU kernel _fill_kernel (toyrenderer_tpu/ops/
// raster_pallas.py:66, host fill_visibility_pallas :172): for every
// 16x128 screen tile, test the triangles of the tile's row of the dense
// (tiles, K) triangle table (its first tile_count entries, in slot
// order), then the big triangles, and keep per pixel the nearest fragment
// (reverse-Z: larger is nearer) and the triangle that wins it, continuing
// from the init planes.  Pixels no fragment wins keep the init planes bit
// for bit; won pixels get the table's triangle id + emit_base.
//
// The TPU host gathers a (tiles, K, 16) record table first (1,020 tiles
// x K = 5,888 x 64 B = 384 MB for the 1080p default view) and streams it
// through VMEM.  Here the records stay (T, 16) and are read through the
// table (4 B a slot): a tile's row is its stretch of a pair stream of
// stride K, so this is K1's fill without the resolve, on tile_walk.cuh's
// warp walk -- a warp per 32x8 region of a tile (each lane 8 pixels of
// one column, depth and id in registers, each written once), the units
// dealt heaviest tile first across blocks, and the corner reject
// (tile_walk::region_rejects) dropping a record that covers no pixel of
// the region before the per-pixel tests.  A region tests the big
// triangles whose tile bbox holds its tile: the plain version (the
// reference's XLA fill) tests every big triangle at every tile, but the
// setup's record of a triangle covers no pixel outside its bbox, so the
// others would score -1 there.  The walk reads each table row's first
// tile_count slots: the table is laid out as bin_triangles lays it,
// those slots and then -1.
//
// The update is strictly-greater in stream order, which picks the plain
// fill's winners: its chunks keep their first maximum, and a later chunk
// must be strictly nearer.  Built with -fmad=false and without fast math,
// evaluating edges and depth in the plain version's order, so depth and
// ids are bit-equal to the plain version (raster.fill_dense) on such
// inputs.
//
// Off the frames' domain the plain fill's chunk grid shows (tile_walk.cuh,
// "The fills' domain"): below an init depth of -1 an empty slot or a
// missed centre wins with id -1, and a chunk whose maximum is NaN loses.
// As in K1, a record check runs before the walk
// (tile_walk::nan_check_kernel), the walk leaves a region holding a
// pixel below -1 to an exact pass of the same call, and the exact pass
// takes every region when the check finds a record whose depth may be
// NaN.  The exact pass (fill_dense_exact_kernel) walks a region on the
// plain fill's grid (raster.fill_dense): the table row from slot 0 in
// chunks of min(chunk, K) slots, the last moved back to end at slot K,
// then the whole big list in chunks of min(chunk, B), no reject.  No
// frame's input is off the domain: the frames pay the check's read of
// the records' depth coefficients and an exact pass with no unit to walk.
//
// What bounds it: the (pair, pixel) edge and depth tests -- 20 f32
// operations each, done under -fmad=false as separate multiplies and
// adds -- over the pixels of each region its records are not rejected
// for.

#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace {

using tile_walk::kBatch;
using tile_walk::kRec;
using tile_walk::kRows;

// The outputs never alias the inputs: the wrapper allocates them.
struct Params {
  tile_walk::Stream s;    // vals_s: the (tiles, K) table; offs: tile * K
  const float* __restrict__ init_z;    // (Hp, Wp), or null: depth 0
  const int* __restrict__ init_id;     // (Hp, Wp), or null: id -1
  float* __restrict__ z_out;           // (Hp, Wp)
  int* __restrict__ id_out;            // (Hp, Wp)
  int* __restrict__ exact_list;        // tile_walk.cuh, kListHead
  int k, chunk, big_chunk;             // K; min(chunk, K); min(chunk, B)
  int emit_base;
};

// This lane's init planes.
__device__ __forceinline__ void load_init(const Params& p,
                                          const tile_walk::Pixels& px,
                                          float* z, int* id) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    z[i] = p.init_z ? __ldg(p.init_z + px.pix[i]) : 0.0f;
    id[i] = p.init_id ? __ldg(p.init_id + px.pix[i]) : -1;
  }
}

__device__ __forceinline__ void store(const Params& p,
                                      const tile_walk::Pixels& px,
                                      const float* z, const int* id) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    p.z_out[px.pix[i]] = z[i];
    p.id_out[px.pix[i]] = id[i];
  }
}

__global__ void __launch_bounds__(tile_walk::kWalkThreads)
fill_dense_kernel(const __grid_constant__ Params p) {
  __shared__ tile_walk::Slot slots[tile_walk::kWalkWarps];
  const int unit = tile_walk::region_unit();
  const tile_walk::Pixels px = tile_walk::region_pixels(p.s, unit);
  float z[kRows];
  int id[kRows];
  load_init(p, px, z, id);
  // off the fills' domain (no frame's init is below -1): the exact pass
  if (p.init_z != nullptr && tile_walk::below_floor(z)) {
    if (threadIdx.x % 32 == 0) tile_walk::leave_unit(p.exact_list, unit);
    return;
  }
  const float cx = px.centre_x(p.s);
  float cy[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) cy[i] = px.centre_y(p.s, i);
  tile_walk::walk_region<true>(
      p.s, px, slots[threadIdx.x / 32],
      [&](float (*rec)[kRec], const int* tri, int n) {
        for (int r = 0; r < n; ++r) {
          const float* e = rec[r];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            float d;
            if (tile_walk::covers(e, cx, cy[i], d) && d > z[i]) {
              z[i] = d;
              id[i] = tri[r] + p.emit_base;
            }
          }
        }
      });
  store(p, px, z, id);
}

// One list of the exact pass for this warp's region, on the plain fill's
// grid: chunks of c slots of ids[0..n) from slot 0, the last moved back
// to end at slot n (raster.chunk_starts).  Each slot scores -1 where it
// is empty (id < 0, emitting its id) or misses the centre, and a
// triangle's emits its id + emit_base; each chunk's first maximum per
// pixel commits where it is strictly nearer and no score of the chunk
// was NaN.  A batch of 32 empty slots is fed as its first: the others
// tie it.
__device__ __forceinline__ void exact_walk(const Params& p,
                                           tile_walk::Slot& slot,
                                           const int* ids, int n, int c,
                                           float cx, const float* cy,
                                           float* bz, int* bw) {
  const int lane = threadIdx.x % 32;
  for (int s0 = 0; s0 < n; s0 += c) {
    const int start = min(s0, n - c);
    float cz[kRows];
    int cw[kRows];
    unsigned nan = 0u;        // pixels whose chunk met a NaN
    bool first = true;
    auto feed = [&](const float* e, int t) {
      const int emit = t >= 0 ? t + p.emit_base : t;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float d = -1.0f;
        if (e != nullptr) tile_walk::covers(e, cx, cy[i], d);
        if (d != d) nan |= 1u << i;
        if (first || d > cz[i]) {
          cz[i] = d;
          cw[i] = emit;
        }
      }
      first = false;
    };
    for (int b0 = 0; b0 < c; b0 += kBatch) {
      const int m = min(kBatch, c - b0);
      const int t = lane < m ? __ldg(ids + start + b0 + lane) : -1;
      const unsigned live = __ballot_sync(0xffffffffu, lane < m && t >= 0);
      if (live == 0u) {
        feed(nullptr, __shfl_sync(0xffffffffu, t, 0));
        continue;
      }
      if (lane < m) {
        if (t >= 0) {
          const float4* src = reinterpret_cast<const float4*>(p.s.tri_rec)
                              + (size_t)t * (kRec / 4);
          float4* dst = reinterpret_cast<float4*>(slot.rec[lane]);
#pragma unroll
          for (int i = 0; i < kRec / 4; ++i) dst[i] = __ldg(src + i);
        }
        slot.tri[lane] = t;
      }
      __syncwarp();
      for (int r = 0; r < m; ++r) {
        const int tr = slot.tri[r];
        feed(tr >= 0 ? slot.rec[r] : nullptr, tr);
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (!((nan >> i) & 1u) && cz[i] > bz[i]) {
        bz[i] = cz[i];
        bw[i] = cw[i];
      }
  }
}

// The exact pass: the units fill_dense_kernel left to it, or every unit
// where the record check found a record whose depth may be NaN, each
// walked as raster.fill_dense walks it: the tile's table row, then the
// big list.
__global__ void __launch_bounds__(tile_walk::kWalkThreads)
fill_dense_exact_kernel(const __grid_constant__ Params p, int units) {
  __shared__ tile_walk::Slot slots[tile_walk::kWalkWarps];
  tile_walk::for_exact_units(p.exact_list, units, [&](int unit) {
    tile_walk::Slot& slot = slots[threadIdx.x / 32];
    const tile_walk::Pixels px = tile_walk::region_pixels(p.s, unit);
    float bz[kRows], cy[kRows];
    int bw[kRows];
    load_init(p, px, bz, bw);
    const float cx = px.centre_x(p.s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) cy[i] = px.centre_y(p.s, i);
    exact_walk(p, slot, p.s.vals_s + (size_t)px.tile * p.k, p.k, p.chunk,
               cx, cy, bz, bw);
    exact_walk(p, slot, p.s.big_list, p.s.big_cap, p.big_chunk, cx, cy,
               bz, bw);
    store(p, px, bz, bw);
  });
}

}  // namespace

extern "C" int fill_dense_launch(
    const void* tri_rec, const void* table, const void* row_start,
    const void* tile_count, const void* bighit, const void* big_list,
    const void* big_box, const void* tile_order, int k, int big_cap,
    const void* init_z, const void* init_id, void* z_out, void* id_out,
    void* exact_list, int n_records, int num_tiles, int tiles_x, int wp,
    int emit_base, int chunk, float inv_w, float inv_h, void* stream) {
  if (chunk < 1 || k < 1 || big_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.s = tile_walk::make_stream(tri_rec, table, row_start, tile_count,
                               nullptr, bighit, big_list, big_box,
                               tile_order, big_cap, tiles_x, wp, inv_w,
                               inv_h);
  p.init_z = static_cast<const float*>(init_z);
  p.init_id = static_cast<const int*>(init_id);
  p.z_out = static_cast<float*>(z_out);
  p.id_out = static_cast<int*>(id_out);
  p.exact_list = static_cast<int*>(exact_list);
  p.k = k;
  p.chunk = chunk < k ? chunk : k;
  p.big_chunk = chunk < big_cap ? chunk : big_cap;
  p.emit_base = emit_base;
  const int units = num_tiles * tile_walk::kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_walk::nan_check_kernel<<<tile_walk::kChecks,
                               tile_walk::kCheckThreads, 0, s>>>(
      static_cast<const float*>(tri_rec), n_records, p.exact_list);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_dense_kernel<<<tile_walk::walk_blocks(num_tiles),
                      tile_walk::kWalkThreads, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  fill_dense_exact_kernel<<<tile_walk::exact_blocks(num_tiles),
                            tile_walk::kWalkThreads, 0, s>>>(p, units);
  return static_cast<int>(cudaGetLastError());
}
