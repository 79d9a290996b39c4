// Fused visibility fill + interpolant resolve over the tile-sorted pair
// stream, for Hopper (sm_90a).
//
// Replaces the TPU kernel _fill_resolve_stream_kernel
// (toyrenderer_tpu/ops/raster_pallas.py:294, with its _peel / _smem /
// _smem_peel entries at :655-693): for every 16x128 screen tile, walk the
// tile's (tile, triangle) pairs in stream order -- edge functions, affine
// depth num/den, reverse-Z test, optional exclusive peel bound -- then the
// resident big-triangle list, then fetch the winner's 64-float resolve
// record and write the 32 interpolant planes.
//
// What bounds it on an H100: the pair loop is arithmetic (5 affine
// evaluations per test and pixel, ~8.8e5 tile-triangle tests over the
// opaque set of the unculled 1080p courtyard, 20 f32 operations each,
// done under -fmad=false as separate multiplies and adds); the epilogue
// is bytes (34 f32 planes written per pixel, ~0.28 GB per launch, plus a
// 256-byte record gathered per covered pixel).  The design is the warp
// walk of tile_walk.cuh: a warp owns a 32x8 region of a tile (each lane 8
// pixels of one column, so depth / winner stay in registers and every
// plane store of a warp is one coalesced row segment) and walks the
// tile's pairs by itself, the units dealt heaviest tile first across
// blocks, so the densest tile -- ~7x the mean -- runs on eight SMs.  A
// record whose edge or depth functions fail at the region's four corners
// by more than their rounding (tile_walk::region_rejects) is dropped
// before the per-pixel tests: the triangles of these views cover a few
// pixels each, so most (pair, region) tests end there.  A rejected
// record fails the coverage test at every pixel of the region, so the
// winners and depth are those of the full walk -- for an init depth of
// at least -1, as every frame's is (a failed test, d = -1, would win
// below it), and where no kept record's depth can be NaN.  A tile tests
// only the big triangles whose tile bbox holds it (a lane per list entry
// and a ballot, stream order kept).
// Off that domain a second kernel of the same launch walks the region
// exactly as the plain fill does (fill_resolve_exact_kernel): every
// record in stream order, no reject, each chunk's first maximum
// committed at the chunk's end only when no score in it is NaN and it is
// strictly nearer, the batch's empty slots scored -1 (tile_walk.cuh,
// "The fills' domain").  The walk leaves a region to it when an init
// depth there is below -1, and every region when a check before the
// walk (tile_walk::nan_check_kernel, shared with K7) finds a record whose
// depth may be NaN (a depth coefficient not a number or past
// kMarginCap).  No frame's input
// is either, and the walk keeps its registers, occupancy and code: the
// frames pay the check's read of the records' depth coefficients and an
// exact pass that finds no unit to walk.
// The epilogue is per warp: each resolves its own 256 pixels, and where
// no fragment won copies the init planes, a pixel's 32 plane loads
// issued before its stores (on a still view the late culled launch walks
// no pair and is nothing but that copy).
// The first layer passes no init planes: the kernel writes their
// constants instead of reading 34 zero planes.
// The TPU's VMEM record scratch (K x 64 f32 = 512 KiB) and its one-hot
// bf16 MXU fetch have no counterpart: the winner's record is an exact f32
// gather from global memory.  Ties keep the first fragment in stream order
// (update only on strictly nearer depth, no atomics), as the TPU's tree
// reduction does.  Built with -fmad=false and without fast math, so edge
// and depth arithmetic round exactly as the plain PyTorch version does
// (the normal's length may differ by an ulp: the plain version takes it
// from torch.linalg.vector_norm).

#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace {

using tile_walk::kRec;
using tile_walk::kRows;
constexpr int kRes = 64;                            // resolve record floats
constexpr int kPlanes = 32;                         // interpolant planes

// The outputs never alias the inputs: the wrapper allocates them.
struct Params {
  tile_walk::Stream s;
  const float* __restrict__ res_rec;   // (T, 64) resolve records
  const float* __restrict__ init_z;    // (Hp, Wp), or null: depth 0
  const int* __restrict__ init_id;     // (Hp, Wp), or null: id -1
  const float* __restrict__ init_rec;  // (32, Hp, Wp), or null: planes 0
  const float* __restrict__ peel;      // (Hp, Wp) exclusive near bound
  float* __restrict__ z_out;
  int* __restrict__ id_out;
  float* __restrict__ planes_out;      // (32, Hp, Wp)
  int* __restrict__ exact_list;        // tile_walk.cuh, kListHead
  int hp, emit_base;
  float peel_bound;
};

// Test one staged batch of raster records against this thread's pixels.
__device__ __forceinline__ void raster_batch(
    float (*rec)[kRec], const int* tri, int n, float px,
    const float* py, const float* pk, bool has_peel, float* bz, int* bw) {
  for (int r = 0; r < n; ++r) {
    const float* e = rec[r];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float d = -1.0f;
      tile_walk::covers(e, px, py[i], d);
      if (has_peel && !(d < pk[i])) d = -1.0f;
      if (d > bz[i]) {
        bz[i] = d;
        bw[i] = tri[r];
      }
    }
  }
}

__device__ __forceinline__ void bary(const float* rec, float x, float y,
                                     float* pc) {
  float lw[3];
#pragma unroll
  for (int v = 0; v < 3; ++v)
    lw[v] = (rec[3 * v] * x + rec[3 * v + 1] * y + rec[3 * v + 2])
            * rec[9 + v];
  float d = lw[0] + lw[1] + lw[2];
  if (fabsf(d) < 1e-30f) d = 1e-30f;
#pragma unroll
  for (int v = 0; v < 3; ++v) pc[v] = lw[v] / d;
}

// sum_v rec[base + stride*v + i] * pc[v], in the plain version's order
__device__ __forceinline__ float lerp(const float* rec, int base, int stride,
                                      int i, const float* pc) {
  return rec[base + i] * pc[0] + rec[base + stride + i] * pc[1]
         + rec[base + 2 * stride + i] * pc[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// The 32 interpolant planes of one pixel (gbuffer.resolve_interpolants).
__device__ void resolve_pixel(const float* __restrict__ rec, float pxn,
                              float pyn, float dx, float dy, float* out) {
  float pc[3], pcx[3], pcy[3];
  bary(rec, pxn, pyn, pc);
  bary(rec, pxn + dx, pyn, pcx);
  bary(rec, pxn, pyn + dy, pcy);
  float nr[3], n[3], uv[2], dux[2], duy[2], prev[3], pos[3], d1[3], d2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) nr[i] = lerp(rec, 12, 3, i, pc);
  float nn = sqrtf(nr[0] * nr[0] + nr[1] * nr[1] + nr[2] * nr[2]);
  nn = fmaxf(nn, 1e-20f);
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = nr[i] / nn;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uv[i] = lerp(rec, 21, 2, i, pc);
    dux[i] = lerp(rec, 21, 2, i, pcx) - uv[i];
    duy[i] = lerp(rec, 21, 2, i, pcy) - uv[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    prev[i] = lerp(rec, 27, 3, i, pc);
    pos[i] = lerp(rec, 49, 3, i, pc);
    d1[i] = lerp(rec, 49, 3, i, pcx) - pos[i];
    d2[i] = lerp(rec, 49, 3, i, pcy) - pos[i];
  }
  // cotangent frame (Schueler); degenerate UVs -> T = B = 0
  float d1p[3], d2p[3], t[3], b[3];
  cross3(n, d1, d1p);
  cross3(d2, n, d2p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = d2p[i] * dux[0] + d1p[i] * duy[0];
    b[i] = d2p[i] * dux[1] + d1p[i] * duy[1];
  }
  float m2 = fmaxf(t[0] * t[0] + t[1] * t[1] + t[2] * t[2],
                   b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
  float inv_max = 1.0f / sqrtf(fmaxf(m2, 1e-20f));
  float duv2 = (dux[0] * dux[0] + dux[1] * dux[1])
               + (duy[0] * duy[0] + duy[1] * duy[1]);
  bool ok = m2 > 1e-16f && duv2 > 1e-12f;
  int k = 0;
  for (int i = 0; i < 3; ++i) out[k++] = n[i];
  for (int i = 0; i < 2; ++i) out[k++] = uv[i];
  for (int i = 0; i < 2; ++i) out[k++] = dux[i];
  for (int i = 0; i < 2; ++i) out[k++] = duy[i];
  for (int i = 0; i < 3; ++i) out[k++] = ok ? t[i] * inv_max : 0.0f;
  for (int i = 0; i < 3; ++i) out[k++] = ok ? b[i] * inv_max : 0.0f;
  for (int i = 36; i < 49; ++i) out[k++] = rec[i];  // material, tex, cutoff
  for (int i = 0; i < 3; ++i) out[k++] = prev[i];
  out[k++] = rec[58];                                // texture statics B
}

// Where no fragment won: the init planes, or the first layer's
// constants.  The pixel's 32 plane loads are all issued before its
// stores.
__device__ __forceinline__ void keep_init(const Params& p, size_t pix,
                                          size_t plane) {
  const float* __restrict__ in = p.init_rec;
  float* __restrict__ out = p.planes_out;
  float v[kPlanes];
#pragma unroll
  for (int c = 0; c < kPlanes; ++c)
    v[c] = in ? __ldg(in + c * plane + pix) : 0.0f;
#pragma unroll
  for (int c = 0; c < kPlanes; ++c) out[c * plane + pix] = v[c];
}

// The epilogue: depth, ids, and each won pixel's planes resolved from its
// winner's record (the init planes where no fragment won).
__device__ __forceinline__ void resolve_unit(const Params& p,
                                             const tile_walk::Pixels& px,
                                             const float* bz, const int* bw,
                                             const int* iid) {
  const size_t plane = (size_t)p.hp * p.s.wp;
  const float dx = p.s.inv_w, dy = p.s.inv_h;
  const float pxr = ((float)px.x + 0.5f) * p.s.inv_w;
  float out[kPlanes];
#pragma unroll 1
  for (int i = 0; i < kRows; ++i) {
    const size_t pix = px.pix[i];
    const int y = px.ty * tile_walk::kTileH + px.row0 + i;
    p.z_out[pix] = bz[i];
    if (bw[i] >= 0) {
      p.id_out[pix] = bw[i] + p.emit_base;
      const float pyr = ((float)y + 0.5f) * p.s.inv_h;
      resolve_pixel(p.res_rec + (size_t)bw[i] * kRes, pxr, pyr, dx, dy, out);
#pragma unroll
      for (int c = 0; c < kPlanes; ++c)
        p.planes_out[c * plane + pix] = out[c];
    } else {
      p.id_out[pix] = iid[i];
      keep_init(p, pix, plane);
    }
  }
}

// This warp's unit as the plain fill renders it (raster.fill_tiles), off
// the fills' domain: from the init, each chunk of cfg.chunk stream
// positions -- the records of a visited tile (walk_region without the
// reject), then the empty slots up to its batch's longest list --
// scores a missed centre or an empty slot -1 (a peeled one too), keeps
// its first maximum per pixel, and commits it where it is strictly
// nearer and no score of the chunk was NaN; then the epilogue.
__device__ __forceinline__ void exact_unit(const Params& p,
                                           tile_walk::Slot& slot, int unit) {
  const tile_walk::Pixels px = tile_walk::region_pixels(p.s, unit);
  const tile_walk::Stream& s = p.s;
  const bool has_peel = p.peel != nullptr;
  const float cx = px.centre_x(s);
  float bz[kRows], cy[kRows], pk[kRows], cz[kRows];
  int bw[kRows], iid[kRows], cw[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    bz[i] = p.init_z ? __ldg(p.init_z + px.pix[i]) : 0.0f;
    iid[i] = p.init_id ? __ldg(p.init_id + px.pix[i]) : -1;
    bw[i] = -1;
    cy[i] = px.centre_y(s, i);
    pk[i] = has_peel ? __ldg(p.peel + px.pix[i]) * p.peel_bound : 0.0f;
  }
  const int c = s.chunk;
  unsigned nan = 0u;          // pixels whose open chunk met a NaN
  int pos = 0;                // stream positions fed
  auto commit = [&]() {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (!((nan >> i) & 1u) && cz[i] > bz[i]) {
        bz[i] = cz[i];
        bw[i] = cw[i];
      }
  };
  // one position: record e (null: an empty slot, id -1)
  auto feed = [&](const float* e, int id) {
    const bool first = pos % c == 0;
    if (first) {
      if (pos > 0) commit();
      nan = 0u;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float d = -1.0f;
      if (e != nullptr) {
        tile_walk::covers(e, cx, cy[i], d);
        if (has_peel && !(d < pk[i])) d = -1.0f;
      }
      if (d != d) nan |= 1u << i;
      if (first || d > cz[i]) {
        cz[i] = d;
        cw[i] = id;
      }
    }
    ++pos;
  };
  if (s.n_chunks[px.tile] > 0)
    tile_walk::walk_region<false>(
        s, px, slot, [&](float (*rec)[kRec], const int* tri, int n) {
          for (int r = 0; r < n; ++r) feed(rec[r], tri[r]);
        });
  // the empty slots: the rest of the open chunk (its first one decides),
  // then whole chunks of them (the first decides for all)
  const int slots = tile_walk::batch_slots(s, px.tile);
  if (pos < slots && pos % c != 0) {
    feed(nullptr, -1);
    pos = (pos + c - 1) / c * c;
  }
  if (pos < slots) {
    feed(nullptr, -1);
    pos = slots;
  }
  if (pos > 0) commit();
  resolve_unit(p, px, bz, bw, iid);
}

__global__ void __launch_bounds__(tile_walk::kWalkThreads)
fill_resolve_kernel(const __grid_constant__ Params p) {
  __shared__ tile_walk::Slot slots[tile_walk::kWalkWarps];
  const tile_walk::Pixels px =
      tile_walk::region_pixels(p.s, tile_walk::region_unit());
  const size_t plane = (size_t)p.hp * p.s.wp;
  const size_t* pix = px.pix;

  float bz[kRows];
  int iid[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    bz[i] = p.init_z ? __ldg(p.init_z + pix[i]) : 0.0f;
    iid[i] = p.init_id ? __ldg(p.init_id + pix[i]) : -1;
  }
  // off the fills' domain (no frame's init is below -1): the exact pass
  const bool low = p.init_z != nullptr && tile_walk::below_floor(bz);
  if (low) {
    if (threadIdx.x % 32 == 0)
      tile_walk::leave_unit(p.exact_list, tile_walk::region_unit());
    return;
  }
  if (p.s.n_chunks[px.tile] == 0) {        // not visited: init stays
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      p.z_out[pix[i]] = bz[i];
      p.id_out[pix[i]] = iid[i];
    }
#pragma unroll 1
    for (int i = 0; i < kRows; ++i) keep_init(p, pix[i], plane);
    return;
  }

  const float cx = px.centre_x(p.s);
  float cy[kRows], pk[kRows];
  int bw[kRows];
  const bool has_peel = p.peel != nullptr;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    cy[i] = px.centre_y(p.s, i);
    pk[i] = has_peel ? __ldg(p.peel + pix[i]) * p.peel_bound : 0.0f;
    bw[i] = -1;
  }
  tile_walk::walk_region<true>(
      p.s, px, slots[threadIdx.x / 32],
      [&](float (*rec)[kRec], const int* tri, int n) {
        raster_batch(rec, tri, n, cx, cy, pk, has_peel, bz, bw);
      });
  resolve_unit(p, px, bz, bw, iid);
}

// The exact pass: the units fill_resolve_kernel left to it, or every
// unit where a warp found a record whose depth may be NaN, walked as the
// plain fill walks them (exact_unit).
__global__ void __launch_bounds__(tile_walk::kWalkThreads)
fill_resolve_exact_kernel(const __grid_constant__ Params p, int units) {
  __shared__ tile_walk::Slot slots[tile_walk::kWalkWarps];
  tile_walk::for_exact_units(p.exact_list, units, [&](int unit) {
    exact_unit(p, slots[threadIdx.x / 32], unit);
  });
}

}  // namespace

extern "C" int fill_resolve_launch(
    const void* tri_rec, const void* res_rec, const void* vals_s,
    const void* offs, const void* counts_eff, const void* n_chunks,
    const void* bighit, const void* big_list, const void* big_box,
    const void* tile_order, const void* tile_len, int big_cap,
    const void* init_z, const void* init_id, const void* init_rec,
    const void* peel, void* z_out, void* id_out, void* planes_out,
    void* exact_list, int n_records, int num_tiles, int tiles_x, int wp,
    int hp, int emit_base, int chunk,
    int tile_batch, float inv_w, float inv_h, float peel_bound,
    void* stream) {
  if (chunk < 1 || tile_batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.s = tile_walk::make_stream(tri_rec, vals_s, offs, counts_eff, n_chunks,
                               bighit, big_list, big_box, tile_order,
                               big_cap, tiles_x, wp, inv_w, inv_h);
  tile_walk::set_chunk_grid(p.s, tile_len, num_tiles, chunk, tile_batch);
  p.res_rec = static_cast<const float*>(res_rec);
  p.init_z = static_cast<const float*>(init_z);
  p.init_id = static_cast<const int*>(init_id);
  p.init_rec = static_cast<const float*>(init_rec);
  p.peel = static_cast<const float*>(peel);
  p.z_out = static_cast<float*>(z_out);
  p.id_out = static_cast<int*>(id_out);
  p.planes_out = static_cast<float*>(planes_out);
  p.exact_list = static_cast<int*>(exact_list);
  const int units = num_tiles * tile_walk::kWarps;
  p.hp = hp;
  p.emit_base = emit_base;
  p.peel_bound = peel_bound;
  const int blocks = tile_walk::walk_blocks(num_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tile_walk::nan_check_kernel<<<tile_walk::kChecks,
                               tile_walk::kCheckThreads, 0, s>>>(
      p.s.tri_rec, n_records, p.exact_list);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_resolve_kernel<<<blocks, tile_walk::kWalkThreads, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  fill_resolve_exact_kernel<<<tile_walk::exact_blocks(num_tiles),
                              tile_walk::kWalkThreads, 0, s>>>(p, units);
  return static_cast<int>(cudaGetLastError());
}
