// The warp walk of the fill kernels: the streamed fills (K1,
// fill_resolve.cu; K2, fill_peel.cu) and the dense-table fill (K7,
// fill_dense.cu, whose table rows it reads as a pair stream of stride K).
//
// The pixels: a 16x128 screen tile is eight 32x8 regions, each one
// warp's; a lane owns 8 pixels of one column of its region.  The plain
// PyTorch versions walk the same tables (raster_cuda.walk_tables,
// raster.fill_dense) and round the pixel centres the same way, which the
// kernels' bit-equality with them relies on.
//
// walk_region: the warp is the unit of work.  The units -- the (tile,
// region) pairs, the tiles heaviest first -- are dealt so that warp w of
// block b takes unit w * B + b of B blocks: the eight regions of the
// densest tile run on eight blocks (eight SMs), not one.  A warp walks
// its tile's pairs, then the big list (each lane testing one entry
// against the tile bbox), by itself: lane r loads
// record r of a batch of up to 32 with 16-byte loads, the next batch's
// records and the batch after's ids in flight while this one runs; each
// lane then tests its record against the region's four corner pixel
// centres (region_rejects, below) and a ballot keeps the rest, which are
// staged in the warp's own 2 KB slot of shared memory in stream order
// and handed to the body.  Only __syncwarp orders the slot: no warp
// waits for another.
//
// The fills' domain, and the exact walk.  The plain fills score a missed
// centre or an empty slot at -1 and take each chunk's first maximum:
// the streamed fills' (raster.fill_tiles, peel_cuda.peel_tiles) over
// each tile's compacted stream -- its pairs, then its big triangles --
// in chunks of `chunk` positions, padded with empty slots to the longest
// list of its batch of `tile_batch` tiles; the dense fill's
// (raster.fill_dense, the reference's XLA fill) over the whole table row
// and then the whole big list.  Neither a skipped record nor a missing
// slot changes a pixel whose init depth (K1, K7) or occluder (K2) is at
// least -1, as every frame's is, and the kernels' fast walks rely on
// that.  A warp whose region holds a pixel below -1 leaves it to the
// launch's exact pass, which walks it on its plain fill's grid: K1 and
// K2 with walk_region<false> (every record in stream order, no reject,
// the position counted, then the batch's empty slots, batch_slots), K7
// slot by slot.  K1's and K7's exact pass takes every region when the
// record check (nan_check_kernel) finds a record whose depth may be NaN
// at a covered pixel: the plain fill's chunk maximum takes a NaN, and
// the whole chunk loses at that pixel.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace tile_walk {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kRows = 8;                            // pixels per lane
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
  const int* tile_order;     // (tiles,) the tiles, heaviest first
  const int* tile_len;       // (tiles,) stream positions (exact walk)
  int num_tiles, chunk, tile_batch;   // the plain fills' chunk grid
  int big_cap;
  int tiles_x, wp;
  float inv_w, inv_h;
};

// This thread's tile and pixels: the tile, its coordinates, the column,
// the first of the thread's rows, and the flat index of each pixel.
struct Pixels {
  int tile, tx, ty, col, row0, x;
  size_t pix[kRows];

  __device__ __forceinline__ Pixels(const Stream& s, int tile_, int col_,
                                    int row0_) {
    tile = tile_;
    tx = tile % s.tiles_x;
    ty = tile / s.tiles_x;
    col = col_;
    row0 = row0_;
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

// Whether raster record e (edges [0:9], depth numerator [9:12],
// denominator [12:15]) covers the pixel centre (x, y) -- all three edge
// functions >= 0 and the denominator > 0 -- and then, in d, its depth
// num / den: each affine function summed ((a * x) + (b * y)) + c, as the
// plain fills do (raster.coverage_depth), which the kernels' bit-equality
// with them relies on under -fmad=false.  A missed centre leaves d.
__device__ __forceinline__ bool covers(const float* e, float x, float y,
                                       float& d) {
  const float l0 = e[0] * x + e[1] * y + e[2];
  const float l1 = e[3] * x + e[4] * y + e[5];
  const float l2 = e[6] * x + e[7] * y + e[8];
  const float num = e[9] * x + e[10] * y + e[11];
  const float den = e[12] * x + e[13] * y + e[14];
  const bool in = l0 >= 0.0f && l1 >= 0.0f && l2 >= 0.0f && den > 0.0f;
  if (in) d = num / den;
  return in;
}

// ---- the warp walk ---------------------------------------------------------

constexpr int kWarps = kTileH * kTileW / (32 * kRows);  // regions a tile
constexpr int kRegionW = kTileW / 4;                // columns per region
static_assert(kWarps == 8 && kRegionW == 32 && 2 * kRows == kTileH,
              "a tile is 4 x 2 regions of 32 x 8 pixels, one per warp");
// Warps per block of the warp walk (raster_cuda.WALK_WARPS).  A block
// holds its registers and shared memory until its slowest warp ends, so
// a heavy unit keeps its block's finished warps' share of the SM idle.
// Of 1, 2, 4 and 8 on an H100, 4 tied 1 on K1's opaque launch and was
// the fastest on K2's sun map (PERF.md, the block-size sweep).
constexpr int kWalkWarps = 4;
constexpr int kWalkThreads = 32 * kWalkWarps;
static_assert(kWarps % kWalkWarps == 0, "a tile's regions fill blocks");

// The warp walk's launch: blocks for num_tiles tiles.
inline int walk_blocks(int num_tiles) {
  return num_tiles * (kWarps / kWalkWarps);
}

// The reject's margin.  Each edge function and the depth denominator is
// affine, f(x, y) = a x + b y + c, and every kernel and plain version
// evaluates it as ((a * x) + (b * y)) + c, each operation rounded once
// (-fmad=false).  With u = 2^-24 and gamma_3 = 3u / (1 - 3u), the rounded
// value differs from the exact one by at most
//     E = gamma_3 (|a| |x| + |b| |y| + |c|)
// (each product meets one rounding and two additions, c two additions;
// Higham, Accuracy and Stability of Numerical Algorithms, 2nd ed., 3.1),
// plus at most 2^-150 for each product that falls below the normal
// range.  Let S = |a| X + |b| Y + |c|, X and Y the largest |x| and |y| of
// the region's pixel centres: then E <= gamma_3 S at every centre.  The
// exact f is affine and the centres are a product grid of rounded
// coordinates, so its exact maximum over them is at one of the four
// corner centres, where the rounded value is at least exact - E.  So if
// the rounded values at all four corners are below -2 gamma_3 S, the
// exact maximum is below -gamma_3 S and the rounded value at every
// centre below 0: the record fails that edge test (l >= 0) at every
// pixel of the region.  For the denominator, at or below -2 gamma_3 S at
// the corners gives at most 0 at every centre, failing den > 0.
//
// In f32 the margin is m = S' kMarginScale + kMarginFloor, S' the rounded
// S (its terms are not negative, so S' >= S (1 - gamma_3)):
// kMarginScale = 3.6e-7 >= 2 gamma_3 / ((1 - gamma_3)(1 - u)) = 3.57628e-7,
// and kMarginFloor = 1e-37 covers the products below the normal range.
// Where S' is above kMarginCap, or not a number, a sum might overflow,
// and the record is kept; a NaN corner value fails every comparison, so
// NaN never rejects.  raster_cuda.region_rejects is the plain version.
constexpr float kMarginScale = 3.6e-7f;
constexpr float kMarginFloor = 1e-37f;
constexpr float kMarginCap = 1e30f;

// A pixel centre, rounded as Pixels::centre_x / centre_y round it.
__device__ __forceinline__ float centre(int t, int size, int c, float inv) {
  return ((float)t * (float)size + ((float)c + 0.5f)) * inv;
}

// A warp's region: its corner pixel centres and their largest magnitudes.
struct Corners {
  float x0, x1, y0, y1, mx, my;
};

// True when (a, b, c) is below -margin at all four corners (kDen: at or
// below).
template <bool kDen>
__device__ __forceinline__ bool below(float a, float b, float c,
                                      const Corners& k) {
  const float s = (fabsf(a) * k.mx + fabsf(b) * k.my) + fabsf(c);
  const float m = -(s * kMarginScale + kMarginFloor);
  const float v00 = a * k.x0 + b * k.y0 + c;
  const float v10 = a * k.x1 + b * k.y0 + c;
  const float v01 = a * k.x0 + b * k.y1 + c;
  const float v11 = a * k.x1 + b * k.y1 + c;
  if (kDen)
    return (s <= kMarginCap) & (v00 <= m) & (v10 <= m) & (v01 <= m)
           & (v11 <= m);
  return (s <= kMarginCap) & (v00 < m) & (v10 < m) & (v01 < m) & (v11 < m);
}

// The record r (edges [0:9], depth numerator [9:12], denominator
// [12:15], id [15]) covers no pixel of the region.
__device__ __forceinline__ bool region_rejects(const float4* r,
                                               const Corners& k) {
  return below<false>(r[0].x, r[0].y, r[0].z, k)
         | below<false>(r[0].w, r[1].x, r[1].y, k)
         | below<false>(r[1].z, r[1].w, r[2].x, k)
         | below<true>(r[3].x, r[3].y, r[3].z, k);
}

// This lane's pixels in the warp walk.  Warp w of block b takes unit
// u = w * gridDim.x + b (region_unit) of the units ordered heaviest tile
// first: tile tile_order[u / 8], region q = u % 8, whose pixels are
// columns 32 (q % 4) .. + 31 and rows 8 (q / 4) .. + 7 of the tile.  The
// launch has walk_blocks(tiles)
// blocks of kWalkWarps warps, so every unit is dealt once, and the blocks
// that start first hold the heaviest units (raster_cuda.dealt_units).
__device__ __forceinline__ int region_unit() {
  return (threadIdx.x / 32) * gridDim.x + blockIdx.x;
}

__device__ __forceinline__ Pixels region_pixels(const Stream& s, int unit) {
  const int lane = threadIdx.x % 32;
  const int q = unit % kWarps;
  return Pixels(s, s.tile_order[unit / kWarps], kRegionW * (q % 4) + lane,
                kRows * (q / 4));
}

// The exact pass's list: [0] the units the walk left to it; then a flag
// for each of kChecks blocks of the record check (K1, K7), 1 where the
// block found a record whose depth may be NaN (every unit then goes to
// the exact pass); then the left units' numbers, in no order.  The check
// writes the head; K2's launch zeroes it.
constexpr int kChecks = kWalkThreads;
constexpr int kListHead = 1 + kChecks;
constexpr int kCheckThreads = 256;

// Leave this warp's unit to the exact pass (lane 0 calls it).
__device__ __forceinline__ void leave_unit(int* list, int unit) {
  list[kListHead + atomicAdd(list, 1)] = unit;
}

// Whether record i's depth numerator or denominator coefficient is not
// a number or above kMarginCap: below it no sum overflows (a pixel
// centre's magnitude is at most 128, the padded grid being less than a
// tile wider and taller than the screen), so no covered pixel's depth is
// NaN.
__device__ __forceinline__ bool maybe_nan(const float* tri_rec, int i) {
  const float4* r = reinterpret_cast<const float4*>(tri_rec) + 4 * i;
  const float4 a = __ldg(r + 2), b = __ldg(r + 3);
  return !(fabsf(a.y) <= kMarginCap && fabsf(a.z) <= kMarginCap
           && fabsf(a.w) <= kMarginCap && fabsf(b.x) <= kMarginCap
           && fabsf(b.y) <= kMarginCap && fabsf(b.z) <= kMarginCap);
}

// The record check, before the walk (K1, K7; kChecks blocks of
// kCheckThreads): block b sets the exact pass's check flag b where its
// share of the n records holds one whose depth may be NaN, and block 0
// zeroes the pass's count.
static __global__ void __launch_bounds__(kCheckThreads)
nan_check_kernel(const float* __restrict__ tri_rec, int n,
                 int* __restrict__ list) {
  bool risky = false;
#pragma unroll 4
  for (int i = blockIdx.x * kCheckThreads + threadIdx.x; i < n;
       i += kChecks * kCheckThreads)
    risky |= maybe_nan(tri_rec, i);
  risky = __syncthreads_or(risky) != 0;
  if (threadIdx.x == 0) {
    list[1 + blockIdx.x] = risky;
    if (blockIdx.x == 0) list[0] = 0;
  }
}

// The exact pass's launch: a block an SM of the H100, each warp taking
// listed units in turn (for_exact_units); a frame's launch has none.
inline int exact_blocks(int num_tiles) {
  const int blocks = walk_blocks(num_tiles);
  return blocks < 132 ? blocks : 132;
}

// body(unit) for each unit of the exact pass's list (every one of the
// `units` where a check flag is set), the warps of the launch taking
// them in turn.  Every thread of the block calls it.
template <class Body>
__device__ __forceinline__ void for_exact_units(const int* list, int units,
                                                Body body) {
  const bool all = __syncthreads_or(__ldg(list + 1 + threadIdx.x)) != 0;
  const int n = all ? units : __ldg(list);
  for (int k = blockIdx.x * kWalkWarps + (int)(threadIdx.x / 32); k < n;
       k += gridDim.x * kWalkWarps)
    body(all ? k : __ldg(list + kListHead + k));
}

// A warp's staging slot: up to 32 kept records in stream order.
struct Slot {
  __align__(16) float rec[kBatch][kRec];
  int tri[kBatch];
};

// One lane's entry of a batch: a triangle id (-1 past the big list's
// end), and whether the region tests it (a pair of the tile's list, or a
// big triangle whose tile bbox holds the tile).
struct Entry {
  int t;
  bool ok;
};

// Walk a visited tile for this warp's region: body(rec, tri, n) for each
// batch's kept records, in stream order -- the tile's own pairs, then the
// big triangles whose tile bbox holds the tile.  kReject: a record
// region_rejects is dropped
// before the body sees it (without it, the body sees every position of
// the tile's stream).  Every lane of the warp calls it; the body runs on
// all of them.
template <bool kReject, class Body>
__device__ __forceinline__ void walk_region(const Stream& s,
                                            const Pixels& px, Slot& slot,
                                            Body body) {
  const int lane = threadIdx.x % 32;
  const int col0 = px.col - lane;
  Corners k;
  k.x0 = centre(px.tx, kTileW, col0, s.inv_w);
  k.x1 = centre(px.tx, kTileW, col0 + kRegionW - 1, s.inv_w);
  k.y0 = centre(px.ty, kTileH, px.row0, s.inv_h);
  k.y1 = centre(px.ty, kTileH, px.row0 + kRows - 1, s.inv_h);
  k.mx = fmaxf(fabsf(k.x0), fabsf(k.x1));
  k.my = fmaxf(fabsf(k.y0), fabsf(k.y1));

  const int first = s.offs[px.tile];
  const int count = s.counts_eff[px.tile];
  const int n_own = (count + kBatch - 1) / kBatch;
  const int n_all = n_own + (s.bighit[px.tile] > 0
                             ? (s.big_cap + kBatch - 1) / kBatch : 0);
  auto entry = [&](int b) {
    Entry e{-1, false};
    if (b < n_own) {
      const int j = b * kBatch + lane;
      if (j < count) {
        e.t = s.vals_s[first + j];
        e.ok = true;
      }
    } else if (b < n_all) {
      const int j = (b - n_own) * kBatch + lane;
      if (j < s.big_cap) {
        e.t = s.big_list[j];
        if (e.t >= 0) {
          const int4 bb = s.big_box[j];
          e.ok = px.tx >= bb.x && px.tx <= bb.y && px.ty >= bb.z
                 && px.ty <= bb.w;
        }
      }
    }
    return e;
  };
  auto fetch = [&](const Entry& e, float4* r) {
    const float4* src = reinterpret_cast<const float4*>(s.tri_rec)
                        + (size_t)(e.ok ? e.t : 0) * (kRec / 4);
#pragma unroll
    for (int i = 0; i < kRec / 4; ++i)
      r[i] = e.ok ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  Entry cur = entry(0), nxt = entry(1);
  float4 next[kRec / 4];
  fetch(cur, next);
  for (int b = 0; b < n_all; ++b) {
    float4 r[kRec / 4];
#pragma unroll
    for (int i = 0; i < kRec / 4; ++i) r[i] = next[i];
    const Entry e = cur;
    const bool ended = b >= n_own && __ballot_sync(0xffffffffu, e.t < 0);
    if (!ended) {        // in flight while this batch runs
      fetch(nxt, next);
      cur = nxt;
      nxt = entry(b + 2);
    }
    const bool keep = e.ok && !(kReject && region_rejects(r, k));
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (m != 0u) {
      if (keep) {
        const int at = __popc(m & ((1u << lane) - 1u));
        float4* dst = reinterpret_cast<float4*>(slot.rec[at]);
#pragma unroll
        for (int i = 0; i < kRec / 4; ++i) dst[i] = r[i];
        slot.tri[at] = e.t;
      }
      __syncwarp();
      body(slot.rec, slot.tri, __popc(m));
      __syncwarp();
    }
    if (ended) break;
  }
}

// The stream positions the plain fills walk for `tile`: the longest
// list of its batch of tile_batch tiles, rounded up to whole chunks
// (tile_len: each tile's pairs and big triangles, 0 unvisited).  Every
// lane of the warp calls it.
__device__ __forceinline__ int batch_slots(const Stream& s, int tile) {
  const int b0 = tile / s.tile_batch * s.tile_batch;
  const int b1 = min(b0 + s.tile_batch, s.num_tiles);
  int m = 0;
  for (int t = b0 + (int)(threadIdx.x % 32); t < b1; t += 32)
    m = max(m, s.tile_len[t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return (m + s.chunk - 1) / s.chunk * s.chunk;
}

// A warp-uniform test: some pixel of this lane's kRows is below -1 (the
// floor of the fills' domain; NaN is not below).
__device__ __forceinline__ bool below_floor(const float* z) {
  bool low = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i) low |= z[i] < -1.0f;
  return __any_sync(0xffffffffu, low);
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
  s.tile_len = nullptr;
  s.num_tiles = 0;
  s.chunk = 1;
  s.tile_batch = 1;
  s.big_cap = big_cap;
  s.tiles_x = tiles_x;
  s.wp = wp;
  s.inv_w = inv_w;
  s.inv_h = inv_h;
  return s;
}

// The exact walk's chunk grid on `s` (the streamed fills' launches).
inline void set_chunk_grid(Stream& s, const void* tile_len, int num_tiles,
                           int chunk, int tile_batch) {
  s.tile_len = static_cast<const int*>(tile_len);
  s.num_tiles = num_tiles;
  s.chunk = chunk;
  s.tile_batch = tile_batch;
}

}  // namespace tile_walk
