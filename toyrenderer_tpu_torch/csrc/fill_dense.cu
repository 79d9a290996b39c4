// Dense-table visibility fill for Hopper (sm_90a).
//
// Replaces the TPU kernel _fill_kernel (toyrenderer_tpu/ops/
// raster_pallas.py:66, host fill_visibility_pallas :172): for every
// 16x128 screen tile, walk the tile's row of the dense (tiles, K)
// triangle table (its first tile_count entries, in stream order), then
// the big triangles, and keep per pixel the nearest fragment (reverse-Z:
// larger is nearer) and the triangle that wins it, continuing from the
// init planes.  Pixels no fragment wins keep the init planes bit for bit;
// won pixels get the table's triangle id + emit_base.
//
// The TPU host gathers a (tiles, K, 16) record table first (1,020 tiles
// x K = 5,888 x 64 B = 384 MB for the 1080p default view) and streams it
// through VMEM.  Here the records stay (T, 16) and each block reads them
// through its row of the table (the table is 4 B a slot): the row is the
// tile's stretch of a pair stream with stride K, so the walk is
// tile_walk.cuh's, shared with the streamed fills -- one 256-thread block
// per tile, heaviest tiles first, batches of 32 records staged in shared
// memory, the big list filtered by tile bbox (a triangle covers no pixel
// outside its bbox, so the filter changes no pixel).  Each thread keeps
// its 8 pixels' depth and id in registers; each is written once.
//
// The update is strictly-greater in stream order: the TPU kernel's tree
// reduce in groups of 8 keeps the first maximum of a group and the next
// group must be strictly nearer, which picks the same winner.  Built with
// -fmad=false and without fast math, and evaluating edges and depth in
// the plain version's order, so depth and ids are bit-equal to
// raster.fill_visibility on the same inputs.
//
// What bounds it: the (pair, pixel) edge and depth tests -- 20 f32
// operations each, done under -fmad=false as separate multiplies and
// adds -- over every pixel of a tile for each of its pairs.  The design
// keeps everything but the records out of device memory; redesign (a
// warp-level reject of pairs that miss a warp's pixels) is later work.

#include <cuda_runtime.h>

#include "tile_walk.cuh"

namespace {

using tile_walk::kRec;
using tile_walk::kRows;
using tile_walk::kThreads;

struct Params {
  tile_walk::Stream s;
  const float* init_z;       // (Hp, Wp) or null: depth 0
  const int* init_id;        // (Hp, Wp) or null: id -1
  float* z_out;              // (Hp, Wp)
  int* id_out;               // (Hp, Wp)
  int emit_base;
};

__global__ void __launch_bounds__(kThreads)
fill_dense_kernel(Params p) {
  __shared__ tile_walk::Shared sh;
  const tile_walk::Pixels px(p.s);
  float z[kRows];
  int win[kRows];            // the winning table id, -1: none yet
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    z[i] = p.init_z ? p.init_z[px.pix[i]] : 0.0f;
    win[i] = -1;
  }

  const float cx = px.centre_x(p.s);
  float cy[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) cy[i] = px.centre_y(p.s, i);
  tile_walk::walk(p.s, px, sh, [&](float (*rec)[kRec], const int* tri,
                                   int n) {
    for (int r = 0; r < n; ++r) {
      const float* e = rec[r];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float d;
        if (tile_walk::covers(e, cx, cy[i], d) && d > z[i]) {
          z[i] = d;
          win[i] = tri[r];
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    p.z_out[px.pix[i]] = z[i];
    p.id_out[px.pix[i]] = win[i] >= 0 ? win[i] + p.emit_base
                          : (p.init_id ? p.init_id[px.pix[i]] : -1);
  }
}

}  // namespace

extern "C" int fill_dense_launch(
    const void* tri_rec, const void* table, const void* row_start,
    const void* tile_count, const void* bighit, const void* big_list,
    const void* big_box, const void* tile_order, int big_cap,
    const void* init_z, const void* init_id, void* z_out, void* id_out,
    int num_tiles, int tiles_x, int wp, int emit_base, float inv_w,
    float inv_h, void* stream) {
  Params p;
  p.s = tile_walk::make_stream(tri_rec, table, row_start, tile_count,
                               nullptr, bighit, big_list, big_box,
                               tile_order, big_cap, tiles_x, wp, inv_w,
                               inv_h);
  p.init_z = static_cast<const float*>(init_z);
  p.init_id = static_cast<const int*>(init_id);
  p.z_out = static_cast<float*>(z_out);
  p.id_out = static_cast<int*>(id_out);
  p.emit_base = emit_base;
  fill_dense_kernel<<<num_tiles, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
