// Bounded-displacement bilinear reprojection warp, for Hopper (sm_90a).
//
// Replaces the TPU kernel _warp_kernel
// (toyrenderer_tpu/ops/warp_pallas.py:41): every output pixel p of an
// (H, W, C) f32 image samples the image bilinearly at the previous-frame
// position prev = clip(p - motion[p], 0, dim - 1), with the displacement
// prev - p clipped to +-(max_disp - 1e-3) pixels and taps outside the
// image clamped to its edge.  TAA resamples its history through it at
// full resolution (C = 3), the shadow denoiser at half resolution
// (history and depth, C = 2).
//
// The TPU kernel streams haloed tiles through VMEM and evaluates a
// (2M+1)^2 tent sum, max(1 - |d - k|, 0) per integer tap k, because
// Mosaic has no vector gather.  Only the two taps on each side of the
// displacement have a nonzero weight, so here each thread computes its
// pixel directly: two row taps and two column taps read from device
// memory (neighbouring threads read neighbouring pixels), each channel
// summed as wy0 * (wx0 * a + wx1 * b) + wy1 * (wx0 * c + wx1 * d) -- the
// TPU kernel's order, once its zero-weight taps (which add exact zeros)
// are left out.  Built with -fmad=false, so the result is bit-equal to
// warp_bilinear_plain.
//
// Bound: bytes.  Each pixel reads its motion (8 B) and, from a window
// that stays in L1/L2, its image row once, and writes C floats.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ img, const float2* __restrict__ motion,
            float* __restrict__ out, int h, int w, int c, float lim) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w;
  const int x = i - y * w;
  const float2 m = motion[i];
  const float yg = static_cast<float>(y);
  const float xg = static_cast<float>(x);
  // previous-frame position, edge-clamped, then the displacement clamped
  // to the kernel's reach (warp_pallas.py:67-70)
  const float py = fminf(fmaxf(yg - m.y, 0.0f), static_cast<float>(h - 1));
  const float px = fminf(fmaxf(xg - m.x, 0.0f), static_cast<float>(w - 1));
  const float dyf = fminf(fmaxf(py - yg, -lim), lim);
  const float dxf = fminf(fmaxf(px - xg, -lim), lim);
  const float fy = floorf(dyf);
  const float fx = floorf(dxf);
  // the tent weights of the two nonzero taps, as the TPU kernel forms them
  const float wy0 = fmaxf(1.0f - fabsf(dyf - fy), 0.0f);
  const float wy1 = fmaxf(1.0f - fabsf(dyf - (fy + 1.0f)), 0.0f);
  const float wx0 = fmaxf(1.0f - fabsf(dxf - fx), 0.0f);
  const float wx1 = fmaxf(1.0f - fabsf(dxf - (fx + 1.0f)), 0.0f);
  const int iy = y + static_cast<int>(fy);
  const int ix = x + static_cast<int>(fx);
  const int y0 = min(max(iy, 0), h - 1);
  const int y1 = min(max(iy + 1, 0), h - 1);
  const int x0 = min(max(ix, 0), w - 1);
  const int x1 = min(max(ix + 1, 0), w - 1);
  const float* r00 = img + (static_cast<long long>(y0) * w + x0) * c;
  const float* r01 = img + (static_cast<long long>(y0) * w + x1) * c;
  const float* r10 = img + (static_cast<long long>(y1) * w + x0) * c;
  const float* r11 = img + (static_cast<long long>(y1) * w + x1) * c;
  float* o = out + static_cast<long long>(i) * c;
  for (int ch = 0; ch < c; ++ch) {
    const float top = wx0 * __ldg(r00 + ch) + wx1 * __ldg(r01 + ch);
    const float bot = wx0 * __ldg(r10 + ch) + wx1 * __ldg(r11 + ch);
    o[ch] = wy0 * top + wy1 * bot;
  }
}

}  // namespace

// img (H, W, C) f32, motion (H, W, 2) f32 (x, y), out (H, W, C) f32, all
// contiguous on the device; lim = max_disp - 1e-3 in f32.  Launches on
// `stream`; returns the launch's cudaError_t (0 = queued).
extern "C" int warp_launch(const void* img, const void* motion, void* out,
                           int h, int w, int c, float lim, void* stream) {
  const long long n = static_cast<long long>(h) * w;
  if (n <= 0 || c <= 0) return 0;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  warp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float2*>(motion),
      static_cast<float*>(out), h, w, c, lim);
  return static_cast<int>(cudaGetLastError());
}
