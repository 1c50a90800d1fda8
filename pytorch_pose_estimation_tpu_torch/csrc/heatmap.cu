// SBP Gaussian target stamping (K1), CUDA C++ for sm_90a.
//
// Replaces: pytorch_pose_estimation_tpu/ops/pallas/heatmap.py,
//   sbp_heatmaps_pallas (kernel body _heatmap_kernel).
//
// Bound on the card: bytes.  The kernel reads B*K*2 floats of joints and
// writes B*K*H*W floats of heatmaps, so the least time is the output write
// over the memory rate (B=1024, K=17, 64x48: 214 MB, about 64 us at
// 3.35 TB/s).  At the main path's B=64 the 13.4 MB output fits in the 50 MB
// L2, and launch latency is most of the time.
//
// What held the first design back: one thread per output element, each
// doing a 64-bit division and a 32-bit divide and modulo by W to find its
// pixel, reloading its joint and recomputing the clip, four rintf and the
// window test, then an expf and an IEEE division, all for a 4-byte store.
// Some 200 instructions per element made it instruction-bound at about a
// quarter of its byte bound, although at sigma=2 the window covers 225 of a
// 64x48 map's 3,072 pixels and the other 93% are plain zeros.
//
// Design: one block of kWarps warps stamps one (b, k) map.  Every thread
// loads the map's 8 bytes of joint and derives, in registers, the valid
// flag, the clipped center and the four window bounds (an empty window when
// the joint is invisible).  The block then writes the map as 16-byte float4
// stores, neighbouring threads on neighbouring addresses, 768 stores per
// 64x48 map, 6 per thread.  Each thread finds the (row, column) of its
// first element with one division and then steps both by loop counters: no
// per-element division or modulo.  Only elements inside the window evaluate
// the exp; the rest store zeros.  Four warps per map rather than one keep
// enough stores in flight at B=64, where there are 1,088 maps for 132 SMs.
// A map starts on a 16-byte boundary only when (H*W) % 4 == 0; otherwise
// the launcher takes the same code with one float per store.
//
// Numerics follow _heatmap_kernel operation for operation: the center is the
// int-truncated coordinate clipped to the map, the window bounds use rintf
// (round half to even, as jnp.round does; roundf would round half away from
// zero and differs whenever 3*sigma+1 is not an integer), and the value is
// expf(-(gx*gx + gy*gy) / (2*sigma^2)).  The sigma-derived constants arrive
// from the host already rounded to float, as the JAX code's Python scalars do.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;  // warps per map; one map per block
constexpr int kThreads = 32 * kWarps;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T make(const float* v) { return v[0]; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T make(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// V floats per store: 4 when every map starts 16-byte aligned, else 1.
template <int V>
__global__ void __launch_bounds__(kThreads)
    sbp_heatmaps_kernel(const float* __restrict__ joints,
                        float* __restrict__ out, int h, int w,
                        float three_sigma, float center_offset,
                        float two_sigma_sq) {
  const int map = blockIdx.x;
  const float x = joints[2 * map];
  const float y = joints[2 * map + 1];
  const bool valid = (x >= 0.0f) && (y >= 0.0f);
  const float cx = fminf(fmaxf((float)(int)x, 0.0f), (float)(w - 1));
  const float cy = fminf(fmaxf((float)(int)y, 0.0f), (float)(h - 1));
  const float ulx = rintf(cx - three_sigma - 1.0f);
  const float uly = rintf(cy - three_sigma - 1.0f);
  // the window as integers (exact: small integral floats); empty if invalid
  const int x0 = (int)ulx, y0 = (int)uly;
  const int x1 = valid ? (int)rintf(cx + three_sigma + 2.0f) : x0;
  const int y1 = valid ? (int)rintf(cy + three_sigma + 2.0f) : y0;

  const int hw = h * w;
  typename Vec<V>::T* dst =
      reinterpret_cast<typename Vec<V>::T*>(out + (size_t)map * hw);
  const int n = hw / V;  // stores per map
  // this thread's first element and the step between its stores, as
  // (row, column): one division each, then loop counters only
  int r = V * (int)threadIdx.x / w;
  int c = V * (int)threadIdx.x - r * w;
  const int dr = kThreads * V / w, dc = kThreads * V - dr * w;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    float v[V];
#pragma unroll
    for (int t = 0; t < V; ++t) v[t] = 0.0f;
    // the V elements lie in rows r .. r+V-1 at most: most stores skip the
    // per-element test
    if (r < y1 && r + V > y0) {
      int rr = r, cc = c;
#pragma unroll
      for (int t = 0; t < V; ++t) {
        if (rr >= y0 && rr < y1 && cc >= x0 && cc < x1) {
          const float gx = (float)cc - ulx - center_offset;
          const float gy = (float)rr - uly - center_offset;
          // __fmul_rn keeps nvcc from contracting the sum of squares into
          // an FMA, which would round differently from the plain version
          const float d2 = __fmul_rn(gx, gx) + __fmul_rn(gy, gy);
          v[t] = expf(-d2 / two_sigma_sq);
        }
        if (++cc == w) {
          cc = 0;
          ++rr;
        }
      }
    }
    dst[q] = Vec<V>::make(v);
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

}  // namespace

// joints: [B, K, 2] fp32 (x, y) in output-map pixels, negative = invisible.
// out: [B, K, H, W] fp32.  three_sigma = 3*sigma, center_offset =
// 3*sigma + 1, two_sigma_sq = 2*sigma*sigma.  Returns cudaGetLastError().
extern "C" int sbp_heatmaps_launch(const float* joints, float* out, int bk,
                                   int h, int w, float three_sigma,
                                   float center_offset, float two_sigma_sq,
                                   void* stream) {
  if (bk > 0 && h > 0 && w > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const bool vec = (h * w) % 4 == 0 && (uintptr_t)out % 16 == 0;
    if (vec) {
      sbp_heatmaps_kernel<4><<<bk, kThreads, 0, s>>>(
          joints, out, h, w, three_sigma, center_offset, two_sigma_sq);
    } else {
      sbp_heatmaps_kernel<1><<<bk, kThreads, 0, s>>>(
          joints, out, h, w, three_sigma, center_offset, two_sigma_sq);
    }
  }
  return (int)cudaGetLastError();
}
