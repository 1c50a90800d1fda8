// SBP Gaussian target stamping (K1), CUDA C++ for sm_90a.
//
// Replaces: pytorch_pose_estimation_tpu/ops/pallas/heatmap.py,
//   sbp_heatmaps_pallas (kernel body _heatmap_kernel).
//
// Bound on the card: bytes.  The kernel reads B*K*2 floats of joints and
// writes B*K*H*W floats of heatmaps; the arithmetic per output element is a
// dozen fp32 operations and one expf, far below the H100's fp32 rate, so the
// least time is the output write over the memory rate (B=256, K=17, 64x48:
// 53.5 MB, about 16 us at 3.35 TB/s).
//
// Design: one thread per output element (b, k, y, x), consecutive threads on
// consecutive x, so the only traffic that matters, the output write, is fully
// coalesced.  Each thread reads its joint directly; the 8 bytes per (b, k)
// are shared by the H*W threads of that map and stay in L1/L2.  No shared
// memory and no reduction: nothing carries between threads.
//
// Numerics follow _heatmap_kernel operation for operation: the center is the
// int-truncated coordinate clipped to the map, the window bounds use rintf
// (round half to even, as jnp.round does; roundf would round half away from
// zero and differs whenever 3*sigma+1 is not an integer), and the value is
// expf(-(gx*gx + gy*gy) / (2*sigma^2)).  The sigma-derived constants arrive
// from the host already rounded to float, as the JAX code's Python scalars do.

#include <cuda_runtime.h>

namespace {

__global__ void sbp_heatmaps_kernel(const float* __restrict__ joints,
                                    float* __restrict__ out, long long n,
                                    int h, int w, float three_sigma,
                                    float center_offset, float two_sigma_sq) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int hw = h * w;
  const long long bk = i / hw;
  const int p = (int)(i - bk * hw);
  const float px = (float)(p % w);
  const float py = (float)(p / w);

  const float x = joints[2 * bk];
  const float y = joints[2 * bk + 1];
  const bool valid = (x >= 0.0f) && (y >= 0.0f);
  const float cx = fminf(fmaxf((float)(int)x, 0.0f), (float)(w - 1));
  const float cy = fminf(fmaxf((float)(int)y, 0.0f), (float)(h - 1));

  const float ulx = rintf(cx - three_sigma - 1.0f);
  const float uly = rintf(cy - three_sigma - 1.0f);
  const float brx = rintf(cx + three_sigma + 2.0f);
  const float bry = rintf(cy + three_sigma + 2.0f);
  const bool in_win = (px >= ulx) && (px < brx) && (py >= uly) && (py < bry);

  const float gx = px - ulx - center_offset;
  const float gy = py - uly - center_offset;
  // __fmul_rn keeps nvcc from contracting the sum of squares into an FMA,
  // which would round differently from the plain version's separate ops
  const float d2 = __fmul_rn(gx, gx) + __fmul_rn(gy, gy);
  const float g = expf(-d2 / two_sigma_sq);
  out[i] = (in_win && valid) ? g : 0.0f;
}

}  // namespace

// joints: [B, K, 2] fp32 (x, y) in output-map pixels, negative = invisible.
// out: [B, K, H, W] fp32.  three_sigma = 3*sigma, center_offset =
// 3*sigma + 1, two_sigma_sq = 2*sigma*sigma.  Returns cudaGetLastError().
extern "C" int sbp_heatmaps_launch(const float* joints, float* out, int bk,
                                   int h, int w, float three_sigma,
                                   float center_offset, float two_sigma_sq,
                                   void* stream) {
  const long long n = (long long)bk * h * w;
  if (n > 0) {
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    sbp_heatmaps_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        joints, out, n, h, w, three_sigma, center_offset, two_sigma_sq);
  }
  return (int)cudaGetLastError();
}
