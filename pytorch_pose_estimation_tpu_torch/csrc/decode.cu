// Fused SBP heatmap decode (K2), CUDA C++ for sm_90a.
//
// Replaces: pytorch_pose_estimation_tpu/ops/pallas/decode.py,
//   decode_sbp_pallas (kernel body _decode_kernel).
//
// Bound on the card: bytes.  The kernel reads B*K*H*W fp32 logits once and
// writes B*K*3 floats; per logit it does one sigmoid and one compare, far
// below the fp32 rate, so the least time is the logit read over the memory
// rate (B=256, K=17, 64x48: 53.5 MB, about 16 us at 3.35 TB/s).
//
// Design: one block of 256 threads per (b, k) heatmap, which in the port's
// NCHW layout is one contiguous row of H*W floats.  Threads stride through
// the row so each warp's loads are coalesced, and each keeps its best
// (value, index) pair; the pairs are reduced with warp shuffles and then
// across the 8 warps through shared memory.  Nothing is written but the
// K*3 result, so the only traffic is the one read of the logits.
//
// Semantics, as in _decode_kernel and the plain version: sigmoid first (when
// pred), then the max, then the FIRST row-major index holding it.  The order
// matters: in fp32 the sigmoid saturates to 1.0 above a logit of about 17,
// so pixels that differ as logits tie after it, and the lowest index wins.
// Every comparison keeps the lower index on equal values, so the parallel
// reduction returns the first occurrence whatever order threads finish in.
// NaN counts as the largest value (as torch.max and jnp.argmax treat it).
// The sigmoid is 1/(1+expf(-x)), the formula of torch's own CUDA sigmoid, so
// the kernel and its plain version on the card see the same values.  A
// strict conf > threshold test decides found; x = (idx % W) * s and
// y = (idx / W) * s with s = input_w / W, else the sentinel (-s, -s, -1).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// true when (av, ai) should win over (bv, bi)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  if (av != bv) return av > bv;
  return ai < bi;
}

__global__ void decode_sbp_kernel(const float* __restrict__ logits,
                                  float* __restrict__ out, int hw, int w,
                                  float scale, float threshold, int pred) {
  const float* row = logits + (long long)blockIdx.x * hw;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < hw; i += kThreads) {
    float v = row[i];
    if (pred) v = 1.0f / (1.0f + expf(-v));
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }

  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 1; k < kWarps; ++k) {
    if (better(sv[k], si[k], bv, bi)) {
      bv = sv[k];
      bi = si[k];
    }
  }

  float* o = out + 3LL * blockIdx.x;
  if (bv > threshold) {
    o[0] = (float)(bi % w) * scale;
    o[1] = (float)(bi / w) * scale;
    o[2] = bv;
  } else {
    o[0] = -scale;
    o[1] = -scale;
    o[2] = -1.0f;
  }
}

}  // namespace

// logits: [B, K, H, W] fp32, contiguous; out: [B, K, 3] fp32 (x, y, conf)
// in input pixels.  bk = B*K rows of hw = H*W values.  Returns
// cudaGetLastError().
extern "C" int decode_sbp_launch(const float* logits, float* out, int bk,
                                 int hw, int w, float scale, float threshold,
                                 int pred, void* stream) {
  if (bk > 0) {
    decode_sbp_kernel<<<bk, kThreads, 0, (cudaStream_t)stream>>>(
        logits, out, hw, w, scale, threshold, pred);
  }
  return (int)cudaGetLastError();
}
