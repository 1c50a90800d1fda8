// Fused SBP heatmap decode (K2), CUDA C++ for sm_90a.
//
// Replaces: pytorch_pose_estimation_tpu/ops/pallas/decode.py,
//   decode_sbp_pallas (kernel body _decode_kernel).
//
// Bound on the card: bytes.  The kernel reads B*K*H*W fp32 logits once and
// writes B*K*3 floats, so the least time is the logit read over the memory
// rate (B=1024, K=17, 64x48: 214 MB, about 64 us at 3.35 TB/s).  At the
// main path's B=64 the 13.4 MB of logits that the head conv has just
// written sit in the 50 MB L2, and launch latency and the sigmoid's
// instructions are most of the time.
//
// What held the first design back: one 256-thread block per map, each
// thread making 12 scalar 4-byte loads in a loop whose every load fed a
// sigmoid and a data-dependent compare before the next was issued, so few
// bytes were in flight; then a serial merge of the 8 warps by one thread.
// It was latency-bound, at under half its byte bound.  Giving each map a
// single warp that loads it all first was slower still: 96 sigmoids per
// lane in sequence, the IEEE division's slow-path branch splitting them
// into separate basic blocks, and at B=64 only 8 warps per SM to hide that.
//
// Design: one block of kWarps warps decodes one (b, k) map, which in the
// port's NCHW layout is one contiguous row of H*W floats.  Each thread first
// issues all its loads for a pass of kPass floats (a 64x48 map is one pass:
// 6 float4 per thread), 16-byte vectors with neighbouring threads on
// neighbouring addresses, read-only and not allocated in L1 since every
// logit is read once; only then does it take the sigmoids and compare.  The
// threads' (value, index) pairs meet in a shuffle reduction in each warp,
// then the kWarps warp results in one shuffle reduction after a single
// __syncthreads.  Maps that do not start on a 16-byte boundary ((H*W) % 4
// != 0, or a view at an odd offset) take the same code with scalar loads.
//
// Semantics, as in _decode_kernel and the plain version: sigmoid first (when
// pred), then the max, then the FIRST row-major index holding it.  The order
// matters: in fp32 the sigmoid saturates to 1.0 above a logit of about 17,
// so pixels that differ as logits tie after it, and the lowest index wins.
// NaN counts as the largest value (as torch.max and jnp.argmax treat it).
// better() encodes that order for any two (value, index) pairs and decides
// every merge between threads.  Inside one thread, elements come in rising
// index order, so better(s, i, bv, bi) with i > bi reduces to later_wins().
// The sigmoid is 1/(1+expf(-x)), the formula of torch's own CUDA sigmoid, so
// the kernel and its plain version on the card see the same values.  A
// strict conf > threshold test decides found; x = (idx % W) * s and
// y = (idx / W) * s with s = input_w / W, else the sentinel (-s, -s, -1).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;  // warps per map; one map per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPass = 3072;  // floats a block loads before comparing

// true when (av, ai) should win over (bv, bi)
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  if (av != bv) return av > bv;
  return ai < bi;
}

// better(s, i, bv, bi) for i > bi: strictly greater, or NaN over a number
__device__ __forceinline__ bool later_wins(float s, float bv) {
  return !(s <= bv) && !isnan(bv);
}

// ld.global.nc.L1::no_allocate: read-only path, no L1 line for data read once
__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void split(float4 v, float* e) {
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}
__device__ __forceinline__ void split(float v, float* e) { e[0] = v; }

// V floats per load: 4 when every map starts 16-byte aligned, else 1.
template <int V>
__global__ void __launch_bounds__(kThreads)
    decode_sbp_kernel(const float* __restrict__ logits,
                      float* __restrict__ out, int hw, int w, float scale,
                      float threshold, int pred) {
  using T = typename std::conditional<V == 4, float4, float>::type;
  constexpr int kLoads = kPass / (kThreads * V);  // per thread per pass
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  const int map = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* row = reinterpret_cast<const T*>(logits + (size_t)map * hw);
  const int n = hw / V;  // loads per map

  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int base = threadIdx.x; base < n; base += kThreads * kLoads) {
    float s[kLoads * V];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = base + kThreads * u;
      T v{};  // zeros past the end of the map, never compared
      if (q < n) v = load_once(row + q);
      split(v, &s[V * u]);
    }
    if (pred) {
#pragma unroll
      for (int k = 0; k < kLoads * V; ++k) {
        s[k] = 1.0f / (1.0f + expf(-s[k]));
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = base + kThreads * u;
      if (q < n) {
#pragma unroll
        for (int t = 0; t < V; ++t) {
          // the thread's first element starts its running best
          const bool first = u == 0 && t == 0 && base == (int)threadIdx.x;
          if (first || later_wins(s[V * u + t], bv)) {
            bv = s[V * u + t];
            bi = V * q + t;
          }
        }
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    warp_v[warp] = bv;
    warp_i[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;
  bv = warp_v[lane % kWarps];
  bi = warp_i[lane % kWarps];
  for (int off = kWarps / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane != 0) return;
  float* o = out + 3 * (size_t)map;
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
  if (bk > 0 && hw > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const bool vec = hw % 4 == 0 && (uintptr_t)logits % 16 == 0;
    if (vec) {
      decode_sbp_kernel<4><<<bk, kThreads, 0, s>>>(logits, out, hw, w, scale,
                                                   threshold, pred);
    } else {
      decode_sbp_kernel<1><<<bk, kThreads, 0, s>>>(logits, out, hw, w, scale,
                                                   threshold, pred);
    }
  }
  return (int)cudaGetLastError();
}
