// Train-mode BatchNorm + ReLU on bf16 activations (K3), CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves BN to XLA, which fuses it
// with the convolution's epilogue and the ReLU.  Added because the port's
// eager chain around every bf16 convolution, x.float() -> torch's fp32
// batch_norm (a statistics pass, then an apply pass) -> fp32 ReLU ->
// .to(bf16), and its mirror in the backward, moved about 76 bytes an
// activation element and kept two fp32 copies of each activation for the
// backward; on the H100 it was about half of the train step.
//
// Bound on the card: bytes.  The forward reads the bf16 input twice (the
// statistics, then the apply) and writes the bf16 output: 6 B an element.
// The backward reads dy and x twice (the sums, then the apply) and writes
// dx: 10 B an element.  At 3.35 TB/s that is 1.8 ns a million elements
// forward and 3.0 backward; the per-channel work is a few KB.
//
// Numerics.  Statistics, normalisation, ReLU and the parameter gradients
// are fp32; the only roundings to bf16 are the block's output and dx,
// where the unfused chain rounds too.  The variance is never taken as
// E[x^2] - E[x]^2: each thread keeps (count, mean, M2) and merges a
// vector of values at a time into it by Chan's rule (a two-pass mean and
// M2 over the vector, then the pairwise update), and the threads, blocks
// and partials are merged by the same rule, always in the same order, so
// that a run gives the same bits every time.  The forward's
// y = max(x*scale + shift, 0) and the backward's ReLU mask are the same
// fmaf over the same saved per-channel scale and shift, so the mask is
// bit for bit the one the forward applied: the gradient passes where
// x*scale + shift > 0, as torch's threshold_backward passes it where the
// ReLU's output is > 0.
//
// Design.  NCHW: a channel is N planes of HW contiguous elements.  One
// tiling serves the four passes over activations.  A tile is a run of
// one image's row of C*HW elements, one position (8 elements, a 16-byte
// vector; 1 on the scalar path) a thread, so that a thread's channel and
// the channel's scale and shift are fixed for its whole life:
//   - large planes (HW > 2,048 on the vector path, the stem's 49,152 px
//     in SBP and 262,144 in SPM) are cut into equal segments of at most
//     2,048 elements, one segment a tile, every thread in one channel;
//   - small planes (layer5's 48 px in SBP) are walked as whole channels,
//     floor(2,048 / HW) of them a tile, channel = offset / HW, so that a
//     warp still reads 512 contiguous bytes.
// A block takes one tile for a range of images (grid y), which keeps
// enough blocks in flight at any shape; each thread loads four images'
// vectors before it uses any.  The reductions write one partial a
// (channel, segment, image range), contiguous by channel; a one-warp-a-
// channel pass then merges them in a fixed order, finalises the
// statistics (and the running statistics, in place) or the gradient's
// sums, and the apply pass reads its channel's few floats from there.
// The tiling itself is computed on the host (``ops/kernels.py``,
// ``bn_plan``) and arrives as a Plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;    // images whose vectors a thread loads at once
constexpr int kWarpsFin = 8;  // warps (channels) a block of the merge pass

// The host's tiling (bn_plan): n images, c channels, hw pixels a plane;
// cpt channels a tile, segs segments a channel (cpt == 1 when segs > 1),
// seg_len elements a segment (hw when segs == 1); splits image ranges of
// ipb images.  Channel ch's partials are at ch * segs * splits +
// seg * splits + split.
struct Plan {
  int n, c, hw, cpt, segs, seg_len, splits, ipb;
};

// A thread's place: its channel, the offset of its first element inside
// an image's row of c * hw, and whether it has one.
struct Place {
  int ch;
  int seg;
  size_t off;
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(const Plan& p) {
  Place q;
  const int group = blockIdx.x / p.segs;
  q.seg = blockIdx.x % p.segs;
  const int e = (int)threadIdx.x * V;
  const int slot = e / p.seg_len;  // the channel's index inside the tile
  const int in_plane = q.seg * p.seg_len + e % p.seg_len;
  q.ch = group * p.cpt + slot;
  q.active = slot < p.cpt && q.ch < p.c && in_plane < p.hw;
  q.off = (size_t)q.ch * p.hw + in_plane;
  return q;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// V bf16 values in and out: one 16-byte vector, or one value.
template <int V>
struct Pack;
template <>
struct Pack<8> {
  static __device__ __forceinline__ void load(const uint16_t* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_lo(w[i]);
      f[2 * i + 1] = bf16_hi(w[i]);
    }
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = to_bf16(f[2 * i]) | (to_bf16(f[2 * i + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Pack<1> {
  static __device__ __forceinline__ void load(const uint16_t* p, float* f) {
    f[0] = bf16_lo(p[0]);
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float* f) {
    p[0] = (uint16_t)to_bf16(f[0]);
  }
};

// Chan's rule: (na, ma, qa) absorbs (nb, mb, qb); counts, means, M2.
__device__ __forceinline__ void chan(float& na, float& ma, float& qa,
                                     float nb, float mb, float qb) {
  if (nb == 0.0f) return;
  const float n = na + nb;
  const float d = mb - ma;
  const float r = nb / n;
  ma = fmaf(d, r, ma);
  qa = qa + qb + d * d * na * r;
  na = n;
}

__device__ __forceinline__ void chan_warp(float& n, float& m, float& q) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, m, o);
    const float qb = __shfl_xor_sync(0xffffffffu, q, o);
    chan(n, m, q, nb, mb, qb);
  }
}

__device__ __forceinline__ float sum_warp(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// This image range's images [n0, n1) of a thread.
__device__ __forceinline__ void images(const Plan& p, int& n0, int& n1) {
  n0 = blockIdx.y * p.ipb;
  n1 = min(n0 + p.ipb, p.n);
}

// The threads of tile slot k are [k * tps, (k + 1) * tps); warp w of the
// block merges slots w, w + warps, ...; lane 0 writes the slot's channel's
// partial.  R values a thread, in shared memory as R arrays of blockDim.
template <int R, typename Merge, typename Write>
__device__ __forceinline__ void reduce_slots(const Plan& p, int V,
                                             float (*sh)[kMaxThreads],
                                             Merge merge, Write write) {
  __syncthreads();
  const int tps = p.seg_len / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int group = blockIdx.x / p.segs;
  for (int k = warp; k < p.cpt; k += warps) {
    const int ch = group * p.cpt + k;
    if (ch >= p.c) break;
    float acc[R];
    merge(acc, nullptr);  // the empty value
    const int end = min((k + 1) * tps, (int)blockDim.x);
    for (int t = k * tps + lane; t < end; t += 32) {
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = sh[r][t];
      merge(acc, v);
    }
    write(ch, acc, lane);
  }
}

__device__ __forceinline__ size_t part_index(const Plan& p, int ch, int seg) {
  return ((size_t)ch * p.segs + seg) * p.splits + blockIdx.y;
}

// Forward, pass 1: partial (count, mean, M2) of each channel of the tile
// over the block's images.  part: 3 arrays of c * segs * splits.
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_stats_kernel(Plan p, const uint16_t* __restrict__ x,
                    float* __restrict__ part) {
  __shared__ float sh[3][kMaxThreads];
  const Place q = place<V>(p);
  int n0, n1;
  images(p, n0, n1);
  const size_t row = (size_t)p.c * p.hw;
  float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (q.active) {
    const uint16_t* src = x + (size_t)n0 * row + q.off;
    for (int i = n0; i < n1; i += kUnroll) {
      const int m = min(kUnroll, n1 - i);
      float f[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (u < m) Pack<V>::load(src + u * row, f[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u >= m) break;
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) s += f[u][e];
        const float mb = s * (1.0f / V);
        float qb = 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = f[u][e] - mb;
          qb = fmaf(d, d, qb);
        }
        chan(cnt, mean, m2, (float)V, mb, qb);
      }
      src += kUnroll * row;
    }
  }
  sh[0][threadIdx.x] = cnt;
  sh[1][threadIdx.x] = mean;
  sh[2][threadIdx.x] = m2;
  const size_t total = (size_t)p.c * p.segs * p.splits;
  reduce_slots<3>(
      p, V, sh,
      [](float* a, const float* v) {
        if (v == nullptr) {
          a[0] = a[1] = a[2] = 0.0f;
        } else {
          chan(a[0], a[1], a[2], v[0], v[1], v[2]);
        }
      },
      [&](int ch, float* a, int lane) {
        chan_warp(a[0], a[1], a[2]);
        if (lane == 0) {
          const size_t i = part_index(p, ch, q.seg);
          part[i] = a[0];
          part[total + i] = a[1];
          part[2 * total + i] = a[2];
        }
      });
}

// Forward, pass 2: one warp a channel merges its partials in order and
// writes stats (4 arrays of c: mean, invstd, scale = weight * invstd,
// shift = bias - mean * scale), and updates the running statistics as
// flax does: running = (1 - momentum) running + momentum batch, with the
// biased variance.  Channel 0 adds one to num_batches_tracked.
__global__ void __launch_bounds__(32 * kWarpsFin)
    bn_finalize_kernel(int c, int parts, const float* __restrict__ part,
                       const float* __restrict__ weight,
                       const float* __restrict__ bias,
                       float* __restrict__ running_mean,
                       float* __restrict__ running_var,
                       long long* __restrict__ batches,
                       float* __restrict__ stats, float momentum, float eps) {
  const int ch = blockIdx.x * kWarpsFin + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ch >= c) return;
  const size_t total = (size_t)c * parts;
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int i = lane; i < parts; i += 32) {
    const size_t j = (size_t)ch * parts + i;
    chan(n, mean, m2, part[j], part[total + j], part[2 * total + j]);
  }
  chan_warp(n, mean, m2);
  if (lane != 0) return;
  const float var = m2 / n;
  const float invstd = 1.0f / sqrtf(var + eps);
  const float scale = weight[ch] * invstd;
  stats[ch] = mean;
  stats[c + ch] = invstd;
  stats[2 * c + ch] = scale;
  stats[3 * c + ch] = bias[ch] - mean * scale;
  running_mean[ch] = (1.0f - momentum) * running_mean[ch] + momentum * mean;
  running_var[ch] = (1.0f - momentum) * running_var[ch] + momentum * var;
  if (ch == 0) *batches += 1;
}

// Forward, pass 3: y = max(x * scale + shift, 0) (no max without the
// ReLU), rounded to bf16.
template <int V, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
    bn_apply_kernel(Plan p, const uint16_t* __restrict__ x,
                    const float* __restrict__ stats,
                    uint16_t* __restrict__ y) {
  const Place q = place<V>(p);
  if (!q.active) return;
  const float scale = stats[2 * p.c + q.ch], shift = stats[3 * p.c + q.ch];
  int n0, n1;
  images(p, n0, n1);
  const size_t row = (size_t)p.c * p.hw;
  const size_t first = (size_t)n0 * row + q.off;
  for (int i = n0; i < n1; i += kUnroll) {
    const int m = min(kUnroll, n1 - i);
    const size_t at = first + (size_t)(i - n0) * row;
    float f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (u < m) Pack<V>::load(x + at + u * row, f[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u >= m) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = fmaf(f[u][e], scale, shift);
        f[u][e] = kRelu ? (v < 0.0f ? 0.0f : v) : v;
      }
      Pack<V>::store(y + at + u * row, f[u]);
    }
  }
}

// Backward, pass 1: partial sums of g and of g * (x - mean) for each
// channel of the tile, g = dy where x * scale + shift > 0 (everywhere
// without the ReLU), else 0.  part: 2 arrays of c * segs * splits.
template <int V, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
    bn_grad_sums_kernel(Plan p, const uint16_t* __restrict__ dy,
                        const uint16_t* __restrict__ x,
                        const float* __restrict__ stats,
                        float* __restrict__ part) {
  __shared__ float sh[2][kMaxThreads];
  const Place q = place<V>(p);
  float sg = 0.0f, sgx = 0.0f;
  if (q.active) {
    const float mean = stats[q.ch];
    const float scale = stats[2 * p.c + q.ch], shift = stats[3 * p.c + q.ch];
    int n0, n1;
    images(p, n0, n1);
    const size_t row = (size_t)p.c * p.hw;
    const size_t first = (size_t)n0 * row + q.off;
    for (int i = n0; i < n1; i += kUnroll) {
      const int m = min(kUnroll, n1 - i);
      const size_t at = first + (size_t)(i - n0) * row;
      float g[kUnroll][V], f[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u < m) {
          Pack<V>::load(dy + at + u * row, g[u]);
          Pack<V>::load(x + at + u * row, f[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u >= m) break;
        float s = 0.0f, sx = 0.0f;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float ge = g[u][e];
          if (kRelu && !(fmaf(f[u][e], scale, shift) > 0.0f)) ge = 0.0f;
          s += ge;
          sx = fmaf(ge, f[u][e] - mean, sx);
        }
        sg += s;
        sgx += sx;
      }
    }
  }
  sh[0][threadIdx.x] = sg;
  sh[1][threadIdx.x] = sgx;
  const size_t total = (size_t)p.c * p.segs * p.splits;
  reduce_slots<2>(
      p, V, sh,
      [](float* a, const float* v) {
        if (v == nullptr) {
          a[0] = a[1] = 0.0f;
        } else {
          a[0] += v[0];
          a[1] += v[1];
        }
      },
      [&](int ch, float* a, int lane) {
        const float s0 = sum_warp(a[0]), s1 = sum_warp(a[1]);
        if (lane == 0) {
          const size_t i = part_index(p, ch, q.seg);
          part[i] = s0;
          part[total + i] = s1;
        }
      });
}

// Backward, pass 2: one warp a channel sums its partials in order; writes
// dbias = sum g, dweight = sum g * xhat (xhat = (x - mean) * invstd), and
// the apply pass's two means (coef: sum g / count, sum g * xhat / count).
__global__ void __launch_bounds__(32 * kWarpsFin)
    bn_grad_finalize_kernel(int c, int parts, float count,
                            const float* __restrict__ part,
                            const float* __restrict__ stats,
                            float* __restrict__ dweight,
                            float* __restrict__ dbias,
                            float* __restrict__ coef) {
  const int ch = blockIdx.x * kWarpsFin + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (ch >= c) return;
  const size_t total = (size_t)c * parts;
  float sg = 0.0f, sgx = 0.0f;
  for (int i = lane; i < parts; i += 32) {
    const size_t j = (size_t)ch * parts + i;
    sg += part[j];
    sgx += part[total + j];
  }
  sg = sum_warp(sg);
  sgx = sum_warp(sgx);
  if (lane != 0) return;
  const float sgxhat = sgx * stats[c + ch];
  dbias[ch] = sg;
  dweight[ch] = sgxhat;
  coef[ch] = sg / count;
  coef[c + ch] = sgxhat / count;
}

// Backward, pass 3: dx = scale * (g - mean(g) - xhat * mean(g * xhat)),
// rounded to bf16.
template <int V, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
    bn_grad_apply_kernel(Plan p, const uint16_t* __restrict__ dy,
                         const uint16_t* __restrict__ x,
                         const float* __restrict__ stats,
                         const float* __restrict__ coef,
                         uint16_t* __restrict__ dx) {
  const Place q = place<V>(p);
  if (!q.active) return;
  const int c = p.c, ch = q.ch;
  const float mean = stats[ch], invstd = stats[c + ch];
  const float scale = stats[2 * c + ch], shift = stats[3 * c + ch];
  const float mg = coef[ch], mgx = coef[c + ch];
  int n0, n1;
  images(p, n0, n1);
  const size_t row = (size_t)p.c * p.hw;
  const size_t first = (size_t)n0 * row + q.off;
  for (int i = n0; i < n1; i += kUnroll) {
    const int m = min(kUnroll, n1 - i);
    const size_t at = first + (size_t)(i - n0) * row;
    float g[kUnroll][V], f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < m) {
        Pack<V>::load(dy + at + u * row, g[u]);
        Pack<V>::load(x + at + u * row, f[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u >= m) break;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float ge = g[u][e];
        if (kRelu && !(fmaf(f[u][e], scale, shift) > 0.0f)) ge = 0.0f;
        const float xhat = (f[u][e] - mean) * invstd;
        g[u][e] = scale * (ge - mg - xhat * mgx);
      }
      Pack<V>::store(dx + at + u * row, g[u]);
    }
  }
}

Plan read_plan(const int* a) {
  return Plan{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]};
}

}  // namespace

// plan: 10 ints from bn_plan, (n, c, hw, cpt, segs, seg_len, splits, ipb,
// threads, vec): vec = 1 when hw % 8 == 0 and every activation pointer is
// 16-byte aligned.  x, y: [n, c, hw] bf16 (as uint16); weight, bias,
// running_mean, running_var: [c] fp32; batches: the int64
// num_batches_tracked; stats: [4, c] fp32 out (mean, invstd, scale,
// shift); scratch: 3 * c * segs * splits floats.  Returns
// cudaGetLastError().
extern "C" int bn_act_forward_launch(const int* plan, const uint16_t* x,
                                     uint16_t* y, const float* weight,
                                     const float* bias, float* running_mean,
                                     float* running_var, long long* batches,
                                     float* stats, float* scratch, int relu,
                                     float momentum, float eps, void* stream) {
  const Plan p = read_plan(plan);
  const int threads = plan[8], vec = plan[9];
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((p.c + p.cpt - 1) / p.cpt * p.segs, p.splits);
  if (vec) {
    bn_stats_kernel<8><<<grid, threads, 0, s>>>(p, x, scratch);
  } else {
    bn_stats_kernel<1><<<grid, threads, 0, s>>>(p, x, scratch);
  }
  bn_finalize_kernel<<<(p.c + kWarpsFin - 1) / kWarpsFin, 32 * kWarpsFin, 0,
                       s>>>(p.c, p.segs * p.splits, scratch, weight, bias,
                            running_mean, running_var, batches, stats,
                            momentum, eps);
  if (vec && relu) {
    bn_apply_kernel<8, true><<<grid, threads, 0, s>>>(p, x, stats, y);
  } else if (vec) {
    bn_apply_kernel<8, false><<<grid, threads, 0, s>>>(p, x, stats, y);
  } else if (relu) {
    bn_apply_kernel<1, true><<<grid, threads, 0, s>>>(p, x, stats, y);
  } else {
    bn_apply_kernel<1, false><<<grid, threads, 0, s>>>(p, x, stats, y);
  }
  return (int)cudaGetLastError();
}

// dy, x, dx: [n, c, hw] bf16 (as uint16); stats: the forward's [4, c];
// dweight, dbias: [c] fp32 out; scratch: 2 * c * segs * splits + 2 * c
// floats.  Returns cudaGetLastError().
extern "C" int bn_act_backward_launch(const int* plan, const uint16_t* dy,
                                      const uint16_t* x, const float* stats,
                                      uint16_t* dx, float* dweight,
                                      float* dbias, float* scratch, int relu,
                                      void* stream) {
  const Plan p = read_plan(plan);
  const int threads = plan[8], vec = plan[9];
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((p.c + p.cpt - 1) / p.cpt * p.segs, p.splits);
  const int parts = p.segs * p.splits;
  float* coef = scratch + 2 * (size_t)p.c * parts;
  if (vec && relu) {
    bn_grad_sums_kernel<8, true><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                         scratch);
  } else if (vec) {
    bn_grad_sums_kernel<8, false><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                          scratch);
  } else if (relu) {
    bn_grad_sums_kernel<1, true><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                         scratch);
  } else {
    bn_grad_sums_kernel<1, false><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                          scratch);
  }
  const float count = (float)p.n * (float)p.hw;
  bn_grad_finalize_kernel<<<(p.c + kWarpsFin - 1) / kWarpsFin,
                            32 * kWarpsFin, 0, s>>>(
      p.c, parts, count, scratch, stats, dweight, dbias, coef);
  if (vec && relu) {
    bn_grad_apply_kernel<8, true><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                          coef, dx);
  } else if (vec) {
    bn_grad_apply_kernel<8, false><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                           coef, dx);
  } else if (relu) {
    bn_grad_apply_kernel<1, true><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                          coef, dx);
  } else {
    bn_grad_apply_kernel<1, false><<<grid, threads, 0, s>>>(p, dy, x, stats,
                                                           coef, dx);
  }
  return (int)cudaGetLastError();
}
