// Flax's train-mode BatchNorm fused with the activation that follows it,
// forward and backward, over NCHW activations in f32 or bf16
// (ml_audio_inpainting_torch/ops/cuda/batchnorm.py holds the plain version,
// the launch plan and the torch.autograd.Function over these kernels).
//
// It replaces no Pallas kernel: the JAX package leaves BatchNorm to XLA,
// which fuses the statistics, the normalisation and the activation into a
// few passes.  In eager PyTorch the same rule is a chain of f32 ops over
// f32 copies of the activations (about 200 bytes an element forward and
// backward in bf16), so these kernels were added for the training steps.
//
// Bound: bytes.  The function reads x and writes y (forward), reads x and
// dy and writes dx (backward): 4 + 6 bytes an element in bf16.  The design
// reads x twice in the forward (statistics, then apply) and x and dy twice
// in the backward (channel sums, then apply): 16 bytes an element in bf16,
// and nothing else of an element's size touches device memory: the apply
// kernels and the backward's sums recompute x - mean, the normalised value
// and the activation's side of 0 from the saved x and the per-channel
// mean and variance.
//
// Rule (models/cnn_blstm.py::FlaxBatchNorm2d): over (N, H, W) in f32,
// mean = E[x], var_raw = E[x^2] - mean^2, var = max(var_raw, 0);
// y = (x - mean) * (rsqrt(var + eps) * gamma) + beta, each step rounded in
// f32 as PyTorch's eager ops round it (no contraction into FMAs), rounded
// once to x's type; the activation (ReLU for slope 0, LeakyReLU otherwise)
// of that value in f32, rounded again.  The backward is the derivative of
// that graph: g, the activation's backward of dy in x's type (rounded where
// the eager graph rounds it), Sg = sum g, Sgc = sum g (x - mean);
// dbeta = Sg, dgamma = Sgc r with r = rsqrt(var + eps), dvar = -Sgc gamma
// r^3 / 2 (0 where var_raw < 0, clamp_min's backward), dmean = -Sg m -
// 2 mean dvar with m = r gamma, dx = g m + dmean / N + 2 x dvar / N.
//
// Layout: x is (B, C, P) contiguous with P = H * W; each block takes one
// chunk of one (b, c) plane.  Planes start anywhere (P is odd at the
// production shapes, 257 x 417), so a block reads its chunk's unaligned
// head and tail element by element and the rest as 16-byte vectors,
// kUnroll of them in flight a thread.  Channel sums are a two-stage f32
// tree with no float atomics: each block writes its partial sums, and the
// last block of a channel to finish (an integer counter a channel, reset
// by that block) adds the channel's partials in a fixed order.  So the
// results repeat bit for bit from run to run.  Inside a data mesh the
// channel sums go through one all_reduce between the two kernels of each
// pass; the backward's dgamma and dbeta are the rank's own (local) sums.
//
// Launchers return the CUDA error of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte vectors a thread loads before it computes

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float param(const void* p, int is_bf16, int c) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[c])
                 : static_cast<const float*>(p)[c];
}

__device__ __forceinline__ void store_param(void* p, int is_bf16, int c, float v) {
  if (is_bf16) {
    static_cast<bf16*>(p)[c] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[c] = v;
  }
}

// Where a block works: its chunk [lo, hi) of plane (b, c), and its index
// among the channel's B * chunks blocks.
struct Chunk {
  int64_t lo, hi;
  int b, c, slot;
};

__device__ __forceinline__ Chunk chunk_of(int C, int P, int chunks, int chunk) {
  const int64_t plane = blockIdx.x / chunks;
  const int j = blockIdx.x % chunks;
  Chunk k;
  k.b = static_cast<int>(plane / C);
  k.c = static_cast<int>(plane % C);
  k.slot = k.b * chunks + j;
  const int64_t base = plane * P;
  k.lo = base + static_cast<int64_t>(j) * chunk;
  k.hi = min(k.lo + chunk, base + P);
  return k;
}

// f(a, b) for every element i of [lo, hi), a = x[i] and b = dy[i] (b = a
// when kTwo is false); with kOut, out[i] = the value f returns.  The head
// before the first 16-byte boundary and the tail after the last one go
// element by element, the rest as vectors.  Each thread's sequence of
// elements depends on the chunk alone, so sums over it repeat.
template <typename T, bool kTwo, bool kOut, typename F>
__device__ __forceinline__ void visit(const T* __restrict__ a, const T* __restrict__ b,
                                      T* __restrict__ out, int64_t lo, int64_t hi, F&& f) {
  constexpr int N = 16 / sizeof(T);
  const int t = threadIdx.x;
  const int64_t v_begin = (lo + N - 1) / N;              // the first whole vector
  const int64_t v_end = max(v_begin, hi / N);            // past the last one
  const int64_t head_end = min(hi, v_begin * N);         // head [lo, head_end): < N elements
  const int64_t tail_begin = max(head_end, v_end * N);   // tail [tail_begin, hi): < N
  if (lo + t < head_end) {
    const int64_t i = lo + t;
    const T r = f(a[i], kTwo ? b[i] : a[i]);
    if constexpr (kOut) out[i] = r;
  }
  if (tail_begin + t < hi) {
    const int64_t i = tail_begin + t;
    const T r = f(a[i], kTwo ? b[i] : a[i]);
    if constexpr (kOut) out[i] = r;
  }
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  for (int64_t v = v_begin + t; v < v_end; v += static_cast<int64_t>(kThreads) * kUnroll) {
    uint4 ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = v + static_cast<int64_t>(u) * kThreads;
      if (w < v_end) {
        ra[u] = __ldg(av + w);
        if constexpr (kTwo) rb[u] = __ldg(bv + w);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = v + static_cast<int64_t>(u) * kThreads;
      if (w < v_end) {
        union { uint4 v; T e[N]; } ea, eb, eo;
        ea.v = ra[u];
        if constexpr (kTwo) eb.v = rb[u];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const T r = f(ea.e[k], kTwo ? eb.e[k] : ea.e[k]);
          if constexpr (kOut) eo.e[k] = r;
        }
        if constexpr (kOut) reinterpret_cast<uint4*>(out)[w] = eo.v;
      }
    }
  }
}

// The block's sums of a and b, in thread 0 (a fixed tree).
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps], sb[kWarps];
  __syncthreads();  // the arrays may hold an earlier call's values still being read
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) {
    sa[w] = a;
    sb[w] = b;
  }
  __syncthreads();
  if (w == 0) {
    a = l < kWarps ? sa[l] : 0.0f;
    b = l < kWarps ? sb[l] : 0.0f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
  }
}

// Stage two of the channel sums: every block stores its partial pair; the
// channel's last block to arrive adds the channel's `per` pairs in slot
// order and returns true (in every thread), with the sums in thread 0's
// a and b and the counter set back to 0.  The others return false.
__device__ __forceinline__ bool channel_sums(float& a, float& b, float* partial, int* counter,
                                             int c, int slot, int per) {
  __shared__ bool last;
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    float2* mine = reinterpret_cast<float2*>(partial) + static_cast<int64_t>(c) * per + slot;
    *mine = make_float2(a, b);
    __threadfence();
    last = atomicAdd(counter + c, 1) == per - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  const float2* all = reinterpret_cast<const float2*>(partial) + static_cast<int64_t>(c) * per;
  a = 0.0f;
  b = 0.0f;
  for (int i = threadIdx.x; i < per; i += kThreads) {
    const float2 p = __ldcg(all + i);
    a += p.x;
    b += p.y;
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) counter[c] = 0;
  return true;
}

// m = rsqrt(max(var_raw, 0) + eps) * gamma, as the eager ops round it; r too.
__device__ __forceinline__ float scale_of(float var_raw, float eps, float gamma, float* r) {
  const float rs = rsqrtf(__fadd_rn(fmaxf(var_raw, 0.0f), eps));
  *r = rs;
  return __fmul_rn(rs, gamma);
}

// The normalised value rounded to T: (x - mean) * m + beta, each op rounded.
template <typename T>
__device__ __forceinline__ T normalised(float x, float mean, float m, float beta) {
  return from_f<T>(__fadd_rn(__fmul_rn(__fsub_rn(x, mean), m), beta));
}

// The activation of a T value, rounded to T: ReLU for slope 0, LeakyReLU.
template <typename T>
__device__ __forceinline__ T activated(T y, float slope) {
  const float v = to_f(y);
  if (v > 0.0f) return y;
  return slope == 0.0f ? from_f<T>(0.0f) : from_f<T>(__fmul_rn(v, slope));
}

// The activation's backward of dy at its input y, in T: dy where y > 0,
// else 0 (ReLU) or dy * slope rounded (LeakyReLU).
template <typename T>
__device__ __forceinline__ float act_grad(T y, T dy, float slope) {
  if (to_f(y) > 0.0f) return to_f(dy);
  return slope == 0.0f ? 0.0f : to_f(from_f<T>(__fmul_rn(to_f(dy), slope)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_fwd_stats_kernel(
    const T* __restrict__ x, float* __restrict__ partial, float* __restrict__ sums,
    int* __restrict__ counter, int B, int C, int P, int chunks, int chunk) {
  const Chunk k = chunk_of(C, P, chunks, chunk);
  float s = 0.0f, s2 = 0.0f;
  visit<T, false, false>(x, x, nullptr, k.lo, k.hi, [&](T a, T) {
    const float v = to_f(a);
    s += v;
    s2 = fmaf(v, v, s2);
    return a;
  });
  if (channel_sums(s, s2, partial, counter, k.c, k.slot, B * chunks) && threadIdx.x == 0) {
    sums[2 * k.c] = s;
    sums[2 * k.c + 1] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_fwd_apply_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ sums,
    const void* __restrict__ gamma, const void* __restrict__ beta, int param_bf16,
    float* __restrict__ saved, float* __restrict__ run_mean, float* __restrict__ run_var,
    long long* __restrict__ batches, int update, float count, float eps, float keep, float take,
    int act, float slope, int C, int P, int chunks, int chunk) {
  const Chunk k = chunk_of(C, P, chunks, chunk);
  const float mean = __fdiv_rn(sums[2 * k.c], count);
  const float var_raw = __fsub_rn(__fdiv_rn(sums[2 * k.c + 1], count), __fmul_rn(mean, mean));
  float r;
  const float m = scale_of(var_raw, eps, param(gamma, param_bf16, k.c), &r);
  const float be = param(beta, param_bf16, k.c);
  if (k.slot == 0 && threadIdx.x == 0) {
    saved[2 * k.c] = mean;
    saved[2 * k.c + 1] = var_raw;
    if (update) {
      run_mean[k.c] = __fadd_rn(__fmul_rn(run_mean[k.c], keep), __fmul_rn(take, mean));
      run_var[k.c] = __fadd_rn(__fmul_rn(run_var[k.c], keep), __fmul_rn(take, fmaxf(var_raw, 0.0f)));
      if (k.c == 0) *batches += 1;
    }
  }
  if (act) {
    visit<T, false, true>(x, x, y, k.lo, k.hi, [&](T a, T) {
      return activated(normalised<T>(to_f(a), mean, m, be), slope);
    });
  } else {
    visit<T, false, true>(x, x, y, k.lo, k.hi, [&](T a, T) {
      return normalised<T>(to_f(a), mean, m, be);
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_bwd_reduce_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ saved,
    const void* __restrict__ gamma, const void* __restrict__ beta, int param_bf16,
    float* __restrict__ partial, float* __restrict__ sums, int* __restrict__ counter,
    void* __restrict__ dgamma, void* __restrict__ dbeta, float eps, int act, float slope,
    int B, int C, int P, int chunks, int chunk) {
  const Chunk k = chunk_of(C, P, chunks, chunk);
  const float mean = saved[2 * k.c];
  float r;
  const float m = scale_of(saved[2 * k.c + 1], eps, param(gamma, param_bf16, k.c), &r);
  const float be = param(beta, param_bf16, k.c);
  float sg = 0.0f, sgc = 0.0f;
  visit<T, true, false>(x, dy, nullptr, k.lo, k.hi, [&](T a, T d) {
    const float v = to_f(a);
    const float g = act ? act_grad(normalised<T>(v, mean, m, be), d, slope) : to_f(d);
    sg += g;
    sgc = fmaf(g, __fsub_rn(v, mean), sgc);
    return a;
  });
  if (channel_sums(sg, sgc, partial, counter, k.c, k.slot, B * chunks) && threadIdx.x == 0) {
    sums[2 * k.c] = sg;
    sums[2 * k.c + 1] = sgc;
    store_param(dbeta, param_bf16, k.c, sg);
    store_param(dgamma, param_bf16, k.c, __fmul_rn(sgc, r));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ saved,
    const float* __restrict__ sums, const void* __restrict__ gamma,
    const void* __restrict__ beta, int param_bf16, T* __restrict__ dx, float count, float eps,
    int act, float slope, int C, int P, int chunks, int chunk) {
  const Chunk k = chunk_of(C, P, chunks, chunk);
  const float mean = saved[2 * k.c];
  const float var_raw = saved[2 * k.c + 1];
  const float ga = param(gamma, param_bf16, k.c);
  float r;
  const float m = scale_of(var_raw, eps, ga, &r);
  const float be = param(beta, param_bf16, k.c);
  const float sg = sums[2 * k.c], sgc = sums[2 * k.c + 1];
  const float dvar = var_raw >= 0.0f ? -0.5f * sgc * ga * r * r * r : 0.0f;
  const float dmean = -sg * m - 2.0f * mean * dvar;
  const float c0 = dmean / count;         // dx = g m + c0 + x c1
  const float c1 = 2.0f * dvar / count;
  visit<T, true, true>(x, dy, dx, k.lo, k.hi, [&](T a, T d) {
    const float v = to_f(a);
    const float g = act ? act_grad(normalised<T>(v, mean, m, be), d, slope) : to_f(d);
    return from_f<T>(fmaf(v, c1, fmaf(g, m, c0)));
  });
}

int launched(void) { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

int bn_fwd_stats_launch(const void* x, float* partial, float* sums, int* counter, int is_bf16,
                        int B, int C, int P, int chunks, int chunk, void* stream) {
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * C * chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    bn_fwd_stats_kernel<bf16><<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x), partial,
                                                         sums, counter, B, C, P, chunks, chunk);
  } else {
    bn_fwd_stats_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), partial,
                                                          sums, counter, B, C, P, chunks, chunk);
  }
  return launched();
}

int bn_fwd_apply_launch(const void* x, void* y, const float* sums, const void* gamma,
                        const void* beta, int param_bf16, float* saved, float* run_mean,
                        float* run_var, long long* batches, int update, float count, float eps,
                        float keep, float take, int act, float slope, int is_bf16, int B, int C,
                        int P, int chunks, int chunk, void* stream) {
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * C * chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    bn_fwd_apply_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), sums, gamma, beta, param_bf16, saved,
        run_mean, run_var, batches, update, count, eps, keep, take, act, slope, C, P, chunks,
        chunk);
  } else {
    bn_fwd_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), sums, gamma, beta, param_bf16,
        saved, run_mean, run_var, batches, update, count, eps, keep, take, act, slope, C, P,
        chunks, chunk);
  }
  return launched();
}

int bn_bwd_reduce_launch(const void* x, const void* dy, const float* saved, const void* gamma,
                         const void* beta, int param_bf16, float* partial, float* sums,
                         int* counter, void* dgamma, void* dbeta, float eps, int act,
                         float slope, int is_bf16, int B, int C, int P, int chunks, int chunk,
                         void* stream) {
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * C * chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    bn_bwd_reduce_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), saved, gamma, beta,
        param_bf16, partial, sums, counter, dgamma, dbeta, eps, act, slope, B, C, P, chunks,
        chunk);
  } else {
    bn_bwd_reduce_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), saved, gamma, beta,
        param_bf16, partial, sums, counter, dgamma, dbeta, eps, act, slope, B, C, P, chunks,
        chunk);
  }
  return launched();
}

int bn_bwd_apply_launch(const void* x, const void* dy, const float* saved, const float* sums,
                        const void* gamma, const void* beta, int param_bf16, void* dx,
                        float count, float eps, int act, float slope, int is_bf16, int B, int C,
                        int P, int chunks, int chunk, void* stream) {
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * C * chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    bn_bwd_apply_kernel<bf16><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), saved, sums, gamma, beta,
        param_bf16, static_cast<bf16*>(dx), count, eps, act, slope, C, P, chunks, chunk);
  } else {
    bn_bwd_apply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), saved, sums, gamma, beta,
        param_bf16, static_cast<float*>(dx), count, eps, act, slope, C, P, chunks, chunk);
  }
  return launched();
}

}  // extern "C"
