// Backward LSTM recurrence over pre-projected inputs, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py
// ::_bwd_kernel (driven by _backward and the custom_vjp's _bwd).  Three
// kernels, behind two C launchers:
//
// lstm_bwd_kernel -- the reverse-time sweep.  For each direction it walks the
//   forward recurrence backwards and, per step, recomputes the gates from
//   (xw_t, h_prev), then
//
//     dh     = dh_carry + g_out[t]
//     dc     = dc_carry + dh * o * (1 - tanh(c_t)^2)
//     dgates = (dc*g*i(1-i), dc*c_prev*f(1-f), dc*i*(1-g^2), dh*tanh(c_t)*o(1-o))
//     dxw[t] = dgates,   dh_carry = dgates @ W_hh^T,   dc_carry = dc * f
//
//   The forward direction sweeps t = T-1 .. 0 with h_prev = h[t-1]; the
//   backward (reverse) direction sweeps t = 0 .. T-1 with h_prev = h[t+1].
//   h_prev and c_prev are zero at the step where that direction's forward
//   recurrence began (t = 0 forward, t = T-1 backward).  h and c are read
//   straight from the forward kernel's (B, T, 2H) outputs (csrc/lstm_fwd.cu),
//   the incoming gradient from the (B, T, 2H) gradient of the layer output;
//   no flipped or shifted copies are made.
//
// lstm_dwhh_partial_kernel + lstm_dwhh_reduce_kernel -- dW_hh = sum over
//   (b, t) of h_prev[b, t]^T (x) dxw[b, t] (_bwd_kernel's accumulation at
//   :109-111), a product of depth K = B*T.  On the TPU one core sees every
//   batch row and accumulates dW_hh in one resident output; here the batch
//   is spread over clusters, so dW_hh is a split-K product of its own.
//
// What bounds them.  At the training shapes (B=25, T=417, H=128, both
// directions) the sweep reads xw, h, c and g and writes dxw, about 118 MB
// (35 us at 3.35 TB/s), and does two (B,H)x(H,4H) products a step, 5.5 GFLOP
// of f32 FMA (82 us at 67 TFLOP/s).  It is bound by latency instead: 417
// dependent steps, where only dh_carry = dgates @ W_hh^T and dc link one
// step to the next.  The reduction is 2.7 GFLOP over 54 MB, bound by f32
// FMA (41 us).
//
// The sweep's design.  One thread-block cluster of C CTAs (C = 8 when
// H % 8 == 0, else 4) runs kRows batch rows of one direction.  CTA r owns
// the hidden units [r*u, (r+1)*u), u = H / C, and their 4u gate columns; at
// launch it copies W_hh[:, own columns] (128 x 64 f32, 32 KB at H=128) into
// shared memory, and that slice serves both products of every step, so
// W_hh is never read from global memory or L2 inside the time loop.  Per
// step s (one cluster barrier, split into arrive and wait):
//   A. partial dh of every unit from this CTA's columns of the last step's
//      dgates (local): part[b, k] = sum_{own cols} dg[b, col] W[k, col];
//   -- cluster arrive (release) --
//   B. off the chain, while the barrier completes: the gate partials of
//      step s+1 over k-slices, from h_prev(s+1), which cp.async staged into
//      shared memory a step earlier (the recomputation needs only saved
//      data, never the carry);
//   -- cluster wait (acquire) --
//   C. thread (b, m) sums the C partials of its unit from the peers' shared
//      memory (distributed shared memory, in rank order), adds xw and the
//      gate partials, does the elementwise step, writes dxw and its dgates
//      (for the next A) and keeps dc in a register;
//   -- __syncthreads --
// The dh partials are double-buffered, so one cluster barrier a step is
// enough: a CTA rewrites a buffer only after every peer has arrived at the
// next step's barrier, which each does after reading it.  No atomics: the
// result does not change from run to run.
//
// The reduction's design.  K is cut into fixed slices; block (tile, slice,
// direction) computes a 64 x 64 tile of dW_hh over its slice, 4 x 4 outputs
// a thread, through two cp.async stages of 32 rows of h_prev and dxw.  A
// second kernel of the same launcher sums each output's partials in slice
// order, so the result is deterministic.  The caller allocates the
// partials; the kernels allocate nothing.
//
// bf16.  The element type is a template parameter, instantiated for f32 and
// bf16 (__nv_bfloat16), as the JAX package runs _bwd_kernel in both.  In
// bf16 the kernels compute what _bwd_kernel computes there:
//   - the sweep reads bf16 xw, h, c and g_out and converts each value to
//     f32 when it loads it; W_hh goes into f32 shared memory at launch
//     (exact); the gates are recomputed from the stored, bf16-rounded h_prev
//     and c (:77-79, :154-156), and the dh and dc carries stay f32;
//   - dxw is stored in bf16 (__float2bfloat16_rn, :108), but dh_carry is
//     taken from the unrounded f32 dgates, which stay in shared memory;
//   - dW_hh sums the unrounded f32 dgates (:109-111), not the bf16 dxw: at
//     B=8, T=100, H=32 summing the rounded dxw instead changes ~40 % of the
//     bf16 entries of dW_hh.  The design chosen: in bf16 the sweep also
//     writes its f32 dgates to a (B, T, 4H) buffer of each direction that
//     the caller allocates (2 x 109 MB a layer at B=128, transient), and
//     lstm_dwhh_partial_kernel reads them beside the bf16 h_prev;
//   - lstm_dwhh_reduce_kernel sums the f32 partials in slice order, as in
//     f32, and rounds each entry to bf16 once, at the end (:184); the sum
//     stays deterministic.
// bf16 h rows are staged by 8-byte copies (4 elements, as the 16-byte f32
// copies), which every H % 4 == 0 aligns.  No tensor cores: every product
// is f32 FMA, as _bwd_kernel's f32 accumulation.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;          // batch rows a cluster of the sweep
constexpr int kThreads = 256;     // threads a CTA, sweep and reduction
constexpr int kMaxCluster = 8;    // CTAs a cluster (the portable maximum)
constexpr int kTile = 64;         // dW_hh tile edge of the reduction
constexpr int kDepth = 32;        // rows of K a stage of the reduction
constexpr int kReduceThreads = 256;

static_assert(kRows % 2 == 0, "phase A gives each thread a pair of batch rows");
static_assert(kTile == 16 * 4, "16 x 16 threads of 4 x 4 outputs cover a tile");

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// Element type <-> f32.  from_f32 rounds to nearest even, as astype does.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename Elem>
__device__ __forceinline__ Elem from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// Four consecutive elements (16 bytes of f32, 8 of bf16) as f32.
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f32(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// Four f32 values stored as four consecutive elements.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The codes of the element types at the C interface (ops/cuda/lstm_cell.py).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
// 8 bytes global -> shared, the same way.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
// Four elements, as one copy of 4 * sizeof(Elem) bytes.
template <typename Elem>
__device__ __forceinline__ void cp_async4x(Elem* dst, const Elem* src, bool valid) {
  if constexpr (sizeof(Elem) == 4) {
    cp_async16(dst, src, valid);
  } else {
    cp_async8(dst, src, valid);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of a cluster barrier; every thread of every CTA calls both
// (the forms without .aligned: a warp need not be converged).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Shared memory of a sweep CTA, byte offsets.  The W_hh slice's row stride
// ldw pads the 4u columns so that ldw / 4 is odd: float4 reads by threads of
// consecutive k then fall in distinct banks.
struct BwdLayout {
  int units, ncol, ldw;
  size_t w, h, part, gp, dg, bytes;
  __host__ __device__ BwdLayout(int H, int cluster, int ksplit, int elem_bytes) {
    units = H / cluster;
    ncol = 4 * units;
    ldw = 4 * ((units + 1) | 1);
    w = 0;                                                          // f32 (H, ldw)
    h = w + sizeof(float) * H * ldw;                                // Elem 2 x (kRows, H)
    part = h + (static_cast<size_t>(elem_bytes) * 2 * kRows * H + 15) / 16 * 16;  // f32 2 x (kRows, H)
    gp = part + sizeof(float) * 2 * kRows * H;                      // f32 2 x (ksplit, kRows, 4u)
    dg = gp + sizeof(float) * 2 * ksplit * kRows * ncol;            // f32 (kRows, 4u)
    bytes = dg + sizeof(float) * kRows * ncol;
  }
};

template <typename Elem>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const Elem* xw_fwd, const Elem* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                    const Elem* xw_bwd, const Elem* w_hh_bwd,
                    const Elem* __restrict__ h_seq,  // (B, T, 2H) forward kernel's h
                    const Elem* __restrict__ c_seq,  // (B, T, 2H) forward kernel's c
                    const Elem* __restrict__ g_out,  // (B, T, 2H) gradient of h
                    Elem* dxw_fwd, Elem* dxw_bwd,    // (B, T, 4H)
                    float* dg_fwd, float* dg_bwd,    // (B, T, 4H) f32 dgates, or null
                    int B, int T, int H, int csize, int ksplit) {
  cg::cluster_group cluster = cg::this_cluster();
  const BwdLayout lay(H, csize, ksplit, sizeof(Elem));
  const int units = lay.units, ncol = lay.ncol, ldw = lay.ldw;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem + lay.w);     // W_hh[:, own columns]
  Elem* h_s = reinterpret_cast<Elem*>(smem + lay.h);       // h_prev, by step parity
  float* part_s = reinterpret_cast<float*>(smem + lay.part);  // dh partials, by parity
  float* gp_s = reinterpret_cast<float*>(smem + lay.gp);   // gate partials, by parity
  float* dg_s = reinterpret_cast<float*>(smem + lay.dg);   // last step's dgates

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * units;  // own units [n0, n0 + units); own column lc is
                                // gate lc / units, unit n0 + lc % units
  const bool reverse = blockIdx.y == 1;
  const Elem* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const Elem* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
  Elem* __restrict__ dxw = reverse ? dxw_bwd : dxw_fwd;
  float* __restrict__ dg_out = reverse ? dg_bwd : dg_fwd;
  const int G = 4 * H;
  const int ldh = 2 * H;
  const int off = blockIdx.y * H;  // this direction's half of h, c and g_out
  const int b0 = (blockIdx.x / csize) * kRows;
  const int rows = min(kRows, B - b0);
  const int tid = threadIdx.x;
  const int kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;  // k per gate partial

  // Step s handles time t(s); its forward predecessor is t - 1 (forward) or
  // t + 1 (backward), absent at the end of the range.
  auto time_of = [&](int s) { return reverse ? s : T - 1 - s; };
  auto prev_of = [&](int t) { return reverse ? t + 1 : t - 1; };
  auto in_range = [&](int t) { return t >= 0 && t < T; };

  // h_prev of step s, all H units of the cluster's rows -> h_s[s & 1], four
  // elements a copy.
  constexpr int kVec = 4;
  auto stage_h = [&](int s) {
    Elem* dst = h_s + (s & 1) * kRows * H;
    const int tp = prev_of(time_of(s));
    const int per_row = H / kVec;
    for (int e = tid; e < kRows * per_row; e += kThreads) {
      const int r = e / per_row;
      const int k = (e - r * per_row) * kVec;
      const bool valid = r < rows && in_range(tp);
      const Elem* src = valid ? h_seq + (static_cast<size_t>(b0 + r) * T + tp) * ldh + off + k
                              : h_seq;
      cp_async4x(dst + r * H + k, src, valid);
    }
    cp_async_commit();
  };

  // B: gate partials of step s over k-slice kq for own column lc, all rows.
  auto gate_partials = [&](int s) {
    if (tid < ncol * ksplit) {
      const int lc = tid % ncol;
      const int kq = tid / ncol;
      const int k_end = min(H, (kq + 1) * kspan);
      const Elem* hb = h_s + (s & 1) * kRows * H;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int k = kq * kspan; k < k_end; k += 4) {  // H % 4 == 0 and kspan % 4 == 0
        const float w0 = w_s[k * ldw + lc];
        const float w1 = w_s[(k + 1) * ldw + lc];
        const float w2 = w_s[(k + 2) * ldw + lc];
        const float w3 = w_s[(k + 3) * ldw + lc];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 hv = load4_f32(hb + r * H + k);
          acc[r] = fmaf(hv.x, w0, acc[r]);
          acc[r] = fmaf(hv.y, w1, acc[r]);
          acc[r] = fmaf(hv.z, w2, acc[r]);
          acc[r] = fmaf(hv.w, w3, acc[r]);
        }
      }
      float* gp = gp_s + ((s & 1) * ksplit + kq) * kRows * ncol + lc;
#pragma unroll
      for (int r = 0; r < kRows; ++r) gp[r * ncol] = acc[r];
    }
  };

  // A: partial dh of unit k, rows 2rp and 2rp+1, from own columns.
  auto dh_partials = [&](int s) {
    if (tid < H * (kRows / 2)) {
      const int k = tid % H;
      const int rp = tid / H;
      const float* w_row = w_s + k * ldw;
      const float* d0 = dg_s + 2 * rp * ncol;
      const float* d1 = d0 + ncol;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 4
      for (int lc = 0; lc < ncol; lc += 4) {
        const float4 w = *reinterpret_cast<const float4*>(w_row + lc);
        const float4 x0 = *reinterpret_cast<const float4*>(d0 + lc);
        const float4 x1 = *reinterpret_cast<const float4*>(d1 + lc);
        a0 = fmaf(x0.x, w.x, a0);
        a0 = fmaf(x0.y, w.y, a0);
        a0 = fmaf(x0.z, w.z, a0);
        a0 = fmaf(x0.w, w.w, a0);
        a1 = fmaf(x1.x, w.x, a1);
        a1 = fmaf(x1.y, w.y, a1);
        a1 = fmaf(x1.z, w.z, a1);
        a1 = fmaf(x1.w, w.w, a1);
      }
      float* part = part_s + (s & 1) * kRows * H;
      part[2 * rp * H + k] = a0;
      part[(2 * rp + 1) * H + k] = a1;
    }
  };

  // Set-up: the W_hh slice, zero dgates, h_prev of steps 0 and 1, gates of step 0.
  for (int e = tid; e < H * ncol; e += kThreads) {
    const int k = e / ncol;
    const int lc = e - k * ncol;
    const int q = lc / units;
    w_s[k * ldw + lc] = to_f32(w_hh[static_cast<size_t>(k) * G + q * H + n0 + lc - q * units]);
  }
  for (int e = tid; e < kRows * ncol; e += kThreads) dg_s[e] = 0.0f;
  stage_h(0);
  if (T > 1) stage_h(1);
  cp_async_wait<0>();
  __syncthreads();
  gate_partials(0);
  __syncthreads();

  // Phase C's thread: batch row cr of the cluster, own unit cm (n = n0 + cm).
  const bool c_thread = tid < kRows * units;
  const int cr = c_thread ? tid / units : 0;
  const int cm = tid - cr * units;
  const int cn = n0 + cm;
  const bool c_active = c_thread && cr < rows;
  const size_t c_base = static_cast<size_t>(b0 + cr) * T;
  float dc_carry = 0.0f;

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    const int tp = prev_of(t);
    // Phase C's global inputs, loaded now so they arrive during A and B.
    float c_t = 0.0f, c_prev = 0.0f, g_in = 0.0f, x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c_active) {
      const size_t at = (c_base + t) * ldh + off + cn;
      c_t = to_f32(c_seq[at]);
      g_in = to_f32(g_out[at]);
      if (in_range(tp)) c_prev = to_f32(c_seq[(c_base + tp) * ldh + off + cn]);
      const Elem* xr = xw + (c_base + t) * G + cn;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = to_f32(xr[q * H]);
    }
    if (s + 2 < T) stage_h(s + 2);  // into h_s[s & 1], last read by B of step s - 1

    if (s > 0) dh_partials(s);
    cluster_arrive();
    if (s + 1 < T) gate_partials(s + 1);
    cluster_wait();

    if (c_active) {
      float dh_carry = 0.0f;
      if (s > 0) {
        const float* part = part_s + (s & 1) * kRows * H + cr * H + cn;
        float v[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          v[r] = r < csize ? *cluster.map_shared_rank(part, r) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < csize) dh_carry += v[r];  // rank order
        }
      }
      const float* gp = gp_s + (s & 1) * ksplit * kRows * ncol + cr * ncol + cm;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a = x[q];
        for (int kq = 0; kq < ksplit; ++kq) a += gp[kq * kRows * ncol + q * units];
        pre[q] = a;
      }
      const float gi = sigmoid_f(pre[0]);
      const float gf = sigmoid_f(pre[1]);
      const float gg = tanhf(pre[2]);
      const float go = sigmoid_f(pre[3]);
      const float dh = dh_carry + g_in;
      const float tc = tanhf(c_t);
      const float dc = dc_carry + dh * go * (1.0f - tc * tc);
      const float d[4] = {dc * gg * gi * (1.0f - gi), dc * c_prev * gf * (1.0f - gf),
                          dc * gi * (1.0f - gg * gg), dh * tc * go * (1.0f - go)};
      Elem* out = dxw + (c_base + t) * G + cn;
      float* dg = dg_s + cr * ncol + cm;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q * H] = from_f32<Elem>(d[q]);
        dg[q * units] = d[q];
      }
      if (dg_out != nullptr) {
        float* dgo = dg_out + (c_base + t) * G + cn;
#pragma unroll
        for (int q = 0; q < 4; ++q) dgo[q * H] = d[q];
      }
      dc_carry = dc * gf;
    }
    cp_async_wait<0>();  // h_prev of step s + 2, for B of step s + 1
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while a peer may still read its dh partials
}

// Block (tile, slice, direction): a kTile x kTile tile of dW_hh over the rows
// [slice * rows_per_slice, ..) of K = B*T, into part[direction, slice].  h
// is in the layer's type HElem; the dgates in DElem, f32 in both
// instantiations (in f32 they are dxw itself).
template <typename HElem, typename DElem>
__global__ void __launch_bounds__(kThreads)
    lstm_dwhh_partial_kernel(const HElem* __restrict__ h_seq,                // (B, T, 2H)
                             const DElem* dxw_fwd, const DElem* dxw_bwd,     // (B, T, 4H)
                             float* __restrict__ part,  // (2, slices, H, 4H)
                             int B, int T, int H, int rows_per_slice) {
  __shared__ __align__(16) HElem a_s[2][kDepth][kTile];  // h_prev rows, units i0 ..
  __shared__ __align__(16) DElem b_s[2][kDepth][kTile];  // dgates rows, gate columns j0 ..
  const int G = 4 * H;
  const int ldh = 2 * H;
  const int tiles_j = (G + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / tiles_j) * kTile;
  const int j0 = (blockIdx.x % tiles_j) * kTile;
  const int slice = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const DElem* __restrict__ dxw = reverse ? dxw_bwd : dxw_fwd;
  const int off = blockIdx.z * H;
  const int M = B * T;
  const int m_begin = slice * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  constexpr int kVec = 4;  // elements a copy
  constexpr int kPerRow = kTile / kVec;

  auto load_stage = [&](int st, int m0) {
    for (int e = tid; e < kDepth * kPerRow; e += kThreads) {
      const int k = e / kPerRow;
      const int c = (e - k * kPerRow) * kVec;
      const int m = m0 + k;
      bool va = false, vb = false;
      const HElem* sa = h_seq;
      const DElem* sb = dxw;
      if (m < m_end) {
        const int b = m / T;
        const int t = m - b * T;
        const int tp = reverse ? t + 1 : t - 1;  // h_prev is zero where tp is out of range
        va = i0 + c < H && tp >= 0 && tp < T;
        if (va) sa = h_seq + (static_cast<size_t>(b) * T + tp) * ldh + off + i0 + c;
        vb = j0 + c < G;
        if (vb) sb = dxw + static_cast<size_t>(m) * G + j0 + c;
      }
      cp_async4x(&a_s[st][k][c], sa, va);
      cp_async4x(&b_s[st][k][c], sb, vb);
    }
    cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  const int chunks = (m_end - m_begin + kDepth - 1) / kDepth;
  if (chunks > 0) load_stage(0, m_begin);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load_stage((ch + 1) & 1, m_begin + (ch + 1) * kDepth);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = ch & 1;
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float4 a = load4_f32(&a_s[st][k][ty * 4]);
      const float4 v = load4_f32(&b_s[st][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = part + (static_cast<size_t>(blockIdx.z) * gridDim.y + slice) * H * G;
  const int col = j0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row < H && col < G) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * G + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// dw_{fwd,bwd} = sum over slices, in slice order, of part[direction, slice],
// in f32, rounded to OutElem once at the end; n4 = H * 4H / 4 float4s a
// direction.
template <typename OutElem>
__global__ void __launch_bounds__(kReduceThreads)
    lstm_dwhh_reduce_kernel(const float* __restrict__ part, OutElem* dw_fwd, OutElem* dw_bwd,
                            int slices, int n4) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= 2 * n4) return;
  const int d = e / n4;
  const int i = e - d * n4;
  const float4* p = reinterpret_cast<const float4*>(part) + static_cast<size_t>(d) * slices * n4 + i;
  float4 s = p[0];
  for (int sl = 1; sl < slices; ++sl) {
    const float4 v = p[static_cast<size_t>(sl) * n4];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  store4((d == 0 ? dw_fwd : dw_bwd) + 4 * static_cast<size_t>(i), s);
}

// Bytes of an element of type code `dtype`, 0 for a code the kernels have not.
int elem_bytes(int dtype) {
  return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
}

template <typename Elem>
cudaError_t launch_bwd(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                       const void* w_hh_bwd, const void* h_seq, const void* c_seq,
                       const void* g_out, void* dxw_fwd, void* dxw_bwd, float* dg_fwd,
                       float* dg_bwd, int B, int T, int H, int cluster, int ksplit,
                       cudaStream_t stream) {
  auto kernel = lstm_bwd_kernel<Elem>;
  const size_t smem = BwdLayout(H, cluster, ksplit, sizeof(Elem)).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster * ((B + kRows - 1) / kRows), 2, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const Elem*>(xw_fwd),
                            static_cast<const Elem*>(w_hh_fwd), static_cast<const Elem*>(xw_bwd),
                            static_cast<const Elem*>(w_hh_bwd), static_cast<const Elem*>(h_seq),
                            static_cast<const Elem*>(c_seq), static_cast<const Elem*>(g_out),
                            static_cast<Elem*>(dxw_fwd), static_cast<Elem*>(dxw_bwd), dg_fwd,
                            dg_bwd, B, T, H, cluster, ksplit);
}

template <typename Elem>
cudaError_t launch_dwhh(const void* h_seq, const float* dg_fwd, const float* dg_bwd, float* part,
                        void* dw_fwd, void* dw_bwd, int B, int T, int H, int slices,
                        int rows_per_slice, cudaStream_t stream) {
  const int tiles = ((H + kTile - 1) / kTile) * ((4 * H + kTile - 1) / kTile);
  lstm_dwhh_partial_kernel<Elem, float><<<dim3(tiles, slices, 2), kThreads, 0, stream>>>(
      static_cast<const Elem*>(h_seq), dg_fwd, dg_bwd, part, B, T, H, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n4 = H * H;  // H * 4H / 4
  lstm_dwhh_reduce_kernel<Elem><<<(2 * n4 + kReduceThreads - 1) / kReduceThreads,
                                  kReduceThreads, 0, stream>>>(
      part, static_cast<Elem*>(dw_fwd), static_cast<Elem*>(dw_bwd), slices, n4);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, of one lstm_bwd CTA for elements of
// `elem_bytes` bytes (4: f32, 2: bf16).
extern "C" int lstm_bwd_smem_bytes(int H, int cluster, int ksplit, int elem_bytes) {
  return static_cast<int>(BwdLayout(H, cluster, ksplit, elem_bytes).bytes);
}

// Launches the backward sweep of both directions of a layer on `stream`:
// (xw_fwd, w_hh_fwd) and (xw_bwd, w_hh_bwd) as given to lstm_fwd_launch,
// h_seq and c_seq its (B, T, 2H) outputs, g_out the (B, T, 2H) gradient of
// h_seq; writes dxw_fwd and dxw_bwd (B, T, 4H), and in bf16 the f32 dgates
// into dg_fwd and dg_bwd (B, T, 4H), which lstm_dwhh_launch then sums (null
// in f32, where dxw is the f32 dgates).  `dtype` is the element type of
// every other array (0: f32, 1: bf16).  The grid is (cluster * ceil(B /
// kRows), 2) CTAs of kThreads in clusters of `cluster` along x; ksplit is
// the number of k-slices of the gate partials.  Returns the CUDA error as an
// int (0 = launched).  Pointers are 16-byte aligned device pointers to
// contiguous arrays; the caller checks shapes, H % 4 == 0, 4 <= H <= 128,
// cluster in {4, 8} dividing H, ksplit * 4H / cluster <= kThreads, and B,
// T >= 1.
extern "C" int lstm_bwd_launch(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                               const void* w_hh_bwd, const void* h_seq, const void* c_seq,
                               const void* g_out, void* dxw_fwd, void* dxw_bwd, float* dg_fwd,
                               float* dg_bwd, int B, int T, int H, int cluster, int ksplit,
                               int dtype, void* stream) {
  const bool dgates = dg_fwd != nullptr && dg_bwd != nullptr;
  if (cluster < 1 || cluster > kMaxCluster || H % cluster != 0 || ksplit < 1 ||
      ksplit * 4 * (H / cluster) > kThreads || 2 * H > kThreads || elem_bytes(dtype) == 0 ||
      dgates != (dtype == kBF16) || (!dgates && (dg_fwd != nullptr || dg_bwd != nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32 ? launch_bwd<float>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_seq, c_seq, g_out,
                                        dxw_fwd, dxw_bwd, dg_fwd, dg_bwd, B, T, H, cluster,
                                        ksplit, st)
                    : launch_bwd<__nv_bfloat16>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_seq, c_seq,
                                                g_out, dxw_fwd, dxw_bwd, dg_fwd, dg_bwd, B, T, H,
                                                cluster, ksplit, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches the dW_hh reduction of both directions on `stream`: the partial
// products of `slices` slices of rows_per_slice rows of K = B*T into part
// (2, slices, H, 4H), then their sums in slice order into dw_fwd and dw_bwd
// (H, 4H), from h_seq (B, T, 2H) and the f32 dgates dg_fwd, dg_bwd (B, T,
// 4H).  `dtype` is the element type of h_seq and of dw (0: f32, 1: bf16);
// the dgates and the partials are f32 in both.  Pointers are 16-byte
// aligned; slices * rows_per_slice >= B*T > (slices - 1) * rows_per_slice.
// Returns the CUDA error as an int.
extern "C" int lstm_dwhh_launch(const void* h_seq, const float* dg_fwd, const float* dg_bwd,
                                float* part, void* dw_fwd, void* dw_bwd, int B, int T, int H,
                                int slices, int rows_per_slice, int dtype, void* stream) {
  if (elem_bytes(dtype) == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32 ? launch_dwhh<float>(h_seq, dg_fwd, dg_bwd, part, dw_fwd, dw_bwd, B, T, H,
                                         slices, rows_per_slice, st)
                    : launch_dwhh<__nv_bfloat16>(h_seq, dg_fwd, dg_bwd, part, dw_fwd, dw_bwd, B,
                                                 T, H, slices, rows_per_slice, st);
  return static_cast<int>(err);
}
