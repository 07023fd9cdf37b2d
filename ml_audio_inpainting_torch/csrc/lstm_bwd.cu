// Backward LSTM recurrence over pre-projected inputs, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py
// ::_bwd_kernel (driven by _backward and the custom_vjp's _bwd), in f32 and
// in bf16, each element type by kernels of its own behind C launchers of its
// own.  Both forms compute, for each direction:
//
// the reverse-time sweep.  It walks the forward recurrence backwards and, per
//   step, recomputes the gates from (xw_t, h_prev), then
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
// the dW_hh sum: sum over (b, t) of h_prev[b, t]^T (x) dgates[b, t]
//   (_bwd_kernel's accumulation at :109-111), a product of depth K = B*T.  On
//   the TPU one core sees every batch row and accumulates dW_hh in one
//   resident output; here the batch is spread over clusters, so dW_hh is a
//   split-K product of its own: fixed slices of K, each summed by its own
//   blocks into a partial, then the partials in slice order
//   (lstm_dwhh_reduce_kernel), so the result does not change from run to run.
//
// Both sweeps run on thread-block clusters.  One cluster of C CTAs (C = 8
// when H % 8 == 0, else 4) runs a group of batch rows of one direction; CTA r
// owns the hidden units [r*u, (r+1)*u), u = H / C, and their 4u gate columns,
// and keeps W_hh[:, own columns] on chip for the whole sweep, so W_hh is never
// read from global memory or L2 inside the time loop.  Per step s (one
// cluster barrier, split into arrive and wait):
//   A. partial dh of every unit from this CTA's columns of the last step's
//      dgates (local): part[b, k] = sum_{own cols} dg[b, col] W[k, col];
//   -- cluster arrive (release) --
//   B. off the chain, while the barrier completes: the gate partials of
//      step s+1 from h_prev(s+1), which cp.async staged into shared memory a
//      step earlier (the recomputation needs only saved data, never the
//      carry);
//   -- cluster wait (acquire) --
//   C. a thread a (batch row, own unit) sums the C partials of its unit from
//      the peers' shared memory (distributed shared memory, in rank order),
//      adds xw and the gate partials, does the elementwise step, writes dxw
//      and its dgates (for the next A) and keeps dc in a register;
//   -- __syncthreads --
// The dh partials are double-buffered, so one cluster barrier a step is
// enough: a CTA rewrites a buffer only after every peer has arrived at the
// next step's barrier, which each does after reading it.  No atomics.
//
// f32: lstm_bwd_kernel (kRows = 4 batch rows a cluster; W_hh's slice
// in f32 shared memory; both products in f32 FMA, a thread a (column,
// k-slice) in B and a (unit, pair of rows) in A), and the split-K sum
// lstm_dwhh_partial_kernel (64 x 64 tiles, 4 x 4 outputs a
// thread, f32 FMA) + lstm_dwhh_reduce_kernel<float>.  At the training shapes
// (B=25, T=417, H=128, both directions) the sweep moves ~118 MB (35 us at
// 3.35 TB/s) and does 5.5 GFLOP of f32 FMA (82 us at 67 TFLOP/s); it is bound
// by latency instead: 417 dependent steps.  The sum is 2.7 GFLOP over 54 MB,
// bound by f32 FMA (41 us).
//
// bf16: lstm_bwd_mma_kernel<Rows, Tiles> and lstm_dwhh_mma_kernel<Vec> +
// lstm_dwhh_reduce_kernel<bf16>, which run every product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators), as _bwd_kernel runs
// bf16: h, c, xw and W_hh are bf16 values, the gates and the dh and dc
// carries f32, dxw is stored in bf16 (__float2bfloat16_rn, :108), and dW_hh
// is summed in f32 and rounded to bf16 once, at the end (:184).
//   - The sweep: Rows (8 or 16, by the batch: one wave of CTAs) batch rows a
//     cluster, the n8 side of both products; the CTA's gate columns (gate
//     product) and the H units (dh product) the m16 side.  Each warp keeps
//     its A fragments of W_hh in registers from launch on (2 x 16 KB a CTA
//     at H=128).  The gate product is exact as it is: h_prev and W_hh are
//     bf16.  The dh product takes the f32 dgates as kPieces bf16 pieces (p0 =
//     bf16(d), p1 = bf16(d - p0), ...): with one piece (d rounded) dxw
//     equals Pallas's on ~74 % of the entries at B=8, T=100, H=32, with
//     three on 99.98 %, as close as an f32 product
//     (tests/test_torch_bf16_lstm.py).  It writes dxw = p0 and the residual
//     lo = p1, bf16 both.  At B=128 it moves ~410 MB (122 us) and issues
//     56 GFLOP of tensor-core products (57 us at 989 TFLOP/s); still 417
//     dependent steps.
//   - The sum: dW_hh = h_prev^T dxw + h_prev^T lo, depth 2*B*T, the f32
//     dgates to 16 bits: summing dxw alone misses Pallas's dW_hh on ~41 % of
//     the entries, (dxw, lo) meets it on 99.7 %.  128 x 128 tiles over
//     fixed slices of K, three cp.async stages of (h_prev, dxw, lo) rows,
//     ldmatrix.trans fragments.  At B=128 it reads ~245 MB (73 us at 3.35
//     TB/s) for 28 GFLOP (28 us): bound by bytes.  Reading a bf16 pair in
//     place of f32 dgates halves the sweep's extra output (2 x 55 MB a layer
//     at B=128, transient) and lets the sum run on the tensor cores.
//   - Its step issues every global access after the barrier's arrive: the
//     next step's h_prev (cp.async), c, g and xw, and the last step's dxw
//     and lo.  An arrive.release waits for the CTA's earlier memory
//     operations, so accesses issued just before it stand on the chain.
// h rows are staged by 16-byte copies where 8 divides H (8-byte ones else),
// which every H % 4 == 0 aligns.

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

// Four consecutive f32 elements.
__device__ __forceinline__ float4 load4_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// Four f32 values stored as four consecutive elements (f32, or bf16 rounded
// to nearest even, as astype does).
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
  __host__ __device__ BwdLayout(int H, int cluster, int ksplit) {
    units = H / cluster;
    ncol = 4 * units;
    ldw = 4 * ((units + 1) | 1);
    w = 0;                                                          // f32 (H, ldw)
    h = w + sizeof(float) * H * ldw;                                // f32 2 x (kRows, H)
    part = h + sizeof(float) * 2 * kRows * H;                       // f32 2 x (kRows, H)
    gp = part + sizeof(float) * 2 * kRows * H;                      // f32 2 x (ksplit, kRows, 4u)
    dg = gp + sizeof(float) * 2 * ksplit * kRows * ncol;            // f32 (kRows, 4u)
    bytes = dg + sizeof(float) * kRows * ncol;
  }
};

__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const float* xw_fwd, const float* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                    const float* xw_bwd, const float* w_hh_bwd,
                    const float* __restrict__ h_seq,  // (B, T, 2H) forward kernel's h
                    const float* __restrict__ c_seq,  // (B, T, 2H) forward kernel's c
                    const float* __restrict__ g_out,  // (B, T, 2H) gradient of h
                    float* dxw_fwd, float* dxw_bwd,   // (B, T, 4H)
                    int B, int T, int H, int csize, int ksplit) {
  cg::cluster_group cluster = cg::this_cluster();
  const BwdLayout lay(H, csize, ksplit);
  const int units = lay.units, ncol = lay.ncol, ldw = lay.ldw;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem + lay.w);     // W_hh[:, own columns]
  float* h_s = reinterpret_cast<float*>(smem + lay.h);       // h_prev, by step parity
  float* part_s = reinterpret_cast<float*>(smem + lay.part);  // dh partials, by parity
  float* gp_s = reinterpret_cast<float*>(smem + lay.gp);   // gate partials, by parity
  float* dg_s = reinterpret_cast<float*>(smem + lay.dg);   // last step's dgates

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * units;  // own units [n0, n0 + units); own column lc is
                                // gate lc / units, unit n0 + lc % units
  const bool reverse = blockIdx.y == 1;
  const float* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const float* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
  float* __restrict__ dxw = reverse ? dxw_bwd : dxw_fwd;
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
    float* dst = h_s + (s & 1) * kRows * H;
    const int tp = prev_of(time_of(s));
    const int per_row = H / kVec;
    for (int e = tid; e < kRows * per_row; e += kThreads) {
      const int r = e / per_row;
      const int k = (e - r * per_row) * kVec;
      const bool valid = r < rows && in_range(tp);
      const float* src = valid ? h_seq + (static_cast<size_t>(b0 + r) * T + tp) * ldh + off + k
                              : h_seq;
      cp_async16(dst + r * H + k, src, valid);
    }
    cp_async_commit();
  };

  // B: gate partials of step s over k-slice kq for own column lc, all rows.
  auto gate_partials = [&](int s) {
    if (tid < ncol * ksplit) {
      const int lc = tid % ncol;
      const int kq = tid / ncol;
      const int k_end = min(H, (kq + 1) * kspan);
      const float* hb = h_s + (s & 1) * kRows * H;
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
    w_s[k * ldw + lc] = w_hh[static_cast<size_t>(k) * G + q * H + n0 + lc - q * units];
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
      c_t = c_seq[at];
      g_in = g_out[at];
      if (in_range(tp)) c_prev = c_seq[(c_base + tp) * ldh + off + cn];
      const float* xr = xw + (c_base + t) * G + cn;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = xr[q * H];
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
      float* out = dxw + (c_base + t) * G + cn;
      float* dg = dg_s + cr * ncol + cm;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q * H] = d[q];
        dg[q * units] = d[q];
      }
      dc_carry = dc * gf;
    }
    cp_async_wait<0>();  // h_prev of step s + 2, for B of step s + 1
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while a peer may still read its dh partials
}

// Block (tile, slice, direction): a kTile x kTile tile of dW_hh over the rows
// [slice * rows_per_slice, ..) of K = B*T, into part[direction, slice].
__global__ void __launch_bounds__(kThreads)
    lstm_dwhh_partial_kernel(const float* __restrict__ h_seq,             // (B, T, 2H)
                             const float* dxw_fwd, const float* dxw_bwd,  // (B, T, 4H)
                             float* __restrict__ part,  // (2, slices, H, 4H)
                             int B, int T, int H, int rows_per_slice) {
  __shared__ __align__(16) float a_s[2][kDepth][kTile];  // h_prev rows, units i0 ..
  __shared__ __align__(16) float b_s[2][kDepth][kTile];  // dgates rows, gate columns j0 ..
  const int G = 4 * H;
  const int ldh = 2 * H;
  const int tiles_j = (G + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / tiles_j) * kTile;
  const int j0 = (blockIdx.x % tiles_j) * kTile;
  const int slice = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const float* __restrict__ dxw = reverse ? dxw_bwd : dxw_fwd;
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
      const float* sa = h_seq;
      const float* sb = dxw;
      if (m < m_end) {
        const int b = m / T;
        const int t = m - b * T;
        const int tp = reverse ? t + 1 : t - 1;  // h_prev is zero where tp is out of range
        va = i0 + c < H && tp >= 0 && tp < T;
        if (va) sa = h_seq + (static_cast<size_t>(b) * T + tp) * ldh + off + i0 + c;
        vb = j0 + c < G;
        if (vb) sb = dxw + static_cast<size_t>(m) * G + j0 + c;
      }
      cp_async16(&a_s[st][k][c], sa, va);
      cp_async16(&b_s[st][k][c], sb, vb);
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

// ------------------------------------------------------------------ bf16 forms
//
// The tensor cores' m16n8k16 product, bf16 operands, f32 accumulators.  Lane
// l = 4 g + tq of a warp holds, two bf16 a register (the lower index in the
// low half):
//   a = {A[g][2tq..+1], A[g+8][2tq..+1], A[g][2tq+8..+9], A[g+8][2tq+8..+9]},
//   b = {B[2tq..+1][g], B[2tq+8..+9][g]},
//   d = {D[g][2tq], D[g][2tq+1], D[g+8][2tq], D[g+8][2tq+1]}.
using bf16 = __nv_bfloat16;

constexpr int kPieces = 3;     // bf16 pieces of the f32 dgates in the sweep's dh product
constexpr int kMaxUnits = 32;  // H / cluster at most (H <= 128, cluster >= 4)
constexpr int kWarps = kThreads / 32;
constexpr int kDwTile = 128;   // dW_hh tile edge of the bf16 sum (all of H <= 128)
constexpr int kDwDepth = 32;   // rows of K a stage of the bf16 sum
constexpr int kDwStages = 3;   // cp.async stages of the bf16 sum
constexpr int kDwLd = kDwTile + 8;  // row stride of its tiles: ldmatrix rows in distinct banks
constexpr int kDwSmem = 2 * kDwStages * 3 * kDwDepth * kDwLd;  // bytes: (h_prev, dxw, lo) a stage

static_assert(kPieces >= 2, "the second piece is the residual lo that the dW_hh sum reads");
static_assert(kWarps * 16 >= 128, "a warp a 16-unit tile of the dh product");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of matrix i, rows 2tq
// and 2tq+1 of column g in register i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// Vec bf16 elements (16 or 8 bytes) global -> shared, zero-filled when !valid.
template <int Vec>
__device__ __forceinline__ void cp_async_vec(bf16* dst, const bf16* src, bool valid) {
  if constexpr (Vec == 8) {
    cp_async16(dst, src, valid);
  } else {
    cp_async8(dst, src, valid);
  }
}

// Shared memory of a bf16 sweep CTA, byte offsets.  kh = ceil(H / 16) tiles
// of the inputs (gate product) and of the units (dh product); kc = ceil(4u /
// 16) tiles of the own gate columns; the gate product's k-tiles are cut into
// ksplit slices of `span` tiles, a warp each.  Row strides are padded so that
// a warp's fragment loads and stores fall in distinct banks; the padding
// columns of h and of the pieces stay zero.
struct MmaLayout {
  int units, ncol, kh, kc, span, tiles, ldh, ldd, ldp, ldg;
  size_t h, dg, part, gp, bytes;
  __host__ __device__ MmaLayout(int H, int rows, int cluster, int ksplit) {
    units = H / cluster;
    ncol = 4 * units;
    kh = (H + 15) / 16;
    kc = (ncol + 15) / 16;
    span = (kh + ksplit - 1) / ksplit;
    tiles = span > kc ? span : kc;  // A fragments a warp keeps of either product
    ldh = 16 * kh + 8;              // bf16
    ldd = 16 * kc + 8;              // bf16
    ldp = 16 * kh + 4;              // f32
    ldg = 16 * kc + 4;              // f32
    h = 0;                                            // bf16 2 x (rows, ldh): h_prev by parity
    dg = h + sizeof(bf16) * 2 * rows * ldh;           // bf16 kPieces x (rows, ldd): dgates
    part = dg + sizeof(bf16) * kPieces * rows * ldd;  // f32 2 x (rows, ldp): dh partials
    gp = part + sizeof(float) * 2 * rows * ldp;       // f32 2 x (ksplit, rows, ldg): gates
    bytes = gp + sizeof(float) * 2 * ksplit * rows * ldg;
  }
};

// The bf16 sweep.  The cluster, the ownership of units and columns, the
// double-buffered dh partials and the one split cluster barrier a step are
// lstm_bwd_kernel's; the two products run on the tensor cores, with the
// batch rows as the n8 side (Rows / 8 tiles) and the CTA's gate columns or
// H units as the m16 side.  Each warp loads its A fragments of W_hh once, at
// launch, into registers (Tiles a product; zero outside H x 4u):
//   gate product (B, off the chain): warp w owns column tile w % kc and
//     k-slice w / kc, gp[slice][row][col] = sum_k h_prev[row][k] W[k][col];
//   dh product (A, on the chain): warp w owns unit tile w,
//     part[row][k] = sum_p sum_{own col} piece_p[row][col] W[k][col],
//     a separate accumulator a piece, summed from the last piece up.
// Phase C splits each f32 dgate d into kPieces bf16 pieces (p0 = bf16(d),
// p1 = bf16(d - p0), ...), keeps them in shared memory as the next step's B
// operand, and stores p0 as dxw and p1 as lo.
template <int Rows, int Tiles>
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_mma_kernel(const bf16* xw_fwd, const bf16* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                        const bf16* xw_bwd, const bf16* w_hh_bwd,
                        const bf16* __restrict__ h_seq,  // (B, T, 2H) forward kernel's h
                        const bf16* __restrict__ c_seq,  // (B, T, 2H) forward kernel's c
                        const bf16* __restrict__ g_out,  // (B, T, 2H) gradient of h
                        bf16* dxw_fwd, bf16* dxw_bwd,    // (B, T, 4H): bf16(dgates)
                        bf16* lo_fwd, bf16* lo_bwd,      // (B, T, 4H): bf16(dgates - dxw)
                        int B, int T, int H, int csize, int ksplit) {
  constexpr int kN = Rows / 8;  // n8 tiles
  // Phase C's items a thread: Rows x units, units <= 4 Tiles (kc <= Tiles).
  constexpr int kCPer = (Rows * 4 * Tiles + kThreads - 1) / kThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const MmaLayout lay(H, Rows, csize, ksplit);
  const int units = lay.units, ncol = lay.ncol, kh = lay.kh, kc = lay.kc, span = lay.span;
  const int ldh = lay.ldh, ldd = lay.ldd, ldp = lay.ldp, ldg = lay.ldg;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* h_s = reinterpret_cast<bf16*>(smem + lay.h);
  bf16* dg_s = reinterpret_cast<bf16*>(smem + lay.dg);
  float* part_s = reinterpret_cast<float*>(smem + lay.part);
  float* gp_s = reinterpret_cast<float*>(smem + lay.gp);

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * units;
  const bool reverse = blockIdx.y == 1;
  const bf16* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const bf16* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
  bf16* __restrict__ dxw = reverse ? dxw_bwd : dxw_fwd;
  bf16* __restrict__ lo_out = reverse ? lo_bwd : lo_fwd;
  const int G = 4 * H;
  const int ld_seq = 2 * H;
  const int off = blockIdx.y * H;
  const int b0 = (blockIdx.x / csize) * Rows;
  const int rows = min(Rows, B - b0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4, tq = tid % 4;

  auto time_of = [&](int s) { return reverse ? s : T - 1 - s; };
  auto prev_of = [&](int t) { return reverse ? t + 1 : t - 1; };
  auto in_range = [&](int t) { return t >= 0 && t < T; };

  // W_hh[k, own column lc], zero outside H x 4u.
  auto w_at = [&](int k, int lc) -> bf16 {
    if (k >= H || lc >= ncol) return __ushort_as_bfloat16(0);
    const int q = lc / units;
    return w_hh[static_cast<size_t>(k) * G + q * H + n0 + lc - q * units];
  };
  const int gq = warp / kc, gm = warp - gq * kc;  // gate product: k-slice, column tile
  const bool g_warp = gq < ksplit;
  const bool d_warp = warp < kh;  // dh product: unit tile `warp`
  uint32_t ag[Tiles][4], ad[Tiles][4];
#pragma unroll
  for (int i = 0; i < Tiles; ++i) {
    const int kt = gq * span + i;
    const bool gv = g_warp && i < span && kt < kh;
    const int m = gm * 16 + g, k = kt * 16 + 2 * tq;
    ag[i][0] = gv ? pack_bf16(w_at(k, m), w_at(k + 1, m)) : 0u;
    ag[i][1] = gv ? pack_bf16(w_at(k, m + 8), w_at(k + 1, m + 8)) : 0u;
    ag[i][2] = gv ? pack_bf16(w_at(k + 8, m), w_at(k + 9, m)) : 0u;
    ag[i][3] = gv ? pack_bf16(w_at(k + 8, m + 8), w_at(k + 9, m + 8)) : 0u;
    const bool dv = d_warp && i < kc;
    const int u = warp * 16 + g, c = i * 16 + 2 * tq;
    ad[i][0] = dv ? pack_bf16(w_at(u, c), w_at(u, c + 1)) : 0u;
    ad[i][1] = dv ? pack_bf16(w_at(u + 8, c), w_at(u + 8, c + 1)) : 0u;
    ad[i][2] = dv ? pack_bf16(w_at(u, c + 8), w_at(u, c + 9)) : 0u;
    ad[i][3] = dv ? pack_bf16(w_at(u + 8, c + 8), w_at(u + 8, c + 9)) : 0u;
  }

  // h_prev of step s, all H units of the cluster's rows -> h_s[s & 1]:
  // 16-byte copies where 8 divides H (this direction's half of a row then
  // starts on 16 bytes), else 8-byte ones.
  const int vec = H % 8 == 0 ? 8 : 4;
  auto stage = [&](int s) {
    bf16* dst = h_s + (s & 1) * Rows * ldh;
    const int tp = prev_of(time_of(s));
    const int per_row = H / vec;
    for (int e = tid; e < Rows * per_row; e += kThreads) {
      const int r = e / per_row;
      const int k = (e - r * per_row) * vec;
      const bool valid = r < rows && in_range(tp);
      const bf16* src =
          valid ? h_seq + (static_cast<size_t>(b0 + r) * T + tp) * ld_seq + off + k : h_seq;
      if (vec == 8) {
        cp_async16(dst + r * ldh + k, src, valid);
      } else {
        cp_async8(dst + r * ldh + k, src, valid);
      }
    }
    cp_async_commit();
  };

  // B: the gate partials of step s from h_s[s & 1] -> gp_s[s & 1][gq].
  auto gate_mma = [&](int s) {
    if (!g_warp) return;
    const bf16* hb = h_s + (s & 1) * Rows * ldh + g * ldh + 2 * tq;
    float acc[kN][4];
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int i = 0; i < Tiles; ++i) {
      const int kt = gq * span + i;
      if (i < span && kt < kh) {
#pragma unroll
        for (int nt = 0; nt < kN; ++nt) {
          const bf16* p = hb + nt * 8 * ldh + kt * 16;
          mma_bf16(acc[nt], ag[i], lds32(p), lds32(p + 8));
        }
      }
    }
    float* o = gp_s + ((s & 1) * ksplit + gq) * Rows * ldg + 2 * tq * ldg + gm * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      float* on = o + nt * 8 * ldg;
      on[0] = acc[nt][0];
      on[ldg] = acc[nt][1];
      on[8] = acc[nt][2];
      on[ldg + 8] = acc[nt][3];
    }
  };

  // A: the dh partials of step s (from the pieces of step s - 1's dgates)
  // of units [16 warp, 16 warp + 16) -> part_s[s & 1].
  auto dh_mma = [&](int s) {
    if (!d_warp) return;
    float acc[kPieces][kN][4];
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
#pragma unroll
      for (int nt = 0; nt < kN; ++nt) acc[p][nt][0] = acc[p][nt][1] = acc[p][nt][2] = acc[p][nt][3] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < Tiles; ++i) {
      if (i < kc) {
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
#pragma unroll
          for (int nt = 0; nt < kN; ++nt) {
            const bf16* b = dg_s + (p * Rows + nt * 8 + g) * ldd + i * 16 + 2 * tq;
            mma_bf16(acc[p][nt], ad[i], lds32(b), lds32(b + 8));
          }
        }
      }
    }
    float* o = part_s + (s & 1) * Rows * ldp + 2 * tq * ldp + warp * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kN; ++nt) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[kPieces - 1][nt][j];
#pragma unroll
        for (int p = kPieces - 2; p >= 0; --p) v[j] += acc[p][nt][j];
      }
      float* on = o + nt * 8 * ldp;
      on[0] = v[0];
      on[ldp] = v[1];
      on[8] = v[2];
      on[ldp + 8] = v[3];
    }
  };

  // Set-up: zero h and the pieces (their padding stays zero), stage h_prev of
  // steps 0 and 1, the gates of step 0.
  for (size_t e = tid; e < lay.part / 16; e += kThreads) {
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  stage(0);
  if (T > 1) stage(1);
  cp_async_wait<0>();
  __syncthreads();
  gate_mma(0);
  __syncthreads();

  // Phase C's items: (batch row cr, own unit cm), kCPer a thread.
  int cr[kCPer], cm[kCPer];
  bool c_on[kCPer];
  float dc_carry[kCPer];
#pragma unroll
  for (int j = 0; j < kCPer; ++j) {
    const int e = tid + j * kThreads;
    cr[j] = e / units;
    cm[j] = e - cr[j] * units;
    c_on[j] = e < Rows * units && cr[j] < rows;
    dc_carry[j] = 0.0f;
  }

  // Phase C's global inputs of step s (c_t, c_prev, g_out, the 4 xw) as
  // bf16, loaded a step ahead: issued after the barrier's arrive, so that
  // its release never waits for them, and read a step later.
  bf16 in_next[kCPer][7];
  auto prefetch = [&](int s) {
    const int t = time_of(s);
    const int tp = prev_of(t);
    const bf16 zero = __ushort_as_bfloat16(0);
#pragma unroll
    for (int j = 0; j < kCPer; ++j) {
#pragma unroll
      for (int v = 0; v < 7; ++v) in_next[j][v] = zero;
      if (c_on[j]) {
        const size_t base = static_cast<size_t>(b0 + cr[j]) * T;
        const int cn = n0 + cm[j];
        const size_t at = (base + t) * ld_seq + off + cn;
        in_next[j][0] = c_seq[at];
        in_next[j][1] = g_out[at];
        if (in_range(tp)) in_next[j][2] = c_seq[(base + tp) * ld_seq + off + cn];
        const bf16* xr = xw + (base + t) * G + cn;
#pragma unroll
        for (int q = 0; q < 4; ++q) in_next[j][3 + q] = xr[q * H];
      }
    }
  };
  prefetch(0);
  // Phase C's outputs (dxw, lo) of a step, stored to global memory a step
  // later, after the barrier's arrive, for the same reason.
  bf16 out_hi[kCPer][4], out_lo[kCPer][4];
  size_t out_at[kCPer];
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < kCPer; ++j) {
      if (c_on[j]) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dxw[out_at[j] + q * H] = out_hi[j][q];
          lo_out[out_at[j] + q * H] = out_lo[j][q];
        }
      }
    }
  };

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    float c_t[kCPer], c_prev[kCPer], g_in[kCPer], x[kCPer][4];
#pragma unroll
    for (int j = 0; j < kCPer; ++j) {
      c_t[j] = __bfloat162float(in_next[j][0]);
      g_in[j] = __bfloat162float(in_next[j][1]);
      c_prev[j] = __bfloat162float(in_next[j][2]);
#pragma unroll
      for (int q = 0; q < 4; ++q) x[j][q] = __bfloat162float(in_next[j][3 + q]);
    }
    if (s > 0) dh_mma(s);
    cluster_arrive();  // the dh partials of step s are out
    if (s + 2 < T) stage(s + 2);  // into h_s[s & 1], last read by B of step s - 1
    if (s + 1 < T) prefetch(s + 1);
    if (s > 0) flush();  // step s - 1's dxw and lo
    if (s + 1 < T) gate_mma(s + 1);
    cluster_wait();  // every peer's are in

#pragma unroll
    for (int j = 0; j < kCPer; ++j) {
      if (!c_on[j]) continue;
      const int cn = n0 + cm[j];
      float dh_carry = 0.0f;
      if (s > 0) {
        const float* dhp = part_s + (s & 1) * Rows * ldp + cr[j] * ldp + cn;
        float v[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          v[r] = r < csize ? *cluster.map_shared_rank(dhp, r) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < csize) dh_carry += v[r];  // rank order
        }
      }
      const float* gp = gp_s + (s & 1) * ksplit * Rows * ldg + cr[j] * ldg + cm[j];
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a = x[j][q];
        for (int kq = 0; kq < ksplit; ++kq) a += gp[kq * Rows * ldg + q * units];
        pre[q] = a;
      }
      const float gi = sigmoid_f(pre[0]);
      const float gf = sigmoid_f(pre[1]);
      const float gg = tanhf(pre[2]);
      const float go = sigmoid_f(pre[3]);
      const float dh = dh_carry + g_in[j];
      const float tc = tanhf(c_t[j]);
      const float dc = dc_carry[j] + dh * go * (1.0f - tc * tc);
      const float d[4] = {dc * gg * gi * (1.0f - gi), dc * c_prev[j] * gf * (1.0f - gf),
                          dc * gi * (1.0f - gg * gg), dh * tc * go * (1.0f - go)};
      out_at[j] = (static_cast<size_t>(b0 + cr[j]) * T + t) * G + cn;
      bf16* piece = dg_s + cr[j] * ldd + cm[j];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float rest = d[q];
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const bf16 v = __float2bfloat16_rn(rest);
          rest -= __bfloat162float(v);
          piece[p * Rows * ldd + q * units] = v;
          if (p == 0) out_hi[j][q] = v;
          if (p == 1) out_lo[j][q] = v;
        }
      }
      dc_carry[j] = dc * gf;
    }
    cp_async_wait<0>();  // h_prev of step s + 2, for B of step s + 1
    __syncthreads();
  }
  flush();  // the last step's
  cluster.sync();  // no CTA leaves while a peer may still read its dh partials
}

// Block (gate-column tile, slice, direction) of the bf16 dW_hh sum: a kDwTile
// x kDwTile tile (all H <= 128 units x 128 gate columns) over the rows
// [slice * rows_per_slice, ..) of K = B*T, h_prev^T dxw + h_prev^T lo in one
// f32 accumulator, into part[direction, slice].  Each stage brings kDwDepth
// rows of h_prev (read in place from h, shifted, zero where a direction's
// recurrence began), dxw and lo by cp.async; the eight warps (2 x 4) each
// take 64 units x 32 columns, A (h_prev^T) and B (dxw, lo) by transposed
// ldmatrix.  Vec: elements a copy, 8 (16 bytes) where 8 divides H, else 4.
template <int Vec>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_dwhh_mma_kernel(const bf16* __restrict__ h_seq,    // (B, T, 2H)
                         const bf16* hi_fwd, const bf16* hi_bwd,  // dxw (B, T, 4H)
                         const bf16* lo_fwd, const bf16* lo_bwd,  // lo (B, T, 4H)
                         float* __restrict__ part,           // (2, slices, H, 4H)
                         int B, int T, int H, int rows_per_slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [kDwStages][3][kDwDepth][kDwLd]
  constexpr int kPlane = kDwDepth * kDwLd;
  constexpr int kPerRow = kDwTile / Vec;
  const int G = 4 * H;
  const int ld_seq = 2 * H;
  const int j0 = blockIdx.x * kDwTile;
  const int slice = blockIdx.y;
  const bool reverse = blockIdx.z == 1;
  const bf16* __restrict__ hi = reverse ? hi_bwd : hi_fwd;
  const bf16* __restrict__ lo = reverse ? lo_bwd : lo_fwd;
  const int off = blockIdx.z * H;
  const int M = B * T;
  const int m_begin = slice * rows_per_slice;
  const int m_end = min(M, m_begin + rows_per_slice);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix: the matrix and row this lane addresses

  auto load_stage = [&](int st, int m0) {
    bf16* base = stages + st * 3 * kPlane;
    for (int e = tid; e < kDwDepth * kPerRow; e += kThreads) {
      const int k = e / kPerRow;
      const int c = (e - k * kPerRow) * Vec;
      const int m = m0 + k;
      bool va = false, vd = false;
      const bf16* sa = h_seq;
      const bf16* sh = hi;
      const bf16* sl = lo;
      if (m < m_end) {
        const int b = m / T;
        const int t = m - b * T;
        const int tp = reverse ? t + 1 : t - 1;  // h_prev is zero where tp is out of range
        va = c < H && tp >= 0 && tp < T;
        if (va) sa = h_seq + (static_cast<size_t>(b) * T + tp) * ld_seq + off + c;
        vd = j0 + c < G;
        if (vd) {
          sh = hi + static_cast<size_t>(m) * G + j0 + c;
          sl = lo + static_cast<size_t>(m) * G + j0 + c;
        }
      }
      bf16* row = base + k * kDwLd + c;
      cp_async_vec<Vec>(row, sa, va);
      cp_async_vec<Vec>(row + kPlane, sh, vd);
      cp_async_vec<Vec>(row + 2 * kPlane, sl, vd);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
  }
  const int chunks = (m_end - m_begin + kDwDepth - 1) / kDwDepth;
#pragma unroll
  for (int st = 0; st < kDwStages - 1; ++st) {
    if (st < chunks) {
      load_stage(st, m_begin + st * kDwDepth);
    } else {
      cp_async_commit();  // an empty group keeps the count of groups in flight fixed
    }
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kDwStages - 2>();  // chunk ch is in
    __syncthreads();                 // and every warp is done with chunk ch - 1's stage
    const int next = ch + kDwStages - 1;
    if (next < chunks) {
      load_stage(next % kDwStages, m_begin + next * kDwDepth);
    } else {
      cp_async_commit();
    }
    const bf16* a_t = stages + (ch % kDwStages) * 3 * kPlane;
#pragma unroll
    for (int kk = 0; kk < kDwDepth; kk += 16) {
      uint32_t a[4][4];  // h_prev^T: rows (units) wm*64 + mi*16 .., k kk ..
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4_trans(a[mi], a_t + (kk + (mat >> 1) * 8 + mrow) * kDwLd + wm * 64 + mi * 16 +
                                     (mat & 1) * 8);
      }
#pragma unroll
      for (int d = 1; d <= 2; ++d) {  // dxw, then lo
        const bf16* d_t = a_t + d * kPlane;
        uint32_t b[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, d_t + (kk + (mat & 1) * 8 + mrow) * kDwLd + wn * 32 + np * 16 +
                                   (mat >> 1) * 8);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  float* out = part + (static_cast<size_t>(blockIdx.z) * gridDim.y + slice) * H * G;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int row = wm * 64 + mi * 16 + (lane / 4);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = j0 + wn * 32 + ni * 8 + 2 * (lane % 4);
      if (col >= G) continue;  // G % 16 == 0: col + 1 < G with col
      if (row < H) {
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * G + col) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      }
      if (row + 8 < H) {
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * G + col) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

// The f32 sweep's launch: the grid is (cluster * ceil(B / kRows), 2) CTAs of
// kThreads in clusters of `cluster` along x.
cudaError_t launch_bwd(const float* xw_fwd, const float* w_hh_fwd, const float* xw_bwd,
                       const float* w_hh_bwd, const float* h_seq, const float* c_seq,
                       const float* g_out, float* dxw_fwd, float* dxw_bwd, int B, int T, int H,
                       int cluster, int ksplit, cudaStream_t stream) {
  auto kernel = lstm_bwd_kernel;
  const size_t smem = BwdLayout(H, cluster, ksplit).bytes;
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
  return cudaLaunchKernelEx(&config, kernel, xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_seq, c_seq,
                            g_out, dxw_fwd, dxw_bwd, B, T, H, cluster, ksplit);
}

using BwdMmaKernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, const bf16*,
                              const bf16*, const bf16*, bf16*, bf16*, bf16*, bf16*, int, int, int,
                              int, int);

// The bf16 sweep's instance for a plan, with its dynamic shared memory set
// and its launch configuration (grid (cluster * groups, 2) in clusters of
// `cluster`; groups = ceil(B / rows)), or cudaErrorInvalidValue for a plan
// it cannot run.  `attr` backs config->attrs.
cudaError_t bwd_mma_config(int B, int H, int rows, int cluster, int ksplit, cudaStream_t stream,
                           BwdMmaKernel* kernel, cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr) {
  if (H < 4 || H % 4 != 0 || cluster < 1 || cluster > kMaxCluster || H % cluster != 0 ||
      ksplit < 1 || B < 1) {
    return cudaErrorInvalidValue;
  }
  const MmaLayout lay(H, rows, cluster, ksplit);
  if (lay.units > kMaxUnits || lay.kh > kWarps || lay.kc * ksplit > kWarps) {
    return cudaErrorInvalidValue;
  }
  // The instances: Rows 8 or 16, Tiles 4 (every H % 8 == 0) or 8.
  if (rows == 8 && lay.tiles <= 4) {
    *kernel = lstm_bwd_mma_kernel<8, 4>;
  } else if (rows == 8 && lay.tiles <= 8) {
    *kernel = lstm_bwd_mma_kernel<8, 8>;
  } else if (rows == 16 && lay.tiles <= 4) {
    *kernel = lstm_bwd_mma_kernel<16, 4>;
  } else if (rows == 16 && lay.tiles <= 8) {
    *kernel = lstm_bwd_mma_kernel<16, 8>;
  } else {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return err;
  *config = {};
  config->gridDim = dim3(cluster * ((B + rows - 1) / rows), 2, 1);
  config->blockDim = dim3(kThreads, 1, 1);
  config->dynamicSmemBytes = lay.bytes;
  config->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

cudaError_t launch_dwhh(const float* h_seq, const float* dg_fwd, const float* dg_bwd, float* part,
                        float* dw_fwd, float* dw_bwd, int B, int T, int H, int slices,
                        int rows_per_slice, cudaStream_t stream) {
  const int tiles = ((H + kTile - 1) / kTile) * ((4 * H + kTile - 1) / kTile);
  lstm_dwhh_partial_kernel<<<dim3(tiles, slices, 2), kThreads, 0, stream>>>(
      h_seq, dg_fwd, dg_bwd, part, B, T, H, rows_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n4 = H * H;  // H * 4H / 4
  lstm_dwhh_reduce_kernel<float><<<(2 * n4 + kReduceThreads - 1) / kReduceThreads,
                                   kReduceThreads, 0, stream>>>(part, dw_fwd, dw_bwd, slices, n4);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, of one f32 lstm_bwd CTA.
extern "C" int lstm_bwd_smem_bytes(int H, int cluster, int ksplit) {
  return static_cast<int>(BwdLayout(H, cluster, ksplit).bytes);
}

// Launches the f32 backward sweep of both directions of a layer on `stream`:
// (xw_fwd, w_hh_fwd) and (xw_bwd, w_hh_bwd) as given to lstm_fwd_launch,
// h_seq and c_seq its (B, T, 2H) outputs, g_out the (B, T, 2H) gradient of
// h_seq; writes dxw_fwd and dxw_bwd (B, T, 4H).  ksplit is the number of
// k-slices of the gate partials.  Returns the CUDA error as an int (0 =
// launched).  Pointers are 16-byte aligned device pointers to contiguous f32
// arrays; the caller checks shapes, H % 4 == 0, 4 <= H <= 128, cluster in
// {4, 8} dividing H, ksplit * 4H / cluster <= kThreads, and B, T >= 1.
extern "C" int lstm_bwd_launch(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                               const void* w_hh_bwd, const void* h_seq, const void* c_seq,
                               const void* g_out, void* dxw_fwd, void* dxw_bwd, int B, int T,
                               int H, int cluster, int ksplit, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || H % cluster != 0 || ksplit < 1 ||
      ksplit * 4 * (H / cluster) > kThreads || 2 * H > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = launch_bwd(
      static_cast<const float*>(xw_fwd), static_cast<const float*>(w_hh_fwd),
      static_cast<const float*>(xw_bwd), static_cast<const float*>(w_hh_bwd),
      static_cast<const float*>(h_seq), static_cast<const float*>(c_seq),
      static_cast<const float*>(g_out), static_cast<float*>(dxw_fwd), static_cast<float*>(dxw_bwd),
      B, T, H, cluster, ksplit, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches the f32 dW_hh reduction of both directions on `stream`: the
// partial products of `slices` slices of rows_per_slice rows of K = B*T into
// part (2, slices, H, 4H), then their sums in slice order into dw_fwd and
// dw_bwd (H, 4H), from h_seq (B, T, 2H) and dxw_fwd, dxw_bwd (B, T, 4H), all
// f32.  Pointers are 16-byte aligned; slices * rows_per_slice >= B*T >
// (slices - 1) * rows_per_slice.  Returns the CUDA error as an int.
extern "C" int lstm_dwhh_launch(const void* h_seq, const void* dxw_fwd, const void* dxw_bwd,
                                float* part, void* dw_fwd, void* dw_bwd, int B, int T, int H,
                                int slices, int rows_per_slice, void* stream) {
  return static_cast<int>(launch_dwhh(
      static_cast<const float*>(h_seq), static_cast<const float*>(dxw_fwd),
      static_cast<const float*>(dxw_bwd), part, static_cast<float*>(dw_fwd),
      static_cast<float*>(dw_bwd), B, T, H, slices, rows_per_slice,
      static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory, in bytes, of one bf16 sweep CTA (lstm_bwd_mma_kernel).
extern "C" int lstm_bwd_mma_smem_bytes(int H, int rows, int cluster, int ksplit) {
  return static_cast<int>(MmaLayout(H, rows, cluster, ksplit).bytes);
}

// Launches the bf16 backward sweep of both directions of a layer on
// `stream`: the arguments of lstm_bwd_launch in bf16, and lo_fwd, lo_bwd (B,
// T, 4H), where it writes bf16(dgates - dxw) beside dxw = bf16(dgates).
// `rows` batch rows a cluster (8 or 16), `cluster` CTAs a cluster, `ksplit`
// k-slices of the gate product (a warp each, with ceil(ceil(4H / cluster) /
// 16) column tiles: at most 8 warps).  Returns the CUDA error as an int;
// cudaErrorInvalidValue (1) for a plan the kernel cannot run.
extern "C" int lstm_bwd_mma_launch(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                                   const void* w_hh_bwd, const void* h_seq, const void* c_seq,
                                   const void* g_out, void* dxw_fwd, void* dxw_bwd, void* lo_fwd,
                                   void* lo_bwd, int B, int T, int H, int rows, int cluster,
                                   int ksplit, void* stream) {
  BwdMmaKernel kernel;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = bwd_mma_config(B, H, rows, cluster, ksplit, static_cast<cudaStream_t>(stream),
                                   &kernel, &config, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const bf16*>(xw_fwd), static_cast<const bf16*>(w_hh_fwd),
      static_cast<const bf16*>(xw_bwd), static_cast<const bf16*>(w_hh_bwd),
      static_cast<const bf16*>(h_seq), static_cast<const bf16*>(c_seq),
      static_cast<const bf16*>(g_out), static_cast<bf16*>(dxw_fwd), static_cast<bf16*>(dxw_bwd),
      static_cast<bf16*>(lo_fwd), static_cast<bf16*>(lo_bwd), B, T, H, cluster, ksplit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of the bf16 sweep's configuration for this plan that the
// card can hold at once (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error.
extern "C" int lstm_bwd_mma_max_clusters(int H, int rows, int cluster, int ksplit) {
  BwdMmaKernel kernel;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = bwd_mma_config(rows, H, rows, cluster, ksplit, nullptr, &kernel, &config, attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &config);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launches the bf16 dW_hh sum of both directions on `stream`: the partial
// products h_prev^T dxw + h_prev^T lo of `slices` slices of rows_per_slice
// rows of K = B*T into part (2, slices, H, 4H) f32, then their sums in slice
// order, rounded to bf16 once, into dw_fwd and dw_bwd (H, 4H).  h_seq (B, T,
// 2H), dxw and lo (B, T, 4H) are bf16.  Pointers are 16-byte aligned; H % 4
// == 0, 4 <= H <= kDwTile.  Returns the CUDA error as an int.
extern "C" int lstm_dwhh_mma_launch(const void* h_seq, const void* hi_fwd, const void* hi_bwd,
                                    const void* lo_fwd, const void* lo_bwd, float* part,
                                    void* dw_fwd, void* dw_bwd, int B, int T, int H, int slices,
                                    int rows_per_slice, void* stream) {
  if (H < 4 || H % 4 != 0 || H > kDwTile || slices < 1 || rows_per_slice < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kernel)(const bf16*, const bf16*, const bf16*, const bf16*, const bf16*, float*, int, int,
                 int, int) = lstm_dwhh_mma_kernel<4>;
  if (H % 8 == 0) kernel = lstm_dwhh_mma_kernel<8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((4 * H + kDwTile - 1) / kDwTile, slices, 2);
  kernel<<<grid, kThreads, kDwSmem, st>>>(
      static_cast<const bf16*>(h_seq), static_cast<const bf16*>(hi_fwd),
      static_cast<const bf16*>(hi_bwd), static_cast<const bf16*>(lo_fwd),
      static_cast<const bf16*>(lo_bwd), part, B, T, H, rows_per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = H * H;  // H * 4H / 4
  lstm_dwhh_reduce_kernel<bf16><<<(2 * n4 + kReduceThreads - 1) / kReduceThreads,
                                  kReduceThreads, 0, st>>>(part, static_cast<bf16*>(dw_fwd),
                                                           static_cast<bf16*>(dw_bwd), slices, n4);
  return static_cast<int>(cudaGetLastError());
}
