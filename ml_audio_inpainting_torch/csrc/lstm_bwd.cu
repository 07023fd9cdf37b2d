// Backward LSTM recurrence over pre-projected inputs, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py
// ::_bwd_kernel (driven by _backward and the custom_vjp's _bwd).  Two kernels:
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
// lstm_dwhh_kernel -- dW_hh = sum over (b, t) of h_prev[b, t]^T (x) dxw[b, t],
//   a product of depth K = B*T.  On the TPU one core sees every batch row
//   and accumulates dW_hh in one resident output; here the batch is spread
//   over blocks, so this second kernel reduces over K in a fixed order (one
//   block a 32x32 tile of dW_hh, both directions in one launch): the result
//   does not change from run to run.
//
// What bounds them.  At the training shapes (B=25, T=417, H=128, both
// directions) the sweep reads xw, h, c and g and writes dxw, about 118 MB
// (35 us at 3.35 TB/s), and does two (B,H)x(H,4H) products a step, 5.5 GFLOP
// of f32 FMA (82 us at 67 TFLOP/s).  It is bound by latency instead: 417
// dependent steps, each with two dependent products (gates from h_prev, then
// dh from dgates), where the forward kernel has one.  The design is the
// forward kernel's: one launch per layer, the time loop inside the kernel,
// carries on chip, W_hh read from L2 (256 KB f32 does not fit a block's
// shared memory) -- twice a step here, once by gate column for the gates and
// once by hidden unit for dh.  The reduction is a plain shared-memory tiled
// product, 2.7 GFLOP over 54 MB, bound by operations.
//
// Layout of the sweep.  Block (x, y) owns kRows = 4 batch rows of direction y
// and runs 4H threads.  Per step:
//   A. thread j (a gate column) dots the block's h_prev rows (shared memory)
//      with W_hh[:, j] and parks the gate pre-activation in shared memory;
//      in the same phase thread (q, n) (q = j / H a quarter of the gate
//      columns, n = j % H a hidden unit) dots the previous step's dgates
//      over that quarter with row n of W_hh (contiguous, read as float4),
//      a partial of dh_carry;
//   -- barrier --
//   B. thread (r, n) = (j / H, j % H) sums the four partials into dh, does
//      the elementwise step for batch row r and unit n, writes dxw and its
//      dgates to shared memory, and stages h_prev of the next step;
//   -- barrier --
// so a step costs two barriers, as in the forward kernel, with twice its
// loads of W_hh.  f32 only.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;          // batch rows per block; kRows * H == 4H threads
constexpr int kChunk = 32;        // W_hh values a thread loads before using them
constexpr int kMaxThreads = 512;  // 4H for H <= 128; caps registers at 128 a thread
constexpr int kTile = 32;         // dW_hh tile edge in the reduction
constexpr int kDepth = 32;        // rows of K a reduction block stages at a time
constexpr int kReduceThreads = 256;

static_assert(kRows == 4, "the elementwise phase maps thread j to (row j / H, unit j % H)");

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kMaxThreads, 1)
    lstm_bwd_kernel(const float* xw_fwd, const float* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                    const float* xw_bwd, const float* w_hh_bwd,
                    const float* __restrict__ h_seq,  // (B, T, 2H) forward kernel's h
                    const float* __restrict__ c_seq,  // (B, T, 2H) forward kernel's c
                    const float* __restrict__ g_out,  // (B, T, 2H) gradient of h
                    float* dxw_fwd, float* dxw_bwd,   // (B, T, 4H)
                    int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                  // (kRows, H)  h_prev of the current step
  float* dc_s = h_s + kRows * H;      // (kRows, H)  dc carry
  float* g_s = dc_s + kRows * H;      // (kRows, 4H) gate pre-activations
  float* dg_s = g_s + kRows * 4 * H;  // (kRows, 4H) dgates of the last step
  float* p_s = dg_s + kRows * 4 * H;  // (4, kRows, H) partials of dh by gate quarter
  const bool reverse = blockIdx.y == 1;
  const float* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const float* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
  float* __restrict__ dxw = reverse ? dxw_bwd : dxw_fwd;
  const int G = 4 * H;
  const int ldh = 2 * H;
  const int off = blockIdx.y * H;  // this direction's half of h, c and g_out
  const int j = threadIdx.x;       // gate column in phase A; blockDim.x == 4H
  const int q = j / H;             // (q, n): gate quarter and unit for the dh partials,
  const int n = j - q * H;         //   and (row q, unit n) in phase B
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const bool active = q < rows;    // phase B has a batch row for this thread
  const size_t row_base = static_cast<size_t>(b0 + q) * T;

  // Step s handles time t(s); its forward predecessor is t - 1 (forward) or
  // t + 1 (backward), absent at the end of the range.
  auto time_of = [&](int s) { return reverse ? s : T - 1 - s; };
  auto prev_of = [&](int t) { return reverse ? t + 1 : t - 1; };
  auto in_range = [&](int t) { return t >= 0 && t < T; };

  for (int u = j; u < kRows * 4 * H; u += blockDim.x) {
    g_s[u] = 0.0f;
    dg_s[u] = 0.0f;
    p_s[u] = 0.0f;  // 4 * kRows * H == kRows * 4H
  }
  {
    const int tp = prev_of(time_of(0));
    h_s[j] = active && in_range(tp) ? h_seq[(row_base + tp) * ldh + off + n] : 0.0f;
    dc_s[j] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    const int tp = prev_of(t);  // the next step's t
    // This thread's phase-B inputs, loaded now so they arrive during phase A.
    float c_t = 0.0f, c_prev = 0.0f, g_in = 0.0f, h_next = 0.0f;
    if (active) {
      c_t = c_seq[(row_base + t) * ldh + off + n];
      g_in = g_out[(row_base + t) * ldh + off + n];
      if (in_range(tp)) {
        c_prev = c_seq[(row_base + tp) * ldh + off + n];
        const int tpp = prev_of(tp);
        if (in_range(tpp)) h_next = h_seq[(row_base + tpp) * ldh + off + n];
      }
    }

    // Phase A, gates: h_prev (shared, broadcast) . W_hh[:, j] (coalesced).
    float x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      x[r] = r < rows ? xw[(static_cast<size_t>(b0 + r) * T + t) * G + j] : 0.0f;
    }
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k0 = 0; k0 < H; k0 += kChunk) {
      float w[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        w[i] = k0 + i < H ? w_hh[static_cast<size_t>(k0 + i) * G + j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kChunk; i += 4) {
        if (k0 + i < H) {  // H % 4 == 0: the whole group of 4 is in range
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(h_s + r * H + k0 + i);
            acc[r] = fmaf(hv.x, w[i], acc[r]);
            acc[r] = fmaf(hv.y, w[i + 1], acc[r]);
            acc[r] = fmaf(hv.z, w[i + 2], acc[r]);
            acc[r] = fmaf(hv.w, w[i + 3], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) g_s[r * G + j] = x[r] + acc[r];

    // Phase A, dh partials of the last step: dgates[:, qH:(q+1)H] (shared,
    // broadcast) . W_hh[n, qH:(q+1)H] (contiguous row, float4).
    if (s > 0) {
      const float* __restrict__ w_row = w_hh + static_cast<size_t>(n) * G + q * H;
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
      for (int k0 = 0; k0 < H; k0 += kChunk) {
        float4 w4[kChunk / 4];
#pragma unroll
        for (int i = 0; i < kChunk / 4; ++i) {
          w4[i] = k0 + 4 * i < H ? *reinterpret_cast<const float4*>(w_row + k0 + 4 * i)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int i = 0; i < kChunk / 4; ++i) {
          if (k0 + 4 * i < H) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 d = *reinterpret_cast<const float4*>(dg_s + r * G + q * H + k0 + 4 * i);
              part[r] = fmaf(d.x, w4[i].x, part[r]);
              part[r] = fmaf(d.y, w4[i].y, part[r]);
              part[r] = fmaf(d.z, w4[i].z, part[r]);
              part[r] = fmaf(d.w, w4[i].w, part[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) p_s[(q * kRows + r) * H + n] = part[r];
    }
    __syncthreads();

    // Phase B: the elementwise step of batch row q, unit n.
    if (active) {
      const float* g = g_s + q * G;
      const float gi = sigmoid_f(g[n]);
      const float gf = sigmoid_f(g[H + n]);
      const float gg = tanhf(g[2 * H + n]);
      const float go = sigmoid_f(g[3 * H + n]);
      float dh_carry = 0.0f;
      if (s > 0) {
        dh_carry = p_s[(0 * kRows + q) * H + n] + p_s[(1 * kRows + q) * H + n];
        dh_carry += p_s[(2 * kRows + q) * H + n];
        dh_carry += p_s[(3 * kRows + q) * H + n];
      }
      const float dh = dh_carry + g_in;
      const float tc = tanhf(c_t);
      const float dc = dc_s[j] + dh * go * (1.0f - tc * tc);
      const float d_i = dc * gg * gi * (1.0f - gi);
      const float d_f = dc * c_prev * gf * (1.0f - gf);
      const float d_g = dc * gi * (1.0f - gg * gg);
      const float d_o = dh * tc * go * (1.0f - go);
      float* dg = dg_s + q * G;
      dg[n] = d_i;
      dg[H + n] = d_f;
      dg[2 * H + n] = d_g;
      dg[3 * H + n] = d_o;
      float* out = dxw + (row_base + t) * G;
      out[n] = d_i;
      out[H + n] = d_f;
      out[2 * H + n] = d_g;
      out[3 * H + n] = d_o;
      dc_s[j] = dc * gf;
      h_s[j] = h_next;
    }
    __syncthreads();
  }
}

// dW_hh of both directions (blockIdx.z): block (x, y) computes the 32x32 tile
// dW[y*32 .., x*32 ..] over all K = B*T rows, kDepth rows at a time, in order.
__global__ void __launch_bounds__(kReduceThreads)
    lstm_dwhh_kernel(const float* __restrict__ h_seq,  // (B, T, 2H)
                     const float* dxw_fwd, const float* dxw_bwd,  // (B, T, 4H)
                     float* dw_fwd, float* dw_bwd,                // (H, 4H)
                     int B, int T, int H) {
  __shared__ float a_s[kDepth][kTile];  // h_prev rows, units i0 ..
  __shared__ float b_s[kDepth][kTile];  // dxw rows, gate columns j0 ..
  const bool reverse = blockIdx.z == 1;
  const float* __restrict__ dxw = reverse ? dxw_bwd : dxw_fwd;
  float* __restrict__ dw = reverse ? dw_bwd : dw_fwd;
  const int G = 4 * H;
  const int ldh = 2 * H;
  const int off = blockIdx.z * H;
  const int M = B * T;
  const int j0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int m0 = 0; m0 < M; m0 += kDepth) {
#pragma unroll
    for (int l = 0; l < kDepth * kTile / kReduceThreads; ++l) {
      const int e = threadIdx.x + kReduceThreads * l;
      const int k = e / kTile;
      const int col = e - k * kTile;
      const int m = m0 + k;
      float av = 0.0f, bv = 0.0f;
      if (m < M) {
        const int b = m / T;
        const int t = m - b * T;
        const int tp = reverse ? t + 1 : t - 1;  // h_prev is zero where tp is out of range
        if (i0 + col < H && tp >= 0 && tp < T) {
          av = h_seq[(static_cast<size_t>(b) * T + tp) * ldh + off + i0 + col];
        }
        if (j0 + col < G) bv = dxw[static_cast<size_t>(m) * G + j0 + col];
      }
      a_s[k][col] = av;
      b_s[k][col] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float a0 = a_s[k][ty], a1 = a_s[k][ty + 16];
      const float v0 = b_s[k][tx], v1 = b_s[k][tx + 16];
      acc[0][0] = fmaf(a0, v0, acc[0][0]);
      acc[0][1] = fmaf(a0, v1, acc[0][1]);
      acc[1][0] = fmaf(a1, v0, acc[1][0]);
      acc[1][1] = fmaf(a1, v1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = i0 + ty + 16 * a;
      const int jj = j0 + tx + 16 * c;
      if (i < H && jj < G) dw[static_cast<size_t>(i) * G + jj] = acc[a][c];
    }
  }
}

}  // namespace

// Launches the backward sweep of both directions of a layer on `stream`:
// (xw_fwd, w_hh_fwd) and (xw_bwd, w_hh_bwd) as given to lstm_fwd_launch,
// h_seq and c_seq its (B, T, 2H) outputs, g_out the (B, T, 2H) gradient of
// h_seq; writes dxw_fwd and dxw_bwd (B, T, 4H).  Returns cudaGetLastError()
// as an int (0 = launched).  Pointers are device pointers to contiguous f32
// arrays; the caller checks shapes, H % 4 == 0, 4 <= H <= 128 and B, T >= 1.
extern "C" int lstm_bwd_launch(const float* xw_fwd, const float* w_hh_fwd, const float* xw_bwd,
                               const float* w_hh_bwd, const float* h_seq, const float* c_seq,
                               const float* g_out, float* dxw_fwd, float* dxw_bwd, int B, int T,
                               int H, void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, 2);
  const size_t smem = sizeof(float) * (kRows * H * 2 + kRows * 4 * H * 2 + 4 * kRows * H);
  lstm_bwd_kernel<<<grid, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_seq, c_seq, g_out, dxw_fwd, dxw_bwd, B, T, H);
  return static_cast<int>(cudaGetLastError());
}

// Launches the dW_hh reduction of both directions on `stream`: dw_fwd and
// dw_bwd (H, 4H) from h_seq (B, T, 2H) and dxw_fwd, dxw_bwd (B, T, 4H).
// Returns cudaGetLastError() as an int.
extern "C" int lstm_dwhh_launch(const float* h_seq, const float* dxw_fwd, const float* dxw_bwd,
                                float* dw_fwd, float* dw_bwd, int B, int T, int H,
                                void* stream) {
  const dim3 grid((4 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile, 2);
  lstm_dwhh_kernel<<<grid, kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h_seq, dxw_fwd, dxw_bwd, dw_fwd, dw_bwd, B, T, H);
  return static_cast<int>(cudaGetLastError());
}
