// Forward LSTM recurrence over pre-projected inputs, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py
// ::_fwd_kernel (driven by _forward and lstm_recurrence_pallas).  For each
// direction it computes, from h = c = 0,
//
//   gates = xw[:, t] + h @ W_hh          (gate order i, f, g, o)
//   c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h     = sigmoid(o) * tanh(c)
//
// over t = 0 .. T-1 (forward direction) or t = T-1 .. 0 (backward).  One
// launch runs both directions of a BiLSTM layer side by side (blockIdx.y)
// and writes them into the two halves of one (B, T, 2H) output.  The
// backward sweep indexes time backwards here, so there is no flip copy and
// the output stays in input time order: h[b, t, :] is the state after the
// input at time t.  When the caller passes c_out (training saves it for the
// backward kernel, csrc/lstm_bwd.cu), the cell state goes into a second
// (B, T, 2H) array laid out the same way; serving passes null and writes
// nothing more.  f32 only.
//
// What bounds it.  At serving shapes (B=32, T=417, H=128) each direction reads
// xw once (B*T*4H*4 = 27.3 MB), writes h (B*T*H*4 = 6.8 MB) and does
// 2*B*H*4H*T = 1.75 GFLOP: 10 us of memory or 26 us of f32 FMA on an H100.
// It is bound by latency instead, 417 dependent steps each of which needs
// the previous step's h from every hidden unit.  The design answers that
// with one launch per layer, the time loop inside the kernel, the (h, c)
// carries on chip, and W_hh read from global memory, where its 256 KB stay
// resident in the 50 MB L2; each thread keeps 32 of those loads in flight,
// and reads h from shared memory 4 values a load.
// W_hh does not fit one block's 227 KB of shared memory in f32; keeping it
// on chip (split across a thread-block cluster) is left to a later redesign.
//
// Layout.  Block (x, y) owns kRows batch rows of direction y (0 forward,
// 1 backward); its 4H threads each own one gate column j.  Per step a thread
// dots the block's h rows (shared memory, broadcast) with W_hh[:, j]
// (coalesced across threads), adds xw, and parks the gate in shared memory;
// after a barrier the threads update (c, h) per hidden unit and write h.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kChunk = 32;       // W_hh loads a thread issues before using them
constexpr int kMaxThreads = 512;  // 4H for H <= 128; caps registers at 128 a thread

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kMaxThreads, 1)
    lstm_fwd_kernel(const float* xw_fwd, const float* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                    const float* xw_bwd, const float* w_hh_bwd,
                    float* __restrict__ h_out,  // (B, T, 2H): forward h, then backward h
                    float* __restrict__ c_out,  // (B, T, 2H) cell state, or null
                    int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;             // (kRows, H)  h_{t-1}
  float* c_s = h_s + kRows * H;  // (kRows, H)  c_{t-1}
  float* g_s = c_s + kRows * H;  // (kRows, 4H) gate pre-activations
  const bool reverse = blockIdx.y == 1;
  const float* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const float* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
  const int G = 4 * H;
  const int ldh = 2 * H;
  h_out += blockIdx.y * H;
  if (c_out != nullptr) c_out += blockIdx.y * H;
  const int j = threadIdx.x;  // gate column; blockDim.x == 4H
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);

  for (int u = j; u < kRows * H; u += blockDim.x) {
    h_s[u] = 0.0f;
    c_s[u] = 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
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
    __syncthreads();

    for (int u = j; u < rows * H; u += blockDim.x) {
      const int r = u / H;
      const int n = u - r * H;
      const float* g = g_s + r * G;
      const float gi = sigmoid_f(g[n]);
      const float gf = sigmoid_f(g[H + n]);
      const float gg = tanhf(g[2 * H + n]);
      const float go = sigmoid_f(g[3 * H + n]);
      const float c = gf * c_s[u] + gi * gg;
      const float h = go * tanhf(c);
      c_s[u] = c;
      h_s[u] = h;
      const size_t at = (static_cast<size_t>(b0 + r) * T + t) * ldh + n;
      h_out[at] = h;
      if (c_out != nullptr) c_out[at] = c;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches the forward sweep of (xw_fwd, w_hh_fwd) and the backward sweep of
// (xw_bwd, w_hh_bwd) on `stream` into h_out (B, T, 2H) and, unless it is
// null, c_out (B, T, 2H), and returns
// cudaGetLastError() as an int (0 = launched).  Pointers are device pointers
// to contiguous f32 arrays; the caller checks shapes, H % 4 == 0 (float4
// reads of h), 4 <= H <= 128 (4H <= kMaxThreads threads a block) and
// B, T >= 1.
extern "C" int lstm_fwd_launch(const float* xw_fwd, const float* w_hh_fwd, const float* xw_bwd,
                               const float* w_hh_bwd, float* h_out, float* c_out, int B, int T,
                               int H, void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, 2);
  const size_t smem = sizeof(float) * (2 * kRows * H + kRows * 4 * H);
  lstm_fwd_kernel<<<grid, 4 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B, T, H);
  return static_cast<int>(cudaGetLastError());
}
