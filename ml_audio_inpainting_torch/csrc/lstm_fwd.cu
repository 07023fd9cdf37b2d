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
// backward kernel, csrc/lstm_bwd.cu, which reads this layout), the cell state
// goes into a second (B, T, 2H) array laid out the same way; serving passes
// null and writes nothing more.
//
// What bounds it.  At the serving shapes (B=32, T=417, H=128, both
// directions) it reads xw once (55 MB) and writes h (14 MB), 21 us at
// 3.35 TB/s, and does 3.5 GFLOP of f32 FMA, 52 us at 67 TFLOP/s.  It is
// bound by latency instead: 417 dependent steps, each of which needs the
// last step's h of every hidden unit.  A block that holds all of W_hh
// cannot exist (256 KB f32 against 227 KB of shared memory), and a block
// that reads it from L2 every step spends ~2.2 us a step on it.  With this
// design a step takes ~2 us on an H100: a loop of bare cluster barriers
// alone takes 0.7 us a step, the release of the peer stores ~0.4 us more,
// the gate product ~0.5 us (scripts/torch_lstm_fwd_phases.py, PERF.md).
//
// The design.  One thread-block cluster of C CTAs (C = 8 when H % 8 == 0,
// else 4) runs Rows batch rows of one direction.  CTA r owns the hidden
// units [r*u, (r+1)*u), u = H / C, and all four gate columns of each (4u
// columns), so a unit's gates, c and h are computed inside one CTA and no
// partial sum crosses CTAs.  At launch the CTA copies W_hh[:, own columns]
// (128 x 64 f32, 32 KB at H=128) into shared memory, and each thread loads
// its part of that slice into registers once: the time loop reads W_hh
// neither from global memory or L2 nor from shared memory, where 32 KB a
// CTA each step would bound the step by shared-memory bandwidth.  A unit's 4 gates x KQ k-slices are 4*KQ
// neighbouring lanes of a warp (KQ = 4, or 2 where 16u > 256 threads);
// lane (unit, gate q, slice kq) holds W_hh[slice kq, column (q, unit)].
// Per step s:
//   P. the lane dots the Rows rows of h_{s-1} over its k-slice (all H
//      units, in its own shared memory, each slice padded to its own banks
//      and to the register span) with its registers, and the KQ lanes of a
//      gate sum their partials by shuffles (a butterfly: every lane gets
//      the same sum);
//   E. lane kq takes rows kq, kq + KQ, ..: it adds xw (staged), applies its
//      gate's sigmoid or tanh, gathers the unit's 4 activations by
//      shuffles, updates c (kept in a register) and h, and stores h into
//      the next h buffer of C/4 CTAs of the cluster (the 4 gate lanes of a
//      unit share the C stores; distributed shared memory: remote stores
//      do not stall the writer);
//   -- cluster arrive (release) --
//   S. off the chain, while the barrier completes: h (and c when asked) go
//      to global memory, after the arrive so that its release waits for the
//      peer stores alone; cp.async stages xw of step s+2 into shared memory
//      (three buffers; xw does not depend on the carry), and each thread
//      waits for its copies a step later, before the arrive that publishes
//      them;
//   -- cluster wait (acquire) --
// No __syncthreads in the loop: one cluster barrier a step.  h is
// double-buffered: a CTA stores into buffer (s+1)&1 of a peer only after the
// peer has arrived at step s-1's barrier, which it does after reading that
// buffer.  The last step's barrier keeps every CTA alive while a peer may
// still store into it.  No atomics and fixed summation orders: two launches
// agree bit for bit.  Rows (batch rows a cluster) and KQ are template
// parameters; the launch plan (ops/cuda/lstm_cell.py::fwd_plan) picks Rows
// from 2, 4 and 8 by the batch, so that about two CTAs share each SM, and
// the launch bounds hold a KQ = 4 instance to 64 registers, so that all of
// them fit the card at once (at ~100 registers, 2 rows a cluster at B=32
// ran 1.6x slower).
//
// The element type, Elem, is a template parameter, instantiated for f32 and
// bf16 (__nv_bfloat16), as the JAX package runs _fwd_kernel in both (bf16
// under make_cnn_train_step(compute_dtype=bfloat16)).  In bf16 the kernel
// computes what _fwd_kernel computes there: W_hh is converted to f32 when
// it is loaded into registers (exact), xw is staged in bf16 and converted
// when it is added, the carries h and c stay f32 (in registers, and the h
// exchanged between the CTAs of a cluster in f32 shared memory), and only
// the global stores of h and c round to bf16 (__float2bfloat16_rn, as
// _fwd_kernel's astype).  bf16 halves the bytes of xw, h and c; the step
// is bound by latency all the same.  A bf16 xw row is staged by 16-byte
// copies where a gate's units fill whole 16-byte groups (8 units), 4-byte
// copies where they fill pairs, and element by element for an odd number
// of units a CTA.  No tensor cores and no approximate transcendentals: f32
// FMA, expf and tanhf, as _fwd_kernel's f32 accumulation.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // threads a CTA
constexpr int kMaxCluster = 8;   // CTAs a cluster (the portable maximum)
constexpr int kStages = 3;       // xw buffers: staged two steps ahead
constexpr int kMaxHidden = 128;  // the largest H: a k-slice's W_hh in 128 / KQ registers
constexpr unsigned kAll = 0xffffffffu;

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

// The codes of the element types at the C interface (ops/cuda/lstm_cell.py).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// 16 or 4 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The two halves of a cluster barrier; every thread of every CTA calls both
// (the forms without .aligned: a warp need not be converged).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Shared memory of a CTA, byte offsets.  The W_hh slice's row stride ldw
// pads the 4u columns as BwdLayout (lstm_bwd.cu) does, so that ldw / 4 is
// odd.  An h row holds the KQ k-slices of kspan units each, every slice in
// a segment of hseg = 128 / KQ + 4 floats: the product runs over the whole
// segment (zero past kspan) with no bounds to test, and the float4 reads of
// one k by the KQ slices of a warp fall in distinct banks.
struct FwdLayout {
  int units, ncol, ldw, kspan, hseg, hrow;
  size_t w, h, xw, bytes;
  __host__ __device__ FwdLayout(int H, int rows, int cluster, int ksplit, int elem_bytes) {
    units = H / cluster;
    ncol = 4 * units;
    ldw = 4 * ((units + 1) | 1);
    kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;
    hseg = kMaxHidden / ksplit + 4;
    hrow = ksplit * hseg;
    w = 0;                                          // f32 (H, ldw)
    h = w + sizeof(float) * H * ldw;                // f32 2 x (rows, hrow), by step parity
    xw = h + sizeof(float) * 2 * rows * hrow;       // Elem kStages x (rows, 4u)
    bytes = xw + (static_cast<size_t>(elem_bytes) * kStages * rows * ncol + 15) / 16 * 16;
  }
};

template <typename Elem, int Rows, int KQ>
__global__ void __launch_bounds__(kThreads, KQ == 4 ? 4 : 2)
    lstm_fwd_kernel(const Elem* xw_fwd, const Elem* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                    const Elem* xw_bwd, const Elem* w_hh_bwd,
                    Elem* __restrict__ h_out,  // (B, T, 2H): forward h, then backward h
                    Elem* __restrict__ c_out,  // (B, T, 2H) cell state, or null
                    int B, int T, int H, int csize) {
  constexpr int kSpanMax = kMaxHidden / KQ;  // W_hh registers a lane
  constexpr int kLanes = 4 * KQ;             // lanes a unit
  constexpr int kRowsLane = (Rows + KQ - 1) / KQ;
  cg::cluster_group cluster = cg::this_cluster();
  const FwdLayout lay(H, Rows, csize, KQ, sizeof(Elem));
  const int units = lay.units, ncol = lay.ncol, kspan = lay.kspan, hrow = lay.hrow;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem + lay.w);  // W_hh[:, own columns]
  float* h_s = reinterpret_cast<float*>(smem + lay.h);  // h_{s-1} of all units, by parity
  Elem* xw_s = reinterpret_cast<Elem*>(smem + lay.xw);  // xw of own columns, by s % kStages

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * units;  // own units [n0, n0 + units); own column lc is
                                // gate lc / units, unit n0 + lc % units
  const bool reverse = blockIdx.y == 1;
  const Elem* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const Elem* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
  const int G = 4 * H;
  const int ldh = 2 * H;
  const int off = blockIdx.y * H;  // this direction's half of h_out and c_out
  const int b0 = (blockIdx.x / csize) * Rows;
  const int rows = min(Rows, B - b0);
  const int tid = threadIdx.x;
  auto time_of = [&](int s) { return reverse ? T - 1 - s : s; };

  // This lane: unit m (n = n0 + m), gate q, k-slice kq; the unit's first lane.
  const int kq = tid % KQ;
  const int q = (tid / KQ) % 4;
  const int m = tid / kLanes;
  const bool unit_ok = m < units;
  const int lc = q * units + m;
  const int first = (tid % 32) - (tid % kLanes);
  const int n = n0 + m;
  const int h_at = (n / kspan) * lay.hseg + n % kspan;  // unit n's place in an h row

  // xw of step s, the cluster's rows and own columns -> xw_s[s % kStages],
  // by the CTA's last threads.  Always commits a group, empty past the end.
  // 16-byte copies where a gate's units fill whole 16-byte groups, else
  // 4-byte ones, else (bf16, an odd number of units) element by element:
  // those plain stores are published by the same barrier as the copies.
  constexpr int kPer16 = 16 / sizeof(Elem);
  constexpr int kPer4 = 4 / sizeof(Elem);
  const int vec = units % kPer16 == 0 ? kPer16 : units % kPer4 == 0 ? kPer4 : 1;
  const int per_gate = units / vec;
  auto stage_xw = [&](int s) {
    if (s < T) {
      Elem* dst = xw_s + (s % kStages) * Rows * ncol;
      const size_t t = time_of(s);
      for (int e = kThreads - 1 - tid; e < Rows * 4 * per_gate; e += kThreads) {
        const int r = e / (4 * per_gate);
        const int g = (e - r * 4 * per_gate) / per_gate;
        const int j = (e - r * 4 * per_gate - g * per_gate) * vec;
        const bool valid = r < rows;
        const Elem* src = valid ? xw + (static_cast<size_t>(b0 + r) * T + t) * G + g * H + n0 + j
                                : xw;
        Elem* d = dst + r * ncol + g * units + j;
        if (vec == kPer16) {
          cp_async16(d, src, valid);
        } else if (vec == kPer4) {
          cp_async4(d, src, valid);
        } else {
          *d = valid ? *src : from_f32<Elem>(0.0f);
        }
      }
    }
    cp_async_commit();
  };

  // Set-up: the W_hh slice, zero h buffers, xw of steps 0 and 1.
  for (int e = tid; e < H * ncol; e += kThreads) {
    const int k = e / ncol;
    const int c = e - k * ncol;
    const int g = c / units;
    w_s[k * lay.ldw + c] = to_f32(w_hh[static_cast<size_t>(k) * G + g * H + n0 + c - g * units]);
  }
  for (int e = tid; e < 2 * Rows * hrow; e += kThreads) h_s[e] = 0.0f;
  stage_xw(0);
  stage_xw(1);
  cp_async_wait_all();
  // Every CTA of the cluster is running and has zeroed the h buffers its
  // peers store into from step 0 on; the W_hh slice and xw(0), xw(1) are in.
  cluster.sync();

  float w[kSpanMax];  // W_hh[kq * kspan + i, column lc], zero past H
#pragma unroll
  for (int i = 0; i < kSpanMax; ++i) {
    const int k = kq * kspan + i;
    w[i] = unit_ok && i < kspan && k < H ? w_s[k * lay.ldw + lc] : 0.0f;
  }
  float c[kRowsLane], h[kRowsLane];
#pragma unroll
  for (int j = 0; j < kRowsLane; ++j) c[j] = h[j] = 0.0f;

  for (int s = 0; s < T; ++s) {
    // P: the gate's partial over slice kq for every row, then its sum.
    const float* hb = h_s + (s & 1) * Rows * hrow + kq * lay.hseg;
    float acc[Rows];
#pragma unroll
    for (int r = 0; r < Rows; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kSpanMax; i += 4) {
#pragma unroll
      for (int r = 0; r < Rows; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hb + r * hrow + i);
        acc[r] = fmaf(hv.x, w[i], acc[r]);
        acc[r] = fmaf(hv.y, w[i + 1], acc[r]);
        acc[r] = fmaf(hv.z, w[i + 2], acc[r]);
        acc[r] = fmaf(hv.w, w[i + 3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < Rows; ++r) {
#pragma unroll
      for (int o = 1; o < KQ; o <<= 1) acc[r] += __shfl_xor_sync(kAll, acc[r], o);
    }

    // E: rows kq + KQ j of this unit.
    const Elem* xs = xw_s + (s % kStages) * Rows * ncol;
    float* h_next = h_s + ((s + 1) & 1) * Rows * hrow + h_at;
#pragma unroll
    for (int j = 0; j < kRowsLane; ++j) {
      const int r = kq + KQ * j;
      float pre = 0.0f;
#pragma unroll
      for (int rr = 0; rr < Rows; ++rr) pre = rr == r ? acc[rr] : pre;
      if (unit_ok && r < Rows) pre += to_f32(xs[r * ncol + lc]);
      const float act = q == 2 ? tanhf(pre) : sigmoid_f(pre);
      const float gi = __shfl_sync(kAll, act, first + kq);
      const float gf = __shfl_sync(kAll, act, first + KQ + kq);
      const float gg = __shfl_sync(kAll, act, first + 2 * KQ + kq);
      const float go = __shfl_sync(kAll, act, first + 3 * KQ + kq);
      c[j] = gf * c[j] + gi * gg;
      h[j] = go * tanhf(c[j]);
      if (unit_ok && r < rows) {
        for (int p = q; p < csize; p += 4) *cluster.map_shared_rank(h_next + r * hrow, p) = h[j];
      }
    }

    cp_async_wait_all();  // xw(s+1), staged a step ago: published by the arrive
    cluster_arrive();
    // Off the chain: the global stores come after the arrive, so that its
    // release waits for the peer stores alone.
    if (unit_ok && q < 2) {
      const size_t t = time_of(s);
#pragma unroll
      for (int j = 0; j < kRowsLane; ++j) {
        const int r = kq + KQ * j;
        if (r < rows) {
          const size_t at = (static_cast<size_t>(b0 + r) * T + t) * ldh + off + n;
          if (q == 0) {
            h_out[at] = from_f32<Elem>(h[j]);
          } else if (c_out != nullptr) {
            c_out[at] = from_f32<Elem>(c[j]);
          }
        }
      }
    }
    stage_xw(s + 2);  // into xw_s[(s+2) % kStages], last read by E of step s-1
    cluster_wait();
  }
}

template <typename Elem, int Rows, int KQ>
cudaError_t launch_plan(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                        const void* w_hh_bwd, void* h_out, void* c_out, int B, int T, int H,
                        int cluster, int groups, cudaStream_t stream) {
  auto kernel = lstm_fwd_kernel<Elem, Rows, KQ>;
  const size_t smem = FwdLayout(H, Rows, cluster, KQ, sizeof(Elem)).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster * groups, 2, 1);
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
                            static_cast<const Elem*>(w_hh_bwd), static_cast<Elem*>(h_out),
                            static_cast<Elem*>(c_out), B, T, H, cluster);
}

template <typename Elem, int KQ>
cudaError_t launch_rows(int rows, const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                        const void* w_hh_bwd, void* h_out, void* c_out, int B, int T, int H,
                        int cluster, int groups, cudaStream_t stream) {
  switch (rows) {
    case 2:
      return launch_plan<Elem, 2, KQ>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B, T, H,
                                      cluster, groups, stream);
    case 4:
      return launch_plan<Elem, 4, KQ>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B, T, H,
                                      cluster, groups, stream);
    case 8:
      return launch_plan<Elem, 8, KQ>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B, T, H,
                                      cluster, groups, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Elem>
cudaError_t launch_elem(int rows, int ksplit, const void* xw_fwd, const void* w_hh_fwd,
                        const void* xw_bwd, const void* w_hh_bwd, void* h_out, void* c_out,
                        int B, int T, int H, int cluster, int groups, cudaStream_t stream) {
  return ksplit == 4 ? launch_rows<Elem, 4>(rows, xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out,
                                            c_out, B, T, H, cluster, groups, stream)
                     : launch_rows<Elem, 2>(rows, xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out,
                                            c_out, B, T, H, cluster, groups, stream);
}

// Bytes of an element of type code `dtype`, 0 for a code the kernel has not.
int elem_bytes(int dtype) {
  return dtype == kF32 ? 4 : dtype == kBF16 ? 2 : 0;
}

}  // namespace

// Dynamic shared memory, in bytes, of one lstm_fwd CTA for elements of
// `elem_bytes` bytes (4: f32, 2: bf16).
extern "C" int lstm_fwd_smem_bytes(int H, int rows, int cluster, int ksplit, int elem_bytes) {
  return static_cast<int>(FwdLayout(H, rows, cluster, ksplit, elem_bytes).bytes);
}

// Launches the forward sweep of (xw_fwd, w_hh_fwd) and the backward sweep of
// (xw_bwd, w_hh_bwd) on `stream` into h_out (B, T, 2H) and, unless it is
// null, c_out (B, T, 2H).  The plan: `groups` clusters of `cluster` CTAs a
// direction, each running `rows` batch rows (rows in {2, 4, 8}, groups =
// ceil(B / rows)), each gate's product split into `ksplit` k-slices (4, or
// 2 where 16 H / cluster > kThreads).  `dtype` is the element type of every
// array (0: f32, 1: bf16).  Returns the CUDA error as an int (0 =
// launched); cudaErrorInvalidValue, launching nothing, for a plan or type
// the kernel cannot run.  Pointers are device pointers to contiguous
// arrays, xw aligned to the copies that stage it (16 bytes always do); the
// caller checks shapes.
extern "C" int lstm_fwd_launch(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                               const void* w_hh_bwd, void* h_out, void* c_out, int B, int T,
                               int H, int rows, int cluster, int ksplit, int groups, int dtype,
                               void* stream) {
  const int eb = elem_bytes(dtype);
  if (eb == 0 || B < 1 || T < 1 || H < 4 || H > kMaxHidden || H % 4 != 0 || cluster < 1 ||
      cluster > kMaxCluster || H % cluster != 0 || (ksplit != 2 && ksplit != 4) ||
      4 * ksplit * (H / cluster) > kThreads || groups < 1 ||
      static_cast<long long>(groups) * rows < B ||
      static_cast<long long>(groups - 1) * rows >= B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The alignment of xw that its staging copies need.
  const int units_bytes = (H / cluster) * eb;
  const int align = units_bytes % 16 == 0 ? 16 : units_bytes % 4 == 0 ? 4 : eb;
  const auto misaligned = [align](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % align != 0;
  };
  if (misaligned(xw_fwd) || misaligned(xw_bwd)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32 ? launch_elem<float>(rows, ksplit, xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out,
                                         c_out, B, T, H, cluster, groups, st)
                    : launch_elem<__nv_bfloat16>(rows, ksplit, xw_fwd, w_hh_fwd, xw_bwd,
                                                 w_hh_bwd, h_out, c_out, B, T, H, cluster,
                                                 groups, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
