// Forward LSTM recurrence over pre-projected inputs, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py
// ::_fwd_kernel (driven by _forward and lstm_recurrence_pallas), in f32 and
// in bf16, each element type by a kernel of its own behind a C launcher of
// its own.  For each direction both compute, from h = c = 0,
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
// directions) the f32 form reads xw once (55 MB) and writes h (14 MB), 21 us
// at 3.35 TB/s, and does 3.5 GFLOP of f32 FMA, 52 us at 67 TFLOP/s.  It is
// bound by latency instead: 417 dependent steps, each of which needs the
// last step's h of every hidden unit.  A block that holds all of W_hh
// cannot exist (256 KB f32 against 227 KB of shared memory), and a block
// that reads it from L2 every step spends ~2.2 us a step on it.  With the
// f32 form's design a step takes ~2 us on an H100: a loop of bare cluster
// barriers alone takes 0.7 us a step, the release of the peer stores ~0.4
// us more, the gate product ~0.5 us (scripts/torch_lstm_fwd_phases.py,
// PERF.md).
//
// Both forms run on thread-block clusters.  One cluster of C CTAs (C = 8
// when H % 8 == 0, else 4) runs a group of batch rows of one direction; CTA
// r owns the hidden units [r*u, (r+1)*u), u = H / C, and all four gate
// columns of each, so a unit's gates, c and h are computed inside one CTA
// and no partial sum crosses CTAs.  W_hh's columns of the CTA are loaded
// into registers once, at launch: the time loop reads W_hh neither from
// global memory or L2 nor from shared memory.  Each step ends with the new
// h of every unit stored into every CTA's shared memory (distributed shared
// memory: remote stores do not stall the writer) and one cluster barrier,
// split into arrive and wait; the global stores, and the loads of xw two
// steps ahead (xw does not depend on the carry), are issued after the
// arrive.  h is double-buffered: a CTA stores into buffer (s+1)&1 of a peer
// only after the peer has arrived at step s-1's barrier, which it does
// after reading that buffer.  No atomics and fixed summation orders: two
// launches agree bit for bit.
//
// f32: lstm_fwd_kernel<Rows, KQ>, no tensor cores: f32 FMA, expf and tanhf,
// as _fwd_kernel's f32 accumulation.  The CTA copies W_hh[:, own columns]
// (128 x 64 f32, 32 KB at H=128) into shared memory, and each thread loads
// its part of that slice into registers.  A unit's 4 gates x KQ k-slices
// are 4*KQ neighbouring lanes of a warp (KQ = 4, or 2 where 16u > 256
// threads); lane (unit, gate q, slice kq) holds W_hh[slice kq, column (q,
// unit)].  Per step s:
//   P. the lane dots the Rows rows of h_{s-1} over its k-slice (all H
//      units, in its own shared memory, each slice padded to its own banks
//      and to the register span) with its registers, and the KQ lanes of a
//      gate sum their partials by shuffles (a butterfly: every lane gets
//      the same sum);
//   E. lane kq takes rows kq, kq + KQ, ..: it adds xw (staged), applies its
//      gate's sigmoid or tanh, gathers the unit's 4 activations by
//      shuffles, updates c (kept in a register) and h, and stores h into
//      the next h buffer of C/4 CTAs of the cluster (the 4 gate lanes of a
//      unit share the C stores);
//   -- cluster arrive (release) --  S. h (and c) to global memory; cp.async
//   of xw of step s+2 into shared memory (three buffers; each thread waits
//   for its copies a step later, before the arrive that publishes them) --
//   cluster wait (acquire) --
// The arrive's release publishes the peer stores, and waits for them.  The
// last step's barrier keeps every CTA alive while a peer may still store
// into it.  Rows (batch rows a cluster) and KQ are template parameters; the
// launch plan (ops/cuda/lstm_cell.py::fwd_plan) picks Rows from 2, 4 and 8
// by the batch, so that about two CTAs share each SM, and the launch bounds
// hold a KQ = 4 instance to 64 registers, so that all of them fit the card
// at once (at ~100 registers, 2 rows a cluster at B=32 ran 1.6x slower).
//
// bf16: lstm_fwd_mma_kernel<Rows>, the gate product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulators), as _fwd_kernel runs
// bf16 (under make_cnn_train_step(compute_dtype=bfloat16)): W_hh and xw are
// bf16 values, the carries h and c f32, and only the global stores of h and
// c round to bf16 (__float2bfloat16_rn, as _fwd_kernel's astype).  At the
// production batch (B=128) its function moves 164 MB of bf16 (49 us at
// 3.35 TB/s) and does 14 GFLOP (14 us at 989 TFLOP/s): bound by bytes, and
// by latency, 417 dependent steps.  The f32 form's lanes spent the bf16
// step on f32 FMAs over 8 rows (3.1 of 5.3 us at B=128,
// scripts/torch_lstm_fwd_phases.py); here a tile pair's 8 units x 8 rows x
// all H inputs are 2 x H/16 x kPieces tensor-core products, in two warps.
//   - The CTA's gate columns are the m side, the cluster's batch rows the n
//     side (Rows = 8: one n8 tile), the H inputs the k side.
//     W_hh is bf16, so its A fragments are exact.
//   - h is an f32 carry, and _fwd_kernel's dot takes it whole; a bf16
//     operand holds 8 bits of it.  It enters as kPieces bf16 pieces (p0 =
//     bf16(h), p1 = bf16(h - p0), ...), each product exact, summed in f32
//     in the accumulators: with one piece (h rounded) h and c equal
//     Pallas's on ~77 % of the entries, with two on 99.88-99.91 %, with
//     three on 99.97-99.99 %, as closely as the f32 product does
//     (tests/test_torch_bf16_lstm.py).
//   - The producer splits: each h value is split once, by the lane that
//     computed it, after two shuffles have put it in the B fragments'
//     layout, and its pieces go to the peers as ready B-fragment registers
//     in one 16-byte store a peer; a consumer loads its fragments with
//     16-byte reads and splits nothing (splitting at the consumers would
//     repeat each split in every warp of the cluster that reads it).
//   - The columns are ordered so that a lane's accumulators hold the four
//     gates of one unit for two batch rows.  A tile pair's k-tiles are
//     halved between two warps, which trade the halves of their sums
//     through a mailbox and a named barrier of the two (each then finishes
//     one row): half the products and half the transcendentals a lane on
//     the chain (one warp a pair took 2.83 us a step at B=128, two 2.35).
//   - The slots travel by st.async, which completes their bytes on the
//     receiving CTA's mbarrier of the parity; a CTA waits on its own
//     mbarrier before it reads them.  So the cluster barrier's arrive is
//     relaxed: it releases nothing and does not wait for the peer stores
//     (with a release it took 0.53 us a step more).  It only orders the
//     reuse of the double-buffered slots (every read's value is consumed
//     before the arrive).
//   - xw is loaded into registers two steps ahead, in three buffers taken
//     in turn (the loop is unrolled by three), so that no register of a
//     load is read before the step that uses it: moving the buffers each
//     step waited for the load, 0.59 us a step.
//   - The tiles are padded with W_hh's zeros for any H % 4 == 0 up to 128
//     (u padded to a multiple of 8).  One instance is built, Rows = 8 (one
//     n8 tile), for any B: the clusters are independent, and at B=128 the
//     256 CTAs run in one wave (16 rows, 128 CTAs, measured slower at B=128
//     and B=25).  The launch plan is ops/cuda/lstm_cell.py::fwd_mma_plan.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // threads an f32 CTA; a bf16 CTA has at most twice as many
constexpr int kMaxCluster = 8;   // CTAs a cluster (the portable maximum)
constexpr int kStages = 3;       // xw buffers: staged two steps ahead
constexpr int kMaxHidden = 128;  // the largest H: a k-slice's W_hh in 128 / KQ registers
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

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
  __host__ __device__ FwdLayout(int H, int rows, int cluster, int ksplit) {
    units = H / cluster;
    ncol = 4 * units;
    ldw = 4 * ((units + 1) | 1);
    kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;
    hseg = kMaxHidden / ksplit + 4;
    hrow = ksplit * hseg;
    w = 0;                                          // f32 (H, ldw)
    h = w + sizeof(float) * H * ldw;                // f32 2 x (rows, hrow), by step parity
    xw = h + sizeof(float) * 2 * rows * hrow;       // f32 kStages x (rows, 4u)
    bytes = xw + (sizeof(float) * kStages * rows * ncol + 15) / 16 * 16;
  }
};

template <int Rows, int KQ>
__global__ void __launch_bounds__(kThreads, KQ == 4 ? 4 : 2)
    lstm_fwd_kernel(const float* xw_fwd, const float* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                    const float* xw_bwd, const float* w_hh_bwd,
                    float* __restrict__ h_out,  // (B, T, 2H): forward h, then backward h
                    float* __restrict__ c_out,  // (B, T, 2H) cell state, or null
                    int B, int T, int H, int csize) {
  constexpr int kSpanMax = kMaxHidden / KQ;  // W_hh registers a lane
  constexpr int kLanes = 4 * KQ;             // lanes a unit
  constexpr int kRowsLane = (Rows + KQ - 1) / KQ;
  cg::cluster_group cluster = cg::this_cluster();
  const FwdLayout lay(H, Rows, csize, KQ);
  const int units = lay.units, ncol = lay.ncol, kspan = lay.kspan, hrow = lay.hrow;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem + lay.w);  // W_hh[:, own columns]
  float* h_s = reinterpret_cast<float*>(smem + lay.h);  // h_{s-1} of all units, by parity
  float* xw_s = reinterpret_cast<float*>(smem + lay.xw);  // xw of own columns, by s % kStages

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * units;  // own units [n0, n0 + units); own column lc is
                                // gate lc / units, unit n0 + lc % units
  const bool reverse = blockIdx.y == 1;
  const float* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const float* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
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
  // 4-byte ones.
  const int vec = units % 4 == 0 ? 4 : 1;
  const int per_gate = units / vec;
  auto stage_xw = [&](int s) {
    if (s < T) {
      float* dst = xw_s + (s % kStages) * Rows * ncol;
      const size_t t = time_of(s);
      for (int e = kThreads - 1 - tid; e < Rows * 4 * per_gate; e += kThreads) {
        const int r = e / (4 * per_gate);
        const int g = (e - r * 4 * per_gate) / per_gate;
        const int j = (e - r * 4 * per_gate - g * per_gate) * vec;
        const bool valid = r < rows;
        const float* src = valid ? xw + (static_cast<size_t>(b0 + r) * T + t) * G + g * H + n0 + j
                                : xw;
        float* d = dst + r * ncol + g * units + j;
        if (vec == 4) {
          cp_async16(d, src, valid);
        } else {
          cp_async4(d, src, valid);
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
    w_s[k * lay.ldw + c] = w_hh[static_cast<size_t>(k) * G + g * H + n0 + c - g * units];
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
    const float* xs = xw_s + (s % kStages) * Rows * ncol;
    float* h_next = h_s + ((s + 1) & 1) * Rows * hrow + h_at;
#pragma unroll
    for (int j = 0; j < kRowsLane; ++j) {
      const int r = kq + KQ * j;
      float pre = 0.0f;
#pragma unroll
      for (int rr = 0; rr < Rows; ++rr) pre = rr == r ? acc[rr] : pre;
      if (unit_ok && r < Rows) pre += xs[r * ncol + lc];
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
            h_out[at] = h[j];
          } else if (c_out != nullptr) {
            c_out[at] = c[j];
          }
        }
      }
    }
    stage_xw(s + 2);  // into xw_s[(s+2) % kStages], last read by E of step s-1
    cluster_wait();
  }
}

// ------------------------------------------------------------------ bf16 form
//
// The tensor cores' m16n8k16 product, bf16 operands, f32 accumulators.  Lane
// l = 4 g + tq of a warp holds, two bf16 a register (the lower index in the
// low half):
//   a = {A[g][2tq..+1], A[g+8][2tq..+1], A[g][2tq+8..+9], A[g+8][2tq+8..+9]},
//   b = {B[2tq..+1][g], B[2tq+8..+9][g]},
//   d = {D[g][2tq], D[g][2tq+1], D[g+8][2tq], D[g+8][2tq+1]}.
using bf16 = __nv_bfloat16;

constexpr int kPieces = 3;        // bf16 pieces of the f32 h in the gate product
constexpr int kSlotWords = 4;     // 32-bit words of an h slot: the kPieces pieces, padded to 16 bytes
constexpr int kMmaMaxTiles = 8;   // k-tiles of the gate product at most (padded inputs <= 128)
constexpr int kPairWarps = 2;     // warps of a tile pair: each takes half its k-tiles and one row

static_assert(kPieces <= kSlotWords, "a slot holds every piece of a B-fragment register");

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Shared memory addresses: the CTA's own (shared::cta) and a peer's
// (shared::cluster, by mapa).
__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// The mbarriers that tell a CTA its slots of a step are in: one arrival (the
// CTA's own, which also expects the step's bytes) and the peers'
// st.async completions of those bytes.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the phase of `parity` to complete; traps if it has not after
// ~2^26 polls.  The trap comes in place of a hang, long after the launcher
// has returned: an asynchronous device fault that shows at a later sync and
// leaves the process's CUDA context unusable, not an error the launcher
// reports.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1 << 26)) __trap();
  }
}
// 16 bytes into a peer's shared memory, completing their bytes on the
// peer's mbarrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async16(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
// The cluster barrier's arrive without release: the slots travel by
// st.async and their mbarriers; the barrier orders the reuse of buffers.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
// Waits for the `count` threads of named barrier `id` (1 .. 15).
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared memory of a bf16 CTA, byte offsets.  A CTA's u = H / C units are
// padded to upad, a multiple of 8: a group of 8 units is the m side of a
// tile pair, ugroups = upad / 8 of them.  The gate product's inputs are the
// cluster's units in padded order (C * upad, ktiles tiles of 16; the
// padding's W_hh rows are zero).  h holds, by step parity, a 16-byte slot
// for every (n-tile, k-tile, half of the k-tile, lane): the pieces of that
// lane's B-fragment register, b0 (half 0) or b1 (half 1).  xch holds a
// mailbox of 32 float4 for each warp of each tile pair; bar the two
// mbarriers, by step parity.
struct MmaFwdLayout {
  int units, upad, ugroups, ktiles;
  size_t h, xch, bar, bytes;
  __host__ __device__ MmaFwdLayout(int H, int rows, int cluster) {
    units = H / cluster;
    upad = (units + 7) / 8 * 8;
    ugroups = upad / 8;
    ktiles = cluster * upad / 16;
    h = 0;
    xch = h + slot_bytes(rows) * 2;
    bar = xch + sizeof(float4) * ugroups * (rows / 8) * kPairWarps * 32;
    bytes = bar + 2 * sizeof(uint64_t);
  }
  // The slots of one parity: what every CTA receives a step.
  __host__ __device__ size_t slot_bytes(int rows) const {
    return sizeof(uint32_t) * kSlotWords * (rows / 8) * ktiles * 2 * 32;
  }
  __host__ __device__ int threads(int rows) const { return 32 * ugroups * (rows / 8) * kPairWarps; }
};

// The bf16 sweep on the tensor cores.  The cluster and the ownership of
// units are lstm_fwd_kernel's.  A tile pair (unit group j: own units 8j ..
// 8j+7; n-tile nt: the cluster's batch rows 8nt .. 8nt+7) takes two warps,
// warp ks of them half the k-tiles.  Its two m16 tiles hold W_hh's columns
// of those units as A fragments, loaded once, at launch, into registers:
// tile 0 gates i (rows 0-7) and f (rows 8-15), tile 1 gates g and o.  So
// the accumulators of lane (g, tq) hold all four gates of unit 8j + g for
// batch rows 8nt + 2tq and + 1.  Per step s:
//   W. wait for the slots of parity s & 1 (their mbarrier; step 0's are
//      zero);
//   P. 2 tiles x its k-tiles x kPieces products, an accumulator a (tile,
//      piece), summed from the last piece up; the two warps trade the
//      halves of their sums (a mailbox and a named barrier of the pair):
//      warp ks keeps row 2tq + ks, whole;
//   E. xw (in registers, loaded two steps ahead) added, the gates' sigmoid
//      and tanh, c (a register) and h of the lane's row;
//   X. h gathered by two shuffles into the B fragments' layout (row,
//      units), split into kPieces bf16 pieces (p0 = bf16(h), p1 = bf16(h -
//      p0), ..), and sent by one 16-byte st.async into slot (nt, k-tile and
//      half of the group's units, lane) of parity (s + 1) & 1 of every CTA
//      of the cluster, completing on that CTA's mbarrier of the parity;
//   -- cluster arrive (relaxed) --
//   S. h (p0) and c (rounded) to global memory, xw of step s + 2 into
//      registers;
//   -- cluster wait --
// The slots carry their own completion, so the barrier's arrive releases
// nothing and does not wait for the peer stores; the barrier only keeps a
// CTA from writing a parity's slots of a peer before the peer has read
// them two steps back (every read's value is consumed before the arrive).
template <int Rows>
__global__ void __launch_bounds__(kPairWarps * kThreads)
    lstm_fwd_mma_kernel(const bf16* xw_fwd, const bf16* w_hh_fwd,  // (B, T, 4H), (H, 4H)
                        const bf16* xw_bwd, const bf16* w_hh_bwd,
                        bf16* __restrict__ h_out,  // (B, T, 2H): forward h, then backward h
                        bf16* __restrict__ c_out,  // (B, T, 2H) cell state, or null
                        int B, int T, int H, int csize) {
  constexpr int kN = Rows / 8;                       // n8 tiles
  constexpr int kTiles = kMmaMaxTiles / kPairWarps;  // A fragments a warp keeps of each tile
  cg::cluster_group cluster = cg::this_cluster();
  const MmaFwdLayout lay(H, Rows, csize);
  const int units = lay.units, upad = lay.upad, ktiles = lay.ktiles;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* h_s = reinterpret_cast<uint4*>(smem + lay.h);         // slots, by parity
  float4* xch_s = reinterpret_cast<float4*>(smem + lay.xch);   // the pairs' mailboxes
  const uint32_t bar = cta_addr(smem + lay.bar);               // mbarrier of parity p at bar + 8p

  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = rank * units;  // own units [n0, n0 + units)
  const bool reverse = blockIdx.y == 1;
  const bf16* __restrict__ xw = reverse ? xw_bwd : xw_fwd;
  const bf16* __restrict__ w_hh = reverse ? w_hh_bwd : w_hh_fwd;
  const int G = 4 * H;
  const int ldh = 2 * H;
  const int off = blockIdx.y * H;
  const int b0 = (blockIdx.x / csize) * Rows;
  const int rows = min(Rows, B - b0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int ks = warp % kPairWarps, pair = warp / kPairWarps;
  const int grp = pair % lay.ugroups, nt = pair / lay.ugroups;
  const int m = grp * 8 + g;      // this lane's own unit (padding where m >= units)
  const int r0 = nt * 8 + 2 * tq;  // the accumulators' batch rows r0 and r0 + 1 of the cluster's
  const int r = r0 + ks;           // the row whose c and h this lane carries
  const int kp = rank * upad + grp * 8;  // the group's units as padded inputs
  const int own_slot = (kp / 16) * 2 + (kp / 8) % 2;  // their k-tile and half
  const int kt_n = ktiles / kPairWarps, kt0 = ks * kt_n;  // this warp's k-tiles
  const uint32_t step_bytes = static_cast<uint32_t>(lay.slot_bytes(Rows));
  const bf16 zero = __ushort_as_bfloat16(0);
  auto time_of = [&](int s) { return reverse ? T - 1 - s : s; };

  // W_hh[input of padded index kpad, column of gate q of own unit mu], zero
  // on the padding.
  auto w_at = [&](int kpad, int q, int mu) -> bf16 {
    const int src = kpad / upad, k = kpad - src * upad;
    if (k >= units || mu >= units || src >= csize) return zero;
    return w_hh[static_cast<size_t>(src * units + k) * G + q * H + n0 + mu];
  };
  uint32_t a[2][kTiles][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const bool on = i < kt_n;
      const int k = (kt0 + i) * 16 + 2 * tq;
      const int qa = 2 * t, qb = 2 * t + 1;  // gates of rows g and g + 8
      a[t][i][0] = on ? pack_bf16(w_at(k, qa, m), w_at(k + 1, qa, m)) : 0u;
      a[t][i][1] = on ? pack_bf16(w_at(k, qb, m), w_at(k + 1, qb, m)) : 0u;
      a[t][i][2] = on ? pack_bf16(w_at(k + 8, qa, m), w_at(k + 9, qa, m)) : 0u;
      a[t][i][3] = on ? pack_bf16(w_at(k + 8, qb, m), w_at(k + 9, qb, m)) : 0u;
    }
  }

  // xw of step s for the lane's row and unit, its 4 gates (zero past the
  // end, for a padding unit and for a row past the batch).
  auto load_x = [&](int s, bf16 (&x)[4]) {
    const bool on = s < T && m < units && r < rows;
    const bf16* src =
        on ? xw + (static_cast<size_t>(b0 + r) * T + time_of(s)) * G + n0 + m : xw;
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = on ? src[q * H] : zero;
  };

  // Set-up: zero the slots and mailboxes, initialise the mbarriers and arm
  // parity 1's for step 1; xw of steps 0 and 1.
  for (size_t e = tid; e < lay.bar / 16; e += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect(bar + 8, step_bytes);
  }
  // Every CTA of the cluster is running, has zeroed its slots and has its
  // mbarriers initialised before any peer sends it a slot.
  cluster.sync();
  // This lane's slot in each CTA it sends to (the lanes of a warp's two
  // halves form the same 16 registers and send to alternate CTAs), and that
  // CTA's mbarriers.
  const int first_peer = lane >> 4;
  uint32_t peer_base[kMaxCluster / 2];
#pragma unroll
  for (int i = 0; i < kMaxCluster / 2; ++i) {
    const int p = first_peer + 2 * i;
    peer_base[i] = p < csize ? peer_addr(cta_addr(smem), p) : 0u;
  }
  const int a4 = (lane & 15) >> 2, tc = lane & 3;
  const int to_lane = 4 * (2 * a4 + ks) + tc;  // row 8nt + 2a4 + ks of units 2tc, 2tc + 1
  const uint32_t slot_off = static_cast<uint32_t>(
      lay.h + sizeof(uint4) * ((static_cast<size_t>(nt) * ktiles * 2 + own_slot) * 32 + to_lane));

  float c = 0.0f;
  // Step s with xw of step s in x_now; loads xw of step s + 2 into x_later.
  auto step = [&](int s, const bf16 (&x_now)[4], bf16 (&x_later)[4]) {
    // W: the slots of this step are in.
    if (s > 0) mbar_wait(bar + 8 * (s & 1), ((s - 1) >> 1) & 1);
    if (tid == 0 && s > 0 && s + 1 < T) mbar_expect(bar + 8 * ((s + 1) & 1), step_bytes);

    // P: the gates' products of rows r0, r0 + 1 (accumulators' layout) over
    // this warp's k-tiles.
    const uint4* hb = h_s + ((s & 1) * kN + nt) * ktiles * 2 * 32 + lane;
    float acc[2][kPieces][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int p = 0; p < kPieces; ++p) acc[t][p][0] = acc[t][p][1] = acc[t][p][2] = acc[t][p][3] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      if (i < kt_n) {
        const uint4 lo = hb[(2 * (kt0 + i)) * 32];
        const uint4 hi = hb[(2 * (kt0 + i) + 1) * 32];
        const uint32_t b0p[4] = {lo.x, lo.y, lo.z, lo.w};
        const uint32_t b1p[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          mma_bf16(acc[0][p], a[0][i], b0p[p], b1p[p]);
          mma_bf16(acc[1][p], a[1][i], b0p[p], b1p[p]);
        }
      }
    }
    float pre[2][4];  // [tile][row r0 gate lo, row r0 + 1 gate lo, row r0 gate hi, row r0 + 1 gate hi]
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[t][kPieces - 1][j];
#pragma unroll
        for (int p = kPieces - 2; p >= 0; --p) v += acc[t][p][j];
        pre[t][j] = v;
      }
    }
    // Warp ks keeps row r0 + ks and gives the other row's sums (gates i, f,
    // g, o) to its partner, through the pair's mailbox.
    const float4 row0 = make_float4(pre[0][0], pre[0][2], pre[1][0], pre[1][2]);
    const float4 row1 = make_float4(pre[0][1], pre[0][3], pre[1][1], pre[1][3]);
    float4* box = xch_s + pair * kPairWarps * 32;
    box[(1 - ks) * 32 + lane] = ks == 0 ? row1 : row0;
    named_barrier(1 + pair, 32 * kPairWarps);
    const float4 other = box[ks * 32 + lane];
    const float4 mine = ks == 0 ? row0 : row1;

    // E: row r of unit m.
    const float gi = sigmoid_f(mine.x + other.x + __bfloat162float(x_now[0]));
    const float gf = sigmoid_f(mine.y + other.y + __bfloat162float(x_now[1]));
    const float gg = tanhf(mine.z + other.z + __bfloat162float(x_now[2]));
    const float go = sigmoid_f(mine.w + other.w + __bfloat162float(x_now[3]));
    c = gf * c + gi * gg;
    const float hv = go * tanhf(c);

    // X: row 8nt + 2a4 + ks of units 2tc, 2tc + 1 (lanes 4 (2tc) + a4 and
    // 4 (2tc + 1) + a4), the B-fragment register of lane to_lane, in pieces,
    // to every CTA's slot of the next step.
    if (s + 1 < T) {
      float lo = __shfl_sync(kAll, hv, 4 * (2 * tc) + a4);
      float hi = __shfl_sync(kAll, hv, 4 * (2 * tc + 1) + a4);
      uint32_t word[kSlotWords] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // low, high half
        lo -= __low2float(v);
        hi -= __high2float(v);
        word[p] = *reinterpret_cast<const uint32_t*>(&v);
      }
      const uint4 slot = make_uint4(word[0], word[1], word[2], word[3]);
      const uint32_t parity = (s + 1) & 1;
      const uint32_t at = slot_off + static_cast<uint32_t>(parity * lay.slot_bytes(Rows));
      const uint32_t bar_at = static_cast<uint32_t>(lay.bar + 8 * parity);
#pragma unroll
      for (int i = 0; i < kMaxCluster / 2; ++i) {
        if (first_peer + 2 * i < csize) st_async16(peer_base[i] + at, slot, peer_base[i] + bar_at);
      }
    }

    cluster_arrive_relaxed();  // this step's slots are read
    // Off the chain: the global stores and loads come after the arrive.
    if (m < units && r < rows) {
      const size_t at = (static_cast<size_t>(b0 + r) * T + time_of(s)) * ldh + off + n0 + m;
      h_out[at] = __float2bfloat16_rn(hv);
      if (c_out != nullptr) c_out[at] = __float2bfloat16_rn(c);
    }
    load_x(s + 2, x_later);
    cluster_wait();  // every peer has read this step's slots
  };
  // Three xw buffers in turn, so that no register of a load is read (or
  // moved) before the step that uses it, two steps later.
  bf16 xa[4], xb[4], xc[4];
  load_x(0, xa);
  load_x(1, xb);
  for (int s = 0; s < T; s += 3) {
    step(s, xa, xc);
    if (s + 1 < T) step(s + 1, xb, xa);
    if (s + 2 < T) step(s + 2, xc, xb);
  }
}

template <int Rows, int KQ>
cudaError_t launch_plan(const float* xw_fwd, const float* w_hh_fwd, const float* xw_bwd,
                        const float* w_hh_bwd, float* h_out, float* c_out, int B, int T, int H,
                        int cluster, int groups, cudaStream_t stream) {
  auto kernel = lstm_fwd_kernel<Rows, KQ>;
  const size_t smem = FwdLayout(H, Rows, cluster, KQ).bytes;
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
  return cudaLaunchKernelEx(&config, kernel, xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B,
                            T, H, cluster);
}

template <int KQ>
cudaError_t launch_rows(int rows, const float* xw_fwd, const float* w_hh_fwd, const float* xw_bwd,
                        const float* w_hh_bwd, float* h_out, float* c_out, int B, int T, int H,
                        int cluster, int groups, cudaStream_t stream) {
  switch (rows) {
    case 2:
      return launch_plan<2, KQ>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B, T, H,
                                cluster, groups, stream);
    case 4:
      return launch_plan<4, KQ>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B, T, H,
                                cluster, groups, stream);
    case 8:
      return launch_plan<8, KQ>(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out, B, T, H,
                                cluster, groups, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

using FwdMmaKernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, bf16*,
                              int, int, int, int);

// The bf16 kernel's instance for a plan, with its dynamic shared memory set
// and its launch configuration (grid (cluster * groups, 2) in clusters of
// `cluster`, 2 warps a tile pair), or cudaErrorInvalidValue for a plan it
// cannot run.  `attr` backs config->attrs.
cudaError_t fwd_mma_config(int B, int H, int rows, int cluster, int groups, cudaStream_t stream,
                           FwdMmaKernel* kernel, cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr) {
  if (B < 1 || H < 4 || H > kMaxHidden || H % 4 != 0 || cluster < 1 || cluster > kMaxCluster ||
      H % cluster != 0 || groups < 1) {
    return cudaErrorInvalidValue;
  }
  if (rows != 8) return cudaErrorInvalidValue;
  *kernel = lstm_fwd_mma_kernel<8>;
  const MmaFwdLayout lay(H, rows, cluster);
  if (lay.ktiles * 16 != cluster * lay.upad || lay.ktiles > kMmaMaxTiles ||
      lay.ktiles % kPairWarps != 0 || lay.threads(rows) > kPairWarps * kThreads ||
      lay.ugroups * rows / 8 > 15 || static_cast<long long>(groups) * rows < B ||
      static_cast<long long>(groups - 1) * rows >= B) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return err;
  *config = {};
  config->gridDim = dim3(cluster * groups, 2, 1);
  config->blockDim = dim3(lay.threads(rows), 1, 1);
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

}  // namespace

// Dynamic shared memory, in bytes, of one f32 lstm_fwd CTA.
extern "C" int lstm_fwd_smem_bytes(int H, int rows, int cluster, int ksplit) {
  return static_cast<int>(FwdLayout(H, rows, cluster, ksplit).bytes);
}

// Launches the f32 forward sweep of (xw_fwd, w_hh_fwd) and the backward sweep
// of (xw_bwd, w_hh_bwd) on `stream` into h_out (B, T, 2H) and, unless it is
// null, c_out (B, T, 2H).  The plan: `groups` clusters of `cluster` CTAs a
// direction, each running `rows` batch rows (rows in {2, 4, 8}, groups =
// ceil(B / rows)), each gate's product split into `ksplit` k-slices (4, or
// 2 where 16 H / cluster > kThreads).  Returns the CUDA error as an int (0 =
// launched); cudaErrorInvalidValue, launching nothing, for a plan the kernel
// cannot run.  Pointers are device pointers to contiguous f32 arrays, xw
// aligned to the copies that stage it (16 bytes always do); the caller
// checks shapes.
extern "C" int lstm_fwd_launch(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                               const void* w_hh_bwd, void* h_out, void* c_out, int B, int T,
                               int H, int rows, int cluster, int ksplit, int groups,
                               void* stream) {
  if (B < 1 || T < 1 || H < 4 || H > kMaxHidden || H % 4 != 0 || cluster < 1 ||
      cluster > kMaxCluster || H % cluster != 0 || (ksplit != 2 && ksplit != 4) ||
      4 * ksplit * (H / cluster) > kThreads || groups < 1 ||
      static_cast<long long>(groups) * rows < B ||
      static_cast<long long>(groups - 1) * rows >= B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The alignment of xw that its staging copies need.
  const int align = (H / cluster) % 4 == 0 ? 16 : 4;
  const auto misaligned = [align](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % align != 0;
  };
  if (misaligned(xw_fwd) || misaligned(xw_bwd)) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      ksplit == 4 ? launch_rows<4>(rows, f(xw_fwd), f(w_hh_fwd), f(xw_bwd), f(w_hh_bwd),
                                   static_cast<float*>(h_out), static_cast<float*>(c_out), B, T,
                                   H, cluster, groups, st)
                  : launch_rows<2>(rows, f(xw_fwd), f(w_hh_fwd), f(xw_bwd), f(w_hh_bwd),
                                   static_cast<float*>(h_out), static_cast<float*>(c_out), B, T,
                                   H, cluster, groups, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory, in bytes, of one bf16 CTA (lstm_fwd_mma_kernel).
extern "C" int lstm_fwd_mma_smem_bytes(int H, int rows, int cluster) {
  return static_cast<int>(MmaFwdLayout(H, rows, cluster).bytes);
}

// Launches the bf16 sweeps on the tensor cores: the arguments of
// lstm_fwd_launch in bf16, without ksplit (each tile pair's k-tiles are
// halved between its two warps).  `rows` batch rows a cluster: 8, one n8
// tile (the one instance built).  Returns the CUDA error as an int; cudaErrorInvalidValue
// (1), launching nothing, for a plan the kernel cannot run.  Pointers are
// device pointers to contiguous bf16 arrays.
extern "C" int lstm_fwd_mma_launch(const void* xw_fwd, const void* w_hh_fwd, const void* xw_bwd,
                                   const void* w_hh_bwd, void* h_out, void* c_out, int B, int T,
                                   int H, int rows, int cluster, int groups, void* stream) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  FwdMmaKernel kernel;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = fwd_mma_config(B, H, rows, cluster, groups, static_cast<cudaStream_t>(stream),
                                   &kernel, &config, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const bf16*>(xw_fwd),
                           static_cast<const bf16*>(w_hh_fwd), static_cast<const bf16*>(xw_bwd),
                           static_cast<const bf16*>(w_hh_bwd), static_cast<bf16*>(h_out),
                           static_cast<bf16*>(c_out), B, T, H, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of the bf16 kernel's configuration for this plan that the
// card can hold at once (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error.
extern "C" int lstm_fwd_mma_max_clusters(int H, int rows, int cluster) {
  FwdMmaKernel kernel;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = fwd_mma_config(rows, H, rows, cluster, 1, nullptr, &kernel, &config, attr);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &config);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
