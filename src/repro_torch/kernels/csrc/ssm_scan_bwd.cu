// Backward of the selective scan (Mamba1) for Hopper (sm_90a): the gradient
// of every Mamba1 layer's scan in a training step.
//
// The TPU kernel `ssm_scan` (src/repro/kernels/ssm_scan.py:48) has no
// backward: the JAX package trains through XLA's derivative of the jnp scan
// in src/repro/models/ssm.py::selective_scan (:74).  This kernel computes
// that derivative.  With a_t = exp(dt_t A), h_t = a_t h_{t-1} + dt_t x_t B_t
// and y_t = h_t . C_t, for the upstream gradients dy (Bsz,S,D) and dh_final
// (Bsz,D,N) it runs the reverse recurrence g_t = dy_t C_t + a_{t+1} g_{t+1}
// from g = dh_final and gives
//   dx_t = dt_t sum_n g_t B_t,   ddt_t = sum_n g_t (A a_t h_{t-1} + x_t B_t),
//   dB_t = sum_d g_t dt_t x_t,   dC_t = sum_d h_t dy_t,
//   dA = sum_{b,t} g_t dt_t a_t h_{t-1},   dh0 = a_0 g_0,
// all float32 (the model widens the scan's inputs to float32).  Its plain
// version is src/repro_torch/kernels/ref.py::ssm_scan_backward.
//
// Work split.  A thread holds R = 4 states of one channel, G = 1, 2, 4 or
// 8 adjacent lanes a channel's N <= 32 states, and a block CPB = 64
// channels (32 at G = 8) of one batch row.  The reverse recurrence needs
// h_{t-1} at every step; the forward kernel (ssm_scan.cu) keeps `states`,
// the state before every chunk of CH = 16 steps (134 MB at 2 x 2048 x 8192
// x 16), and the chunks run in reverse: each recomputes its 16 steps from
// its state with the forward's exact operations, keeping a_t and h_{t-1}
// of every step in registers (128 a thread: the chunk's loops are
// unrolled), then steps g backward through them.
//
// The design answers what this kernel's first version (1.85 ms at
// 2 x 2048 x 8192, 10 % of its bound) measured when each of its costs was
// taken out on the card (scan_bwd_causes.py first): its synchronous
// staging 0.47 ms, its 28 shuffles a thread and step 0.32 ms, its own
// forward pass 0.32 ms, its three exps a state-step 0.07 ms, its partials'
// stores 0.01 ms and torch sums 0.06 ms.  So:
//   - no forward pass: the chunks start from the forward kernel's states;
//   - one exp a state-step: the recompute keeps a_t, the backward reads it;
//   - the next chunk (in reverse) of x, dt, dy, B, C and its state is
//     staged with cp.async into the other half of a double buffer while
//     the current one runs, one __syncthreads() a chunk;
//   - a reduce-scatter, not a butterfly, as the forward reduces y: each
//     step a lane's 8 terms of dB_t and dC_t become one sum over the
//     warp's channels in 3 rounds (7 shuffles; a butterfly takes 24), and
//     a channel's sum_n g B and sum_n A q one each over its G lanes in 2
//     rounds (2 shuffles, against 4).  The rounds run from the lowest lane
//     bit up, which pairs the lanes as the first version's butterfly did:
//     dx and ddt keep its bits.  Rounds from the highest bit gave them
//     other last bits, and 4 training steps of falcon-mamba-7b then read
//     2.7e-3 from the plain scan's losses against TRAIN_TRAJ_TOL's 1e-3
//     (chip_smoke.py 11f; 5.0e-4 in this order).  At the chunk's end the
//     block sums its warps in a fixed order and writes one partial per
//     block, (ceil(D / 64), Bsz, S, N), half the first version's; a
//     second kernel sums them over the blocks (and dA over the batch) in
//     a fixed order: no float atomics, so two launches give the same bits.
//
// What bounds it.  Each input read once and each output written once is
// x, dt, dy, dx, ddt (134 MB each at 2 x 2048 x 8192 float32) and the
// states: 0.24 ms at 3.35 TB/s.  The kernel takes 0.88 ms there
// (scan_bwd_causes.py redesign, an H100 at 700 W): the history's 209-225
// registers a thread leave one block of 8 warps a SM (256 blocks: two
// waves), which issue the unrolled chunk (most of the kernel's 2,168
// instructions) on roughly half their cycles (instructions run over the
// time taken).  Taking out the reduce-scatters measured 0.65 ms, all the
// sums 0.54, the exps 0.87, the stores 0.86.  Chunks of 8 steps (a
// smaller history) ran 1.00 ms, blocks of 32 channels (two a SM) 0.94;
// in earlier revisions a_t kept in shared memory to fit 12 warps a SM ran
// 1.19, and the sums through a per-warp shared-memory exchange 1.0-1.1:
// the latency that 8 warps leave unhidden, not the issue rate, holds it.
//
// Numbers.  The exp and the state update are the forward kernel's:
// ex2.approx on dt * (A log2 e), and __fmul_rn/__fadd_rn, so the recomputed
// h equals the forward's bit for bit.  The sums over lanes, channels,
// warps and blocks are taken in a fixed order for a given N and D.

#include "simt.cuh"

#include <atomic>
#include <cstddef>

namespace {

using simt::cp_async4;
using simt::cp_async_commit;
using simt::cp_async_wait;

constexpr int R = 4;           // states of one thread
constexpr int CH = 16;         // time steps of one chunk (ssm_scan.cu's SCH)
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one block, in floats; every section a multiple of 4.
template <int G>
struct Bwd {
  static constexpr int CPB = G == 8 ? 32 : 64;    // channels of one block
  static constexpr int THREADS = CPB * G;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int CW = 32 / G;               // channels of one warp
  static constexpr int NP = G * R;                // states padded to lanes
  // staging, one half of the double buffer: x, dt and dy as
  // [channel][step] rows of CHP (16-byte aligned), B and C as [step][NP],
  // and the chunk's state, R floats a thread
  static constexpr int CHP = CH + 4;
  static constexpr int ROW = CPB * CHP;
  static constexpr int BC = CH * NP;
  static constexpr int HST = 3 * ROW + 2 * BC;
  static constexpr int HALF = HST + THREADS * R;
  // the chunk's two per-channel sums, [CPB][DSP] each, the second at SQ
  // (16 floats past the first's end, so that the lanes writing one and
  // the other fall on other banks); each warp's dB and dC, [CH][NP] each,
  // dC at WQ (16 floats past dB's end, likewise)
  static constexpr int DSP = CH + 1;
  static constexpr int SQ = CPB * DSP + 16;
  static constexpr int SUMS = SQ + CPB * DSP;
  static constexpr int WQ = CH * NP + 16;
  static constexpr int WPART = 2 * WQ;
  static constexpr size_t BYTES =
      sizeof(float) * (2 * HALF + SUMS + WARPS * WPART);
  static constexpr int X_ELEMS = CH * CPB / THREADS;  // a thread's copies
  static constexpr int B_ELEMS = (BC + THREADS - 1) / THREADS;  // x's, B's
  static_assert(CW * G == 32 && (CH * CPB) % THREADS == 0 &&
                    (2 * CH * NP) % THREADS == 0,
                "even split");
  static_assert(HALF % 4 == 0 && SUMS % 4 == 0 &&
                    ROW % 4 == 0 && BC % 4 == 0,
                "16-byte aligned sections");
};

// 2^v on the SFU (MUFU.EX2), as ssm_scan.cu computes it
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A reduce-scatter over the lanes of a warp that differ in the bits M,
// 2 M, ..., HI: each holds L values v[0..L); a round keeps the half of
// them that the lane's bit selects and adds its partner's copy of that
// half, so each lane ends with the sum of L / 2^rounds of them; once one
// is left, a round adds the partner's (a butterfly).  The rounds run from
// the lowest bit up, so each sum pairs its lanes as a butterfly from the
// lowest bit does (the first version's order, and so dx and ddt's bits).
template <int M, int HI, int L, int K>
__device__ __forceinline__ void reduce_lanes(float (&v)[K], int lane) {
  if constexpr (M <= HI) {
    if constexpr (L > 1) {
      constexpr int W = L / 2;
      const bool up = lane & M;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float send = up ? v[k] : v[k + W];
        const float keep = up ? v[k + W] : v[k];
        v[k] = keep + __shfl_xor_sync(kFull, send, M);
      }
      reduce_lanes<M * 2, HI, W>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], M);
      reduce_lanes<M * 2, HI, 1>(v, lane);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(Bwd<G>::THREADS, 1)
    ssm_scan_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ A,
                        const float* __restrict__ states,
                        const float* __restrict__ dy,
                        const float* __restrict__ dh_final,
                        float* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ dB_part,
                        float* __restrict__ dC_part,
                        float* __restrict__ dA_part, float* __restrict__ dh0,
                        int S, int D, int N) {
  using P = Bwd<G>;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                          // [2][HALF]
  float* sums = stage + 2 * P::HALF;            // [CPB][DSP], at SQ again
  float* wpart = sums + P::SUMS;                // [WARPS][WPART]

  const unsigned tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = tid / G;              // this thread's channel in the block
  const int g = tid % G;              // and its lane in the channel
  const int cw = lane / G;            // its channel in the warp
  const int d0 = blockIdx.x * P::CPB;
  const int d = d0 + c;
  const size_t b = blockIdx.y;
  const int chunks = (S + CH - 1) / CH;

  // this thread's states n = g*R + r; a state past N or a channel past D
  // has A = 0 and B = C = x = dt = dy = 0, so its h and g stay 0
  bool owns[R];
  float Ar[R], a2[R], gn[R], dA[R];   // gn is a_{t+1} g_{t+1}
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = g * R + r;
    owns[r] = d < D && n < N;
    Ar[r] = owns[r] ? A[static_cast<size_t>(d) * N + n] : 0.0f;
    a2[r] = __fmul_rn(Ar[r], kLog2e);
    gn[r] = (owns[r] && dh_final != nullptr)
                ? dh_final[(b * D + d) * N + n] : 0.0f;
    dA[r] = 0.0f;
  }
  auto state_at = [&](int k, int r) {
    return ((b * chunks + k) * D + d) * N + g * R + r;
  };

  // One thread's share of a chunk's staging: element i of x, dt and dy is
  // step xs0 + G * i of channel d0 + xc, element i of B and C is
  // tid + i * THREADS of the chunk's [step][NP], and its own R states of
  // the chunk's first state; zeros past S, D and N.
  // The chunk's dx and ddt are written back with the same map.
  const int xc = tid % P::CPB, xs0 = tid / P::CPB;
  const bool x_ok = d0 + xc < D;
  const size_t x_at = (b * S + xs0) * D + d0 + xc;   // element 0 at t0 = 0
  const size_t x_step = static_cast<size_t>(G) * D;  // to element i + 1
  auto issue = [&](float* half, int t0) {
    const size_t at0 = x_at + static_cast<size_t>(t0) * D;
#pragma unroll
    for (int i = 0; i < P::X_ELEMS; ++i) {
      const bool ok = x_ok && t0 + xs0 + G * i < S;
      const size_t at = at0 + i * x_step;
      float* dst = half + xc * P::CHP + xs0 + G * i;
      cp_async4(dst, x + at, ok);
      cp_async4(dst + P::ROW, dt + at, ok);
      cp_async4(dst + 2 * P::ROW, dy + at, ok);
    }
#pragma unroll
    for (int i = 0; i < P::B_ELEMS; ++i) {
      const unsigned e = tid + i * P::THREADS;
      if (P::BC % P::THREADS != 0 && e >= P::BC) break;
      const int s = e / P::NP, n = e % P::NP;
      const bool ok = n < N && t0 + s < S;
      const size_t at = (b * S + t0 + s) * N + n;
      float* dst = half + 3 * P::ROW + e;
      cp_async4(dst, Bm + at, ok);
      cp_async4(dst + P::BC, Cm + at, ok);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cp_async4(half + P::HST + tid * R + r,
                states + state_at(t0 / CH, r), owns[r]);
    }
  };

  if (chunks > 0) {
    issue(stage + ((chunks - 1) & 1) * P::HALF, (chunks - 1) * CH);
    cp_async_commit();
  }
  const size_t part_row = (static_cast<size_t>(blockIdx.x) * gridDim.y + b) *
                          static_cast<size_t>(S);
  // Where this lane's sums land.  dB and dC: the warp's 2 NP outputs of
  // a step, after the reduce-scatter over its channels (see
  // reduce_lanes): rounds on channel bits 0, 1, 2 pick bits 2, 1, 0 of the
  // index of the term the lane keeps, (q, r) = index >> 2, index & 3 of
  // its lane's states; at CW = 4 two rounds leave two terms (index bit 0 =
  // j), and above 8 the lanes of channels cw < 8 write.  sum_n g B and
  // sum_n A q: the channel's lanes g = 0 and 1 (its one lane at G = 1)
  // write one each.
  constexpr int PER = P::CW < 8 ? 8 / P::CW : 1;     // terms left a lane
  const int index = ((cw & 1) << 2) | ((cw & 2) >> 1 << 1) |
                    (P::CW < 8 ? 0 : (cw & 4) >> 2);
  float* const term_out = wpart + warp * P::WPART + (index >> 2) * P::WQ +
                          g * R + (index & 3);
  const bool term_writes = P::CW <= 8 || cw < 8;
  float* const sum_out = sums + (g & 1) * P::SQ + c * P::DSP;
  const bool sum_writes = g < 2;

  for (int k = chunks - 1; k >= 0; --k) {
    cp_async_wait<0>();
    // chunk k is visible to all, and every thread is done with chunk k+1:
    // its staging half, which the next issue overwrites, and the sums
    __syncthreads();
    const int t0 = k * CH;
    if (k > 0) issue(stage + ((k - 1) & 1) * P::HALF, t0 - CH);
    cp_async_commit();

    const float* half = stage + (k & 1) * P::HALF;
    const float4 h4 = *reinterpret_cast<const float4*>(half + P::HST +
                                                       tid * R);
    float h[R] = {h4.x, h4.y, h4.z, h4.w};   // the state before the chunk
    const float* xs = half + c * P::CHP;          // this channel's rows
    const float* dts = xs + P::ROW;
    const float* dys = dts + P::ROW;
    const float* bs = half + 3 * P::ROW + g * R;  // this thread's states
    const float* cs = bs + P::BC;
    // 4 steps of a channel's row: one 16-byte read
    auto four = [](const float* row, int s0, float (&v)[4]) {
      const float4 q = *reinterpret_cast<const float4*>(row + s0);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    };

    // the chunk forward, as ssm_scan.cu steps it; steps past S are zeros
    // (dt = 0: a = 1, and h stays as it is).  ah and hh keep a_t and
    // h_{t-1} of each step.
    float ah[CH][R], hh[CH][R];
#pragma unroll
    for (int s0 = 0; s0 < CH; s0 += 4) {
      float dt4[4], x4[4];
      four(dts, s0, dt4);
      four(xs, s0, x4);
#pragma unroll
      for (int s = s0; s < s0 + 4; ++s) {
        const float dtv = dt4[s - s0];
        const float dtx = __fmul_rn(dtv, x4[s - s0]);
        const float4 bv = *reinterpret_cast<const float4*>(bs + s * P::NP);
        const float bb[R] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          ah[s][r] = exp2_approx(__fmul_rn(dtv, a2[r]));
          hh[s][r] = h[r];
          h[r] = __fadd_rn(__fmul_rn(ah[s][r], h[r]),
                           __fmul_rn(dtx, bb[r]));
        }
      }
    }

    // the chunk backward; steps past S leave g as it is and add nothing
    // that is stored.  Step s's inputs, then its terms: this channel's dB_t
    // and dC_t terms (pb, pc), sum_n g B and sum_n A (g a h_{t-1}) (sgb,
    // saq)
    struct In {
      float dtv, xv, dyv;
      float4 bv, cv;
    };
    float dt4[4], x4[4], dy4[4];      // the group of 4 steps of step s
    auto load_step = [&](int s, In& in) {
      if (s % 4 == 3) {
        four(dts, s - 3, dt4);
        four(xs, s - 3, x4);
        four(dys, s - 3, dy4);
      }
      in.dtv = dt4[s % 4];
      in.xv = x4[s % 4];
      in.dyv = dy4[s % 4];
      in.bv = *reinterpret_cast<const float4*>(bs + s * P::NP);
      in.cv = *reinterpret_cast<const float4*>(cs + s * P::NP);
    };
    // Each step reads the next step's inputs before it writes its sums, so
    // the reads do not wait on the writes.
    In in;
    load_step(CH - 1, in);
#pragma unroll
    for (int s = CH - 1; s >= 0; --s) {
      const float dtx = __fmul_rn(in.dtv, in.xv);
      const float bb[R] = {in.bv.x, in.bv.y, in.bv.z, in.bv.w};
      const float cc[R] = {in.cv.x, in.cv.y, in.cv.z, in.cv.w};
      const float dtv = in.dtv, dyv = in.dyv;
      float terms[2 * R];             // pb, then pc
      float sums2[2] = {0.0f, 0.0f};  // sgb, saq
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ht = s == CH - 1 ? h[r] : hh[s + 1][r];
        const float gt = fmaf(dyv, cc[r], gn[r]);
        const float ga = gt * ah[s][r];
        const float q = ga * hh[s][r];
        dA[r] = fmaf(dtv, q, dA[r]);
        sums2[1] = fmaf(Ar[r], q, sums2[1]);
        sums2[0] = fmaf(gt, bb[r], sums2[0]);
        terms[R + r] = ht * dyv;
        terms[r] = gt * dtx;
        gn[r] = ga;
      }
      if (s > 0) load_step(s - 1, in);
      // dB_t and dC_t over the warp's channels (the lane bits from G up)
      reduce_lanes<G, 16, 2 * R>(terms, lane);
      if (term_writes) {
#pragma unroll
        for (int j = 0; j < PER; ++j) term_out[s * P::NP + j] = terms[j];
      }
      // the channel's two sums over its G lanes
      reduce_lanes<1, G / 2, 2>(sums2, lane);
      if constexpr (G == 1) {
        sum_out[s] = sums2[0];
        sum_out[P::SQ + s] = sums2[1];
      } else if (sum_writes) {
        sum_out[s] = sums2[0];
      }
    }
    __syncthreads();

    // the chunk's dx and ddt (the staging's elements), and its dB and dC
    // summed over the warps
    const int steps = min(CH, S - t0);
    if (x_ok) {
      const size_t at0 = x_at + static_cast<size_t>(t0) * D;
#pragma unroll
      for (int i = 0; i < P::X_ELEMS; ++i) {
        const int s = xs0 + G * i;
        if (s < steps) {
          const float sgb = sums[xc * P::DSP + s];
          const float saq = sums[P::SQ + xc * P::DSP + s];
          const size_t at = at0 + i * x_step;
          dx[at] = half[P::ROW + xc * P::CHP + s] * sgb;
          ddt[at] = fmaf(half[xc * P::CHP + s], sgb, saq);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2 * CH * P::NP / P::THREADS; ++i) {
      const unsigned e = tid + i * P::THREADS;
      const int q = e / (CH * P::NP), s = e / P::NP % CH, n = e % P::NP;
      if (s < steps && n < N) {
        const int at = q * P::WQ + s * P::NP + n;
        float v = wpart[at];
#pragma unroll
        for (int w = 1; w < P::WARPS; ++w) v += wpart[w * P::WPART + at];
        (q == 0 ? dB_part : dC_part)[(part_row + t0 + s) * N + n] = v;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (owns[r]) {
      const size_t at = (b * D + d) * N + g * R + r;
      dh0[at] = gn[r];
      dA_part[at] = dA[r];
    }
  }
}

// dB and dC: the per-block partials summed over the blocks; dA: the
// per-row partials summed over the batch; each in index order.
__global__ void __launch_bounds__(256)
    ssm_scan_bwd_sum_kernel(const float* __restrict__ dB_part,
                            const float* __restrict__ dC_part,
                            const float* __restrict__ dA_part,
                            float* __restrict__ dB, float* __restrict__ dC,
                            float* __restrict__ dA, int parts, size_t rows,
                            int Bsz, size_t dn) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  for (size_t i = first; i < rows; i += stride) {
    float sb = 0.0f, sc = 0.0f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) {
      sb += dB_part[p * rows + i];
      sc += dC_part[p * rows + i];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  for (size_t i = first; i < dn; i += stride) {
    float s = 0.0f;
    for (int r = 0; r < Bsz; ++r) s += dA_part[r * dn + i];
    dA[i] = s;
  }
}

struct Args {
  const float *x, *dt, *B, *C, *A, *states, *dy, *dh_final;
  float *dx, *ddt, *dB, *dC, *dA, *dh0, *dB_part, *dC_part, *dA_part;
  int Bsz, S, D, N;
};

// The kernel's shared-memory limit: set once per device for the life of
// the process (a race sets it twice, which is harmless), so a launch adds
// no host call.
template <int G>
cudaError_t prepare(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit =
      device < 64 ? 1ull << device : 0ull;   // devices past 64: every call
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Bwd<G>::BYTES));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int G>
cudaError_t launch_g(const Args& a, int device, cudaStream_t stream) {
  using P = Bwd<G>;
  const cudaError_t err = prepare<G>(device);
  if (err != cudaSuccess) return err;
  const int blocks = (a.D + P::CPB - 1) / P::CPB;
  ssm_scan_bwd_kernel<G><<<dim3(blocks, a.Bsz), P::THREADS, P::BYTES,
                           stream>>>(
      a.x, a.dt, a.B, a.C, a.A, a.states, a.dy, a.dh_final, a.dx, a.ddt,
      a.dB_part, a.dC_part, a.dA_part, a.dh0, a.S, a.D, a.N);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return launched;
  const size_t rows = static_cast<size_t>(a.Bsz) * a.S * a.N;
  const size_t dn = static_cast<size_t>(a.D) * a.N;
  const size_t most = rows > dn ? rows : dn;
  const int grid = static_cast<int>(most / 256 + 1 < 4096 ? most / 256 + 1
                                                          : 4096);
  ssm_scan_bwd_sum_kernel<<<grid, 256, 0, stream>>>(
      a.dB_part, a.dC_part, a.dA_part, a.dB, a.dC, a.dA, blocks, rows,
      a.Bsz, dn);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major float32 tensors: x, dt, dy, dx, ddt (Bsz, S, D); B,
// C, dB, dC (Bsz, S, N); A, dA (D, N); states (Bsz, ceil(S / 16), D, N),
// the forward kernel's; dh_final, dh0, dA_part (Bsz, D, N); dB_part,
// dC_part (ceil(D / 64), Bsz, S, N), or ceil(D / 32) for N > 16: scratch.
// dh_final may be null (zeros).  `stream` is the caller's cudaStream_t;
// the call only queues the kernel and the sum of its partials and returns
// the launches' cudaError_t.
extern "C" int repro_ssm_scan_bwd_f32(
    const void* x, const void* dt, const void* B, const void* C,
    const void* A, const void* states, const void* dy, const void* dh_final,
    void* dx, void* ddt, void* dB, void* dC, void* dA, void* dh0,
    void* dB_part, void* dC_part, void* dA_part, int Bsz, int S, int D, int N,
    int device, void* stream) {
  if (Bsz < 0 || S < 0 || D < 0 || N < 1 || N > 8 * R) {
    return cudaErrorInvalidValue;
  }
  if (Bsz == 0 || D == 0) return cudaSuccess;
  if (Bsz > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto out = [](void* p) { return static_cast<float*>(p); };
  const Args a{in(x),       in(dt),      in(B),       in(C),   in(A),
               in(states),  in(dy),      in(dh_final), out(dx), out(ddt),
               out(dB),     out(dC),     out(dA),     out(dh0),
               out(dB_part), out(dC_part), out(dA_part), Bsz, S, D, N};
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= R) return launch_g<1>(a, device, s);
  if (N <= 2 * R) return launch_g<2>(a, device, s);
  if (N <= 4 * R) return launch_g<4>(a, device, s);
  return launch_g<8>(a, device, s);
}
