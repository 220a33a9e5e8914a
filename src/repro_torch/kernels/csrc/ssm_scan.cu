// Selective scan (Mamba1) for Hopper (sm_90a): the SSM recurrence of every
// Mamba1 layer, in every prefill and decode step of the port's LM path.
//
// Replaces the TPU kernel `ssm_scan` of src/repro/kernels/ssm_scan.py
// (pallas_call at :61, body `_scan_kernel` at :25).  It computes the
// function that src/repro/models/ssm.py::selective_scan needs:
//   h <- exp(dt_t * A) * h + (dt_t * x_t) (x) B_t,   y_t = h . C_t
// over t = 0..S-1, with x, dt (Bsz,S,D), B, C (Bsz,S,N), A (D,N) float32,
// state h float32 (Bsz,D,N) starting from h0 (or zeros), returning y in the
// input type and the final state.  Unlike the TPU kernel it takes any Bsz,
// S >= 0 and D (ragged edges are masked), 1 <= N <= 32, h0, and returns
// h_final.  For training it can also keep `states` (Bsz, ceil(S / SCH), D,
// N), the state before every chunk of SCH = 16 steps, from which the
// backward kernel (ssm_scan_bwd.cu) recomputes h without a forward pass of
// its own.
//
// Translation.  The TPU kernel tiles channels over a parallel grid axis and
// carries the (bd, N) state in VMEM across a sequential chunk axis.  GPU
// blocks run in no order, so here the time loop runs inside the block and
// the state lives in registers for the whole sequence: one thread owns
// R = 4 states of one channel, and G = 1, 2, 4 or 8 adjacent lanes (the
// power of two with G * R >= N) hold the channel's N states.  A block holds
// CPB = 32 channels of one batch row (32 * G threads): at D = 8192 that is
// 256 blocks, which covers the 132 SMs at batch 1.
//
// What bounds it.  Each input read once and each output written once is
// 203 MB at the long-prefill shape (1x2048x8192, N = 16, float32): 0.061 ms
// at 3.35 TB/s.  But every state-step costs an exp and a handful of
// dependent float operations, 268 M state-steps there, so the kernel is
// bound by instruction issue and latency: the 268 M exps alone take about
// 0.065 ms on the SMs' 16 MUFU.EX2 lanes a clock, and at batch 1 an SM
// holds only about 8 warps.  The first version spent about 28 instructions
// a state-step (one lane a state: its own shared loads of dt and x, 4
// shuffles and adds for y_t, an accurate expf), and its chunk staging did
// not overlap the time loop.  The design:
//   - R = 4 states a thread, and a thread walks its channel in groups of
//     GS = max(G, 4) steps.  x and dt sit transposed in shared memory
//     ([channel][step]), so a group's dt and x are one 16-byte read each
//     per 4 steps; B_t and C_t are one 16-byte read each per step; dt_t *
//     x_t is formed once per step; the R products h * C are summed with 3
//     FMAs.  The exps depend on dt only, so they issue ahead of the h
//     chains.
//   - y: at the end of a group each lane holds the partial sums of its R
//     states for the group's steps, and a reduce-scatter over the G lanes
//     (G - 1 shuffles per G steps, against log2(G) per step for a
//     butterfly) leaves lane g with the whole y of step g of each G steps,
//     which it stores: every lane stores, no branch per step.
//   - The exp is one MUFU.EX2: exp(dt * A) = 2^(dt * (A * log2 e)), with
//     A * log2 e formed once a state (ex2.approx, about 2 ulp; results
//     under 2^-126 flush to 0).  The accurate expf it replaces cost 8
//     instructions on a dependent chain.
//   - The next chunk of CH = 32 steps of x, dt, B and C is staged into the
//     other half of a double buffer while the current chunk runs, with one
//     __syncthreads() a chunk: float32 through 4-byte cp.async copies,
//     zero-filled past the edges; bf16 (2 bytes, under cp.async's smallest
//     copy) loaded into registers before the chunk and widened and stored
//     after it (widened at the load, the compiler would wait on the loads
//     before the time loop).
//     Each thread's copy offsets are formed once; a chunk adds t0 rows.
//
// The states are stored only by the instantiation that keeps them (a
// template flag), at the start of every second group of GS steps: serving
// passes no `states` and runs the kernel without the store.
//
// Numbers.  The state update uses __fmul_rn/__fadd_rn, so it is not fused
// into FMAs and rounds as the plain PyTorch version's elementwise ops do
// (exp(dt*A) * h + (dt*x) * B); only the exp differs from its expf, by a
// few ulp, and the state carries that error at the scale of 1e-7 of h.
// The sum over N is taken in another order (the thread's R products in
// order, then the reduce-scatter over its G lanes), fixed for a given N, so
// y is the same in every launch.

#include "simt.cuh"

#include <cstddef>
#include <type_traits>

namespace {

using simt::cp_async4;
using simt::cp_async_commit;
using simt::cp_async_wait;
using simt::from_f32;
using simt::to_f32;

constexpr int R = 4;      // states of one thread
constexpr int CPB = 32;   // channels of one block
constexpr int CH = 32;    // time steps of one staged chunk
constexpr int SCH = 16;   // steps between two kept states (bwd's CH)
constexpr float kLog2e = 1.4426950408889634f;

// G: lanes per channel (1, 2, 4 or 8).  One half of the double buffer holds
// a chunk's x and dt, transposed ([CPB][CHP] each, so a lane reads 4 steps
// of its channel at once), and B and C ([CH][NP] each).
template <int G>
struct Shape {
  static constexpr int THREADS = CPB * G;
  static constexpr int NP = G * R;            // states padded to the lanes
  static constexpr int CHP = CH + 4;          // a channel's row: 9 x 16 B
  static constexpr int XS = CPB * CHP;
  static constexpr int BS = CH * NP;
  static constexpr int HALF = 2 * XS + 2 * BS;
  static constexpr int GS = G < 4 ? 4 : G;    // steps of one group
  static constexpr int X_ELEMS = CH * CPB / THREADS;   // a thread's copies
  static constexpr int B_ELEMS = BS / THREADS;         // of x and of B
  static_assert((CH * CPB) % THREADS == 0 && BS % THREADS == 0 &&
                    CH % GS == 0,
                "even split");
  static_assert((HALF * 4) % 16 == 0 && (XS * 4) % 16 == 0,
                "16-byte reads of x, dt, B and C");
  static_assert(CH % SCH == 0 && SCH % GS == 0, "states at group starts");
};

// One thread's share of a chunk's staging.  Element i of x and dt is step
// (tid >> 5) + G * i of channel d0 + (tid & 31), at [channel][step] in the
// half; element i of B and C is step tid / NP + 8 * i of state tid % NP, at
// tid + i * THREADS.  Elements past S, D or N are zeros.
template <typename T, int G>
struct Stager {
  using Sh = Shape<G>;
  const T *x, *dt, *Bm, *Cm;
  size_t x0, b0;          // this thread's element 0 at t0 = 0
  size_t D, N;            // one row of x, of B
  int xt, bt, S, xs0;
  bool x_ok, b_ok;        // the channel lies inside D, the state inside N

  __device__ Stager(const T* x_, const T* dt_, const T* B_, const T* C_,
                    size_t row0, int S_, int D_, int N_, int d0)
      : x(x_), dt(dt_), Bm(B_), Cm(C_), D(D_), N(N_), S(S_) {
    const int tid = threadIdx.x;
    xt = tid >> 5;
    bt = tid / Sh::NP;
    x0 = (row0 + xt) * D + d0 + (tid & 31);
    b0 = (row0 + bt) * N + tid % Sh::NP;
    xs0 = (tid & 31) * Sh::CHP + xt;
    x_ok = d0 + (tid & 31) < D_;
    b_ok = tid % Sh::NP < N_;
  }

  // float32: queue the chunk at t0 into `half` as cp.async copies; a copy
  // that is not valid reads nothing and writes zeros
  __device__ void issue(float* half, int t0) const {
    const size_t xstep = G * D, bstep = 8 * N;
    const T* xp = x + x0 + t0 * D;
    const T* dp = dt + x0 + t0 * D;
#pragma unroll
    for (int i = 0; i < Sh::X_ELEMS; ++i) {
      const bool ok = x_ok && t0 + xt + G * i < S;
      cp_async4(half + xs0 + G * i, xp + i * xstep, ok);
      cp_async4(half + Sh::XS + xs0 + G * i, dp + i * xstep, ok);
    }
    const T* bp = Bm + b0 + t0 * N;
    const T* cp = Cm + b0 + t0 * N;
    float* bs = half + 2 * Sh::XS + threadIdx.x;
#pragma unroll
    for (int i = 0; i < Sh::B_ELEMS; ++i) {
      const bool ok = b_ok && t0 + bt + 8 * i < S;
      cp_async4(bs + i * Sh::THREADS, bp + i * bstep, ok);
      cp_async4(bs + Sh::BS + i * Sh::THREADS, cp + i * bstep, ok);
    }
  }

  // The registers hold the chunk as loaded; it is widened only when it is
  // stored, so no instruction waits on the loads before the time loop.
  struct Regs {
    T x[Sh::X_ELEMS], dt[Sh::X_ELEMS], b[Sh::B_ELEMS], c[Sh::B_ELEMS];
  };
  // bf16: read the chunk at t0 into registers (a chunk past S is all zeros
  // and reads nothing), ...
  __device__ void load(Regs& r, int t0) const {
    const size_t xstep = G * D, bstep = 8 * N;
    const T* xp = x + x0 + t0 * D;
    const T* dp = dt + x0 + t0 * D;
    const T zero = from_f32<T>(0.0f);
#pragma unroll
    for (int i = 0; i < Sh::X_ELEMS; ++i) {
      const bool ok = x_ok && t0 + xt + G * i < S;
      r.x[i] = ok ? xp[i * xstep] : zero;
      r.dt[i] = ok ? dp[i * xstep] : zero;
    }
    const T* bp = Bm + b0 + t0 * N;
    const T* cp = Cm + b0 + t0 * N;
#pragma unroll
    for (int i = 0; i < Sh::B_ELEMS; ++i) {
      const bool ok = b_ok && t0 + bt + 8 * i < S;
      r.b[i] = ok ? bp[i * bstep] : zero;
      r.c[i] = ok ? cp[i * bstep] : zero;
    }
  }
  // ... and store it into `half`, widened
  __device__ void store(float* half, const Regs& r) const {
#pragma unroll
    for (int i = 0; i < Sh::X_ELEMS; ++i) {
      half[xs0 + G * i] = to_f32(r.x[i]);
      half[Sh::XS + xs0 + G * i] = to_f32(r.dt[i]);
    }
    float* bs = half + 2 * Sh::XS + threadIdx.x;
#pragma unroll
    for (int i = 0; i < Sh::B_ELEMS; ++i) {
      bs[i * Sh::THREADS] = to_f32(r.b[i]);
      bs[Sh::BS + i * Sh::THREADS] = to_f32(r.c[i]);
    }
  }
};

// 2^v on the SFU (MUFU.EX2): about 2 ulp, denormal results flushed to 0
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The G lanes of a channel hold q[0..G) each; lane g returns the sum over
// the lanes of q[g].  Each round halves the live entries: a lane keeps the
// half its bit of g selects and adds its partner's copy of that half, so
// G partial sums take G - 1 shuffles in all, in a fixed order.
template <int G>
__device__ __forceinline__ float reduce_scatter(float (&q)[G], int g) {
#pragma unroll
  for (int w = G / 2; w >= 1; w /= 2) {
    const bool up = g & w;
#pragma unroll
    for (int k = 0; k < w; ++k) {
      const float send = up ? q[k] : q[k + w];
      const float keep = up ? q[k + w] : q[k];
      q[k] = keep + __shfl_xor_sync(0xffffffffu, send, w, G);
    }
  }
  return q[0];
}

template <typename T, int G, bool kStates>
__global__ void __launch_bounds__(Shape<G>::THREADS)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ h0,
                    T* __restrict__ y, float* __restrict__ h_final,
                    float* __restrict__ states, int S, int D, int N) {
  using Sh = Shape<G>;
  constexpr int GS = Sh::GS;
  __shared__ __align__(16) float smem[2 * Sh::HALF];

  const int c = threadIdx.x / G;   // this thread's channel in the block
  const int g = threadIdx.x % G;   // and its lane in the channel
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const size_t b = blockIdx.y;
  const Stager<T, G> stager(x, dt, Bm, Cm, b * S, S, D, N, d0);

  // this thread's states n = g*R + r: A * log2(e), and h from h0 (or
  // zeros); a state past N or a channel past D has A = 0 and
  // B = C = x = dt = 0, so its h stays 0 and it adds nothing to y
  float a2[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = g * R + r;
    const bool owns = d < D && n < N;
    a2[r] = owns ? __fmul_rn(A[static_cast<size_t>(d) * N + n], kLog2e)
                 : 0.0f;
    h[r] = (owns && h0 != nullptr) ? h0[(b * D + d) * N + n] : 0.0f;
  }

  const int chunks = (S + CH - 1) / CH;
  const size_t state_row = b * ((S + SCH - 1) / SCH);   // (b, 0) of states
  constexpr bool kAsync = std::is_same<T, float>::value;
  typename Stager<T, G>::Regs regs;
  if (chunks > 0) {
    if constexpr (kAsync) {
      stager.issue(smem, 0);
      cp_async_commit();
    } else {
      stager.load(regs, 0);
      stager.store(smem, regs);
    }
  }
  for (int k = 0; k < chunks; ++k) {
    if constexpr (kAsync) cp_async_wait<0>();
    // chunk k is visible to all, and every thread is done with chunk k-1,
    // whose half the next staging overwrites
    __syncthreads();
    const int t0 = k * CH;
    float* next = smem + ((k + 1) & 1) * Sh::HALF;
    if constexpr (kAsync) {
      if (k + 1 < chunks) stager.issue(next, t0 + CH);
      cp_async_commit();
    } else {
      // unconditional, so the loads stay ahead of the time loop
      stager.load(regs, t0 + CH);
    }

    const float* half = smem + (k & 1) * Sh::HALF;
    const float* xs = half + c * Sh::CHP;
    const float* dts = xs + Sh::XS;
    const float* bs = half + 2 * Sh::XS + g * R;
    const float* cs = bs + Sh::BS;
    const int steps = min(CH, S - t0);
    T* yp = y + (b * S + t0) * D + d;
    // groups of GS steps; steps past the chunk's end are zeros in shared
    // memory (dt = 0 leaves h as it is) and store nothing
    for (int t = 0; t < steps; t += GS) {
      if constexpr (kStates) {
        if (t % SCH == 0) {     // the state before step t0 + t
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int n = g * R + r;
            if (d < D && n < N) {
              states[((state_row + (t0 + t) / SCH) * D + d) * N + n] = h[r];
            }
          }
        }
      }
      float dtv[GS], xv[GS], part[GS];
#pragma unroll
      for (int q = 0; q < GS; q += 4) {
        const float4 dv = *reinterpret_cast<const float4*>(dts + t + q);
        const float4 xq = *reinterpret_cast<const float4*>(xs + t + q);
        dtv[q] = dv.x, dtv[q + 1] = dv.y, dtv[q + 2] = dv.z, dtv[q + 3] = dv.w;
        xv[q] = xq.x, xv[q + 1] = xq.y, xv[q + 2] = xq.z, xv[q + 3] = xq.w;
      }
#pragma unroll
      for (int s = 0; s < GS; ++s) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (t + s) * Sh::NP);
        const float4 cv =
            *reinterpret_cast<const float4*>(cs + (t + s) * Sh::NP);
        const float bb[R] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[R] = {cv.x, cv.y, cv.z, cv.w};
        const float dtx = __fmul_rn(dtv[s], xv[s]);
        float p = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float da = exp2_approx(__fmul_rn(dtv[s], a2[r]));
          h[r] = __fadd_rn(__fmul_rn(da, h[r]), __fmul_rn(dtx, bb[r]));
          p = fmaf(h[r], cc[r], p);
        }
        part[s] = p;
      }
      // lane g of the channel gets y of step j * G + g of the group
#pragma unroll
      for (int j = 0; j < GS / G; ++j) {
        float q[G];
#pragma unroll
        for (int s = 0; s < G; ++s) q[s] = part[j * G + s];
        const float sum = reduce_scatter<G>(q, g);
        const int ts = t + j * G + g;
        if (ts < steps && d < D) {
          yp[static_cast<size_t>(ts) * D] = from_f32<T>(sum);
        }
      }
    }

    if constexpr (!kAsync) stager.store(next, regs);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = g * R + r;
    if (d < D && n < N) h_final[(b * D + d) * N + n] = h[r];
  }
}

template <typename T, int G>
void launch_g(const T* x, const T* dt, const T* B, const T* C,
              const float* A, const float* h0, T* y, float* h_final,
              float* states, int Bsz, int S, int D, int N,
              cudaStream_t stream) {
  const dim3 grid((D + CPB - 1) / CPB, Bsz);
  if (states != nullptr) {
    ssm_scan_kernel<T, G, true><<<grid, Shape<G>::THREADS, 0, stream>>>(
        x, dt, B, C, A, h0, y, h_final, states, S, D, N);
  } else {
    ssm_scan_kernel<T, G, false><<<grid, Shape<G>::THREADS, 0, stream>>>(
        x, dt, B, C, A, h0, y, h_final, states, S, D, N);
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* B, const void* C,
           const void* A, const void* h0, void* y, void* h_final,
           void* states, int Bsz, int S, int D, int N, int device,
           void* stream) {
  if (Bsz < 0 || S < 0 || D < 0 || N < 1 || N > 8 * R) {
    return cudaErrorInvalidValue;
  }
  if (Bsz == 0 || D == 0) return cudaSuccess;
  if (Bsz > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* xp = static_cast<const T*>(x);
  const auto* dtp = static_cast<const T*>(dt);
  const auto* bp = static_cast<const T*>(B);
  const auto* cp = static_cast<const T*>(C);
  const auto* ap = static_cast<const float*>(A);
  const auto* h0p = static_cast<const float*>(h0);
  auto* yp = static_cast<T*>(y);
  auto* hp = static_cast<float*>(h_final);
  auto* sp = static_cast<float*>(states);
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= R) {
    launch_g<T, 1>(xp, dtp, bp, cp, ap, h0p, yp, hp, sp, Bsz, S, D, N, s);
  } else if (N <= 2 * R) {
    launch_g<T, 2>(xp, dtp, bp, cp, ap, h0p, yp, hp, sp, Bsz, S, D, N, s);
  } else if (N <= 4 * R) {
    launch_g<T, 4>(xp, dtp, bp, cp, ap, h0p, yp, hp, sp, Bsz, S, D, N, s);
  } else {
    launch_g<T, 8>(xp, dtp, bp, cp, ap, h0p, yp, hp, sp, Bsz, S, D, N, s);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major tensors; h0 may be null (zeros), and so may states
// (float32, (Bsz, ceil(S / 16), D, N): not kept).  `stream` is the caller's
// cudaStream_t.  The call only queues the kernel and returns the launch's
// cudaError_t.
extern "C" int repro_ssm_scan_f32(const void* x, const void* dt,
                                  const void* B, const void* C, const void* A,
                                  const void* h0, void* y, void* h_final,
                                  void* states, int Bsz, int S, int D, int N,
                                  int device, void* stream) {
  return launch<float>(x, dt, B, C, A, h0, y, h_final, states, Bsz, S, D, N,
                       device, stream);
}

extern "C" int repro_ssm_scan_bf16(const void* x, const void* dt,
                                   const void* B, const void* C,
                                   const void* A, const void* h0, void* y,
                                   void* h_final, void* states, int Bsz,
                                   int S, int D, int N, int device,
                                   void* stream) {
  return launch<__nv_bfloat16>(x, dt, B, C, A, h0, y, h_final, states, Bsz,
                               S, D, N, device, stream);
}
