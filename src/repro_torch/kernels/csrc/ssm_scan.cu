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
// S >= 0 and D (ragged edges are masked), h0, and returns h_final.
//
// Translation.  The TPU kernel tiles channels over a parallel grid axis and
// carries the (bd, N) state in VMEM across a sequential chunk axis.  GPU
// blocks run in no order, so here the time loop runs inside the block: one
// thread owns one state element (b, d, n) for the whole sequence and keeps
// it in a register.  G = 8, 16 or 32 adjacent lanes (the power of two
// >= N) hold the N states of one channel, so a 128-thread block covers
// 128/G channels of one batch row: 1,024 blocks at D = 8192, N = 16, which
// fills the 132 SMs even at batch 1 (one thread per channel would give
// 64 blocks).  Each step reduces h * C over the G lanes with
// __shfl_xor_sync; lanes n >= N see B = C = 0 and add nothing.  Chunks of
// CH time steps of x, dt, B and C are staged in shared memory with
// coalesced loads, and y is staged there and written back per chunk.
//
// Numbers.  The state update uses __fmul_rn/__fadd_rn, so it is not fused
// into FMAs and rounds exactly as the plain PyTorch version's elementwise
// ops do (exp(dt*A) * h + (dt*x) * B), with expf (no fast math).  Only the
// sum over N is taken in another order (a butterfly), so y differs from
// the plain version in the last bits of float32.
//
// Bound (published H100 SXM peaks).  Each input is read once and each
// output written once: at the long-prefill shape 1x2048x8192, N = 16,
// float32 that is 203,161,600 B -> 0.061 ms at 3.35 TB/s, against
// 7*Bsz*S*D*N = 1.9 GFLOP -> 0.028 ms at 67 TFLOP/s: bound by bytes.  A
// decode step (S = 1) moves 1.67 MB (0.5 us) and is bound by the launch.
// This kernel is meant to be right first: the time loop is a chain of
// dependent steps per thread, and overlapping the staging of the next
// chunk (cp.async / TMA) with the current one is work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 128;  // threads of one block
constexpr int CH = 64;        // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// G: lanes per channel (a power of two, N <= G <= 32).
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const float* __restrict__ A, const float* __restrict__ h0,
                    T* __restrict__ y, float* __restrict__ h_final, int S,
                    int D, int N) {
  constexpr int CPB = THREADS / G;  // channels of one block
  __shared__ float xs[CH][CPB];
  __shared__ float dts[CH][CPB];
  __shared__ float ys[CH][CPB];
  __shared__ float bs[CH][G];
  __shared__ float cs[CH][G];

  const int tid = threadIdx.x;
  const int c = tid / G;  // this thread's channel within the block
  const int n = tid % G;  // and its state index
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const size_t b = blockIdx.y;
  const bool owns = d < D && n < N;
  const size_t state = (b * D + d) * N + n;

  const float a = owns ? A[static_cast<size_t>(d) * N + n] : 0.0f;
  float h = (owns && h0 != nullptr) ? h0[state] : 0.0f;

  for (int t0 = 0; t0 < S; t0 += CH) {
    const int steps = min(CH, S - t0);
    const size_t row0 = b * S + t0;  // row (b, t0) of the (Bsz*S, .) views
    // Stage x, dt for this block's channels and B, C for all N.  Elements
    // past an edge are zero: a channel past D only computes zeros, and a
    // state past N adds 0 to every sum.
    for (int e = tid; e < CH * CPB; e += THREADS) {
      const int t = e / CPB, cc = e % CPB;
      const bool ok = t < steps && d0 + cc < D;
      const size_t off = (row0 + t) * D + d0 + cc;
      xs[t][cc] = ok ? to_f32(x[off]) : 0.0f;
      dts[t][cc] = ok ? to_f32(dt[off]) : 0.0f;
    }
    for (int e = tid; e < CH * G; e += THREADS) {
      const int t = e / G, nn = e % G;
      const bool ok = t < steps && nn < N;
      const size_t off = (row0 + t) * N + nn;
      bs[t][nn] = ok ? to_f32(Bm[off]) : 0.0f;
      cs[t][nn] = ok ? to_f32(Cm[off]) : 0.0f;
    }
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
      const float dtv = dts[t][c];
      const float da = expf(__fmul_rn(dtv, a));
      const float u = __fmul_rn(__fmul_rn(dtv, xs[t][c]), bs[t][n]);
      h = __fadd_rn(__fmul_rn(da, h), u);
      float part = __fmul_rn(h, cs[t][n]);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off, G);
      }
      if (n == 0) ys[t][c] = part;
    }
    __syncthreads();

    for (int e = tid; e < CH * CPB; e += THREADS) {
      const int t = e / CPB, cc = e % CPB;
      if (t < steps && d0 + cc < D) {
        y[(row0 + t) * D + d0 + cc] = from_f32<T>(ys[t][cc]);
      }
    }
    // The next chunk's staging writes xs, dts, bs and cs, which nobody
    // reads any more; ys is rewritten only after its __syncthreads.
  }
  if (owns) h_final[state] = h;
}

template <typename T>
int launch(const void* x, const void* dt, const void* B, const void* C,
           const void* A, const void* h0, void* y, void* h_final, int Bsz,
           int S, int D, int N, int device, void* stream) {
  if (Bsz < 0 || S < 0 || D < 0 || N < 1 || N > 32) {
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
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= 8) {
    const dim3 grid((D + THREADS / 8 - 1) / (THREADS / 8), Bsz);
    ssm_scan_kernel<T, 8><<<grid, THREADS, 0, s>>>(xp, dtp, bp, cp, ap, h0p,
                                                   yp, hp, S, D, N);
  } else if (N <= 16) {
    const dim3 grid((D + THREADS / 16 - 1) / (THREADS / 16), Bsz);
    ssm_scan_kernel<T, 16><<<grid, THREADS, 0, s>>>(xp, dtp, bp, cp, ap, h0p,
                                                    yp, hp, S, D, N);
  } else {
    const dim3 grid((D + THREADS / 32 - 1) / (THREADS / 32), Bsz);
    ssm_scan_kernel<T, 32><<<grid, THREADS, 0, s>>>(xp, dtp, bp, cp, ap, h0p,
                                                    yp, hp, S, D, N);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major tensors; h0 may be null (zeros).  `stream` is the
// caller's cudaStream_t.  The call only queues the kernel and returns the
// launch's cudaError_t.
extern "C" int repro_ssm_scan_f32(const void* x, const void* dt,
                                  const void* B, const void* C, const void* A,
                                  const void* h0, void* y, void* h_final,
                                  int Bsz, int S, int D, int N, int device,
                                  void* stream) {
  return launch<float>(x, dt, B, C, A, h0, y, h_final, Bsz, S, D, N, device,
                       stream);
}

extern "C" int repro_ssm_scan_bf16(const void* x, const void* dt,
                                   const void* B, const void* C,
                                   const void* A, const void* h0, void* y,
                                   void* h_final, int Bsz, int S, int D,
                                   int N, int device, void* stream) {
  return launch<__nv_bfloat16>(x, dt, B, C, A, h0, y, h_final, Bsz, S, D, N,
                               device, stream);
}
