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
// Work split: the forward kernel's (ssm_scan.cu).  A block holds CPB = 32
// channels of one batch row, and G = 1, 2, 4 or 8 adjacent lanes hold a
// channel's N <= 32 states, R = 4 a thread, in registers.  The reverse
// recurrence needs h_{t-1} at every step, which the forward does not keep
// (2.1 GB a layer at 2 x 2048 x 8192 x 16), so the kernel runs two passes:
//   1. forward over the sequence, writing the state before every chunk of
//      CH = 16 steps to `bounds` (Bsz, chunks, D, N): 134 MB at that shape;
//   2. the chunks in reverse: stage the chunk's x, dt, dy, B and C into
//      shared memory, recompute its h from the chunk's first state into
//      shared memory (each thread keeps its own R states a step), then step
//      g backward through the chunk.
// Per step, dx and ddt are sums over a channel's G lanes (shuffles); dB and
// dC are sums over all D channels, which span blocks: a block sums its
// warps' channels (shuffles), then its warps in a fixed order, and writes
// one partial per block (`dB_part`, `dC_part`: (blocks, Bsz, S, N)); dA is
// summed per batch row (`dA_part`: (Bsz, D, N)).  The caller sums the
// partials, so no float atomics: two launches give the same bits.
//
// What bounds it.  Each input read once and each output written once is
// x, dt, dy, dx, ddt (134 MB each at 2 x 2048 x 8192 float32) and little
// else: about 0.2 ms at 3.35 TB/s.  The work is about 20 float operations
// and one exp per state and step (the recomputed forward, then the
// backward), 10.7 GFLOP there, 0.16 ms at the CUDA cores' float32 peak;
// the kernel also runs the forward a second time (pass 1) and reduces over
// lanes with shuffles.  This first version is simple: its loads are
// synchronous (other blocks on the SM hide them), and it is latency-bound.
//
// Numbers.  The exp and the state update are the forward kernel's:
// ex2.approx on dt * (A log2 e), and __fmul_rn/__fadd_rn, so the recomputed
// h equals the forward's bit for bit.  The sums over lanes and warps are
// taken in a fixed order for a given N and D.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int R = 4;           // states of one thread
constexpr int CPB = 32;        // channels of one block
constexpr int CH = 16;         // time steps of one chunk
constexpr int CHP = CH + 1;    // a channel's row of a chunk in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one block, in floats; the float4 sections come first.
template <int G>
struct Bwd {
  static constexpr int THREADS = CPB * G;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int NP = G * R;                // states padded to the lanes
  static constexpr int HIST = CH * THREADS * R;   // h before each step
  static constexpr int BC = CH * NP;              // the chunk's B or C
  static constexpr int PART = WARPS * CH * NP;    // each warp's dB or dC
  static constexpr int ROW = CPB * CHP;           // x, dt, dy, dx or ddt
  static constexpr size_t BYTES =
      sizeof(float) * (HIST + 2 * BC + 2 * PART + 5 * ROW);
  static_assert(THREADS % 32 == 0 && BC % 4 == 0, "float4 sections");
};

// 2^v on the SFU (MUFU.EX2), as ssm_scan.cu computes it
__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int G>
__global__ void __launch_bounds__(Bwd<G>::THREADS)
    ssm_scan_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ A,
                        const float* __restrict__ h0,
                        const float* __restrict__ dy,
                        const float* __restrict__ dh_final,
                        float* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ dB_part,
                        float* __restrict__ dC_part,
                        float* __restrict__ dA_part, float* __restrict__ dh0,
                        float* __restrict__ bounds, int S, int D, int N) {
  using P = Bwd<G>;
  extern __shared__ __align__(16) float smem[];
  float* hist = smem;                 // [CH][THREADS][R]
  float* bs = hist + P::HIST;         // [CH][NP]
  float* cs = bs + P::BC;
  float* part_b = cs + P::BC;         // [WARPS][CH][NP]
  float* part_c = part_b + P::PART;
  float* xs = part_c + P::PART;       // [CPB][CHP]
  float* dts = xs + P::ROW;
  float* dys = dts + P::ROW;
  float* dxs = dys + P::ROW;
  float* ddts = dxs + P::ROW;

  const int tid = threadIdx.x;
  const int c = tid / G;              // this thread's channel in the block
  const int g = tid % G;              // and its lane in the channel
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + c;
  const size_t b = blockIdx.y;
  const int chunks = (S + CH - 1) / CH;

  // this thread's states n = g*R + r; a state past N or a channel past D
  // has A = 0 and B = C = x = dt = dy = 0, so its h and g stay 0
  bool owns[R];
  size_t at_state[R];                 // (b, d, n) in a (Bsz, D, N) tensor
  float Ar[R], a2[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = g * R + r;
    owns[r] = d < D && n < N;
    at_state[r] = (b * D + d) * N + n;
    Ar[r] = owns[r] ? A[static_cast<size_t>(d) * N + n] : 0.0f;
    a2[r] = __fmul_rn(Ar[r], kLog2e);
    h[r] = (owns[r] && h0 != nullptr) ? h0[at_state[r]] : 0.0f;
  }

  // the chunk at t0 into shared memory: x, dt (and dy) as [channel][step],
  // B (and C) as [step][state]; zeros past S, D and N
  auto stage = [&](int t0, bool backward) {
    for (int i = tid; i < CH * CPB; i += P::THREADS) {
      const int s = i / CPB, cc = i % CPB;
      const bool ok = t0 + s < S && d0 + cc < D;
      const size_t at = (b * S + t0 + s) * D + d0 + cc;
      xs[cc * CHP + s] = ok ? x[at] : 0.0f;
      dts[cc * CHP + s] = ok ? dt[at] : 0.0f;
      if (backward) dys[cc * CHP + s] = ok ? dy[at] : 0.0f;
    }
    for (int i = tid; i < CH * P::NP; i += P::THREADS) {
      const int s = i / P::NP, n = i % P::NP;
      const bool ok = t0 + s < S && n < N;
      const size_t at = (b * S + t0 + s) * N + n;
      bs[i] = ok ? Bm[at] : 0.0f;
      if (backward) cs[i] = ok ? Cm[at] : 0.0f;
    }
  };
  // step s of the staged chunk: h <- exp(dt A) h + (dt x) B
  auto step = [&](int s) {
    const float dtv = dts[c * CHP + s];
    const float dtx = __fmul_rn(dtv, xs[c * CHP + s]);
    const float4 bv = *reinterpret_cast<const float4*>(bs + s * P::NP + g * R);
    const float bb[R] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float da = exp2_approx(__fmul_rn(dtv, a2[r]));
      h[r] = __fadd_rn(__fmul_rn(da, h[r]), __fmul_rn(dtx, bb[r]));
    }
  };
  auto bound_at = [&](int k, int r) {
    return ((b * chunks + k) * D + d) * N + g * R + r;
  };

  // pass 1: the state before every chunk
  for (int k = 0; k < chunks; ++k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (owns[r]) bounds[bound_at(k, r)] = h[r];
    }
    __syncthreads();                  // every thread is done with chunk k-1
    stage(k * CH, false);
    __syncthreads();
    const int steps = min(CH, S - k * CH);
    for (int s = 0; s < steps; ++s) step(s);
  }

  // pass 2: the chunks in reverse; gn is a_{t+1} g_{t+1}
  float gn[R], dA[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    gn[r] = (owns[r] && dh_final != nullptr) ? dh_final[at_state[r]] : 0.0f;
    dA[r] = 0.0f;
  }
  const size_t part_row = (static_cast<size_t>(blockIdx.x) * gridDim.y + b) *
                          static_cast<size_t>(S);
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * CH;
    const int steps = min(CH, S - t0);
#pragma unroll
    for (int r = 0; r < R; ++r) h[r] = owns[r] ? bounds[bound_at(k, r)] : 0.0f;
    __syncthreads();                  // every thread is done with chunk k+1
    stage(t0, true);
    __syncthreads();
    // h before each step of the chunk: each thread keeps its own states
    for (int s = 0; s < steps; ++s) {
      *reinterpret_cast<float4*>(hist + (s * P::THREADS + tid) * R) =
          make_float4(h[0], h[1], h[2], h[3]);
      step(s);
    }
    for (int s = steps - 1; s >= 0; --s) {
      const float dtv = dts[c * CHP + s], xv = xs[c * CHP + s];
      const float dyv = dys[c * CHP + s];
      const float dtx = __fmul_rn(dtv, xv);
      const float4 bv =
          *reinterpret_cast<const float4*>(bs + s * P::NP + g * R);
      const float4 cv =
          *reinterpret_cast<const float4*>(cs + s * P::NP + g * R);
      const float4 hv = *reinterpret_cast<const float4*>(
          hist + (s * P::THREADS + tid) * R);
      const float bb[R] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[R] = {cv.x, cv.y, cv.z, cv.w};
      const float hp[R] = {hv.x, hv.y, hv.z, hv.w};
      float sgb = 0.0f, saq = 0.0f;   // sum_n g B, sum_n A (g a h_{t-1})
      float pb[R], pc[R];             // this channel's dB_t and dC_t terms
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = exp2_approx(__fmul_rn(dtv, a2[r]));
        const float ht = __fadd_rn(__fmul_rn(a, hp[r]), __fmul_rn(dtx, bb[r]));
        const float gt = fmaf(dyv, cc[r], gn[r]);
        const float q = gt * a * hp[r];
        dA[r] = fmaf(dtv, q, dA[r]);
        saq = fmaf(Ar[r], q, saq);
        sgb = fmaf(gt, bb[r], sgb);
        pc[r] = ht * dyv;
        pb[r] = gt * dtx;
        gn[r] = a * gt;
      }
      // over the channel's G lanes (a butterfly: every lane gets the sum)
#pragma unroll
      for (int w = 1; w < G; w *= 2) {
        sgb += __shfl_xor_sync(kFull, sgb, w);
        saq += __shfl_xor_sync(kFull, saq, w);
      }
      if (g == 0) {
        dxs[c * CHP + s] = dtv * sgb;
        ddts[c * CHP + s] = fmaf(xv, sgb, saq);
      }
      // over the warp's channels: lanes g, g + G, g + 2G, ...
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int w = G; w < 32; w *= 2) {
          pb[r] += __shfl_xor_sync(kFull, pb[r], w);
          pc[r] += __shfl_xor_sync(kFull, pc[r], w);
        }
      }
      if (lane < G) {
        const int at = (warp * CH + s) * P::NP + g * R;
        *reinterpret_cast<float4*>(part_b + at) =
            make_float4(pb[0], pb[1], pb[2], pb[3]);
        *reinterpret_cast<float4*>(part_c + at) =
            make_float4(pc[0], pc[1], pc[2], pc[3]);
      }
    }
    __syncthreads();
    // the chunk's dx and ddt, and its dB and dC summed over the warps
    for (int i = tid; i < CH * CPB; i += P::THREADS) {
      const int s = i / CPB, cc = i % CPB;
      if (s < steps && d0 + cc < D) {
        const size_t at = (b * S + t0 + s) * D + d0 + cc;
        dx[at] = dxs[cc * CHP + s];
        ddt[at] = ddts[cc * CHP + s];
      }
    }
    for (int i = tid; i < CH * P::NP; i += P::THREADS) {
      const int s = i / P::NP, n = i % P::NP;
      if (s < steps && n < N) {
        float sb = part_b[i], sc = part_c[i];
        for (int w = 1; w < P::WARPS; ++w) {
          sb += part_b[w * CH * P::NP + i];
          sc += part_c[w * CH * P::NP + i];
        }
        const size_t at = (part_row + t0 + s) * N + n;
        dB_part[at] = sb;
        dC_part[at] = sc;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (owns[r]) {
      dh0[at_state[r]] = gn[r];
      dA_part[at_state[r]] = dA[r];
    }
  }
}

struct Args {
  const float *x, *dt, *B, *C, *A, *h0, *dy, *dh_final;
  float *dx, *ddt, *dB_part, *dC_part, *dA_part, *dh0, *bounds;
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
  constexpr size_t bytes = Bwd<G>::BYTES;
  const cudaError_t err = prepare<G>(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.D + CPB - 1) / CPB, a.Bsz);
  ssm_scan_bwd_kernel<G><<<grid, Bwd<G>::THREADS, bytes, stream>>>(
      a.x, a.dt, a.B, a.C, a.A, a.h0, a.dy, a.dh_final, a.dx, a.ddt,
      a.dB_part, a.dC_part, a.dA_part, a.dh0, a.bounds, a.S, a.D, a.N);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major float32 tensors: x, dt, dy, dx, ddt (Bsz, S, D); B,
// C (Bsz, S, N); A (D, N); h0, dh_final, dA_part, dh0 (Bsz, D, N); dB_part,
// dC_part (ceil(D / 32), Bsz, S, N); bounds (Bsz, ceil(S / 16), D, N),
// scratch.  h0 and dh_final may be null (zeros).  The caller sums dB_part
// and dC_part over their first dimension and dA_part over the batch.
// `stream` is the caller's cudaStream_t; the call only queues the kernel and
// returns the launch's cudaError_t.
extern "C" int repro_ssm_scan_bwd_f32(
    const void* x, const void* dt, const void* B, const void* C,
    const void* A, const void* h0, const void* dy, const void* dh_final,
    void* dx, void* ddt, void* dB_part, void* dC_part, void* dA_part,
    void* dh0, void* bounds, int Bsz, int S, int D, int N, int device,
    void* stream) {
  if (Bsz < 0 || S < 0 || D < 0 || N < 1 || N > 8 * R) {
    return cudaErrorInvalidValue;
  }
  if (Bsz == 0 || D == 0) return cudaSuccess;
  if (Bsz > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(B), static_cast<const float*>(C),
               static_cast<const float*>(A), static_cast<const float*>(h0),
               static_cast<const float*>(dy),
               static_cast<const float*>(dh_final), static_cast<float*>(dx),
               static_cast<float*>(ddt), static_cast<float*>(dB_part),
               static_cast<float*>(dC_part), static_cast<float*>(dA_part),
               static_cast<float*>(dh0), static_cast<float*>(bounds),
               Bsz, S, D, N};
  const auto s = static_cast<cudaStream_t>(stream);
  if (N <= R) return launch_g<1>(a, device, s);
  if (N <= 2 * R) return launch_g<2>(a, device, s);
  if (N <= 4 * R) return launch_g<4>(a, device, s);
  return launch_g<8>(a, device, s);
}
