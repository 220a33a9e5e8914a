// Blocked matrix product for Hopper (sm_90a): the body of every `mul` task
// of the paper's Fig. 2 DAG.
//
// Replaces the TPU kernel `matmul` of src/repro/kernels/matmul_pallas.py
// (pallas_call at :55, body `_matmul_kernel` at :19, tiles fitted by
// `_fit_block` at :32).  It computes the same function: (M,K) @ (K,N) ->
// (M,N) in the input type, summed in float32.
//
// Translation.  The TPU kernel walks K as the sequential third grid axis and
// carries the sum in a VMEM scratch accumulator from one grid step to the
// next.  GPU blocks run in no order, so here one block owns one 128x128
// output tile for the whole of K: a loop inside the block stages BK-deep
// slices of x and y through shared memory, and each of its 256 threads keeps
// an 8x8 micro-tile of the sum in registers.  The ragged edge of any M, N
// and K is masked by zero-fill in shared memory; tiles are never shrunk to
// divisors of the dims as `_fit_block` does.
//
// Numbers.  Each output element is one thread's sum over K in one fixed
// order (k-tiles ascending, fmaf within a tile ascending), with no split-K
// and no atomics, so the same inputs give the same bits in every launch and
// from every host thread: the runtime's promise that a threaded run equals
// the sequential one bit for bit rests on that.  float32 stays IEEE fp32 FMA
// on the CUDA cores, never TF32.  bf16 inputs are widened with
// __bfloat162float, summed in fp32 and rounded once to bf16 (to nearest
// even) on the store, as the reference's float32 accumulator is cast to
// x.dtype.
//
// Bound at the main path's shape, 4096^3 (2 * 4096^3 = 1.37e11 FLOP),
// against the published H100 SXM peaks:
//   float32  2.05 ms of operations at 67 TFLOP/s on the CUDA cores; its
//            201 MB of bytes take 0.06 ms at 3.35 TB/s.  Bound by operations.
//   bf16     0.139 ms at 989 TFLOP/s on the tensor cores.  Bound by
//            operations.
// This kernel runs on the CUDA cores for both types and is meant to be right
// first: wgmma, TMA-fed multi-stage pipelines and a bf16 tensor-core path are
// work for later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 128;  // output rows of one block
constexpr int BN = 128;  // output columns of one block
constexpr int BK = 8;    // depth of one shared-memory stage
constexpr int TM = 8;    // output rows of one thread
constexpr int TN = 8;    // output columns of one thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
// x is stored transposed (xs[k][m]); a row pitch of BM + 4 floats puts the
// eight k-rows that one warp writes at once into distinct banks.
constexpr int XS_PITCH = BM + 4;

static_assert((BM * BK) % THREADS == 0, "x stage must split evenly");
static_assert((BK * BN) % THREADS == 0, "y stage must split evenly");

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[BK][XS_PITCH];  // xs[k][m] = x[m][k]
  __shared__ __align__(16) float ys[BK][BN];        // ys[k][n] = y[k][n]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ty = tid / (BN / TN);  // this thread's rows: ty*TM ...
  const int tx = tid % (BN / TN);  // and columns: tx*TN ...

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage x[row0:+BM, k0:+BK] and y[k0:+BK, col0:+BN].  Elements past an
    // edge are zero, so they add nothing to any sum that is stored.
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int m = e / BK, k = e % BK;
      const int gm = row0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K)
                     ? to_f32(x[static_cast<size_t>(gm) * K + gk])
                     : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < BK * BN / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = col0 + n;
      ys[k][n] = (gk < K && gn < N)
                     ? to_f32(y[static_cast<size_t>(gk) * N + gn])
                     : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = col0 + tx * TN + j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           int device, void* stream) {
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  matmul_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major tensors; `stream` is the caller's cudaStream_t.  The
// call only queues the kernel and returns the launch's cudaError_t.
extern "C" int repro_matmul_f32(const void* x, const void* y, void* out,
                                int M, int N, int K, int device,
                                void* stream) {
  return launch<float>(x, y, out, M, N, K, device, stream);
}

extern "C" int repro_matmul_bf16(const void* x, const void* y, void* out,
                                 int M, int N, int K, int device,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, y, out, M, N, K, device, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
