// Blocked matrix product on the CUDA cores for Hopper (sm_90a): the body of
// every `mul` task of the paper's Fig. 2 DAG (float32), and bf16 products
// whose rows or pointers the tensor-core kernel (matmul_wgmma.cu) cannot
// take.
//
// Replaces the TPU kernel `matmul` of src/repro/kernels/matmul_pallas.py
// (pallas_call at :55, body `_matmul_kernel` at :19, tiles fitted by
// `_fit_block` at :32).  It computes the same function: (M,K) @ (K,N) ->
// (M,N) in the input type, summed in float32.
//
// Translation.  The TPU kernel walks K as the sequential third grid axis and
// carries the sum in a VMEM scratch accumulator from one grid step to the
// next.  GPU blocks run in no order, so here one block owns one BM x 128
// output tile for the whole of K and walks K itself, BK deep at a time:
// BK = 16, and BM = 128 where that grid fills the 132 SMs twice over (the
// Fig. 2 shape), else BM = 64, which doubles the blocks of a small product
// and halves the loop body that a lone warp per scheduler must run from
// its instruction cache.  The ragged edge of any M, N and K
// is masked by zero-fill in shared memory; tiles are never shrunk to
// divisors of the dims as `_fit_block` does.
//
// What bounds it.  At the main path's shape, 4096^3 float32 (1.37e11 FLOP),
// the operations take 2.05 ms at the published 67 TFLOP/s of the CUDA
// cores and the 201 MB of bytes 0.06 ms at 3.35 TB/s: bound by operations,
// so the kernel has to keep the FMA pipe issuing.  What stood in its way in
// the first version was shared memory (16 scalar loads, four of them 4-way
// bank conflicts, for every 64 FMAs of a thread) and a single stage, whose
// loads never overlapped the FMAs.  The design:
//   - Thread tiles.  A block has 128 threads (4 warps, 2 x 2, of
//     (BM / 2) x 64) and a thread owns (BM / 16) x 16 outputs: rows
//     4r + {0..3} (and 32 + 4r + {0..3} at BM = 128), columns
//     4c + 16 * j4 + {0..3} of its warp's tile, for lane 4r + c.  Per k step
//     it reads its x values and 16 y values as 16-byte shared loads: a
//     warp's x reads hit 8 consecutive 16-byte words and its y reads 4, so
//     each load is one conflict-free wavefront.  At BM = 128 that is 6
//     loads for 128 FMAs (the first version: 16 for 64), with 128
//     accumulators in registers; two blocks an SM.
//   - A ring of STAGES = 4 tiles in shared memory (66,560 B a block at
//     BM = 128): the copies of tile k + 3 are in flight while tile k is
//     multiplied, with one __syncthreads() per tile.
//   - Copies, float32: x is stored transposed (xs[k][m], row pitch
//     BM + 4) so that a thread's 8 x values are two 16-byte reads.  A copy
//     cannot transpose more than one element, so x moves as 4-byte cp.async
//     copies, a warp's 32 of them covering 8 k x 4 m: each row's 32 bytes
//     are one full sector of global memory, and with the pitch of 132
//     words the 32 destinations fall in 32 distinct banks.  y keeps its
//     layout and moves as 16-byte cp.async copies (the `vector` variant:
//     N % 4 == 0 and a 16-byte aligned y, whose output rows are then also
//     stored 16 bytes at a time) or as 4-byte copies (`scalar`: any N and
//     pointer).  The wrapper picks the variant.
//   - bf16 is 2 bytes a element, under cp.async's smallest copy: its tiles
//     are loaded into registers before tile k is multiplied, and widened
//     with __bfloat162float and stored into the ring after it (widened at
//     the load, the compiler would wait on the loads before the products).
//
// Numbers.  Each output element is one thread's fmaf chain over k in
// ascending order, starting from 0, with no split-K and no atomics: the same
// chain as the first version of this kernel, so the same inputs give the
// same bits in every launch and from every host thread, which is what the
// runtime's promise that a threaded run equals the sequential one bit for
// bit rests on.  float32 stays IEEE fp32 FMA on the CUDA cores, never TF32.
// bf16 inputs are summed in fp32 and rounded once to bf16 (to nearest even)
// on the store, as the reference's float32 accumulator is cast to x.dtype.

#include "simt.cuh"

#include <cstddef>
#include <type_traits>

namespace {

using simt::cp_async16;
using simt::cp_async4;
using simt::cp_async_commit;
using simt::cp_async_wait;
using simt::from_f32;
using simt::to_f32;

constexpr int BN = 128;      // output columns of one block
constexpr int BK = 16;       // depth of one tile of the ring
constexpr int STAGES = 4;    // tiles in the ring
constexpr int THREADS = 128;
constexpr int TN = 16;       // output columns of one thread

// A block's tile: BM = 128 rows on a grid that fills the card twice over,
// else BM = 64 (twice the blocks, and a loop body half the size, which one
// warp a scheduler runs from its instruction cache).  A thread owns
// TM = BM / 16 rows, and copies x from TM row groups of 16.
template <int BM_>
struct Tile {
  static constexpr int BM = BM_, TM = BM / 16;
  static constexpr int XS_PITCH = BM + 4;          // xs[k][m], in floats
  static constexpr int XS_FLOATS = BK * XS_PITCH;
  static constexpr int YS_FLOATS = BK * BN;        // ys[k][n]
  static constexpr int STAGE_FLOATS = XS_FLOATS + YS_FLOATS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
  // per thread and tile: x elements, y elements, y 16-byte vectors
  static constexpr int X_ELEMS = BM * BK / THREADS;
  static constexpr int Y_ELEMS = BK * BN / THREADS;
  static constexpr int Y_VECS = BK * BN / 4 / THREADS;
  static_assert((BM == 64 || BM == 128) && BK == 16 &&
                    TM * TN * THREADS == BM * BN,
                "the copy and fragment maps below are written for these");
  static_assert((STAGE_FLOATS * 4) % 16 == 0 && (XS_FLOATS * 4) % 16 == 0,
                "16-byte shared reads need 16-byte aligned tiles");
  static_assert(2 * SMEM_BYTES <= 232448, "two blocks must fit an SM");
};
using BigTile = Tile<128>;
using SmallTile = Tile<64>;

// One thread's share of a tile's copies.  For the tile at k0 and copy i,
// with g = TM:
//   x element i: m = (tid >> 3) + 16 * (i % g), k = (tid & 7) + 8 * (i / g)
//   y element i: k = i,                         n = tid         (scalar)
//   y vector i:  k = (tid >> 5) + 4 * i,        n = 4 * (tid & 31) (vector)
// A warp's x copies cover 8 k x 4 m, its y copies 32 n or 32 vectors of 4.
template <typename T, bool VEC, typename TL>
struct Copies {
  static constexpr int Y_ROWS = VEC ? 4 : 1;   // y rows from copy i to i + 1
  const T* x;        // x[row0 + (tid >> 3)][tid & 7]
  const T* y;        // y[first k][col0 + n]
  size_t x_rows16;   // 16 rows of x
  size_t y_row;      // one row of y
  int m_left;        // rows of x from this thread's first one to M
  int xk, yk, K;
  bool y_ok;         // this thread's y column (or vector) lies inside N

  __device__ Copies(const T* x_, const T* y_, int M, int N, int K_, int row0,
                    int col0) {
    const int tid = threadIdx.x;
    const int xm = tid >> 3;
    xk = tid & 7;
    yk = VEC ? tid >> 5 : 0;
    const int yn = VEC ? 4 * (tid & 31) : tid;
    K = K_;
    x = x_ + (static_cast<size_t>(row0) + xm) * K + xk;
    y = y_ + static_cast<size_t>(yk) * N + col0 + yn;
    x_rows16 = static_cast<size_t>(16) * K;
    y_row = N;
    m_left = M - row0 - xm;
    y_ok = col0 + yn < N;   // vector: N % 4 == 0, so all four or none
  }

  __device__ const T* x_src(int k0, int i) const {
    return x + (i % TL::TM) * x_rows16 + k0 + 8 * (i / TL::TM);
  }
  __device__ bool x_valid(int k0, int i) const {
    return 16 * (i % TL::TM) < m_left && k0 + xk + 8 * (i / TL::TM) < K;
  }
  // shared offsets within a stage
  __device__ static int x_dst(int i) {
    const int tid = threadIdx.x;
    return ((tid & 7) + 8 * (i / TL::TM)) * TL::XS_PITCH + (tid >> 3) +
           16 * (i % TL::TM);
  }
  __device__ const T* y_src(int k0, int i) const {
    return y + (k0 + Y_ROWS * i) * y_row;
  }
  __device__ bool y_valid(int k0, int i) const {
    return y_ok && k0 + yk + Y_ROWS * i < K;
  }
  __device__ static int y_dst(int i) {
    const int tid = threadIdx.x;
    return TL::XS_FLOATS + (VEC ? ((tid >> 5) + 4 * i) * BN + 4 * (tid & 31)
                                : i * BN + tid);
  }

  // float32: queue the tile at k0 into `stage` as cp.async copies; a copy
  // that is not valid reads nothing and writes zeros
  __device__ void issue(float* stage, int k0) const {
#pragma unroll
    for (int i = 0; i < TL::X_ELEMS; ++i) {
      cp_async4(stage + x_dst(i), x_src(k0, i), x_valid(k0, i));
    }
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < TL::Y_VECS; ++i) {
        cp_async16(stage + y_dst(i), y_src(k0, i), y_valid(k0, i));
      }
    } else {
#pragma unroll
      for (int i = 0; i < TL::Y_ELEMS; ++i) {
        cp_async4(stage + y_dst(i), y_src(k0, i), y_valid(k0, i));
      }
    }
  }

  // bf16: read the tile at k0 into registers (zeros past K, so a tile past
  // the last is all zeros and reads nothing), ...
  __device__ void load(T (&xr)[TL::X_ELEMS], T (&yr)[TL::Y_ELEMS],
                       int k0) const {
    const T zero = from_f32<T>(0.0f);
#pragma unroll
    for (int i = 0; i < TL::X_ELEMS; ++i) {
      xr[i] = x_valid(k0, i) ? *x_src(k0, i) : zero;
    }
#pragma unroll
    for (int i = 0; i < TL::Y_ELEMS; ++i) {
      yr[i] = y_valid(k0, i) ? *y_src(k0, i) : zero;
    }
  }
  // ... and store it into `stage`, widened only here, so that no
  // instruction waits on the loads before the tile is multiplied
  __device__ static void store(float* stage, const T (&xr)[TL::X_ELEMS],
                               const T (&yr)[TL::Y_ELEMS]) {
#pragma unroll
    for (int i = 0; i < TL::X_ELEMS; ++i) stage[x_dst(i)] = to_f32(xr[i]);
#pragma unroll
    for (int i = 0; i < TL::Y_ELEMS; ++i) stage[y_dst(i)] = to_f32(yr[i]);
  }
};

// acc += xs^T ys over the BK k steps of one tile, in ascending k.  The
// thread's rows are am + 32 * h + {0..3} for h < TM / 4, its columns
// bn + 16 * j4 + {0..3} for j4 = 0..3.
template <typename TL>
__device__ __forceinline__ void multiply(const float* __restrict__ stage,
                                         int am, int bn,
                                         float (&acc)[TL::TM][TN]) {
  const float* xs = stage;
  const float* ys = stage + TL::XS_FLOATS;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TL::TM], b[TN];
#pragma unroll
    for (int h = 0; h < TL::TM / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(
          xs + kk * TL::XS_PITCH + am + 32 * h);
      a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z,
      a[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 v =
          *reinterpret_cast<const float4*>(ys + kk * BN + bn + 16 * h);
      b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z,
      b[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

template <typename T, bool VEC, typename TL>
__global__ void __launch_bounds__(THREADS, 2)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ out, int M, int N, int K) {
  static_assert(std::is_same<T, float>::value || !VEC,
                "the vector variant is float32's");
  constexpr int TM = TL::TM;
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.y * TL::BM;
  const int col0 = blockIdx.x * BN;
  const int tiles = (K + BK - 1) / BK;
  const Copies<T, VEC, TL> copies(x, y, M, N, K, row0, col0);

  // warps tile the block 2 x 2, (BM / 2) x 64 each; lane 4r + c owns rows
  // 4r + 32h and columns 4c + 16 * j4 of its warp's tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int am = (warp >> 1) * (TL::BM / 2) + (lane >> 2) * 4;
  const int bn = (warp & 1) * 64 + (lane & 3) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  if constexpr (std::is_same<T, float>::value) {
    // tiles 0 .. STAGES-2 in flight; one commit group per tile, empty
    // past the last, so "tile t landed" is always "<= STAGES-2 pending"
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < tiles) copies.issue(smem + s * TL::STAGE_FLOATS, s * BK);
      cp_async_commit();
    }
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<STAGES - 2>();
      // tile t is visible to all, and every thread is done with tile t-1,
      // whose slot the next copies overwrite
      __syncthreads();
      const int next = t + STAGES - 1;
      if (next < tiles) {
        copies.issue(smem + (next % STAGES) * TL::STAGE_FLOATS, next * BK);
      }
      cp_async_commit();
      multiply<TL>(smem + (t % STAGES) * TL::STAGE_FLOATS, am, bn, acc);
    }
  } else {
    // registers carry one tile: loaded before tile t is multiplied and
    // stored after it, unconditionally (a tile past the last is zeros in
    // a slot nobody reads), so the loads stay ahead of the products
    T xr[TL::X_ELEMS], yr[TL::Y_ELEMS];
    for (int s = 0; s < STAGES - 1 && s < tiles; ++s) {
      copies.load(xr, yr, s * BK);
      Copies<T, VEC, TL>::store(smem + s * TL::STAGE_FLOATS, xr, yr);
    }
    for (int t = 0; t < tiles; ++t) {
      __syncthreads();
      const int next = t + STAGES - 1;
      copies.load(xr, yr, next * BK);
      multiply<TL>(smem + (t % STAGES) * TL::STAGE_FLOATS, am, bn, acc);
      Copies<T, VEC, TL>::store(smem + (next % STAGES) * TL::STAGE_FLOATS,
                                xr, yr);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + am + (i & 3) + 32 * (i >> 2);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int gn = col0 + bn + 16 * h;
      T* o = out + static_cast<size_t>(gm) * N + gn;
      if constexpr (VEC) {
        // N % 4 == 0 and a fresh 16-byte aligned out: whole vectors
        if (gn < N) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gn + j < N) o[j] = from_f32<T>(acc[i][4 * h + j]);
        }
      }
    }
  }
}

template <typename T, bool VEC, typename TL>
cudaError_t launch_tile(const void* x, const void* y, void* out, int M, int N,
                        int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + TL::BM - 1) / TL::BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<T, VEC, TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  matmul_kernel<T, VEC, TL><<<grid, THREADS, TL::SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename T, bool VEC>
int launch(const void* x, const void* y, void* out, int M, int N, int K,
           int device, void* stream) {
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (VEC && (N % 4 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long big_blocks = static_cast<long long>((N + BN - 1) / BN) *
                               ((M + BigTile::BM - 1) / BigTile::BM);
  const auto s = static_cast<cudaStream_t>(stream);
  return big_blocks >= 2LL * sms
             ? launch_tile<T, VEC, BigTile>(x, y, out, M, N, K, s)
             : launch_tile<T, VEC, SmallTile>(x, y, out, M, N, K, s);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major tensors; `stream` is the caller's cudaStream_t.  The
// call only queues the kernel and returns the launch's cudaError_t.
// repro_matmul_f32 is the vector variant: it takes N % 4 == 0 and 16-byte
// aligned y and out, and refuses anything else; the scalar entries take
// any shape and pointer.
extern "C" int repro_matmul_f32(const void* x, const void* y, void* out,
                                int M, int N, int K, int device,
                                void* stream) {
  return launch<float, true>(x, y, out, M, N, K, device, stream);
}

extern "C" int repro_matmul_f32_scalar(const void* x, const void* y,
                                       void* out, int M, int N, int K,
                                       int device, void* stream) {
  return launch<float, false>(x, y, out, M, N, K, device, stream);
}

extern "C" int repro_matmul_bf16(const void* x, const void* y, void* out,
                                 int M, int N, int K, int device,
                                 void* stream) {
  return launch<__nv_bfloat16, false>(x, y, out, M, N, K, device, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
