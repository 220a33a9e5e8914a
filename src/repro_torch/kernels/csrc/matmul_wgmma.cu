// Blocked bf16 matrix product for Hopper (sm_90a) on the tensor cores:
// wgmma fed by TMA.  The bf16 route of the port's matmul (the wrapper in
// kernels/matmul.py picks it for bf16 with K % 8 == 0 and N % 8 == 0;
// float32 and other bf16 shapes keep csrc/matmul.cu on the CUDA cores).
//
// Replaces, like csrc/matmul.cu, the TPU kernel `matmul` of
// src/repro/kernels/matmul_pallas.py (pallas_call at :55, body
// `_matmul_kernel` at :19): (M,K) @ (K,N) -> (M,N) in bf16, summed in
// float32 and rounded once to bf16 (to nearest even) on the store, as the
// reference's float32 accumulator is cast to x.dtype.
//
// Translation.  The TPU kernel walks K on a sequential grid axis with a
// VMEM accumulator.  Here one block owns one 128x256 output tile for the
// whole of K, and three warpgroups split the work:
//   - warpgroup 2, the producer: one thread issues TMA loads of 64-deep
//     stages, x[m0:+128, k0:+64] as one box and y[k0:+64, n0:+256] as four
//     64x64 boxes, into a ring of 4 stages, each guarded by a "full"
//     mbarrier (TMA's bytes) and an "empty" one (the consumers' release);
//   - warpgroups 0 and 1, the consumers: each owns 64 output rows and
//     issues wgmma m64n128k16 twice per 16-deep step (the tile's two
//     128-column halves), with both operands read from shared memory; its
//     64x256 float32 sum is 128 registers a thread (setmaxnreg gives the
//     consumers 232 registers and the producer 40).
// x (M,K) is K-major as stored; y (K,N) row-major is MN-major, read with
// the descriptor's transpose bit and never copied transposed.  The 128-byte
// swizzle of the tensor maps is the layout the descriptors name
// (hopper.cuh).  A consumer keeps one k-stage's wgmma in flight while it
// issues the next (wgmma.wait_group 1), and releases a stage only after the
// wgmma that read it has completed.  The ragged edges of M, N and K come
// from TMA's zero fill and a masked store, never from shrinking tiles.
//
// Numbers.  Each output element is one fixed sequence of wgmma steps over K
// (k ascending), with no split-K and no atomics, so two launches give the
// same bits.  The tensor cores' order of the products inside one k16 step
// is the hardware's own, so the result may differ from csrc/matmul.cu's in
// the last float32 bits before the bf16 rounding.
//
// Bound at 4096^3 in bf16: 2 * 4096^3 = 1.37e11 operations, 0.139 ms at
// the H100 SXM's 989 TFLOP/s; its 100.7 MB take 0.030 ms at 3.35 TB/s.
// Bound by operations.  One block per SM (197,696 B of shared memory); the
// ring lets TMA bring three stages ahead while the tensor cores work.  What
// holds it back from the bound: one output tile per block, so each tile's
// epilogue (plain 4-byte stores from registers) and the next block's first
// loads do not overlap the products, and the last wave of 128x256 tiles
// leaves SMs idle.

#include "hopper.cuh"

#include <cstddef>

namespace {

using namespace hopper;

constexpr int BM = 128;         // output rows of one block
constexpr int BN = 256;         // output columns of one block
constexpr int BK = 64;          // depth of one stage: one 128-byte line
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;    // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr uint32_t A_BYTES = BM * BK * 2;          // x box: 16 KB
constexpr uint32_t B_BOX_BYTES = BK * 64 * 2;      // 64 k x 64 n: 8 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + (BN / 64) * B_BOX_BYTES;
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(STAGES) * STAGE_BYTES + 2 * STAGES * 8 + kSwizzleAtom;

static_assert(BM == 64 * CONSUMERS, "one consumer per 64 rows");
static_assert(SMEM_BYTES <= 232448, "over the block's shared memory");

// The 64x128 half `d` of a consumer's sum to out, rounded to bf16; `row` is
// the thread's first row, `col` its first column of the half.
__device__ __forceinline__ void store_half(const float (&d)[64],
                                           __nv_bfloat16* __restrict__ out,
                                           int row, int col, int M, int N) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col + 8 * j;   // c and c + 1; N is even
    if (c >= N) continue;
    if (row < M) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N + c) =
          pack_bf16(d[4 * j], d[4 * j + 1]);
    }
    if (row + 8 < M) {
      *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row + 8) * N +
                                   c) = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap ymap,
                        __nv_bfloat16* __restrict__ out, int M, int N,
                        int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (kSwizzleAtom - smem_addr(smem_raw) %
                              kSwizzleAtom) % kSwizzleAtom;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  const int nk = (K + BK - 1) / BK;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        const uint32_t use = kt / STAGES;
        mbar_wait(&empty[s], (use & 1) ^ 1);   // use 0 passes at once
        uint8_t* a = smem + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(a, &xmap, &full[s], kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          tma_load_2d(b + j * B_BOX_BYTES, &ymap, &full[s], n0 + 64 * j,
                      kt * BK);
        }
      }
    }
  } else {
    regs_alloc<232>();
    float acc0[64], acc1[64];   // the tile's two 128-column halves
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] = 0.0f;
      acc1[i] = 0.0f;
    }
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint32_t a = smem_addr(smem + s * STAGE_BYTES) + wg * 64 * 128;
      const uint32_t b = smem_addr(smem + s * STAGE_BYTES + A_BYTES);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc_sw128(a + 32 * kk, 16, kSwizzleAtom);
        wgmma_ss_m64n128k16<1>(
            acc0, da, desc_sw128(b + 2048 * kk, B_BOX_BYTES, kSwizzleAtom),
            1);
        wgmma_ss_m64n128k16<1>(
            acc1, da,
            desc_sw128(b + 2 * B_BOX_BYTES + 2048 * kk, B_BOX_BYTES,
                       kSwizzleAtom),
            1);
      }
      wgmma_commit();
      fence_regs(acc0);
      fence_regs(acc1);
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);

    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
    const int col = n0 + 2 * (lane % 4);
    store_half(acc0, out, row, col, M, N);
    store_half(acc1, out, row, col + 128, M, N);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  x (M,K), y (K,N) and out (M,N)
// are contiguous row-major bf16 device tensors, 16-byte aligned, with
// K % 8 == 0 and N % 8 == 0 (TMA needs 16-byte row strides).  The call
// only queues the kernel and returns the launch's cudaError_t.
extern "C" int repro_matmul_bf16_wgmma(const void* x, const void* y,
                                       void* out, int M, int N, int K,
                                       int device, void* stream) {
  if (M < 0 || N < 0 || K < 0 || K % 8 != 0 || N % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, ymap{};   // K == 0: no stage is loaded
  if (K > 0) {
    const uint64_t xdims[2] = {static_cast<uint64_t>(K),
                               static_cast<uint64_t>(M)};
    const uint64_t xstrides[1] = {static_cast<uint64_t>(K) * 2};
    const uint32_t xbox[2] = {BK, BM};
    err = make_map(&xmap, x, 2, xdims, xstrides, xbox);
    if (err != cudaSuccess) return err;
    const uint64_t ydims[2] = {static_cast<uint64_t>(N),
                               static_cast<uint64_t>(K)};
    const uint64_t ystrides[1] = {static_cast<uint64_t>(N) * 2};
    const uint32_t ybox[2] = {64, BK};
    err = make_map(&ymap, y, 2, ydims, ystrides, ybox);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(matmul_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  matmul_wgmma_kernel<<<grid, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      xmap, ymap, static_cast<__nv_bfloat16*>(out), M, N, K);
  return cudaGetLastError();
}
