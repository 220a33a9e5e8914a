// Blocked bf16 matrix product for Hopper (sm_90a) on the tensor cores:
// persistent blocks, wgmma fed by TMA, an epilogue stored by TMA.  The bf16
// route of the port's matmul (the wrapper in kernels/matmul.py picks it for
// bf16 with K % 8 == 0 and N % 8 == 0 on 16-byte aligned tensors; float32
// and other bf16 shapes keep csrc/matmul.cu on the CUDA cores).
//
// Replaces, like csrc/matmul.cu, the TPU kernel `matmul` of
// src/repro/kernels/matmul_pallas.py (pallas_call at :55, body
// `_matmul_kernel` at :19): (M,K) @ (K,N) -> (M,N) in bf16, summed in
// float32 and rounded once to bf16 (to nearest even) on the store, as the
// reference's float32 accumulator is cast to x.dtype.
//
// Translation.  The TPU kernel walks K on a sequential grid axis with a
// VMEM accumulator.  Here one block owns one 128 x BN output tile at a time
// for the whole of K, and walks many tiles:
//   - The plan (kernels/matmul.py::plan, on the host, per (M, N) and the
//     blocks the card runs at once) picks BN, 256 or 128, by the fewest
//     waves times a tile's work (1000x1528: 96 tiles of 128x128 in one
//     wave, not 48 of 128x256), the block count, min(tiles, resident), and
//     the raster group.  Block b takes tiles b, b + blocks, ... in grouped
//     raster order (tile_coords: `group` rows of tiles at a time, down each
//     column of the group; the plan picks the group whose first wave reads
//     the fewest rows of x and columns of y, so the tiles in flight share
//     them in L2).
//   - Warpgroup 2, the producer (setmaxnreg 40): one thread issues TMA
//     loads of 64-deep stages, x[m0:+128, k0:+64] as one box and y[k0:+64,
//     n0:+BN] as BN/64 boxes of 64x64, into a ring of STAGES stages, each
//     guarded by a "full" mbarrier (TMA's bytes) and an "empty" one (the
//     consumers' release).  The ring's index and phase run on across
//     tiles, so the next tile's loads land while this tile's last products
//     and its epilogue run.
//   - Warpgroups 0 and 1, the consumers (setmaxnreg 232): each owns 64
//     output rows and issues one wgmma a 16-deep step, m64n256k16 (BN 256)
//     or m64n128k16 (BN 128), both operands from shared memory; its 64 x BN
//     float32 sum is BN/2 registers a thread.  A consumer keeps one stage's
//     products in flight while it issues the next (wgmma.wait_group 1) and
//     then releases the earlier stage: one thread of the warpgroup arrives
//     on its empty barrier.
//   - Epilogue through shared memory: each consumer rounds its sum to bf16
//     into its own 64-row staging tile (128B-swizzled as TMA reads it: row
//     r's 16-byte chunk j at chunk j ^ (r % 8), which also spreads a warp's
//     writes over all 32 banks), fences it for the async proxy, and one of
//     its threads stores it with a 2-D TMA map over out in 64x64 boxes.  TMA
//     clips rows past M and columns past N.  The consumer then starts the
//     next tile's products while the store drains; it writes the staging
//     tile again only after the store has read it (bulk wait_group.read).
//     At BN 256 the 64 x 256 sum goes out in two rounds of 128 columns, so
//     the ring keeps 4 stages (Tile<256>).
// x (M,K) is K-major as stored; y (K,N) row-major is MN-major, read with
// the descriptor's transpose bit and never copied transposed.  The 128-byte
// swizzle of the tensor maps is the layout the descriptors name
// (hopper.cuh).  The ragged edges of M, N and K come from TMA's zero fill
// on the loads and its clipping on the stores, never from shrinking tiles.
//
// Numbers.  Each output element is one fixed sequence of k16 products over
// K (k ascending), with no split-K, no stream-K and no atomics, so two
// launches give the same bits, and which block runs a tile changes nothing.
// The products' width (m64n256k16, m64n128k16) does not change an
// element's sum: the redesign kept the bits of the one-tile-a-block kernel
// it replaced, which issued two m64n128k16 a step (PERF.md §6).  The tensor
// cores' order of the products inside one k16 step is the hardware's own,
// so the result may differ from csrc/matmul.cu's in the last float32 bits
// before the bf16 rounding.
//
// Bound at 4096^3 in bf16: 2 * 4096^3 = 1.37e11 operations, 0.139 ms at
// the H100 SXM's 989 TFLOP/s; its 100.7 MB take 0.030 ms at 3.35 TB/s.
// Bound by operations.  At 1000x1528x776: 2.37e9 operations, 0.0024 ms; 7.0
// MB, 0.0021 ms.  One block an SM: 230,464 B of shared memory at BN 256 (4
// stages of 48 KB, two 16 KB staging tiles), 230,496 B at BN 128 (6 stages
// of 32 KB, two 16 KB staging tiles).  What still holds it back
// (matmul_causes.py): both consumers drain their sums to shared memory at
// the same time, so the tensor cores idle for that part of each epilogue
// (a ping-pong of two consumers on alternate tiles would hide it); the
// last wave of 4096^3's 512 tiles fills 116 of 132 SMs; and at small
// shapes the pipeline's fill and drain are a large share of a few
// microseconds of work.  Clusters of two blocks on tiles one above the
// other, multicasting the y tile they share, were tried and taken out:
// they gained under 1 % at 4096^3 and 8 % at 1000x1528x776, and lost 19 %
// at 4104x4096x4096 and 50 % at 128x18944x3584, where a cluster's tile
// past M and the narrower tiles it forced added waves (PERF.md §6).

#include "hopper.cuh"

#include <atomic>
#include <climits>
#include <cstddef>

namespace {

using namespace hopper;

constexpr int BM = 128;         // output rows of a tile
constexpr int BK = 64;          // depth of one stage: one 128-byte line
constexpr int CONSUMERS = 2;    // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr uint32_t A_BYTES = BM * BK * 2;       // x box: 16 KB
constexpr uint32_t BOX_BYTES = 64 * 64 * 2;     // a 64x64 box of y or out
constexpr int MAX_DEVICES = 64;

static_assert(BM == 64 * CONSUMERS, "one consumer per 64 rows");

// Each tile shape's budget: the ring's stages and the columns of one
// epilogue round.
template <int BN>
struct Tile;
template <>
struct Tile<256> {
  static constexpr int STAGES = 4, EPI_COLS = 128;
};
template <>
struct Tile<128> {
  static constexpr int STAGES = 6, EPI_COLS = 128;
};

template <int BN>
struct Smem {
  static constexpr int STAGES = Tile<BN>::STAGES;
  static constexpr int EPI_COLS = Tile<BN>::EPI_COLS;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + (BN / 64) * BOX_BYTES;
  // one consumer's staging tile: 64 rows x EPI_COLS
  static constexpr uint32_t EPI_BYTES = (EPI_COLS / 64) * BOX_BYTES;
  static constexpr size_t EPI = static_cast<size_t>(STAGES) * STAGE_BYTES;
  static constexpr size_t BARS = EPI + CONSUMERS * EPI_BYTES;
  static constexpr size_t BYTES = BARS + 2 * STAGES * 8 + kSwizzleAtom;
  static_assert(BN % EPI_COLS == 0 && EPI_COLS % 64 == 0, "whole boxes");
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

// Tile t's row and column of tiles in grouped raster order: `group` rows
// of tiles at a time, down each column of the group before the next one
// (kernels/matmul.py::tile_coords is the same formula).
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n,
                                            int group, int& tm, int& tn) {
  const int per_group = group * tiles_n;
  const int first = (t / per_group) * group;
  const int rows = min(tiles_m - first, group);
  const int r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// One 16-deep step of a consumer's 64 x BN sum: x's 64x16 slice at
// descriptor `da`, y's 16 x BN slice at shared address `b`.
template <int BN>
__device__ __forceinline__ void issue_step(float (&acc)[BN / 2], uint64_t da,
                                           uint32_t b) {
  if constexpr (BN == 256) {
    wgmma_ss_m64n256k16<1>(acc, da, desc_sw128(b, BOX_BYTES, kSwizzleAtom),
                           1);
  } else {
    wgmma_ss_m64n128k16<1>(acc, da, desc_sw128(b, BOX_BYTES, kSwizzleAtom),
                           1);
  }
}

// A consumer warpgroup hands a stage back to the producer: one arrival,
// after its wgmma wait has completed the warpgroup's products that read
// the stage.
__device__ __forceinline__ void release(uint64_t* empty) {
  if (threadIdx.x % 128 == 0) mbar_arrive(empty);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap ymap,
                        const __grid_constant__ CUtensorMap omap, int M,
                        int N, int K, int tiles_m, int tiles_n, int group) {
  using L = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (kSwizzleAtom - smem_addr(smem_raw) %
                              kSwizzleAtom) % kSwizzleAtom;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + L::STAGES;

  const int wg = threadIdx.x / 128;
  const int nk = (K + BK - 1) / BK;
  const int tiles = tiles_m * tiles_n;

  if (threadIdx.x == CONSUMERS * 128) {   // the producer's thread
    prefetch_map(&xmap);
    prefetch_map(&ymap);
    prefetch_map(&omap);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);   // one arrival a consumer
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full, tile after tile
    regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      uint32_t it = 0;   // stages loaded so far, over all tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, tiles_m, tiles_n, group, tm, tn);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % L::STAGES;
          // use 0 passes at once; later ones wait for both consumers to
          // hand the stage back
          mbar_wait(&empty[s], ((it / L::STAGES) & 1) ^ 1);
          uint8_t* a = smem + s * L::STAGE_BYTES;
          uint8_t* b = a + A_BYTES;
          mbar_arrive_expect_tx(&full[s], L::STAGE_BYTES);
          tma_load_2d(a, &xmap, &full[s], kt * BK, tm * BM);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            tma_load_2d(b + j * BOX_BYTES, &ymap, &full[s], tn * BN + 64 * j,
                        kt * BK);
          }
        }
      }
    }
    return;
  }

  regs_alloc<232>();
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int ra = warp * 16 + lane / 4;   // the thread's rows ra, ra + 8
  const bool leader = threadIdx.x % 128 == 0;
  uint8_t* stage = smem + L::EPI + wg * L::EPI_BYTES;
  float acc[BN / 2];
  uint32_t it = 0;   // stages consumed so far, over all tiles
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int tm, tn;
    tile_coords(t, tiles_m, tiles_n, group, tm, tn);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % L::STAGES;
      mbar_wait(&full[s], (it / L::STAGES) & 1);
      const uint32_t a = smem_addr(smem + s * L::STAGE_BYTES) + wg * 64 * 128;
      const uint32_t b = smem_addr(smem + s * L::STAGE_BYTES + A_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        issue_step<BN>(acc, desc_sw128(a + 32 * kk, 16, kSwizzleAtom),
                       b + 2048 * kk);
      }
      wgmma_commit();
      fence_regs(acc);
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (kt > 0) release(&empty[(it - 1) % L::STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (nk > 0) release(&empty[(it - 1) % L::STAGES]);

    // epilogue: BN / EPI_COLS rounds through the staging tile
    const int row0 = tm * BM + wg * 64;
#pragma unroll
    for (int r = 0; r < BN / L::EPI_COLS; ++r) {
      if (leader) bulk_wait_read<0>();   // the last store has read the tile
      named_bar_sync(1 + wg, 128);       // this warpgroup's own barrier
#pragma unroll
      for (int jj = 0; jj < L::EPI_COLS / 8; ++jj) {
        const int j = r * (L::EPI_COLS / 8) + jj;   // acc[4j..4j+3]
        uint8_t* box = stage + (jj / 8) * BOX_BYTES;
        const int chunk = ((jj % 8) ^ (ra % 8)) << 4;   // (ra + 8) % 8 too
        *reinterpret_cast<uint32_t*>(box + ra * 128 + chunk +
                                     4 * (lane % 4)) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(box + (ra + 8) * 128 + chunk +
                                     4 * (lane % 4)) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      // (the second consumer's rows may all lie past M)
      if (leader && row0 < M) {
#pragma unroll
        for (int c = 0; c < L::EPI_COLS / 64; ++c) {
          const int col = tn * BN + r * L::EPI_COLS + 64 * c;
          if (col < N) tma_store_2d(&omap, stage + c * BOX_BYTES, col, row0);
        }
        bulk_commit();
      }
    }
  }
  if (leader) bulk_wait<0>();   // out is written before the block ends
}

// Sets the kernel's shared-memory limit, once per device.
template <int BN>
cudaError_t configure(int device) {
  static std::atomic<bool> ready[MAX_DEVICES];
  if (device < MAX_DEVICES && ready[device].load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<BN>::BYTES));
  if (err == cudaSuccess && device < MAX_DEVICES) ready[device].store(true);
  return err;
}

template <int BN>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& ymap,
                   const CUtensorMap& omap, int M, int N, int K, int tiles_m,
                   int tiles_n, int blocks, int group, int device,
                   cudaStream_t stream) {
  const cudaError_t err = configure<BN>(device);
  if (err != cudaSuccess) return err;
  matmul_wgmma_kernel<BN><<<blocks, THREADS, Smem<BN>::BYTES, stream>>>(
      xmap, ymap, omap, M, N, K, tiles_m, tiles_n, group);
  return cudaGetLastError();
}

cudaError_t set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// A map over a row-major (rows, cols) bf16 tensor, boxes of box_rows x
// box_cols.
cudaError_t matrix_map(CUtensorMap* map, const void* base, int rows,
                       int cols, uint32_t box_rows, uint32_t box_cols) {
  const uint64_t dims[2] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(cols) * 2};
  const uint32_t box[2] = {box_cols, box_rows};
  return make_map(map, base, 2, dims, strides, box);
}

}  // namespace

// Plain C interface, loaded with ctypes.  x (M,K), y (K,N) and out (M,N)
// are contiguous row-major bf16 device tensors, 16-byte aligned, with
// K % 8 == 0 and N % 8 == 0 (TMA needs 16-byte row strides).  bn, blocks
// and group are kernels/matmul.py::plan's: the tile's columns (128 or 256),
// the persistent blocks (1..tiles) and the raster group (1..rows of
// tiles).  The call only queues the kernel and returns the launch's
// cudaError_t.
extern "C" int repro_matmul_bf16_wgmma(const void* x, const void* y,
                                       void* out, int M, int N, int K, int bn,
                                       int blocks, int group, int device,
                                       void* stream) {
  if (M < 0 || N < 0 || K < 0 || K % 8 != 0 || N % 8 != 0 ||
      (bn != 128 && bn != 256) || device < 0) {
    return cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return cudaSuccess;
  const long long tiles_m = (static_cast<long long>(M) + BM - 1) / BM;
  const long long tiles_n = (static_cast<long long>(N) + bn - 1) / bn;
  if (tiles_m * tiles_n > INT_MAX / 2 || blocks < 1 ||
      blocks > tiles_m * tiles_n || group < 1 || group > tiles_m) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, ymap{}, omap{};   // K == 0: no stage is loaded
  err = matrix_map(&omap, out, M, N, 64, 64);
  if (err == cudaSuccess && K > 0) {
    err = matrix_map(&xmap, x, M, K, BM, BK);
    if (err == cudaSuccess) err = matrix_map(&ymap, y, K, N, BK, 64);
  }
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const int tm = static_cast<int>(tiles_m), tn = static_cast<int>(tiles_n);
  if (bn == 256) {
    return launch<256>(xmap, ymap, omap, M, N, K, tm, tn, blocks, group,
                       device, s);
  }
  return launch<128>(xmap, ymap, omap, M, N, K, tm, tn, blocks, group, device,
                     s);
}

// How many blocks of the kernel the card runs at once, into *count: the
// blocks an SM holds (one: both tile shapes take over half of its shared
// memory) times the SMs.  kernels/matmul.py::plan takes it as the card's
// parallelism.
extern "C" int repro_matmul_bf16_wgmma_resident(int device, void* count) {
  if (device < 0) return cudaErrorInvalidValue;
  cudaError_t err = set_device(device);
  if (err == cudaSuccess) err = configure<256>(device);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, matmul_wgmma_kernel<256>, THREADS, Smem<256>::BYTES);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  *static_cast<int*>(count) = per_sm * sms;
  return err;
}
