// Flash attention (forward) for Hopper (sm_90a) on the CUDA cores: the
// float32 route of the port's flash attention (qwen2-7b's prefill at
// compute_dtype float32), and bf16 calls that the tensor-core kernel
// (flash_attention_wgmma.cu) cannot take (D % 8 != 0, or q, k, v not on
// 16-byte boundaries).
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (pallas_call at :94, body
// `_flash_kernel` at :29).  It computes what that kernel computes:
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,g,j] * D**-0.5) v[b,g,j]
// for q (B,H,Sq,D), k, v (B,KH,Sk,D), g = h / (H/KH) (GQA: K/V are read
// through the head map, never repeated), with the online-softmax statistics
// m, l and the accumulator in float32 and the output in q's type.  The
// causal mask is top-left: key j is visible to query i iff j <= i on
// absolute indices from 0, also when Sq != Sk (not FlashAttention-2/3's
// bottom-right convention).  Unlike the TPU kernel it takes any Sq, Sk >= 0
// (ragged tiles are masked) and any head dim 1 <= D <= 128.
//
// Translation.  The TPU kernel walks the kv tiles on a sequential grid axis
// and keeps m, l and acc in VMEM scratch between grid steps.  GPU blocks run
// in no order, so one block owns one (64-row query tile, head, batch) and
// loops over 32-key tiles itself, m, l and acc in registers throughout; the
// heaviest causal query tiles launch first.  One launch a call, no atomics,
// so two launches give the same bits.  The keys are not split across blocks:
// every path of the port fills the card (qwen2-7b's long prefill has 896
// blocks) or has a single key tile (the served 4-12 token prompts), so a
// split would serve no traffic.
//
// What bounds it.  qwen2-7b's long prefill, q (1,28,2048,128), k, v
// (1,4,2048,128) causal: 2,098,176 visible (i, j) pairs per head, 4 * 128
// operations each for the two products, 30.1 GFLOP a launch: 0.449 ms at
// the H100 SXM's published 67 TFLOP/s of float32 on the CUDA cores.  Its
// bytes, q, k, v read once and the output written once, 67.1 MB in
// float32, take 0.020 ms at 3.35 TB/s.  So it is bound by operations, and
// the design keeps the FMA pipe issuing:
//   - Occupancy.  128 threads (4 warps) a block; warp w owns query rows
//     16w..16w+15 of the tile, so a row's statistics never leave its warp.
//     Shared memory at D <= 128 (DP = 128): Q 64 x 132 floats (33,792 B),
//     a ring of 2 stages of K and V, 32 x 132 floats each (67,584 B), and
//     each warp's probabilities, 32 keys x 16 rows (8,192 B): 109,568 B, so
//     two blocks fit an SM's 228 KB (the first version: 119,808 B, one
//     block of 8 warps).  At D <= 64 (DP = 64) it is 60,416 B, three
//     blocks.  Each instantiation asks once per device for the largest
//     shared-memory carveout (prepare()); a static_assert on Layout holds
//     two blocks' shared memory, with the 1 KB the card reserves for each,
//     under the SM's 228 KB, and __launch_bounds__(128, 2) holds the
//     registers to what two blocks may take.
//   - Copies.  K and V tiles arrive by cp.async into the ring: the copies
//     of tile t + 1 are issued right after tile t has landed and are in
//     flight while tile t is multiplied, with one __syncthreads() a tile.
//     float32 rows with D % 4 == 0 and 16-byte aligned q, k, v move as
//     16-byte copies (the `vector` loads), any other float32 as 4-byte
//     copies, a warp's 32 copies on 32 consecutive elements of one row;
//     bf16 (2 bytes, under cp.async's smallest copy) is read into registers
//     before tile t is multiplied and widened into the ring after it.  Tile
//     rows keep their global layout at a pitch of DP + 4 floats, and the
//     copy map is shifts and masks of compile-time powers of two (no
//     division by D).  Columns past D and keys past Sk are zero-filled.
//     Q arrives once, as 4-byte copies that rotate each 4-float chunk to
//     (d+1, d+2, d+3, d): a 16-byte read puts q[d] in the 4th register of
//     a quad and k[d] in the 1st, so the two factors of each FMA sit in
//     registers of opposite parity (register banks).
//   - Micro-tiles.  In S = Q K^T a lane owns 4 rows (rg + 4i, rg = lane & 3)
//     x 4 keys (kg + 8j, kg = lane >> 2) and steps through D four at a
//     time: 4 16-byte reads of Q, 4 of K, 64 FMAs.  In O += P V it owns the
//     same 4 rows x DP / 8 columns (4 kg + 32 jj + {0..3}): per key one
//     16-byte read of P (stored per warp as [key][4 rg + i]) and DP / 32 of
//     V, 4 DP / 2 FMAs (the first version: 16 FMAs for 2 reads, 32 for 3).
//     At the pitch of DP + 4 floats every warp-wide read touches at most 8
//     distinct 16-byte words in distinct banks, so each is one wavefront.
//     Both loops run to compile-time bounds (BK, DP), unrolled 8 chunks
//     (S) and 16 keys (P V) deep.
//   - Masking only where needed.  A tile is masked for a warp only if it
//     crosses the diagonal of the warp's 16 rows or reaches past Sk; a warp
//     skips a tile wholly above its rows (its probabilities would all be
//     0, which leaves m, l and acc bit for bit as they are), and the block
//     stops at the last key its rows can see.
//   - exp2f (no fast math) with log2(e) folded into the scale.  A row's max
//     over a tile is a 3-step __shfl_xor_sync butterfly over the 8 lanes
//     that share its rows; each lane keeps its own share of l, summed once
//     at the end in a fixed order.
// Build (nvcc 12, -O3, sm_90a, `-Xptxas -v` as chip_smoke.py's build line
// prints it): registers of float32 vector / scalar / bf16 at DP = 128:
// 203 / 255 / 255; at DP = 64: 157 / 211 / 195; no spills.
// With two blocks of 128 threads an SM the register file allows 256 each.
//
// What the design does not reach (PERF.md §6): the 0.898 ms that is
// half the bound at the long shape.  Builds of this kernel with the
// shared-memory reads and the softmax taken out (diagnostics whose output
// is wrong, not kept) were not much faster, so the FMA issue rate itself
// bounds it; in its SASS many FFMAs read two operands from one register
// bank (register number mod 2).  Designs that were slower:
// 8 x 4 score and 8 x 8 output micro-tiles over 64-key tiles (two warps a
// row half exchanging row maxima, single K and V slots to fit two blocks),
// and this design with single K and V slots at three blocks an SM: both
// give up the 2-stage ring's overlap.
//
// Masking.  A masked key (causal, or past Sk in a ragged tile) takes part
// in neither the max nor the sum: its score is set to -inf, so its
// probability is exactly 0, and a row that has seen no visible key yet
// keeps m = -inf and rescales nothing (m_use below).  A row with no visible
// key (Sk = 0) has l = 0 and is written as 0, as the TPU kernel's
// `l == 0 -> 1` gives.  Rows past Sq are not written.  Every output
// element is summed in one fixed order, so two launches give the same bits.
// float32 stays IEEE float32 FMA on the CUDA cores, never TF32.

#include "simt.cuh"

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using simt::cp_async16;
using simt::cp_async4;
using simt::cp_async_commit;
using simt::cp_async_wait;
using simt::from_f32;
using simt::to_f32;

constexpr int BQ = 64;          // query rows of one block
constexpr int BK = 32;          // keys of one tile
constexpr int WARPS = 4;        // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_D = 128;

// how a tile moves from global to shared memory
enum class Load { kVector, kScalar, kRegs };

// Shared-memory layout for head dims up to DP (64 or 128).
template <int DP_>
struct Layout {
  static constexpr int DP = DP_;
  static constexpr int PITCH = DP + 4;            // floats a tile row
  static constexpr int Q_FLOATS = BQ * PITCH;
  static constexpr int KV_FLOATS = BK * PITCH;    // one K or V tile
  static constexpr int STAGE_FLOATS = 2 * KV_FLOATS;
  static constexpr int P_FLOATS = BK * 16;        // one warp's [key][row]
  static constexpr int SMEM_BYTES =
      4 * (Q_FLOATS + 2 * STAGE_FLOATS + WARPS * P_FLOATS);
  static constexpr int NJ = DP / 32;              // output column groups
  static_assert(DP == 64 || DP == 128, "the maps below are written for these");
  static_assert((PITCH * 4) % 16 == 0, "16-byte rows");
  static_assert(2 * (SMEM_BYTES + 1024) <= 228 * 1024,
                "two blocks an SM at every head dim");
};

// One thread's copies of a ROWS x DP tile whose rows are D apart in global
// memory: copy i of thread tid covers element (or 4-vector) tid + THREADS*i
// of the row-major tile, so a warp's copies are consecutive in one row.
template <typename T, Load L, int DP, int ROWS, bool ROT = false>
struct Rows {
  static constexpr int PITCH = DP + 4;
  static constexpr int WIDTH = L == Load::kVector ? 4 : 1;   // elements
  static constexpr int PER_ROW = DP / WIDTH;
  static constexpr int N = ROWS * PER_ROW / THREADS;         // per thread
  static_assert(N * THREADS == ROWS * PER_ROW, "whole copies per thread");

  __device__ static int row(int i) {
    return (threadIdx.x + THREADS * i) / PER_ROW;   // powers of two: shifts
  }
  __device__ static int col(int i) {
    return WIDTH * ((threadIdx.x + THREADS * i) % PER_ROW);
  }
  // where column c of a row lands in shared memory
  __device__ static int dst(int r, int c) {
    return r * PITCH + (ROT ? (c & ~3) | ((c + 3) & 3) : c);
  }

  // float32: queue the tile's copies; rows >= valid and columns >= D are
  // zero-filled and read nothing
  __device__ static void issue(float* dst, const T* src, int valid, int D) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = row(i), c = col(i);
      const bool ok = r < valid && c < D;
      const T* s = ok ? src + static_cast<size_t>(r) * D + c : src;
      if constexpr (L == Load::kVector) {
        static_assert(!ROT, "a 16-byte copy cannot rotate");
        cp_async16(dst + r * PITCH + c, s, ok);
      } else {
        cp_async4(dst + Rows::dst(r, c), s, ok);
      }
    }
  }

  // bf16: read into registers (zeros where not valid), ...
  __device__ static void load(T (&reg)[N], const T* src, int valid, int D) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = row(i), c = col(i);
      reg[i] = (r < valid && c < D) ? src[static_cast<size_t>(r) * D + c]
                                    : from_f32<T>(0.0f);
    }
  }
  // ... and widen into shared memory
  __device__ static void store(float* dst, const T (&reg)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[Rows::dst(row(i), col(i))] = to_f32(reg[i]);
  }
  // bf16, where there is nothing to overlap: both at once
  __device__ static void copy(float* dst, const T* src, int valid, int D) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = row(i), c = col(i);
      dst[Rows::dst(r, c)] =
          (r < valid && c < D) ? to_f32(src[static_cast<size_t>(r) * D + c])
                               : 0.0f;
    }
  }
};

template <typename T, Load L, int DP>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int KH, int Sq, int Sk, int D, int causal,
                           float scale_log2) {
  using LY = Layout<DP>;
  constexpr int PITCH = LY::PITCH, NJ = LY::NJ;
  using QRows = Rows<T, L == Load::kRegs ? L : Load::kScalar, DP, BQ, true>;
  using KVRows = Rows<T, L, DP, BK>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                   // [BQ][PITCH]
  float* ring = qs + LY::Q_FLOATS;                    // 2 x (K, V)
  float* ps = ring + 2 * LY::STAGE_FLOATS;            // per warp [BK][16]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 3, kg = lane >> 2;
  // the last query tiles see the most keys under a causal mask: run them
  // first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int g = h / (H / KH);
  const T* qp = q + ((b * H + h) * Sq + r0) * D;
  const T* kp = k + (b * KH + g) * static_cast<size_t>(Sk) * D;
  const T* vp = v + (b * KH + g) * static_cast<size_t>(Sk) * D;
  const int rows = min(BQ, Sq - r0);

  // keys past the tile's last row are masked for all of its rows
  const int kv_end = causal ? min(Sk, r0 + rows) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  // this warp's rows: rw0 + rg + 4i
  const int rw0 = r0 + 16 * warp;
  float* pw = ps + warp * LY::P_FLOATS;

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.0f;
  }

  if (n_tiles > 0) {
    if constexpr (L == Load::kRegs) {
      QRows::copy(qs, qp, rows, D);
      KVRows::copy(ring, kp, Sk, D);
      KVRows::copy(ring + LY::KV_FLOATS, vp, Sk, D);
    } else {
      QRows::issue(qs, qp, rows, D);
      KVRows::issue(ring, kp, Sk, D);
      KVRows::issue(ring + LY::KV_FLOATS, vp, Sk, D);
      cp_async_commit();
    }
  }
  // bf16 only: the next tile, held in registers while this one is used
  T kr[L == Load::kRegs ? KVRows::N : 1], vr[L == Load::kRegs ? KVRows::N : 1];

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t & 1;
    const float* ks = ring + slot * LY::STAGE_FLOATS;
    const float* vs = ks + LY::KV_FLOATS;
    float* next = ring + (slot ^ 1) * LY::STAGE_FLOATS;
    const int c0 = t * BK, c1 = c0 + BK;
    const size_t off1 = static_cast<size_t>(c1) * D;
    const bool more = t + 1 < n_tiles;
    if constexpr (L == Load::kRegs) {
      // tile t is in shared memory, and every thread is done with tile
      // t - 1, whose slot takes tile t + 1 after the products below
      __syncthreads();
      if (more) {
        KVRows::load(kr, kp + off1, Sk - c1, D);
        KVRows::load(vr, vp + off1, Sk - c1, D);
      }
    } else {
      cp_async_wait<0>();
      // tile t is visible to all, and every thread is done with tile t - 1,
      // whose slot the copies of tile t + 1 now overwrite
      __syncthreads();
      if (more) {
        KVRows::issue(next, kp + off1, Sk - c1, D);
        KVRows::issue(next + LY::KV_FLOATS, vp + off1, Sk - c1, D);
      }
      cp_async_commit();
    }

    // a tile wholly above the warp's rows (or a warp wholly past Sq) would
    // give probabilities of exactly 0: skip it
    const bool skip = rw0 >= Sq || (causal && c0 > rw0 + 15);
    if (!skip) {
      // s[i][j]: row rw0 + rg + 4i against key c0 + kg + 8j
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      const float* qa = qs + (16 * warp + rg) * PITCH;
      const float* ka = ks + kg * PITCH;
#pragma unroll 8
      for (int d = 0; d < DP; d += 4) {
        float4 a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(qa + 4 * i * PITCH + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = *reinterpret_cast<const float4*>(ka + 8 * j * PITCH + d);
        }
        // a[i] holds (q[d+1], q[d+2], q[d+3], q[d]): d in ascending order
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].w, c[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].x, c[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].y, c[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].z, c[j].w, s[i][j]);
          }
      }

      // only a tile that crosses the diagonal of the warp's rows or
      // reaches past Sk is masked
      const bool mask = (causal && c0 + BK - 1 > rw0) || c1 > Sk;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = rw0 + rg + 4 * i, col = c0 + kg + 8 * j;
          const bool hidden = mask && (col >= Sk || (causal && col > r));
          s[i][j] = hidden ? -INFINITY : s[i][j] * scale_log2;
        }

      // online softmax, per row, in base 2
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        const float m_new = fmaxf(m[i], mx);
        // no visible key yet: nothing to rescale, and exp2(-inf) gives 0
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        const float corr = exp2f(m[i] - m_use);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = exp2f(s[i][j] - m_use);  // masked: exactly 0
          sum += s[i][j];
        }
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float4*>(pw + (kg + 8 * j) * 16 + 4 * rg) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      }
      __syncwarp();

      // acc[i][4jj + e] += p[row i][key] * v[key][4kg + 32jj + e]
      const float* pa = pw + 4 * rg;
      const float* va = vs + 4 * kg;
#pragma unroll 16
      for (int key = 0; key < BK; ++key) {
        const float4 p4 = *reinterpret_cast<const float4*>(pa + key * 16);
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 x =
              *reinterpret_cast<const float4*>(va + key * PITCH + 32 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * jj] = fmaf(p[i], x.x, acc[i][4 * jj]);
            acc[i][4 * jj + 1] = fmaf(p[i], x.y, acc[i][4 * jj + 1]);
            acc[i][4 * jj + 2] = fmaf(p[i], x.z, acc[i][4 * jj + 2]);
            acc[i][4 * jj + 3] = fmaf(p[i], x.w, acc[i][4 * jj + 3]);
          }
        }
      }
    }

    if constexpr (L == Load::kRegs) {
      if (more) {
        KVRows::store(next, kr);
        KVRows::store(next + LY::KV_FLOATS, vr);
      }
    }
  }

  // each lane holds its share of l: sum the 8 lanes of a row (a butterfly
  // leaves the same bits in every lane)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
    }
  }

  const size_t row_base = (b * H + h) * Sq + r0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * warp + rg + 4 * i;
    if (r >= rows) continue;
    const size_t row = row_base + r;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = 4 * kg + 32 * jj;
      const float o4[4] = {acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                           acc[i][4 * jj + 2] * inv,
                           acc[i][4 * jj + 3] * inv};
      if constexpr (L == Load::kVector) {
        // D % 4 == 0 and a 16-byte aligned out: whole vectors
        if (c < D) {
          *reinterpret_cast<float4*>(out + row * D + c) =
              make_float4(o4[0], o4[1], o4[2], o4[3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < D) out[row * D + c + e] = from_f32<T>(o4[e]);
        }
      }
    }
  }
}

// The kernel's attributes: set once per device for the life of the process
// (a race sets them twice, which is harmless), so a launch adds no host call.
template <typename T, Load L, int DP>
cudaError_t prepare(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit =
      device < 64 ? 1ull << device : 0ull;   // devices past 64: every call
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, L, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<DP>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // as much of the SM's 256 KB as shared memory allows, so that two (D >
  // 64) or three (D <= 64) blocks fit
  err = cudaFuncSetAttribute(flash_attention_kernel<T, L, DP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, Load L, int DP>
cudaError_t launch_dp(const T* q, const T* k, const T* v, T* out, int B,
                      int H, int KH, int Sq, int Sk, int D, int causal,
                      int device, cudaStream_t s) {
  cudaError_t err = prepare<T, L, DP>(device);
  if (err != cudaSuccess) return err;
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((Sq - 1) / BQ + 1, H, B);   // Sq > 0
  flash_attention_kernel<T, L, DP><<<grid, THREADS, Layout<DP>::SMEM_BYTES,
                                     s>>>(q, k, v, out, H, KH, Sq, Sk, D,
                                          causal, scale_log2);
  return cudaGetLastError();
}

template <typename T, Load L>
cudaError_t launch_load(const T* q, const T* k, const T* v, T* out, int B,
                        int H, int KH, int Sq, int Sk, int D, int causal,
                        int device, cudaStream_t s) {
  if (D <= 64) {
    return launch_dp<T, L, 64>(q, k, v, out, B, H, KH, Sq, Sk, D, causal,
                               device, s);
  }
  return launch_dp<T, L, 128>(q, k, v, out, B, H, KH, Sq, Sk, D, causal,
                              device, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int Sq, int Sk, int D, int causal, int device,
           void* stream) {
  if (B < 0 || H < 1 || KH < 1 || H % KH != 0 || Sq < 0 || Sk < 0 ||
      D < 1 || D > MAX_D || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    if (D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
        aligned16(out)) {
      return launch_load<T, Load::kVector>(qp, kp, vp, op, B, H, KH, Sq, Sk,
                                           D, causal, device, s);
    }
    return launch_load<T, Load::kScalar>(qp, kp, vp, op, B, H, KH, Sq, Sk,
                                         D, causal, device, s);
  } else {
    return launch_load<T, Load::kRegs>(qp, kp, vp, op, B, H, KH, Sq, Sk, D,
                                       causal, device, s);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major tensors q (B,H,Sq,D), k, v (B,KH,Sk,D) and out
// (B,H,Sq,D); `causal` is 0 or 1; `stream` is the caller's cudaStream_t.
// The call only queues the kernel and returns the launch's cudaError_t.
extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int H, int KH, int Sq, int Sk, int D,
                                         int causal, int device,
                                         void* stream) {
  return launch<float>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, device,
                       stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int KH, int Sq, int Sk,
                                          int D, int causal, int device,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, H, KH, Sq, Sk, D, causal,
                               device, stream);
}
