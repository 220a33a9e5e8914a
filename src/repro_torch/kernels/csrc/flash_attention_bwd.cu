// Flash attention's backward for Hopper (sm_90a) on the CUDA cores: the
// float32 route of the gradient of the port's flash attention (phase 11b's
// reduced launcher and every float32 training step), and bf16 calls that
// the tensor-core kernel (flash_attention_bwd_wgmma.cu) cannot take
// (D % 8 != 0, or q, k, v, out, dout not on 16-byte boundaries).
//
// Replaces no TPU kernel: the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py has no backward, and the JAX package
// trains by differentiating its attention, src/repro/models/layers.py
// `attention_scores` (:166), through XLA.  This computes that gradient:
// for out = softmax(scale * q k^T) v with scale = D**-0.5, GQA (query head
// h reads kv head h / (H/KH)) and the top-left causal mask (key j visible
// to query i iff j <= i on absolute indices from 0, also when Sq != Sk),
// given dout and the forward's row log-sum-exp lse (natural log of
// sum_j exp(scale * q.k_j), csrc/flash_attention.cu's header):
//   P = exp(scale * q k^T - lse),  dV = P^T dO,  dP = dO V^T,
//   dS = P o (dP - delta),  dQ = scale * dS K,  dK = scale * dS^T Q,
// with delta = rowsum(dO o O) from the pre-pass (flash_attention_bwd.cuh).
// dK and dV of a kv head sum over its G = H/KH query heads.
//
// Design: two passes, neither with atomics, so every output is summed in
// one fixed order and two launches give the same bits.
//   - dK/dV: one block owns 64 keys of one (kv head, batch); it keeps K and
//     V in shared memory, loops over the G query heads and, for each, over
//     the 64-row query tiles from the tile of its first key on (causal),
//     and keeps dK and dV in registers across the whole loop;
//   - dQ: one block owns 64 query rows of one (head, batch) and loops over
//     the 64-key tiles up to its last row's diagonal (causal); the
//     heaviest query tiles launch first.
// Each pass recomputes S and dP for its pairs, so the backward does 7
// products a visible pair (14 D operations; S^T, dP^T, dV, dK in the
// first, S, dP, dQ in the second) where an atomic dQ would do 5.  Tiles
// are staged in shared memory as float32 at a pitch of DP + 4 (DP = 64 or
// 128, D padded with zeros), 256 threads a block; in the score products a
// thread owns 4 x 4 (key, query) pairs, rows tg + 16i against rows tc + 16j
// (tg = tid / 16, tc = tid % 16), read as 16-byte vectors, so a quarter
// warp's reads fall in distinct banks; in the accumulating products it
// owns 4 rows x 4 DP / 64 columns (4 tc + 64 jj + e).  Loads are plain
// loads into shared memory between two __syncthreads(), not overlapped
// with the products: a simple kernel, right first.
//
// Numbers.  float32 stays IEEE float32 FMA on the CUDA cores, never TF32.
// For bf16 inputs, P is rounded to bf16 where it meets dO in dV, as the
// forward rounds it before P V and as the plain backward
// (kernels/flash_attention.py::attention_backward) does; every other value
// stays float32 and the outputs are rounded once, to the inputs' type.  A
// masked pair (causal, or a key past Sk) has P = 0 exactly; query rows past
// Sq read lse = +inf, so their P is 0 too; rows of dK, dV past Sk and of dQ
// past Sq are not written.  The wrapper launches nothing when Sq or Sk is
// 0 (the gradients are zeros).
//
// Bound (published H100 SXM peaks; launch/costs.py::flash_backward_bound).
// qwen2-7b's training attention, q (2,28,2048,128), k, v (2,4,2048,128),
// causal, float32: 117,497,856 visible pairs, 10 D operations each for the
// five products the gradient needs, 150.4 GFLOP: 2.245 ms at 67 TFLOP/s on
// the CUDA cores; its 269 MB (q, k, v, out, dout, lse read, dq, dk, dv
// written) take 0.080 ms at 3.35 TB/s.  Bound by operations.  What holds
// it back: the two recomputed products, the diagonal tiles computed whole,
// and the loads that stall the block between its products.

#include "flash_attention_bwd.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using simt::from_f32;
using simt::to_f32;

constexpr int BT = 64;          // keys (dK/dV) or queries (dQ) of a block,
                                // and of each tile it loops over
constexpr int THREADS = 256;
constexpr int MAX_D = 128;

template <int DP_>
struct Layout {
  static constexpr int DP = DP_;
  static constexpr int PITCH = DP + 4;      // floats a row of a D tile
  static constexpr int TILE = BT * PITCH;   // one 64-row D tile
  static constexpr int SPITCH = BT + 4;     // floats a row of a pair tile
  static constexpr int PAIRS = BT * SPITCH;
  // dK/dV: K, V, Q, dO, P, dS, lse, delta; dQ: Q, dO, K, V, dS, lse, delta
  static constexpr int KV_BYTES = 4 * (4 * TILE + 2 * PAIRS + 2 * BT);
  static constexpr int Q_BYTES = 4 * (4 * TILE + PAIRS + 2 * BT);
  static_assert(DP == 64 || DP == 128, "the maps below are written for these");
  static_assert(KV_BYTES <= 232448, "over the block's shared memory");
};

// The ROWS = 64 rows from `src` (row-major, D wide) into a tile of pitch
// DP + 4 floats; rows >= valid and columns >= D are zeros.
template <typename T, int DP>
__device__ void load_tile(float* dst, const T* src, int valid, int D) {
  for (int i = threadIdx.x; i < BT * DP; i += THREADS) {
    const int r = i / DP, c = i % DP;   // powers of two: shifts
    dst[r * (DP + 4) + c] =
        (r < valid && c < D) ? to_f32(src[static_cast<size_t>(r) * D + c])
                             : 0.0f;
  }
}

// acc[i][j] += row (ra + 16 i) of a . row (rb + 16 j) of b, over DP
template <int DP>
__device__ __forceinline__ void dots(float (&acc)[4][4], const float* a,
                                     int ra, const float* b, int rb) {
  constexpr int PITCH = DP + 4;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + (ra + 16 * i) * PITCH + d);
      y[i] = *reinterpret_cast<const float4*>(b + (rb + 16 * i) * PITCH + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_c w[row (tg + 16 i)][c] * x[c][4 tc + 64 jj + e]:
// a 64 x 64 pair tile `w` (pitch BT + 4) times a 64-row D tile `x`
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[4][DP / 16],
                                           const float* w, const float* x,
                                           int tg, int tc) {
  constexpr int PITCH = DP + 4, SPITCH = BT + 4, NJ = DP / 64;
#pragma unroll 4
  for (int c = 0; c < BT; ++c) {
    float wi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wi[i] = w[(tg + 16 * i) * SPITCH + c];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float4 xv =
          *reinterpret_cast<const float4*>(x + c * PITCH + 4 * tc + 64 * jj);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * jj] = fmaf(wi[i], xv.x, acc[i][4 * jj]);
        acc[i][4 * jj + 1] = fmaf(wi[i], xv.y, acc[i][4 * jj + 1]);
        acc[i][4 * jj + 2] = fmaf(wi[i], xv.z, acc[i][4 * jj + 2]);
        acc[i][4 * jj + 3] = fmaf(wi[i], xv.w, acc[i][4 * jj + 3]);
      }
    }
  }
}

// rows (tg + 16 i) of a 64-row block of `dst` (row-major, D wide), starting
// at row r0 of `valid` rows, from acc times `scale`
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst,
                                           const float (&acc)[4][DP / 16],
                                           int valid, int D, float scale,
                                           int tg, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tg + 16 * i;
    if (r >= valid) continue;
#pragma unroll
    for (int jj = 0; jj < DP / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tc + 64 * jj + e;
        if (d < D) {
          dst[static_cast<size_t>(r) * D + d] =
              from_f32<T>(acc[i][4 * jj + e] * scale);
        }
      }
  }
}

// P rounded as the forward rounds it before P V: to bf16 for bf16 inputs
template <typename T>
__device__ __forceinline__ float as_input(float p) {
  return to_f32(from_f32<T>(p));
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int KH, int Sq, int Sk,
                          int D, int causal, float scale, float scale_log2) {
  using LY = Layout<DP>;
  constexpr int SPITCH = LY::SPITCH;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + LY::TILE;
  float* qs = vs + LY::TILE;
  float* dos = qs + LY::TILE;
  float* ps = dos + LY::TILE;        // [key][query]: P (rounded for dV)
  float* dss = ps + LY::PAIRS;       // [key][query]: dS
  float* ls = dss + LY::PAIRS;       // the tile's rows' lse, log2 units
  float* dl = ls + BT;               // and delta

  const int tg = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int k0 = blockIdx.x * BT;
  const int g = blockIdx.y;
  const size_t b = blockIdx.z;
  const int G = H / KH;
  const size_t kv_row0 = (b * KH + g) * Sk + k0;
  load_tile<T, DP>(ks, k + kv_row0 * D, Sk - k0, D);
  load_tile<T, DP>(vs, v + kv_row0 * D, Sk - k0, D);

  float dka[4][DP / 16], dva[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      dka[i][j] = 0.0f;
      dva[i][j] = 0.0f;
    }

  const int n_q = (Sq + BT - 1) / BT;
  // query tile qt holds rows 64 qt..64 qt + 63: under the causal mask the
  // tiles before this block's first key see none of its keys
  const int q_first = causal ? blockIdx.x : 0;
  for (int hh = 0; hh < G; ++hh) {
    const size_t bh = b * H + static_cast<size_t>(g) * G + hh;
    for (int qt = q_first; qt < n_q; ++qt) {
      const int i0 = qt * BT;
      __syncthreads();   // every thread is done with the previous tile
      load_tile<T, DP>(qs, q + (bh * Sq + i0) * D, Sq - i0, D);
      load_tile<T, DP>(dos, dout + (bh * Sq + i0) * D, Sq - i0, D);
      if (threadIdx.x < BT) {
        const int i = i0 + threadIdx.x;
        ls[threadIdx.x] =
            i < Sq ? lse[bh * Sq + i] * flash_bwd::kLog2e : INFINITY;
        dl[threadIdx.x] = i < Sq ? delta[bh * Sq + i] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = 0.0f;
          dp[i][j] = 0.0f;
        }
      dots<DP>(s, ks, tg, qs, tc);      // S^T: keys x queries
      dots<DP>(dp, vs, tg, dos, tc);    // dP^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tg + 16 * i, col = tc + 16 * j;
          float p = exp2f(s[i][j] * scale_log2 - ls[col]);
          if (causal && key > i0 + col) p = 0.0f;
          ps[(tg + 16 * i) * SPITCH + col] = as_input<T>(p);
          dss[(tg + 16 * i) * SPITCH + col] = p * (dp[i][j] - dl[col]);
        }
      __syncthreads();
      accumulate<DP>(dva, ps, dos, tg, tc);   // dV += P^T dO
      accumulate<DP>(dka, dss, qs, tg, tc);   // dK += dS^T Q
    }
  }
  store_rows<T, DP>(dk + kv_row0 * D, dka, Sk - k0, D, scale, tg, tc);
  store_rows<T, DP>(dv + kv_row0 * D, dva, Sk - k0, D, 1.0f, tg, tc);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int KH, int Sq, int Sk, int D, int causal,
                        float scale, float scale_log2) {
  using LY = Layout<DP>;
  constexpr int SPITCH = LY::SPITCH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + LY::TILE;
  float* ks = dos + LY::TILE;
  float* vs = ks + LY::TILE;
  float* dss = vs + LY::TILE;        // [query][key]: dS
  float* ls = dss + LY::PAIRS;
  float* dl = ls + BT;

  const int tg = threadIdx.x / 16, tc = threadIdx.x % 16;
  // the last query tiles see the most keys under a causal mask: run them
  // first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int g = h / (H / KH);
  const size_t bh = b * H + h;
  const int rows = min(BT, Sq - r0);
  load_tile<T, DP>(qs, q + (bh * Sq + r0) * D, rows, D);
  load_tile<T, DP>(dos, dout + (bh * Sq + r0) * D, rows, D);
  if (threadIdx.x < BT) {
    const int i = r0 + threadIdx.x;
    ls[threadIdx.x] = i < Sq ? lse[bh * Sq + i] * flash_bwd::kLog2e : INFINITY;
    dl[threadIdx.x] = i < Sq ? delta[bh * Sq + i] : 0.0f;
  }

  float dqa[4][DP / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) dqa[i][j] = 0.0f;

  // keys past the tile's last row are masked for all of its rows
  const int kv_end = causal ? min(Sk, r0 + rows) : Sk;
  const int n_tiles = (kv_end + BT - 1) / BT;
  const T* kp = k + (b * KH + g) * static_cast<size_t>(Sk) * D;
  const T* vp = v + (b * KH + g) * static_cast<size_t>(Sk) * D;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BT;
    __syncthreads();   // every thread is done with the previous tile
    load_tile<T, DP>(ks, kp + static_cast<size_t>(c0) * D, Sk - c0, D);
    load_tile<T, DP>(vs, vp + static_cast<size_t>(c0) * D, Sk - c0, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.0f;
        dp[i][j] = 0.0f;
      }
    dots<DP>(s, qs, tg, ks, tc);      // S: queries x keys
    dots<DP>(dp, dos, tg, vs, tc);    // dP
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = tg + 16 * i, key = c0 + tc + 16 * j;
        float p = exp2f(s[i][j] * scale_log2 - ls[row]);
        if (key >= Sk || (causal && key > r0 + row)) p = 0.0f;
        dss[row * SPITCH + tc + 16 * j] = p * (dp[i][j] - dl[row]);
      }
    __syncthreads();
    accumulate<DP>(dqa, dss, ks, tg, tc);   // dQ += dS K
  }
  store_rows<T, DP>(dq + (bh * Sq + r0) * D, dqa, rows, D, scale, tg, tc);
}

template <typename T, int DP>
cudaError_t launch_dp(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, T* dq, T* dk,
                      T* dv, int B, int H, int KH, int Sq, int Sk, int D,
                      int causal, cudaStream_t s) {
  using LY = Layout<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LY::KV_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LY::Q_BYTES);
  if (err != cudaSuccess) return err;
  const double rs = 1.0 / std::sqrt(static_cast<double>(D));
  const float scale = static_cast<float>(rs);
  const float scale_log2 = static_cast<float>(rs * 1.4426950408889634);
  flash_bwd_dkdv_kernel<T, DP>
      <<<dim3((Sk + BT - 1) / BT, KH, B), THREADS, LY::KV_BYTES, s>>>(
          q, k, v, dout, lse, delta, dk, dv, H, KH, Sq, Sk, D, causal, scale,
          scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DP>
      <<<dim3((Sq + BT - 1) / BT, H, B), THREADS, LY::Q_BYTES, s>>>(
          q, k, v, dout, lse, delta, dq, H, KH, Sq, Sk, D, causal, scale,
          scale_log2);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int B, int H, int KH, int Sq, int Sk, int D,
           int causal, int device, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > MAX_D || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* dl = static_cast<float*>(delta);
  err = flash_bwd::launch_delta<T>(
      out, dout, dl, static_cast<size_t>(B) * H * Sq, D, s);
  if (err != cudaSuccess) return err;
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* gp = static_cast<const T*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dqp = static_cast<T*>(dq);
  auto* dkp = static_cast<T*>(dk);
  auto* dvp = static_cast<T*>(dv);
  if (D <= 64) {
    return launch_dp<T, 64>(qp, kp, vp, gp, lp, dl, dqp, dkp, dvp, B, H, KH,
                            Sq, Sk, D, causal, s);
  }
  return launch_dp<T, 128>(qp, kp, vp, gp, lp, dl, dqp, dkp, dvp, B, H, KH,
                           Sq, Sk, D, causal, s);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major tensors: q, out, dout, dq (B,H,Sq,D); k, v, dk, dv
// (B,KH,Sk,D); lse (B,H,Sq) float32 from the forward; delta (B,H,Sq)
// float32 scratch the pre-pass fills.  B, Sq, Sk >= 1; `causal` is 0 or 1;
// `stream` is the caller's cudaStream_t.  The call only queues the
// pre-pass and the two passes and returns the first launch error.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int H, int KH, int Sq, int Sk, int D, int causal,
    int device, void* stream) {
  return launch<float>(q, k, v, out, dout, lse, dq, dk, dv, delta, B, H, KH,
                       Sq, Sk, D, causal, device, stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int B, int H, int KH, int Sq, int Sk, int D, int causal,
    int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, dout, lse, dq, dk, dv, delta,
                               B, H, KH, Sq, Sk, D, causal, device, stream);
}
