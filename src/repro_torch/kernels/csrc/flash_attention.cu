// Flash attention (forward) for Hopper (sm_90a): the attention of every
// layer of every prefill on the port's dense LM path.
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
// in no order, so one block owns one (query tile, head, batch) and loops
// over the kv tiles itself; m, l and acc stay in the block's registers for
// the whole loop and nothing crosses blocks (no atomics, no split-K).
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns query rows
// 4ty..4ty+3 of the 64-row tile, score columns 4tx..4tx+3 of each 64-key
// tile, and output columns 4tx..4tx+3 (and 64+4tx.. when D > 64).  The 16
// threads of one ty are one half-warp, so a row's max and sum over a tile
// are __shfl_xor_sync butterflies over 16 lanes, which leave the same bits
// in every lane.  Q (transposed), K (transposed) and V tiles and the tile's
// probabilities (transposed) are staged in shared memory as float32, so
// each step of both products is two or three 16-byte loads and 16 or 32
// FMAs.  At D = 128 that is 119,808 B of dynamic shared memory, above the
// 48 KB default, so the launch raises the kernel's limit first.  Key tiles
// wholly above the diagonal are skipped, as the TPU kernel's `pl.when`
// skips them, and the heaviest query tiles are launched first.
//
// Masking.  A masked key (causal, or past Sk in a ragged tile) takes part
// in neither the max nor the sum: its probability is set to exactly 0
// (masking with -1e30 would give exp(0) = 1 while m is still -1e30).  A row
// with no visible key (Sk = 0) has l = 0 and is written as 0, as the TPU
// kernel's `l == 0 -> 1` gives.  Rows past Sq are not written.  Every
// output element is summed in one fixed order, so two launches give the
// same bits.  expf runs without fast math.
//
// Bound (published H100 SXM peaks).  qwen2-7b's long prefill, q
// (1,28,2048,128), k, v (1,4,2048,128) causal: 2,098,176 visible (i, j)
// pairs per head, 4 * 128 operations each for the two products, about
// 30.1 GFLOP per launch: 0.030 ms at bf16's 989 TFLOP/s, 0.45 ms at the
// CUDA cores' 67 TFLOP/s float32.  Its bytes, q, k, v read once and the
// output written once, are 33.6 MB in bf16: 0.010 ms at 3.35 TB/s.  So it
// is bound by operations.  This kernel is meant to be right first: it
// multiplies on the CUDA cores in float32, with one block of 8 warps per
// SM (its shared memory) and no overlap of a tile's loads with the previous
// tile's products.  Tensor cores (wgmma on bf16 tiles), TMA loads into a
// ring of stages and warp specialisation are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int BQ = 64;         // query rows of one block
constexpr int BK = 64;         // keys of one tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int LDT = BQ + 4;    // row stride of the transposed tiles (floats)
constexpr int MAX_D = 128;

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

// Bytes of dynamic shared memory for head dim D with NJ column groups.
__host__ __device__ constexpr size_t smem_bytes(int D, int NJ) {
  return sizeof(float) *
         (static_cast<size_t>(2 * D * LDT) + BK * 64 * NJ + BK * LDT);
}

// NJ: output column groups of 64 (1 when D <= 64, else 2).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int KH, int Sq, int Sk, int D, int causal,
                           float scale) {
  constexpr int VLD = 64 * NJ;  // row stride of the V tile
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                 // [D][LDT]: Q tile, transposed
  float* kt = qt + D * LDT;         // [D][LDT]: K tile, transposed
  float* vs = kt + D * LDT;         // [BK][VLD]: V tile
  float* pt = vs + BK * VLD;        // [BK][LDT]: probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
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
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qt[d * LDT + r] = r < rows ? to_f32(qp[static_cast<size_t>(r) * D + d])
                               : 0.0f;
  }

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.0f;
  }

  // keys past the tile's last row are masked for all of its rows
  const int kv_end = causal ? min(Sk, r0 + rows) : Sk;
  for (int c0 = 0; c0 < kv_end; c0 += BK) {
    const int cols = min(BK, Sk - c0);
    __syncthreads();  // the previous tile's products are done with kt/vs/pt
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const size_t off = static_cast<size_t>(c0 + c) * D + d;
      kt[d * LDT + c] = c < cols ? to_f32(kp[off]) : 0.0f;
    }
    for (int e = tid; e < BK * VLD; e += THREADS) {
      const int c = e / VLD, d = e % VLD;
      const size_t off = static_cast<size_t>(c0 + c) * D + d;
      vs[c * VLD + d] = (c < cols && d < D) ? to_f32(vp[off]) : 0.0f;
    }
    __syncthreads();

    // scores of rows 4ty+i against keys 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDT + 4 * ty);
      const float4 bv =
          *reinterpret_cast<const float4*>(kt + d * LDT + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bb[j], s[i][j]);
    }

    // online softmax over this tile, per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * tx + j;
        const bool visible = c < Sk && (!causal || c <= r);
        s[i][j] = visible ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      }
      const float m_new = fmaxf(m[i], mx);
      // no visible key yet: nothing to rescale, and exp(-inf) gives p = 0
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = expf(m[i] - m_use);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);  // masked: exp(-inf) = 0 exactly
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * LDT + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc[rows 4ty+i][cols 4tx+j (+64)] += p @ v over the tile's keys
    for (int c = 0; c < cols; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * LDT + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vs + c * VLD + 64 * jj + 4 * tx);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * jj + j] = fmaf(pv[i], vv[j], acc[i][4 * jj + j]);
      }
    }
  }

  T* op = out + ((b * H + h) * Sq + r0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 64 * jj + 4 * tx + j;
        if (d < D) {
          op[static_cast<size_t>(r) * D + d] =
              from_f32<T>(acc[i][4 * jj + j] * inv);
        }
      }
  }
}

template <typename T, int NJ>
cudaError_t launch_nj(const T* q, const T* k, const T* v, T* out, int B,
                      int H, int KH, int Sq, int Sk, int D, int causal,
                      cudaStream_t s) {
  const size_t bytes = smem_bytes(D, NJ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, THREADS, bytes, s>>>(
      q, k, v, out, H, KH, Sq, Sk, D, causal,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
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
  if (D <= 64) {
    return launch_nj<T, 1>(qp, kp, vp, op, B, H, KH, Sq, Sk, D, causal, s);
  }
  return launch_nj<T, 2>(qp, kp, vp, op, B, H, KH, Sq, Sk, D, causal, s);
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
