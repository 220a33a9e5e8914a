// Flash attention (forward) for Hopper (sm_90a) on the tensor cores: the
// bf16 route of the port's flash attention, which every layer of every
// prefill on the dense LM path takes.  The wrapper in
// kernels/flash_attention.py picks it for bf16 with D % 8 == 0 and
// D <= 128; float32, and bf16 with other head dims, keep
// csrc/flash_attention.cu on the CUDA cores.
//
// Replaces, like csrc/flash_attention.cu, the TPU kernel `flash_attention`
// of src/repro/kernels/flash_attention.py (pallas_call at :94, body
// `_flash_kernel` at :31), and computes what that kernel computes:
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,g,j] * D**-0.5) v[b,g,j]
// for q (B,H,Sq,D), k, v (B,KH,Sk,D), g = h / (H/KH) (GQA: K/V are read
// through the head map, never repeated), with m, l and the accumulator in
// float32 and the output in bf16.  The causal mask is top-left: key j is
// visible to query i iff j <= i on absolute indices from 0, also when
// Sq != Sk (not FlashAttention-2/3's bottom-right convention).  Any
// Sq, Sk >= 0.
//
// Translation.  The TPU kernel walks the kv tiles on a sequential grid axis
// with m, l and acc in VMEM scratch.  Here, in FlashAttention-3's shape kept
// simple, one block owns one (128-row query tile, head, batch) and loops
// over 128-key tiles itself; the heaviest causal tiles launch first.  Three
// warpgroups split the work:
//   - warpgroup 2, the producer: one thread loads the Q tile once by TMA,
//     then the K and V tiles into a ring of 2 stages, each guarded by a
//     "full" mbarrier (TMA's bytes) and an "empty" one (the consumers'
//     release).  The tensor maps are 3-D, (D, S, B*heads), so TMA's zero
//     fill stops at the end of each head's keys: a ragged tile never reads
//     the next head's rows (0 * a non-finite V would poison the sum).  A
//     head dim is one or two 64-wide boxes (one 128-byte swizzled line a
//     row), so D is padded to 64 or 128 by the zero fill;
//   - warpgroups 0 and 1, the consumers, 64 query rows each:
//       S = Q K^T by wgmma m64n128k16, both operands from shared memory
//       (K is K-major as stored), over ceil(D/16) steps;
//       the online softmax in registers on the accumulator's own layout:
//       a thread holds two rows (lane/4 and lane/4 + 8 of its warp's 16),
//       and a row's 128 scores lie in the 4 lanes of a quad, so its max
//       and sum are 2-step __shfl_xor_sync butterflies;
//       O += P V by wgmma m64n64k16 per 64-wide D box, with P rounded to
//       bf16 in registers as the A operand (the accumulator's layout is
//       the A fragment's, so no shuffle) and V from shared memory as an
//       MN-major operand (the descriptor's transpose bit).
//     The consumers take 232 registers each (setmaxnreg), the producer 40.
//     They take turns on the tensor cores (ping-pong through two named
//     barriers): one issues its S or P V products while the other runs
//     its softmax.  A consumer waits for its wgmma (wait_group 0) before
//     it reads the scores and before it releases a stage.
//
// Masking.  Only tiles that reach past Sk or cross the diagonal of the
// warpgroup's rows are masked.  A zero-filled key scores exactly 0, not
// -inf, so a masked key is set to -inf before the max: it takes part in
// neither the max nor the sum and its probability is exactly 0.  A row that
// has seen no visible key yet keeps m = -inf and rescales nothing (the
// guard below); a row with no visible key at all (Sk = 0) has l = 0 and is
// written as 0, as the TPU kernel's `l == 0 -> 1` gives.  Rows past Sq are
// not written.  The exponentials are exp2f (no fast math) with the scale
// folded in by log2(e).
//
// Numbers.  P is rounded to bf16 before P V, as the JAX model does at bf16
// compute; l sums the float32 probabilities.  For training the kernel also
// writes, where the caller passes an lse tensor (float32 (B,H,Sq)), each
// row's log-sum-exp lse = log sum_j exp(scale q.k_j) in natural-log units:
// (m + log2 l) * ln 2 from the row's statistics, which run in log2 units
// of the scaled scores; -inf for a row with no visible key.  The backward
// (flash_attention_bwd_wgmma.cu) reads it back times log2 e.  Serving
// passes null and the kernel writes nothing more.  Every output element is
// summed in one fixed order (no split-KV, no atomics), so two launches give
// the same bits.
//
// Bound (published H100 SXM peaks).  qwen2-7b's long prefill, q
// (1,28,2048,128), k, v (1,4,2048,128) causal: 2,098,176 visible (i, j)
// pairs per head, 4 * 128 operations each, about 30.1 GFLOP per launch:
// 0.030 ms at bf16's 989 TFLOP/s; its 33.6 MB of bytes take 0.010 ms at
// 3.35 TB/s.  Bound by operations.  The design answers it with the tensor
// cores (wgmma), TMA loads of the next K/V stage overlapping the current
// tile's products and softmax, and two consumer warpgroups per block whose
// softmax and products alternate; one block per SM (164,904 B of shared
// memory at D > 64, 82,984 B at D <= 64).  Diagonal tiles are computed
// whole and masked, so a causal launch does about 6 % more products than
// it keeps.  What holds it back from the bound: each warpgroup's softmax
// (exp2f and the masks on the CUDA cores) is as long as its products, and
// the score and P V products of one warpgroup do not overlap each other.

#include "hopper.cuh"

#include <cmath>
#include <cstddef>

namespace {

using namespace hopper;

constexpr int BQ = 128;          // query rows of one block
constexpr int BKV = 128;         // keys of one tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;     // warpgroups of 64 query rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int MAX_D = 128;
constexpr uint32_t BOX_BYTES = 128 * 64 * 2;   // 128 rows x 64 of D: 16 KB

static_assert(BQ == 64 * CONSUMERS, "one consumer per 64 rows");
static_assert(BQ == 128 && BKV == 128, "the boxes hold 128 rows");

// Shared memory for ND boxes of D: the Q tile, then the stages' K and V
// tiles, then the barriers; each tile is ND boxes.
template <int ND>
struct Smem {
  static constexpr uint32_t TILE = ND * BOX_BYTES;
  __host__ __device__ static constexpr uint32_t K(int s) {
    return TILE * (1 + 2 * s);
  }
  __host__ __device__ static constexpr uint32_t V(int s) {
    return TILE * (2 + 2 * s);
  }
  static constexpr uint32_t BARS = TILE * (1 + 2 * STAGES);
  static constexpr size_t BYTES = BARS + 8 * (1 + 2 * STAGES) + kSwizzleAtom;
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A row's log-sum-exp in natural-log units from its statistics in log2
// units (m the scaled max, l the sum of exp2 against it); -inf for a row
// that saw no key
__device__ __forceinline__ float row_lse(float m, float l) {
  return l == 0.0f ? -INFINITY : (m + log2f(l)) * 0.6931471805599453f;
}

// ND: boxes of 64 along D (1 when D <= 64, else 2).
template <int ND>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int H, int KH, int Sq,
                       int Sk, int D, int causal, float scale_log2) {
  using L = Smem<ND>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (kSwizzleAtom - smem_addr(smem_raw) %
                              kSwizzleAtom) % kSwizzleAtom;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  // the last query tiles see the most keys under a causal mask: run them
  // first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KH);
  const int rows = min(BQ, Sq - r0);
  // keys past the tile's last row are masked for all of its rows
  const int kv_end = causal ? min(Sk, r0 + rows) : Sk;
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread loads Q, then keeps the K/V ring full
    regs_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        tma_load_3d(smem + c * BOX_BYTES, &qmap, q_full, 64 * c, r0,
                    b * H + h);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const uint32_t use = t / STAGES;
        mbar_wait(&empty[s], (use & 1) ^ 1);   // use 0 passes at once
        mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          tma_load_3d(smem + L::K(s) + c * BOX_BYTES, &kmap, &full[s],
                      64 * c, t * BKV, b * KH + g);
          tma_load_3d(smem + L::V(s) + c * BOX_BYTES, &vmap, &full[s],
                      64 * c, t * BKV, b * KH + g);
        }
      }
    }
  } else {
    regs_alloc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row_a = r0 + wg * 64 + warp * 16 + lane / 4;  // absolute
    const int row_b = row_a + 8;
    const int kcol = 2 * (lane % 4);   // first key / D column in an n8 block
    const int first_row = r0 + wg * 64;   // the warpgroup's first row
    const int ksteps = (D + 15) / 16;
    const uint32_t q_addr = smem_addr(smem) + wg * 64 * 128;
    // ping-pong: the two consumers take turns to issue their products
    // (named barrier 1 + wg is this one's turn), so one's softmax runs
    // while the other's products keep the tensor cores busy
    const uint32_t my_turn = 1 + wg, other_turn = 2 - wg;
    if (wg == 1) named_bar_arrive(1, CONSUMERS * 128);   // 0 starts

    float o[ND][32];
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const int c0 = t * BKV;

      // S = Q K^T over the head dim's 16-wide steps
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
      const uint32_t k_addr = smem_addr(smem + L::K(s));
      fence_regs(sc);
      named_bar_sync(my_turn, CONSUMERS * 128);
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_m64n128k16<0>(sc, desc_sw128(q_addr + off, 16, kSwizzleAtom),
                               desc_sw128(k_addr + off, 16, kSwizzleAtom), 1);
      }
      wgmma_commit();
      named_bar_arrive(other_turn, CONSUMERS * 128);
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax, in log2 units; sc[4j + e] is row_a's key
      // c0 + 8j + kcol + e, sc[4j + 2 + e] row_b's
      const bool masked =
          c0 + BKV > Sk || (causal && c0 + BKV - 1 > first_row);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float va = sc[4 * j + e] * scale_log2;
          float vb = sc[4 * j + 2 + e] * scale_log2;
          if (masked) {
            const int key = c0 + 8 * j + kcol + e;
            if (key >= Sk || (causal && key > row_a)) va = -INFINITY;
            if (key >= Sk || (causal && key > row_b)) vb = -INFINITY;
          }
          sc[4 * j + e] = va;
          sc[4 * j + 2 + e] = vb;
          mx_a = fmaxf(mx_a, va);
          mx_b = fmaxf(mx_b, vb);
        }
      }
      mx_a = quad_max(mx_a);
      mx_b = quad_max(mx_b);
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // no visible key yet: nothing to rescale, and exp2(-inf) gives p = 0
      const float mu_a = mn_a == -INFINITY ? 0.0f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.0f : mn_b;
      const float corr_a = exp2f(m_a - mu_a), corr_b = exp2f(m_b - mu_b);
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = exp2f(sc[4 * j + e] - mu_a);  // masked: exactly 0
          sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mu_b);
          sum_a += sc[4 * j + e];
          sum_b += sc[4 * j + 2 + e];
        }
      }
      l_a = l_a * corr_a + quad_sum(sum_a);
      l_b = l_b * corr_b + quad_sum(sum_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j] *= corr_a;
          o[c][4 * j + 1] *= corr_a;
          o[c][4 * j + 2] *= corr_b;
          o[c][4 * j + 3] *= corr_b;
        }

      // P as bf16 A fragments: step kk covers keys 16kk..16kk+15, which
      // are the score blocks j = 2kk and 2kk + 1
      uint32_t p[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V
      const uint32_t v_addr = smem_addr(smem + L::V(s));
#pragma unroll
      for (int c = 0; c < ND; ++c) fence_regs(o[c]);
      named_bar_sync(my_turn, CONSUMERS * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          wgmma_rs_m64n64k16<1>(
              o[c], p[kk],
              desc_sw128(v_addr + c * BOX_BYTES + 2048 * kk, BOX_BYTES,
                         kSwizzleAtom));
        }
      }
      wgmma_commit();
      named_bar_arrive(other_turn, CONSUMERS * 128);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < ND; ++c) fence_regs(o[c]);
      mbar_arrive(&empty[s]);   // this stage's K and V are read
    }

    const float inv_a = 1.0f / (l_a == 0.0f ? 1.0f : l_a);
    const float inv_b = 1.0f / (l_b == 0.0f ? 1.0f : l_b);
    if (lse != nullptr && lane % 4 == 0) {
      // the quad's four lanes hold the same m and l
      float* lp = lse + static_cast<size_t>(b * H + h) * Sq;
      if (row_a < Sq) lp[row_a] = row_lse(m_a, l_a);
      if (row_b < Sq) lp[row_b] = row_lse(m_b, l_b);
    }
    __nv_bfloat16* op = out + static_cast<size_t>(b * H + h) * Sq * D;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + kcol;   // d and d + 1; D % 8 == 0
        if (d >= D) continue;
        if (row_a < Sq) {
          *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(row_a) * D +
                                       d) =
              pack_bf16(o[c][4 * j] * inv_a, o[c][4 * j + 1] * inv_a);
        }
        if (row_b < Sq) {
          *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(row_b) * D +
                                       d) =
              pack_bf16(o[c][4 * j + 2] * inv_b, o[c][4 * j + 3] * inv_b);
        }
      }
  }
}

// A 3-D map over a (B*heads, S, D) bf16 tensor, boxes of 128 rows x 64.
cudaError_t head_map(CUtensorMap* map, const void* base, int heads, int S,
                     int D) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads)};
  const uint64_t strides[2] = {static_cast<uint64_t>(D) * 2,
                               static_cast<uint64_t>(S) * D * 2};
  const uint32_t box[3] = {64, 128, 1};
  return make_map(map, base, 3, dims, strides, box);
}

template <int ND>
cudaError_t launch_nd(const CUtensorMap& qmap, const CUtensorMap& kmap,
                      const CUtensorMap& vmap, __nv_bfloat16* out,
                      float* lse, int B, int H, int KH, int Sq, int Sk,
                      int D, int causal, cudaStream_t stream) {
  const size_t bytes = Smem<ND>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const double log2e = 1.4426950408889634;
  flash_wgmma_kernel<ND><<<grid, THREADS, bytes, stream>>>(
      qmap, kmap, vmap, out, lse, H, KH, Sq, Sk, D, causal,
      static_cast<float>(log2e / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  q (B,H,Sq,D), k, v (B,KH,Sk,D)
// and out (B,H,Sq,D) are contiguous bf16 device tensors, 16-byte aligned,
// with D % 8 == 0 and D <= 128 (TMA needs 16-byte row strides); lse is
// null or a float32 (B,H,Sq) device tensor that receives each row's
// log-sum-exp (see the header); `causal` is 0 or 1; `stream` is the
// caller's cudaStream_t.  The call only queues the kernel and returns the
// launch's cudaError_t.
extern "C" int repro_flash_attention_bf16_wgmma(const void* q, const void* k,
                                                const void* v, void* out,
                                                void* lse, int B, int H,
                                                int KH, int Sq, int Sk, int D,
                                                int causal, int device,
                                                void* stream) {
  if (B < 0 || H < 1 || KH < 1 || H % KH != 0 || Sq < 0 || Sk < 0 ||
      D < 8 || D > MAX_D || D % 8 != 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap{}, kmap{}, vmap{};   // Sk == 0: no K/V tile is loaded
  err = head_map(&qmap, q, B * H, Sq, D);
  if (err != cudaSuccess) return err;
  if (Sk > 0) {
    err = head_map(&kmap, k, B * KH, Sk, D);
    if (err != cudaSuccess) return err;
    err = head_map(&vmap, v, B * KH, Sk, D);
    if (err != cudaSuccess) return err;
  }
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto s = static_cast<cudaStream_t>(stream);
  if (D <= 64) {
    return launch_nd<1>(qmap, kmap, vmap, op, lp, B, H, KH, Sq, Sk, D, causal,
                        s);
  }
  return launch_nd<2>(qmap, kmap, vmap, op, lp, B, H, KH, Sq, Sk, D, causal,
                      s);
}
