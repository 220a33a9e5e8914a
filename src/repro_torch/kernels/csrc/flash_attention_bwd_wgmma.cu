// Flash attention's backward for Hopper (sm_90a) on the tensor cores: the
// bf16 route of the gradient of the port's flash attention, which every
// training step of the dense, encoder-decoder and VLM paths takes at bf16
// compute.  The wrapper in kernels/flash_attention.py picks it for bf16
// with D % 8 == 0 and D <= 128 and q, k, v, out and dout on 16-byte
// boundaries (TMA needs 16-byte rows and bases); every other call keeps
// csrc/flash_attention_bwd.cu on the CUDA cores.
//
// Replaces no TPU kernel: the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py has no backward, and the JAX package
// trains by differentiating src/repro/models/layers.py `attention_scores`
// (:166) through XLA.  It computes that gradient, as
// csrc/flash_attention_bwd.cu states it: for out = softmax(scale q k^T) v,
// scale = D**-0.5, GQA (query head h reads kv head h / (H/KH)) and the
// top-left causal mask (key j visible to query i iff j <= i from 0, also
// when Sq != Sk; not FlashAttention-2/3's bottom-right convention), given
// dout and the forward's row log-sum-exp lse (natural log):
//   P = exp(scale q k^T - lse), dV = P^T dO, dP = dO V^T,
//   dS = P o (dP - delta), dQ = scale dS K, dK = scale dS^T Q,
// delta = rowsum(dO o O) from the pre-pass (flash_attention_bwd.cuh).
//
// Design.  Two kinds of unit without atomics, so every output is summed in
// one fixed order and two launches give the same bits (FlashAttention-2/3's
// float32 atomicAdd of dQ is not taken).  Both kinds run in ONE launch after
// the pre-pass: the wrapper hands over a list of units (kind, tile, head,
// batch), heaviest first (kernels/flash_attention.py::backward_schedule: 4
// products a dK/dV step, 3 a dQ step, times the steps of the unit's causal
// range), and block i runs unit i, so the block scheduler starts the long
// causal units first and fills the SMs they leave idle with the short ones
// of either kind.  Which SM runs a unit changes nothing in its sums.  Every
// block has the forward's shape: three warpgroups, warpgroup 2 the producer
// (one thread issues TMA loads into a ring of 2 stages guarded by full/empty
// mbarriers; the maps are 3-D, (D, S, B*heads), so a ragged tile never
// reads the next head's rows and D is zero-filled to 64 or 128), warpgroups
// 0 and 1 the consumers (setmaxnreg: 240 registers each, the producer 24: 8
// warps x 240 + 4 x 24 is the 12 x 168 a thread that the block is launched
// with, and a consumer's request beyond what the producer gives up would
// wait for ever; both kinds of unit make the same requests).
//   - dK/dV unit: 128 keys (64 a consumer) of one (kv head, batch), its K
//     and V tiles kept in shared memory.  It loops over the G = H/KH query
//     heads of the group and, for each, over the 64-row query tiles from
//     the tile of its first key on (causal); the producer warp brings each
//     tile's Q and dO by TMA and its rows' lse (times log2 e) and delta by
//     plain loads.  A consumer computes the transposed scores directly, S^T
//     = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major in
//     shared memory), so P^T and dS^T arrive in the accumulator's layout,
//     which is the A fragment's: it rounds them to bf16 in registers and
//     issues dV += P^T dO and dK += dS^T Q (m64n64k16 per 64-wide D box, A
//     from registers, dO and Q as MN-major operands).  No transpose is
//     needed, so dS is never staged in shared memory.  dK and dV stay in
//     float32 registers across the whole loop (2 x 64 a thread at D = 128),
//     summed over the G heads in one order, and are written once in bf16.
//   - dQ unit: 128 query rows (64 a consumer) of one (head, batch), its Q
//     and dO tiles kept, looping over 64-key tiles up to its last row's
//     diagonal (causal): S = Q K^T and dP = dO V^T (SS), P and dS in
//     registers, dQ += dS K (RS, K as an MN-major operand).  dQ is written
//     once in bf16.
//   - The two consumers run free: neither waits for the other, and every
//     step issues its products whole, with no branch around a wgmma (ptxas
//     serializes wgmma under a branch it cannot prove warpgroup-uniform,
//     C7518).  A tile wholly above a warpgroup's diagonal is computed and
//     masked whole: its P = 0 adds +0 to dK, dV or dQ, which changes no
//     bits, at one wasted step in 2 to 32 of the causal units.  A
//     ping-pong of the consumers on named barriers measured slower on the
//     card, both with a turn for each product phase and with one turn for
//     a step's scores and the previous step's accumulating products
//     (PERF.md §6), so it is not taken.
// Each kind recomputes S and dP, so a visible pair costs 7 products (14 D
// operations) where an atomic dQ would take 5.  The lse rows read past Sq
// are +inf (P = 0), keys past Sk are masked in the dQ unit and not written
// in the dK/dV unit.  The diagonal tiles are computed whole and masked.
//
// Numbers: every product accumulates in float32.  P and dS are rounded to
// bf16 where they are the A operand of dV += P^T dO, dK += dS^T Q and dQ
// += dS K (P as the forward rounds it before P V); P itself, dP, delta,
// lse and dS before its rounding are float32; dq, dk and dv are rounded
// to bf16 once, at the end.  Exponentials are exp2f (no fast math) with
// the scale and log2 e folded in.  Each output is summed in the order of
// its unit's steps, which no assignment of units to SMs changes.
//
// Tiles and resources.  dK/dV: 128 keys x 64 queries a step; shared memory
// K and V (2 x 32 KB at D > 64), two stages of Q and dO (2 x 2 x 16 KB),
// their lse and delta (1 KB), barriers: 133,160 B (D > 64), 67,624 B (D <=
// 64).  dQ: 128 queries x 64 keys a step; Q and dO (2 x 32 KB), two stages
// of K and V (2 x 2 x 16 KB): 132,136 B (66,600 B).  A block takes the
// larger, one block an SM.  Registers: 240 a consumer thread; chip_smoke.py
// prints what `-Xptxas -v` and the occupancy calculator report
// (repro_flash_attention_bwd_wgmma_resources).
//
// Bound (published H100 SXM peaks; launch/costs.py::flash_backward_bound).
// qwen2-7b's training attention, q (2,28,2048,128), k, v (2,4,2048,128),
// causal, bf16: 117,497,856 visible pairs, 10 D operations each for the
// five products the gradient needs, 150.4 GFLOP: 0.152 ms at 989 TFLOP/s;
// its 135 MB (q, k, v, out, dout, lse read, dq, dk, dv written) take
// 0.040 ms at 3.35 TB/s.  Bound by operations.  What holds it back: the
// two recomputed products (7 where 5 would do; ordered dQ sums across
// units would cut them without atomics), the diagonal tiles computed whole,
// and each warpgroup's own products and exponentials, which run in series
// (overlapping them needs a second step's scores in registers, which at D
// = 128 spilled and ran slower).

#include "hopper.cuh"
#include "flash_attention_bwd.cuh"

#include <cmath>
#include <cstddef>

namespace {

using namespace hopper;

constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;     // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int BLOCK_ROWS = 64 * CONSUMERS;   // keys (dK/dV), queries (dQ)
constexpr int STEP = 64;         // queries (dK/dV) or keys (dQ) a step
constexpr int MAX_D = 128;
constexpr uint32_t BIG = 128 * 128;    // bytes of a 128-row x 64 bf16 box
constexpr uint32_t SMALL = 64 * 128;   // bytes of a 64-row x 64 bf16 box

static_assert(BLOCK_ROWS == 128, "the BIG boxes hold a block's rows");

// Shared memory of either kind for ND boxes of D: the block's own tiles
// (128 rows: K and V, or Q and dO), then the stages' streamed tiles (64
// rows: Q and dO, or K and V), then `stats` bytes a stage, then the
// barriers (the fixed tiles' one, the stages' full and empty ones).
template <int ND, uint32_t STATS_BYTES>
struct Smem {
  static constexpr uint32_t FIXED = ND * BIG;
  static constexpr uint32_t STREAM = ND * SMALL;
  static constexpr uint32_t A = 0, B = FIXED;   // the block's two tiles
  __host__ __device__ static constexpr uint32_t SA(int s) {
    return 2 * FIXED + 2 * STREAM * s;
  }
  __host__ __device__ static constexpr uint32_t SB(int s) {
    return SA(s) + STREAM;
  }
  static constexpr uint32_t STATS = 2 * FIXED + 2 * STREAM * STAGES;
  static constexpr uint32_t BARS = STATS + STATS_BYTES * STAGES;
  static constexpr size_t BYTES = BARS + 8 * (1 + 2 * STAGES) + kSwizzleAtom;
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

// dK/dV: a stage also holds its 64 rows' lse (log2 units) and delta
template <int ND>
using KvSmem = Smem<ND, 2 * STEP * 4>;
template <int ND>
using QSmem = Smem<ND, 0>;

// the launch's dynamic shared memory: what the larger kind needs
template <int ND>
constexpr size_t kBlockBytes = KvSmem<ND>::BYTES > QSmem<ND>::BYTES
                                   ? KvSmem<ND>::BYTES
                                   : QSmem<ND>::BYTES;

// The m64n64 accumulator x (a warpgroup's 64 rows x 64 columns) as four
// bf16 A fragments of 16 columns each: step kk covers columns 16 kk..16 kk
// + 15, the accumulator's n8 blocks 2 kk and 2 kk + 1 (the layouts agree,
// so no shuffle).
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    f[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc (64 x 64) += A B^T over D: A's 64 rows at a_addr and B's 64 rows at
// b_addr, both K-major (D contiguous) in 128B-swizzled boxes of 64 columns,
// a's boxes a_box bytes apart and b's b_box.
__device__ __forceinline__ void rows_dot(float (&acc)[32], uint32_t a_addr,
                                         uint32_t a_box, uint32_t b_addr,
                                         uint32_t b_box, int ksteps) {
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_m64n64k16<0>(
        acc, desc_sw128(a_addr + (kk / 4) * a_box + col, 16, kSwizzleAtom),
        desc_sw128(b_addr + (kk / 4) * b_box + col, 16, kSwizzleAtom), 1);
  }
}

// acc[c] (64 x 64 of D box c) += F X: F the fragments of a 64 x 64
// accumulator, X the 64 rows at x_addr (64-row boxes, read MN-major: D is
// the output dim).
template <int ND>
__device__ __forceinline__ void frag_mma(float (&acc)[ND][32],
                                         const uint32_t (&f)[4][4],
                                         uint32_t x_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      wgmma_rs_m64n64k16<1>(
          acc[c], f[kk],
          desc_sw128(x_addr + c * SMALL + 2048 * kk, SMALL, kSwizzleAtom));
    }
}

template <int ND>
__device__ __forceinline__ void zero(float (&acc)[ND][32]) {
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
}

template <int ND>
__device__ __forceinline__ void fence_all(float (&acc)[ND][32]) {
#pragma unroll
  for (int c = 0; c < ND; ++c) fence_regs(acc[c]);
}

// Writes a warpgroup's 64 rows x D of acc * scale in bf16: rows row_a and
// row_a + 8 of this thread, those below `valid` only.
template <int ND>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[ND][32],
                                           int row_a, int valid, int D,
                                           int kcol, float scale) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 64 * c + 8 * j + kcol;   // d and d + 1; D % 8 == 0
      if (d >= D) continue;
      if (row_a < valid) {
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_a) * D +
                                     d) =
            pack_bf16(acc[c][4 * j] * scale, acc[c][4 * j + 1] * scale);
      }
      if (row_b < valid) {
        *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row_b) * D +
                                     d) =
            pack_bf16(acc[c][4 * j + 2] * scale, acc[c][4 * j + 3] * scale);
      }
    }
}

// ---------------------------------------------------------------- dK, dV

// One dK/dV unit: keys 128 kt.. of kv head g of batch b.
template <int ND>
__device__ __forceinline__ void dkdv_unit(
    uint8_t* smem, const CUtensorMap& qmap, const CUtensorMap& kmap,
    const CUtensorMap& vmap, const CUtensorMap& domap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int kt,
    int g, int b, int H, int KH, int Sq, int Sk, int D, int causal,
    float scale, float scale_log2) {
  using L = KvSmem<ND>;
  float* stats = reinterpret_cast<float*>(smem + L::STATS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = kt * BLOCK_ROWS;
  const int G = H / KH;
  const int n_q = (Sq + STEP - 1) / STEP;
  // query tile qt holds rows 64 qt..64 qt + 63: under the causal mask the
  // tiles before the block's first key see none of its keys
  const int q_first = causal ? min(k0 / STEP, n_q) : 0;
  const int per_head = n_q - q_first;
  const int n_steps = G * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: its first warp loads K and V once, then keeps the ring of
    // Q, dO and their rows' lse and delta full
    regs_dealloc<24>();
    if (threadIdx.x < CONSUMERS * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::FIXED);
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          tma_load_3d(smem + L::A + c * BIG, &kmap, kv_full, 64 * c, k0,
                      b * KH + g);
          tma_load_3d(smem + L::B + c * BIG, &vmap, kv_full, 64 * c, k0,
                      b * KH + g);
        }
      }
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % STAGES;
        const int bh = b * H + g * G + t / per_head;
        const int i0 = (q_first + t % per_head) * STEP;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);   // use 0 passes
        float* ls = stats + 2 * STEP * s;
        for (int r = lane; r < STEP; r += 32) {
          const int i = i0 + r;
          const size_t at = static_cast<size_t>(bh) * Sq + i;
          ls[r] = i < Sq ? lse[at] * flash_bwd::kLog2e : INFINITY;
          ls[STEP + r] = i < Sq ? delta[at] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * L::STREAM);
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            tma_load_3d(smem + L::SA(s) + c * SMALL, &qmap, &full[s], 64 * c,
                        i0, bh);
            tma_load_3d(smem + L::SB(s) + c * SMALL, &domap, &full[s],
                        64 * c, i0, bh);
          }
        } else {
          mbar_arrive(&full[s]);   // after this lane's lse and delta
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int kw0 = k0 + wg * 64;                      // its first key
    const int key_a = kw0 + warp * 16 + lane / 4;      // absolute
    const int key_b = key_a + 8;
    const int kcol = 2 * (lane % 4);   // first query / D column of an n8
    const int ksteps = (D + 15) / 16;
    const uint32_t k_addr = smem_addr(smem + L::A) + wg * 64 * 128;
    const uint32_t v_addr = smem_addr(smem + L::B) + wg * 64 * 128;

    float dka[ND][32], dva[ND][32];
    zero(dka);
    zero(dva);
    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % STAGES;
      const int i0 = (q_first + t % per_head) * STEP;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t q_addr = smem_addr(smem + L::SA(s));
      const uint32_t do_addr = smem_addr(smem + L::SB(s));
      const float* ls = stats + 2 * STEP * s;
      const float* dl = ls + STEP;

      // S^T = K Q^T and dP^T = V dO^T: keys x queries.  A tile whose every
      // query precedes every key of the warpgroup is computed too and
      // masked whole: P = 0 adds +0 to dK and dV, which changes no bits,
      // and no branch divides the warpgroup's products
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        st[i] = 0.0f;
        dpt[i] = 0.0f;
      }
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      rows_dot(st, k_addr, BIG, q_addr, SMALL, ksteps);
      rows_dot(dpt, v_addr, BIG, do_addr, SMALL, ksteps);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T scale log2 e - lse log2 e); dS^T = P^T (dP^T - Δ).
      // st[4j + e] is key_a against query i0 + 8j + kcol + e, st[4j + 2 +
      // e] key_b against the same query
      const bool masked = causal && kw0 + 63 > i0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + kcol + e;
          const float l2 = ls[col], dlt = dl[col];
          float pa = exp2f(st[4 * j + e] * scale_log2 - l2);
          float pb = exp2f(st[4 * j + 2 + e] * scale_log2 - l2);
          if (masked) {
            if (key_a > i0 + col) pa = 0.0f;
            if (key_b > i0 + col) pb = 0.0f;
          }
          st[4 * j + e] = pa;
          st[4 * j + 2 + e] = pb;
          dpt[4 * j + e] = pa * (dpt[4 * j + e] - dlt);
          dpt[4 * j + 2 + e] = pb * (dpt[4 * j + 2 + e] - dlt);
        }
      uint32_t pf[4][4], df[4][4];
      to_frags(st, pf);
      to_frags(dpt, df);

      // dV += P^T dO, dK += dS^T Q
      fence_all(dva);
      fence_all(dka);
      wgmma_fence();
      frag_mma<ND>(dva, pf, do_addr);
      frag_mma<ND>(dka, df, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(dva);
      fence_all(dka);
      mbar_arrive(&empty[s]);   // this stage's tiles and rows are read
    }

    const size_t base = (static_cast<size_t>(b) * KH + g) * Sk * D;
    store_rows(dk + base, dka, key_a, Sk, D, kcol, scale);
    store_rows(dv + base, dva, key_a, Sk, D, kcol, 1.0f);
  }
}

// -------------------------------------------------------------------- dQ

// One dQ unit: query rows 128 qt.. of head h of batch b.
template <int ND>
__device__ __forceinline__ void dq_unit(
    uint8_t* smem, const CUtensorMap& qmap, const CUtensorMap& kmap,
    const CUtensorMap& vmap, const CUtensorMap& domap,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int qt, int h, int b, int H, int KH,
    int Sq, int Sk, int D, int causal, float scale, float scale_log2) {
  using L = QSmem<ND>;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int r0 = qt * BLOCK_ROWS;
  const int g = h / (H / KH);
  const int rows = min(BLOCK_ROWS, Sq - r0);
  // keys past the tile's last row are masked for all of its rows
  const int kv_end = causal ? min(Sk, r0 + rows) : Sk;
  const int n_tiles = (kv_end + STEP - 1) / STEP;
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
    // producer: one thread loads Q and dO, then keeps the K/V ring full
    regs_dealloc<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_arrive_expect_tx(q_full, 2 * L::FIXED);
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        tma_load_3d(smem + L::A + c * BIG, &qmap, q_full, 64 * c, r0,
                    b * H + h);
        tma_load_3d(smem + L::B + c * BIG, &domap, q_full, 64 * c, r0,
                    b * H + h);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);   // use 0 passes
        mbar_arrive_expect_tx(&full[s], 2 * L::STREAM);
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          tma_load_3d(smem + L::SA(s) + c * SMALL, &kmap, &full[s], 64 * c,
                      t * STEP, b * KH + g);
          tma_load_3d(smem + L::SB(s) + c * SMALL, &vmap, &full[s], 64 * c,
                      t * STEP, b * KH + g);
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int first_row = r0 + wg * 64;                // the warpgroup's
    const int row_a = first_row + warp * 16 + lane / 4;   // absolute
    const int row_b = row_a + 8;
    const int kcol = 2 * (lane % 4);   // first key / D column of an n8
    const int ksteps = (D + 15) / 16;
    const size_t bh = static_cast<size_t>(b) * H + h;
    // rows past Sq: P = 0
    const float l_a = row_a < Sq ? lse[bh * Sq + row_a] * flash_bwd::kLog2e
                                 : INFINITY;
    const float l_b = row_b < Sq ? lse[bh * Sq + row_b] * flash_bwd::kLog2e
                                 : INFINITY;
    const float d_a = row_a < Sq ? delta[bh * Sq + row_a] : 0.0f;
    const float d_b = row_b < Sq ? delta[bh * Sq + row_b] : 0.0f;
    const uint32_t q_addr = smem_addr(smem + L::A) + wg * 64 * 128;
    const uint32_t do_addr = smem_addr(smem + L::B) + wg * 64 * 128;

    float dqa[ND][32];
    zero(dqa);
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int c0 = t * STEP;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t k_addr = smem_addr(smem + L::SA(s));
      const uint32_t v_addr = smem_addr(smem + L::SB(s));

      // S = Q K^T and dP = dO V^T: queries x keys.  A tile whose every key
      // follows every row of the warpgroup is computed and masked whole,
      // as in dkdv_unit
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = 0.0f;
        dp[i] = 0.0f;
      }
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      rows_dot(sc, q_addr, BIG, k_addr, SMALL, ksteps);
      rows_dot(dp, do_addr, BIG, v_addr, SMALL, ksteps);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - Δ); sc[4j + e] is row_a's key c0 + 8j + kcol + e
      const bool masked =
          c0 + STEP > Sk || (causal && c0 + STEP - 1 > first_row);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = c0 + 8 * j + kcol + e;
          float pa = exp2f(sc[4 * j + e] * scale_log2 - l_a);
          float pb = exp2f(sc[4 * j + 2 + e] * scale_log2 - l_b);
          if (masked) {
            // a zero-filled key past Sk scores 0, not -inf: mask it
            if (key >= Sk || (causal && key > row_a)) pa = 0.0f;
            if (key >= Sk || (causal && key > row_b)) pb = 0.0f;
          }
          dp[4 * j + e] = pa * (dp[4 * j + e] - d_a);
          dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d_b);
        }
      uint32_t df[4][4];
      to_frags(dp, df);

      // dQ += dS K
      fence_all(dqa);
      wgmma_fence();
      frag_mma<ND>(dqa, df, k_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(dqa);
      mbar_arrive(&empty[s]);   // this stage's K and V are read
    }
    store_rows(dq + bh * Sq * D, dqa, row_a, Sq, D, kcol, scale);
  }
}

// --------------------------------------------------------------- the launch

// Block i runs unit units[i] = (kind, tile, head, batch): kind 0 a dK/dV
// unit (tile of 128 keys, kv head), kind 1 a dQ unit (tile of 128 queries,
// query head).  The unit is the same for every thread, so a block takes
// one branch whole and its setmaxnreg requests match.
template <int ND>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap kv_qmap,
                     const __grid_constant__ CUtensorMap kv_kmap,
                     const __grid_constant__ CUtensorMap kv_vmap,
                     const __grid_constant__ CUtensorMap kv_domap,
                     const __grid_constant__ CUtensorMap q_qmap,
                     const __grid_constant__ CUtensorMap q_kmap,
                     const __grid_constant__ CUtensorMap q_vmap,
                     const __grid_constant__ CUtensorMap q_domap,
                     const int4* __restrict__ units,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int KH, int Sq,
                     int Sk, int D, int causal, float scale,
                     float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (kSwizzleAtom - smem_addr(smem_raw) %
                              kSwizzleAtom) % kSwizzleAtom;
  const int4 u = units[blockIdx.x];
  if (u.x == 0) {
    dkdv_unit<ND>(smem, kv_qmap, kv_kmap, kv_vmap, kv_domap, lse, delta, dk,
                  dv, u.y, u.z, u.w, H, KH, Sq, Sk, D, causal, scale,
                  scale_log2);
  } else {
    dq_unit<ND>(smem, q_qmap, q_kmap, q_vmap, q_domap, lse, delta, dq, u.y,
                u.z, u.w, H, KH, Sq, Sk, D, causal, scale, scale_log2);
  }
}

// A 3-D map over a (B*heads, S, D) bf16 tensor, boxes of `rows` rows x 64.
cudaError_t head_map(CUtensorMap* map, const void* base, int heads, int S,
                     int D, uint32_t rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads)};
  const uint64_t strides[2] = {static_cast<uint64_t>(D) * 2,
                               static_cast<uint64_t>(S) * D * 2};
  const uint32_t box[3] = {64, rows, 1};
  return make_map(map, base, 3, dims, strides, box);
}

template <int ND>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(flash_bwd_kernel<ND>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kBlockBytes<ND>));
}

template <int ND>
cudaError_t launch_nd(const void* q, const void* k, const void* v,
                      const void* dout, const int4* units, int n_units,
                      const float* lse, const float* delta,
                      __nv_bfloat16* dq, __nv_bfloat16* dk,
                      __nv_bfloat16* dv, int B, int H, int KH, int Sq, int Sk,
                      int D, int causal, cudaStream_t stream) {
  const double rs = 1.0 / std::sqrt(static_cast<double>(D));
  const float scale = static_cast<float>(rs);
  const float scale_log2 = static_cast<float>(rs * 1.4426950408889634);
  // dK/dV units: their K and V in 128-row boxes, Q and dO in 64-row ones;
  // dQ units: their Q and dO in 128-row boxes, K and V in 64-row ones
  CUtensorMap kv_q{}, kv_k{}, kv_v{}, kv_do{}, q_q{}, q_k{}, q_v{}, q_do{};
  cudaError_t err = head_map(&kv_q, q, B * H, Sq, D, STEP);
  if (err == cudaSuccess) err = head_map(&kv_do, dout, B * H, Sq, D, STEP);
  if (err == cudaSuccess) err = head_map(&kv_k, k, B * KH, Sk, D, BLOCK_ROWS);
  if (err == cudaSuccess) err = head_map(&kv_v, v, B * KH, Sk, D, BLOCK_ROWS);
  if (err == cudaSuccess) err = head_map(&q_q, q, B * H, Sq, D, BLOCK_ROWS);
  if (err == cudaSuccess) {
    err = head_map(&q_do, dout, B * H, Sq, D, BLOCK_ROWS);
  }
  if (err == cudaSuccess) err = head_map(&q_k, k, B * KH, Sk, D, STEP);
  if (err == cudaSuccess) err = head_map(&q_v, v, B * KH, Sk, D, STEP);
  if (err == cudaSuccess) err = set_smem<ND>();
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<ND><<<n_units, THREADS, kBlockBytes<ND>, stream>>>(
      kv_q, kv_k, kv_v, kv_do, q_q, q_k, q_v, q_do, units, lse, delta, dq, dk,
      dv, H, KH, Sq, Sk, D, causal, scale, scale_log2);
  return cudaGetLastError();
}

template <int ND>
cudaError_t resources_nd(int* out) {
  cudaFuncAttributes attr{};
  cudaError_t err = set_smem<ND>();
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, flash_bwd_kernel<ND>);
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_bwd_kernel<ND>, THREADS, kBlockBytes<ND>);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes + kBlockBytes<ND>);
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = THREADS;
  out[4] = blocks;
  return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes.  q, out, dout, dq (B,H,Sq,D) and
// k, v, dk, dv (B,KH,Sk,D) are contiguous bf16 device tensors, q, k, v,
// out and dout 16-byte aligned, with D % 8 == 0 and D <= 128; lse (B,H,Sq)
// is the forward's float32 row log-sum-exp; delta (B,H,Sq) float32 scratch
// that the pre-pass fills; units (n_units, 4) int32 on the device, every
// unit of kernels/flash_attention.py::backward_schedule for these sizes
// with rows = 128, in the order to run.  B, Sq, Sk >= 1; `causal` is 0 or
// 1; `stream` is the caller's cudaStream_t.  The call only queues the
// pre-pass and the units' launch and returns the first launch error.
extern "C" int repro_flash_attention_bwd_bf16_wgmma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, const void* units, int n_units, int B, int H, int KH,
    int Sq, int Sk, int D, int causal, int device, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 ||
      D < 8 || D > MAX_D || D % 8 != 0 || B > 65535 || H > 65535 ||
      n_units < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* dl = static_cast<float*>(delta);
  err = flash_bwd::launch_delta<__nv_bfloat16>(
      out, dout, dl, static_cast<size_t>(B) * H * Sq, D, s);
  if (err != cudaSuccess) return err;
  const auto* up = static_cast<const int4*>(units);
  const auto* lp = static_cast<const float*>(lse);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  if (D <= 64) {
    return launch_nd<1>(q, k, v, dout, up, n_units, lp, dl, dqp, dkp, dvp, B,
                        H, KH, Sq, Sk, D, causal, s);
  }
  return launch_nd<2>(q, k, v, dout, up, n_units, lp, dl, dqp, dkp, dvp, B,
                      H, KH, Sq, Sk, D, causal, s);
}

// The kernel that takes head dim D: its registers a thread, shared memory
// a block (static and dynamic), local (spill) bytes a thread, threads a
// block and resident blocks an SM, into out[0..4].
extern "C" int repro_flash_attention_bwd_bf16_wgmma_resources(int D,
                                                              int* out) {
  if (D < 8 || D > MAX_D || D % 8 != 0) return cudaErrorInvalidValue;
  return D <= 64 ? resources_nd<1>(out) : resources_nd<2>(out);
}
