// Flash attention (forward) for Hopper (sm_90a) on the tensor cores: the
// bf16 route of the port's flash attention, which every layer of every
// bf16 prefill and every bf16 training step of the attention families
// takes.  The wrapper in kernels/flash_attention.py picks it for bf16 with
// D % 8 == 0 and D <= 128 on 16-byte aligned tensors; float32, and bf16
// with other head dims, keep csrc/flash_attention.cu on the CUDA cores.
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
// with m, l and acc in VMEM scratch.  Here a unit is one (128-row query
// tile, head, batch), and one block computes it whole, looping over its
// 128-key tiles itself.  The design is FlashAttention-3's (Shah et al.
// 2024, §3.1-3.2):
//   - Persistent blocks over one heaviest-first list.  The wrapper hands
//     over every unit of the launch, sorted by its kv tiles (the causal
//     range), most first, ties by batch, head, tile
//     (kernels/flash_attention.py::forward_schedule), as an int32 device
//     tensor cached per shape.  min(units, SMs) blocks walk it in snake
//     order: round r takes the next gridDim.x units, block i the i-th of
//     them in even rounds and the (gridDim.x-1-i)-th in odd ones.  Against
//     greedy list scheduling (a unit counter in global memory) this static
//     walk ends within one kv tile at every FLASH_SHAPES row (tiles + 1 a
//     unit as the cost), needs no counter to reset between launches, and
//     makes all three warpgroups of a block walk the same units with no
//     communication.  A served prefill (S 4-12) is one unit a head: 28
//     blocks for qwen2-7b, not 132.
//   - Warpgroup 2, the producer (setmaxnreg 24): one thread issues TMA
//     loads.  Q goes into two buffers, unit u into buffer u % 2, each
//     guarded by a "full" mbarrier (TMA's bytes) and an "empty" one that
//     both consumers arrive on after their unit's last S = Q K^T has
//     completed; so the next unit's Q lands while this unit's last tiles
//     run.  K and V go into a ring of STAGES stages (2 at D > 64, 5 at
//     D <= 64: what shared memory holds beside the Q buffers and the output
//     tile), K and V each with their own full and empty barriers, so the
//     scores of tile t start when K_t has landed, whatever V_t does.  The
//     stage index and phase run on across units; nothing resets per unit.
//     The tensor maps are 3-D, (D, S, B*heads), so TMA's zero fill stops at
//     the end of each head's keys: a ragged tile never reads the next
//     head's rows (0 * a non-finite V would poison the sum).  A head dim is
//     one or two 64-wide boxes (one 128-byte swizzled line a row), so D is
//     padded to 64 or 128 by the zero fill.
//   - Warpgroups 0 and 1, the consumers (setmaxnreg 240), 64 query rows
//     each, pipelined within the warpgroup: in iteration t a consumer
//     issues S_t = Q K_t^T (wgmma m64n128k16, both operands from shared
//     memory, K K-major as stored) and then O += P_{t-1} V_{t-1} (P rounded
//     to bf16 in registers as the A operand, V an MN-major operand: one
//     m64n128k16 a k16 step spanning both 64-wide boxes of V at D > 64,
//     m64n64k16 at D <= 64), waits for the scores alone (wait_group 1) and
//     runs their online softmax on the CUDA cores while P V runs on the
//     tensor cores, then waits for P V and rescales O by the tile's
//     correction.  A unit's last P V shares its turn with the scores of the
//     next unit's first tile, which run under the unit's epilogue; the
//     block's last unit issues its last P V alone.  On top, the two
//     consumers ping-pong through two named barriers: each issue of a
//     tile's products is one turn, so one consumer's softmax also runs
//     under the other's products.  The softmax works on the accumulator's
//     own layout: a thread holds two rows (lane/4 and lane/4 + 8 of its
//     warp's 16), and a row's 128 scores lie in the 4 lanes of a quad, so
//     its max and sum are 2-step __shfl_xor_sync butterflies; the
//     accumulator's layout is the A fragment's, so P needs no shuffle.
//   - Epilogue through shared memory: a consumer scales its O by 1/l,
//     packs it to bf16 into its 64 rows of a 128B-swizzled staging tile,
//     fences it for the async proxy and one thread stores it with a 3-D
//     TMA map over out (B*H, Sq, D) in 64-row boxes; TMA clips rows past
//     Sq and columns past D (D = 72, 112).  The store runs while the
//     consumer starts its next unit; the staging tile is written again only
//     after the store has read it (bulk wait_group.read).  lse is written
//     from registers.
//
// Masking.  Only tiles that reach past Sk or cross the diagonal of the
// unit's rows are masked, off the products: the mask is a branch of the
// softmax on the unit's values alone, never around a wgmma (ptxas
// serializes a wgmma under a branch it cannot prove warpgroup-uniform,
// C7518).  A zero-filled key scores
// exactly 0, not -inf, so a masked key is set to -inf before the max: it
// takes part in neither the max nor the sum and its probability is exactly
// 0.  A row that has seen no visible key yet keeps m = -inf and rescales
// nothing (the guard below); a row with no visible key at all (Sk = 0) has
// l = 0 and is written as 0, as the TPU kernel's `l == 0 -> 1` gives.  Rows
// past Sq are not written.  The exponentials are exp2f (no fast math) with
// the scale folded in by log2(e).
//
// Numbers.  P is rounded to bf16 before P V, as the JAX model does at bf16
// compute; l sums the float32 probabilities.  For training the kernel also
// writes, where the caller passes an lse tensor (float32 (B,H,Sq)), each
// row's log-sum-exp lse = log sum_j exp(scale q.k_j) in natural-log units:
// (m + log2 l) * ln 2 from the row's statistics, which run in log2 units
// of the scaled scores; -inf for a row with no visible key.  The backward
// (flash_attention_bwd_wgmma.cu) reads it back times log2 e.  Serving
// passes null and the kernel writes nothing more.  Every output element
// sees one fixed sequence of operations, O *= corr_t; O += P_t V_t tile by
// tile in key order (O starts at +0, which corr_0 = 0 would leave), and l =
// l * corr_t + sum p likewise, with the same k16 steps in each product as
// the one-block-a-tile kernel this replaced: no split-KV, no atomics, and
// which block runs a unit changes nothing.  So two launches give the same
// bits, and the redesign kept the earlier kernel's bits of out and lse.
//
// Bound (published H100 SXM peaks).  qwen2-7b's long prefill, q
// (1,28,2048,128), k, v (1,4,2048,128) causal: 2,098,176 visible (i, j)
// pairs per head, 4 * 128 operations each, about 30.1 GFLOP per launch:
// 0.030 ms at bf16's 989 TFLOP/s; its 33.6 MB of bytes take 0.010 ms at
// 3.35 TB/s.  Bound by operations.  One block an SM: 230,496 B of shared
// memory at D > 64 (two Q buffers, the staging tile, 2 stages of K and V:
// seven 32 KB tiles), 214,208 B at D <= 64 (five stages of 16 KB tiles).
// What still holds it back (PERF.md §6, flash_fwd_causes.py): the
// arithmetic kept for its bits.  exp2f without fast math guards each
// exponent below -126 with three more instructions (a flushing ex2.approx
// would save them), and the scores are scaled by one multiply before the
// max is subtracted (FlashAttention-3 fuses both into one FFMA); with two
// consumer warps an SMSP, that instruction stream and its latency, not the
// tensor cores, set a tile's time, most at D = 64, where a tile's products
// halve.  The diagonal tiles are computed whole and masked (about 6 % more
// products than a causal launch keeps at S = 2048), and the last units of a
// launch leave SMs idle (one kv tile of imbalance on 4-14 tiles a unit).

#include "hopper.cuh"

#include <cmath>
#include <cstddef>

namespace {

using namespace hopper;

constexpr int BQ = 128;          // query rows of one unit
constexpr int BKV = 128;         // keys of one tile
constexpr int CONSUMERS = 2;     // warpgroups of 64 query rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int MAX_D = 128;
constexpr int QBUFS = 2;         // Q buffers: this unit's and the next one's
constexpr uint32_t BOX_BYTES = 128 * 64 * 2;   // 128 rows x 64 of D: 16 KB
constexpr uint32_t HALF_BOX = 64 * 64 * 2;     // a consumer's 64 rows of it

static_assert(BQ == 64 * CONSUMERS, "one consumer per 64 rows");
static_assert(BQ == 128 && BKV == 128, "the boxes hold 128 rows");

// Shared memory for ND boxes of D: the Q buffers, the output's staging
// tile, the stages' K tiles, their V tiles, then the barriers; each tile is
// ND boxes.
template <int ND>
struct Smem {
  static constexpr int STAGES = ND == 1 ? 5 : 2;
  static constexpr uint32_t TILE = ND * BOX_BYTES;
  __host__ __device__ static constexpr uint32_t Q(int i) { return TILE * i; }
  static constexpr uint32_t O = TILE * QBUFS;
  __host__ __device__ static constexpr uint32_t K(int s) {
    return TILE * (QBUFS + 1 + s);
  }
  __host__ __device__ static constexpr uint32_t V(int s) {
    return TILE * (QBUFS + 1 + STAGES + s);
  }
  static constexpr uint32_t BARS = TILE * (QBUFS + 1 + 2 * STAGES);
  // q_full, q_empty (QBUFS each); k_full, k_empty, v_full, v_empty
  // (STAGES each)
  static constexpr int N_BARS = 2 * QBUFS + 4 * STAGES;
  static constexpr size_t BYTES = BARS + 8 * N_BARS + kSwizzleAtom;
  static_assert(BYTES <= 232448, "over the block's shared memory");
};

// A position in the K/V ring that runs on across units: the stage and the
// parity of its current use.
template <int STAGES>
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++s == STAGES) {
      s = 0;
      phase ^= 1;
    }
  }
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

// The index in the unit list of this block's unit of round `round` (the
// round's gridDim.x units, walked forwards in even rounds and backwards in
// odd ones), or -1 past the list's end.
__device__ __forceinline__ int snake_unit(int round, int n_units) {
  const int pos = round % 2 == 0 ? static_cast<int>(blockIdx.x)
                                 : static_cast<int>(gridDim.x - 1 -
                                                    blockIdx.x);
  const int i = round * static_cast<int>(gridDim.x) + pos;
  return i < n_units ? i : -1;
}

// One unit of the list: its query tile's first row, its head, its batch
// and its kv tiles (keys past the tile's last row are masked for all of
// its rows).
struct Unit {
  int r0, h, b, n_tiles;
};

__device__ __forceinline__ Unit read_unit(const int* __restrict__ units,
                                          int i, int Sq, int Sk,
                                          int causal) {
  Unit w;
  w.r0 = units[3 * i] * BQ;
  w.h = units[3 * i + 1];
  w.b = units[3 * i + 2];
  const int rows = min(BQ, Sq - w.r0);
  const int kv_end = causal ? min(Sk, w.r0 + rows) : Sk;
  w.n_tiles = (kv_end + BKV - 1) / BKV;
  return w;
}

// A consumer's end of a unit: lse from registers, O / l in bf16 through
// its 64 rows of the staging tile (128B-swizzled as TMA reads it: row r's
// 16-byte chunk j lies at chunk j ^ (r % 8) of its line), then one thread
// stores them with a TMA map over out, which clips rows past Sq and
// columns past D; the store runs on while the consumer goes on.
struct Epilogue {
  uint8_t* stage;   // the warpgroup's 64 rows of the staging tile's boxes
  float* lse;
  int H, Sq, wg, warp, lane;

  template <int ND>
  __device__ __forceinline__ void store(const CUtensorMap& omap,
                                        const Unit& w,
                                        const float (&o)[32 * ND], float m_a,
                                        float m_b, float l_a,
                                        float l_b) const {
    const int first_row = w.r0 + wg * 64;
    const int ra = warp * 16 + lane / 4, rb = ra + 8;   // within the 64
    const float inv_a = 1.0f / (l_a == 0.0f ? 1.0f : l_a);
    const float inv_b = 1.0f / (l_b == 0.0f ? 1.0f : l_b);
    if (lse != nullptr && lane % 4 == 0) {
      // the quad's four lanes hold the same m and l
      float* lp = lse + static_cast<size_t>(w.b * H + w.h) * Sq + first_row;
      if (first_row + ra < Sq) lp[ra] = row_lse(m_a, l_a);
      if (first_row + rb < Sq) lp[rb] = row_lse(m_b, l_b);
    }
    const bool leader = threadIdx.x % 128 == 0;
    if (leader) bulk_wait_read<0>();   // the last store has read the tile
    named_bar_sync(3 + wg, 128);       // this warpgroup's own barrier
#pragma unroll
    for (int jj = 0; jj < 8 * ND; ++jj) {
      const int c = jj / 8, j = jj % 8;
      uint8_t* box = stage + c * BOX_BYTES;
      *reinterpret_cast<uint32_t*>(box + ra * 128 + ((j ^ (ra % 8)) << 4) +
                                   4 * (lane % 4)) =
          pack_bf16(o[4 * jj] * inv_a, o[4 * jj + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(box + rb * 128 + ((j ^ (rb % 8)) << 4) +
                                   4 * (lane % 4)) =
          pack_bf16(o[4 * jj + 2] * inv_b, o[4 * jj + 3] * inv_b);
    }
    fence_proxy_async();
    named_bar_sync(3 + wg, 128);
    if (leader && first_row < Sq) {
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        tma_store_3d(&omap, stage + c * BOX_BYTES, 64 * c, first_row,
                     w.b * H + w.h);
      }
      bulk_commit();
    }
  }
};

// S = Q K^T over the head dim's 16-wide steps, into sc (zeroed first).
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_addr,
                                             uint32_t k_addr, int ksteps) {
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_m64n128k16<0>(sc, desc_sw128(q_addr + off, 16, kSwizzleAtom),
                           desc_sw128(k_addr + off, 16, kSwizzleAtom), 1);
  }
}

// O += P V: step kk covers keys 16kk..16kk+15; at D > 64 one m64n128k16
// product spans both 64-wide boxes of V (LBO = a box), at D <= 64 one
// m64n64k16.  o[4j + e] is row_a's column 8j + kcol + e, o[4j + 2 + e]
// row_b's, as in the scores.
template <int ND>
__device__ __forceinline__ void issue_pv(float (&o)[32 * ND],
                                         const uint32_t (&p)[BKV / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t vd =
        desc_sw128(v_addr + 2048 * kk, BOX_BYTES, kSwizzleAtom);
    if constexpr (ND == 2) {
      wgmma_rs_m64n128k16<1>(o, p[kk], vd);
    } else {
      wgmma_rs_m64n64k16<1>(o, p[kk], vd);
    }
  }
}

// The online softmax of one tile's scores in place, in log2 units: sc[4j
// + e] is row_a's key c0 + 8j + kcol + e, sc[4j + 2 + e] row_b's; on
// return sc holds the probabilities, m and l are the rows' new statistics
// and corr the factor by which O must be rescaled.  Only a tile that
// reaches past Sk or crosses the diagonal of the unit's rows (from r0) is
// masked: with tiles of 128 keys and 128 rows on multiples of 128 that is
// the diagonal tile of both warpgroups, and the test depends on the unit
// alone, not on the warpgroup.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[64], float& m_a, float& m_b, float& l_a, float& l_b,
    float& corr_a, float& corr_b, int c0, int r0, int row_a, int row_b,
    int kcol, int Sk, int causal, float scale_log2) {
  const bool masked = c0 + BKV > Sk || (causal && c0 + BKV - 1 > r0);
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
  corr_a = exp2f(m_a - mu_a);
  corr_b = exp2f(m_b - mu_b);
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = exp2f(sc[4 * j + e] - mu_a);   // masked: exactly 0
      sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mu_b);
      sum_a += sc[4 * j + e];
      sum_b += sc[4 * j + 2 + e];
    }
  }
  l_a = l_a * corr_a + quad_sum(sum_a);
  l_b = l_b * corr_b + quad_sum(sum_b);
  m_a = mn_a;
  m_b = mn_b;
}

// P as bf16 A fragments: step kk covers keys 16kk..16kk+15, which are the
// score blocks j = 2kk and 2kk + 1
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&p)[BKV / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// ND: boxes of 64 along D (1 when D <= 64, else 2).  units: n_units rows
// of (query tile, head, batch).
template <int ND>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const int* __restrict__ units, int n_units,
                       float* __restrict__ lse, int H, int KH, int Sq,
                       int Sk, int D, int causal, float scale_log2) {
  using L = Smem<ND>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (kSwizzleAtom - smem_addr(smem_raw) %
                              kSwizzleAtom) % kSwizzleAtom;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* q_empty = q_full + QBUFS;
  uint64_t* k_full = q_empty + QBUFS;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < QBUFS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], CONSUMERS * 128);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS * 128);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread loads each unit's Q, then keeps the K/V ring
    // full, running ahead into the next unit
    regs_dealloc<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      Ring<STAGES> ring;
      for (int u = 0;; ++u) {   // the block's u-th unit
        const int i = snake_unit(u, n_units);
        if (i < 0) break;
        const Unit w = read_unit(units, i, Sq, Sk, causal);
        const int kvh = w.b * KH + w.h / (H / KH);
        const int qb = u % QBUFS;
        mbar_wait(&q_empty[qb], ((u / QBUFS) & 1) ^ 1);  // use 0 passes
        mbar_arrive_expect_tx(&q_full[qb], L::TILE);
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          tma_load_3d(smem + L::Q(qb) + c * BOX_BYTES, &qmap, &q_full[qb],
                      64 * c, w.r0, w.b * H + w.h);
        }
        for (int t = 0; t < w.n_tiles; ++t, ring.next()) {
          const int s = ring.s;
          mbar_wait(&k_empty[s], ring.phase ^ 1);
          mbar_arrive_expect_tx(&k_full[s], L::TILE);
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            tma_load_3d(smem + L::K(s) + c * BOX_BYTES, &kmap, &k_full[s],
                        64 * c, t * BKV, kvh);
          }
          mbar_wait(&v_empty[s], ring.phase ^ 1);
          mbar_arrive_expect_tx(&v_full[s], L::TILE);
#pragma unroll
          for (int c = 0; c < ND; ++c) {
            tma_load_3d(smem + L::V(s) + c * BOX_BYTES, &vmap, &v_full[s],
                        64 * c, t * BKV, kvh);
          }
        }
      }
    }
  } else {
    regs_alloc<240>();
    const int wt = threadIdx.x % 128;
    const int warp = wt / 32, lane = threadIdx.x % 32;
    const int kcol = 2 * (lane % 4);   // first key / D column in an n8 block
    const int ksteps = (D + 15) / 16;
    // ping-pong: the two consumers take turns to issue their products
    // (named barrier 1 + wg is this one's turn), so one's softmax runs
    // while the other's products keep the tensor cores busy
    const uint32_t my_turn = 1 + wg, other_turn = 2 - wg;
    const Epilogue epi{smem + L::O + wg * HALF_BOX, lse, H, Sq, wg, warp,
                       lane};
    if (wg == 1) named_bar_arrive(1, CONSUMERS * 128);   // 0 starts
    Ring<STAGES> kr, vr;   // the K and V stages this consumer reads next
    float o[32 * ND];
    float sc[64];
    uint32_t p[BKV / 16][4];
    float m_a, m_b, l_a, l_b, corr_a, corr_b;
    // this warpgroup's 64 rows of unit u's Q buffer
    auto q_addr = [&](int u) {
      return smem_addr(smem + L::Q(u % QBUFS)) + wg * 64 * 128;
    };

    if (Sk == 0) {
      // no key: each unit's rows are zeros, their lse -inf
#pragma unroll
      for (int j = 0; j < 32 * ND; ++j) o[j] = 0.0f;
      for (int u = 0;; ++u) {
        const int i = snake_unit(u, n_units);
        if (i < 0) break;
        const Unit w = read_unit(units, i, Sq, Sk, causal);
        mbar_wait(&q_full[u % QBUFS], (u / QBUFS) & 1);
        mbar_arrive(&q_empty[u % QBUFS]);
        epi.store<ND>(omap, w, o, -INFINITY, -INFINITY, 0.0f, 0.0f);
      }
    } else {
      // the block's first unit: its scores of tile 0 alone in this turn
      Unit w = read_unit(units, blockIdx.x, Sq, Sk, causal);
      mbar_wait(&q_full[0], 0);
      mbar_wait(&k_full[kr.s], kr.phase);
#pragma unroll
      for (int j = 0; j < 64; ++j) sc[j] = 0.0f;
      fence_regs(sc);
      named_bar_sync(my_turn, CONSUMERS * 128);
      wgmma_fence();
      issue_scores(sc, q_addr(0), smem_addr(smem + L::K(kr.s)), ksteps);
      wgmma_commit();
      named_bar_arrive(other_turn, CONSUMERS * 128);
      wgmma_wait<0>();
      fence_regs(sc);
      if (w.n_tiles == 1) mbar_arrive(&q_empty[0]);   // Q's last use
      mbar_arrive(&k_empty[kr.s]);
      kr.next();

      for (int u = 0;; ++u) {   // the block's u-th unit; sc holds S_0
        // this thread's rows: lane/4 and lane/4 + 8 of its warp's 16
        const int ra = w.r0 + wg * 64 + warp * 16 + lane / 4, rb = ra + 8;
#pragma unroll
        for (int j = 0; j < 32 * ND; ++j) o[j] = 0.0f;
        m_a = m_b = -INFINITY;
        l_a = l_b = 0.0f;
        // O is +0, as O * corr_0 (corr_0 = 0) would leave it
        softmax_tile(sc, m_a, m_b, l_a, l_b, corr_a, corr_b, 0, w.r0, ra, rb,
                     kcol, Sk, causal, scale_log2);
        pack_p(sc, p);

        // tile t's scores and tile t - 1's P V in one turn; t's softmax
        // runs under that P V
        for (int t = 1; t < w.n_tiles; ++t) {
          mbar_wait(&k_full[kr.s], kr.phase);
          mbar_wait(&v_full[vr.s], vr.phase);
#pragma unroll
          for (int j = 0; j < 64; ++j) sc[j] = 0.0f;
          fence_regs(sc);
          fence_regs(o);
          named_bar_sync(my_turn, CONSUMERS * 128);
          wgmma_fence();
          issue_scores(sc, q_addr(u), smem_addr(smem + L::K(kr.s)), ksteps);
          wgmma_commit();
          issue_pv<ND>(o, p, smem_addr(smem + L::V(vr.s)));
          wgmma_commit();
          named_bar_arrive(other_turn, CONSUMERS * 128);
          wgmma_wait<1>();   // the scores; P V runs on
          fence_regs(sc);
          if (t == w.n_tiles - 1) mbar_arrive(&q_empty[u % QBUFS]);
          mbar_arrive(&k_empty[kr.s]);
          kr.next();
          softmax_tile(sc, m_a, m_b, l_a, l_b, corr_a, corr_b, t * BKV, w.r0,
                       ra, rb, kcol, Sk, causal, scale_log2);
          wgmma_wait<0>();   // P_{t-1} V_{t-1}
          fence_regs(o);
          mbar_arrive(&v_empty[vr.s]);
          vr.next();
#pragma unroll
          for (int j = 0; j < 8 * ND; ++j) {
            o[4 * j] *= corr_a;
            o[4 * j + 1] *= corr_a;
            o[4 * j + 2] *= corr_b;
            o[4 * j + 3] *= corr_b;
          }
          pack_p(sc, p);
        }

        // the block's last unit: its last tile's P V alone, below
        const int ni = snake_unit(u + 1, n_units);
        if (ni < 0) break;
        // the last tile's P V, and in the same turn the next unit's scores
        // of its tile 0, which run under this unit's epilogue
        const Unit next = read_unit(units, ni, Sq, Sk, causal);
        mbar_wait(&q_full[(u + 1) % QBUFS], ((u + 1) / QBUFS) & 1);
        mbar_wait(&k_full[kr.s], kr.phase);
        mbar_wait(&v_full[vr.s], vr.phase);
#pragma unroll
        for (int j = 0; j < 64; ++j) sc[j] = 0.0f;
        fence_regs(sc);
        fence_regs(o);
        named_bar_sync(my_turn, CONSUMERS * 128);
        wgmma_fence();
        issue_pv<ND>(o, p, smem_addr(smem + L::V(vr.s)));
        wgmma_commit();
        issue_scores(sc, q_addr(u + 1), smem_addr(smem + L::K(kr.s)),
                     ksteps);
        wgmma_commit();
        named_bar_arrive(other_turn, CONSUMERS * 128);
        wgmma_wait<1>();   // the P V; the next scores run on
        fence_regs(o);
        mbar_arrive(&v_empty[vr.s]);
        vr.next();
        epi.store<ND>(omap, w, o, m_a, m_b, l_a, l_b);
        wgmma_wait<0>();
        fence_regs(sc);
        if (next.n_tiles == 1) mbar_arrive(&q_empty[(u + 1) % QBUFS]);
        mbar_arrive(&k_empty[kr.s]);
        kr.next();
        w = next;
      }
      mbar_wait(&v_full[vr.s], vr.phase);
      fence_regs(o);
      named_bar_sync(my_turn, CONSUMERS * 128);
      wgmma_fence();
      issue_pv<ND>(o, p, smem_addr(smem + L::V(vr.s)));
      wgmma_commit();
      named_bar_arrive(other_turn, CONSUMERS * 128);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&v_empty[vr.s]);
      epi.store<ND>(omap, w, o, m_a, m_b, l_a, l_b);
    }
    if (wt == 0) bulk_wait<0>();   // out is written before the block ends
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
cudaError_t launch_nd(const CUtensorMap& qmap, const CUtensorMap& kmap,
                      const CUtensorMap& vmap, const CUtensorMap& omap,
                      const int* units, int n_units, float* lse, int H,
                      int KH, int Sq, int Sk, int D, int causal, int sms,
                      cudaStream_t stream) {
  const size_t bytes = Smem<ND>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int grid = n_units < sms ? n_units : sms;
  const double log2e = 1.4426950408889634;
  flash_wgmma_kernel<ND><<<grid, THREADS, bytes, stream>>>(
      qmap, kmap, vmap, omap, units, n_units, lse, H, KH, Sq, Sk, D, causal,
      static_cast<float>(log2e / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  q (B,H,Sq,D), k, v (B,KH,Sk,D)
// and out (B,H,Sq,D) are contiguous bf16 device tensors, 16-byte aligned,
// with D % 8 == 0 and D <= 128 (TMA needs 16-byte row strides); lse is
// null or a float32 (B,H,Sq) device tensor that receives each row's
// log-sum-exp (see the header); units (n_units, 3) int32 on the device,
// every unit of kernels/flash_attention.py::forward_schedule for these
// sizes, in the order to run; `causal` is 0 or 1; `stream` is the caller's
// cudaStream_t.  The call only queues the kernel and returns the launch's
// cudaError_t.
extern "C" int repro_flash_attention_bf16_wgmma(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* units, int n_units, int B, int H, int KH, int Sq, int Sk,
    int D, int causal, int device, void* stream) {
  if (B < 0 || H < 1 || KH < 1 || H % KH != 0 || Sq < 0 || Sk < 0 ||
      D < 8 || D > MAX_D || D % 8 != 0 || B > 65535 || H > 65535 ||
      n_units < 0) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  if (static_cast<long long>(n_units) !=
      static_cast<long long>(B) * H * ((Sq + BQ - 1) / BQ)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap{}, kmap{}, vmap{}, omap{};   // Sk == 0: no K/V tile
  err = head_map(&qmap, q, B * H, Sq, D, BQ);
  if (err == cudaSuccess) err = head_map(&omap, out, B * H, Sq, D, 64);
  if (err == cudaSuccess && Sk > 0) {
    err = head_map(&kmap, k, B * KH, Sk, D, BKV);
    if (err == cudaSuccess) err = head_map(&vmap, v, B * KH, Sk, D, BKV);
  }
  if (err != cudaSuccess) return err;
  const auto* up = static_cast<const int*>(units);
  auto* lp = static_cast<float*>(lse);
  const auto s = static_cast<cudaStream_t>(stream);
  if (D <= 64) {
    return launch_nd<1>(qmap, kmap, vmap, omap, up, n_units, lp, H, KH, Sq,
                        Sk, D, causal, sms, s);
  }
  return launch_nd<2>(qmap, kmap, vmap, omap, up, n_units, lp, H, KH, Sq,
                      Sk, D, causal, sms, s);
}
