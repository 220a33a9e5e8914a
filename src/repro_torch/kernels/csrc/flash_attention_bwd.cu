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
// Design: two kinds of unit, neither with atomics, so every output is
// summed in one fixed order and two launches give the same bits; both run
// in ONE launch after the pre-pass, block i taking unit i of the list the
// wrapper hands over (kernels/flash_attention.py::backward_schedule with
// rows = 64: (kind, tile, head, batch), heaviest first, so the long causal
// units start first and the short ones of either kind fill the SMs behind
// them).
//   - dK/dV unit: 64 keys of one (kv head, batch); K and V stay in shared
//     memory while the unit walks the G query heads and, for each, the
//     64-row query tiles from the tile of its first key on (causal);
//   - dQ unit: 64 query rows of one (head, batch), Q and dO in shared
//     memory, walking the 64-key tiles up to its last row's diagonal.
// A block is two teams of 256 threads (16 warps).  The teams take the
// unit's steps in turns (team 0 the even ones, team 1 the odd ones), each
// with its own stage of the block's two-stage ring (Q and dO, or K and V,
// with the rows' lse and delta), so one team's tiles load while the other
// team's products run.  Float32 tiles whose rows are 16-byte multiples (D %
// 4 == 0, every tensor 16-byte aligned) stream by cp.async (16-byte copies,
// commit_group / wait_group); other float32 calls and every bf16 call (on
// this route only when misaligned or D % 8 != 0) keep the converting plain
// load, load_tile.  Each team keeps its own dK and dV (or dQ) in registers;
// at the end team 1 hands its sums over through shared memory and team 0
// writes team 0's + team 1's.  Each kind recomputes S and dP for its pairs,
// so the backward does 7 products a visible pair (14 D operations; S^T,
// dP^T, dV, dK in the first, S, dP, dQ in the second) where an atomic dQ
// would do 5.
//
// Tiles: float32 in shared memory at a pitch of DP + 4 (DP = 64 or 128, D
// padded with zeros).  In the score products a thread owns 4 x 4 (key,
// query) pairs, rows tg + 16 i against rows tc + 16 j (tg = t / 16, tc = t
// % 16 of its team's t), read as 16-byte vectors, so a quarter warp's reads
// fall in distinct banks.  The pairs of a key row all lie in one warp (its
// two tg), so P and dS never need a block barrier: at DP = 64 a warp leaves
// its rows in its team's 64 x 64 pair tile (pitch BT + 4) and reads them
// back four columns at a time; at DP = 128, with no room for that tile,
// the accumulating products take them by warp shuffles.  In those a thread
// owns 4 rows x 4 DP / 64 columns (4 tc + 64 jj + e) of dK, dV or dQ.
// Shared memory: the unit's own two tiles, two stages of two tiles, lse and
// delta, and at DP = 64 two pair tiles: 204,288 B at DP = 128, 140,800 B at
// DP = 64; 512 threads under __launch_bounds__(512, 1) (128 registers a
// thread at most: small spills at DP = 128), one block and 16 warps an SM.
// One team of 256 threads that double-buffers its own steps (255
// registers, no spills, 8 warps) measured 11 % slower at DP = 128 (PERF.md
// §6).  chip_smoke.py prints what `-Xptxas -v` and the occupancy
// calculator report (repro_flash_attention_bwd_resources).
//
// Numbers.  float32 stays IEEE float32 FMA on the CUDA cores, never TF32.
// For bf16 inputs, P is rounded to bf16 where it meets dO in dV, as the
// forward rounds it before P V and as the plain backward
// (kernels/flash_attention.py::attention_backward) does; every other value
// stays float32 and the outputs are rounded once, to the inputs' type.  A
// masked pair (causal, or a key past Sk) has P = 0 exactly; query rows past
// Sq read lse = +inf, so their P is 0 too; rows of dK, dV past Sk and of dQ
// past Sq are not written.  The wrapper launches nothing when Sq or Sk is
// 0 (the gradients are zeros).  The teams' split of a unit's steps sums
// each output as (even steps) + (odd steps), another order than a single
// walk: the bits differ from a one-team kernel's, and are the same on
// every launch; against a float64 gradient the error is no larger than the
// plain float32 version's (PERF.md §6).
//
// Bound (published H100 SXM peaks; launch/costs.py::flash_backward_bound).
// qwen2-7b's training attention, q (2,28,2048,128), k, v (2,4,2048,128),
// causal, float32: 117,497,856 visible pairs, 10 D operations each for the
// five products the gradient needs, 150.4 GFLOP: 2.245 ms at 67 TFLOP/s on
// the CUDA cores; its 269 MB (q, k, v, out, dout, lse read, dq, dk, dv
// written) take 0.080 ms at 3.35 TB/s.  Bound by operations.  What holds
// it back: the two recomputed products, the diagonal tiles computed whole,
// the shared-memory reads (a 4 x 4 micro-tile does 2 FMAs a float read; at
// DP = 128 the shuffles add one read for every 8 FMAs), and a team that
// waits for its own stage while only the other computes.

#include "flash_attention_bwd.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using simt::from_f32;
using simt::to_f32;

constexpr int BT = 64;          // keys (dK/dV) or queries (dQ) of a unit,
                                // and of each tile it loops over
constexpr int TEAM = 256;       // threads of a team
constexpr int TEAMS = 2;
constexpr int THREADS = TEAM * TEAMS;
constexpr int MAX_D = 128;

template <int DP_>
struct Layout {
  static constexpr int DP = DP_;
  static constexpr int PITCH = DP + 4;      // floats a row of a D tile
  static constexpr int TILE = BT * PITCH;   // one 64-row D tile
  // floats: the unit's own two tiles (K and V, or Q and dO) and its rows'
  // lse and delta (dQ), then a stage a team: two tiles (Q and dO, or K and
  // V) and their rows' lse and delta (dK/dV)
  static constexpr int OWN = 0;
  static constexpr int OWN_STATS = 2 * TILE;
  static constexpr int STAGE_FLOATS = 2 * TILE + 2 * BT;
  __host__ __device__ static constexpr int STAGE(int team) {
    return 2 * TILE + 2 * BT + team * STAGE_FLOATS;
  }
  // at DP = 64 a team also has a 64 x 64 pair tile (P or dS) of pitch
  // BT + 4, where its warps leave their rows for the accumulating
  // products; at DP = 128 there is no room, and warp shuffles carry them
  static constexpr bool STAGED = DP == 64;
  static constexpr int SPITCH = BT + 4;
  static constexpr int PAIR = BT * SPITCH;
  __host__ __device__ static constexpr int PAIRS(int team) {
    return 2 * TILE + 2 * BT + TEAMS * STAGE_FLOATS + team * PAIR;
  }
  static constexpr int FLOATS =
      2 * TILE + 2 * BT + TEAMS * STAGE_FLOATS + (STAGED ? TEAMS * PAIR : 0);
  static constexpr int BYTES = 4 * FLOATS;
  static_assert(DP == 64 || DP == 128, "the maps below are written for these");
  static_assert(BYTES <= 232448, "over the block's shared memory");
  // team 1's sums (two 4 x DP / 16 arrays a thread) fit in the stages
  static_assert(2 * 4 * (DP / 16) * TEAM <= TEAMS * STAGE_FLOATS,
                "the hand-over buffer");
};

// a team's barrier: named barrier 1 + team over its 256 threads
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(TEAM) : "memory");
}

// The BT = 64 rows from `src` (row-major, D wide) into a tile of pitch
// DP + 4 floats, by threads t = 0..n - 1; rows >= valid and columns >= D
// are zeros.  Plain loads, converted to float32.
template <typename T, int DP>
__device__ void load_tile(float* dst, const T* src, int valid, int D, int t,
                          int n) {
  for (int i = t; i < BT * DP; i += n) {
    const int r = i / DP, c = i % DP;   // powers of two: shifts
    dst[r * (DP + 4) + c] =
        (r < valid && c < D) ? to_f32(src[static_cast<size_t>(r) * D + c])
                             : 0.0f;
  }
}

// The same by cp.async, 16 bytes a copy: float32, D % 4 == 0 and `src`
// 16-byte aligned.  The caller commits and waits.
template <int DP>
__device__ void load_tile_async(float* dst, const float* src, int valid,
                                int D, int t, int n) {
  constexpr int CHUNKS = DP / 4;   // 16-byte chunks of a row
  for (int i = t; i < BT * CHUNKS; i += n) {
    const int r = i / CHUNKS, c = 4 * (i % CHUNKS);
    const bool ok = r < valid && c < D;
    simt::cp_async16(dst + r * (DP + 4) + c,
                     ok ? src + static_cast<size_t>(r) * D + c : src, ok);
  }
}

template <typename T, int DP, bool VEC>
__device__ __forceinline__ void load(float* dst, const T* src, int valid,
                                     int D, int t, int n) {
  if constexpr (VEC) {
    load_tile_async<DP>(dst, src, valid, D, t, n);
  } else {
    load_tile<T, DP>(dst, src, valid, D, t, n);
  }
}

// acc[i][j] += row (ra + 16 i) of a . row (rb + 16 j) of b, over DP
template <int DP>
__device__ __forceinline__ void dots(float (&acc)[4][4], const float* a,
                                     int ra, const float* b, int rb) {
  constexpr int PITCH = DP + 4;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = *reinterpret_cast<const float4*>(b + (rb + 16 * j) * PITCH + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(a + (ra + 16 * i) * PITCH + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x.x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x.y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x.z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x.w, y[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][4 jj + e] += sum_c w(row tg + 16 i, c) * x[c][4 tc + 64 jj + e]:
// the 64 x 64 pair tile w, of which this thread holds w[i][j] = w(row tg +
// 16 i, column tc + 16 j), times a 64-row D tile x.  The two tg of a warp
// are its lanes 0-15 and 16-31, so w(row, c) of this thread's rows lies in
// lane (lane & 16) | (c % 16), at j = c / 16.
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[4][DP / 16],
                                           const float (&w)[4][4],
                                           const float* x, int tc) {
  constexpr int PITCH = DP + 4, NJ = DP / 64;
  const int half = threadIdx.x & 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll 4
    for (int u = 0; u < 16; ++u) {
      const int c = 16 * j + u;
      float wi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wi[i] = __shfl_sync(0xffffffffu, w[i][j], half | u);
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 xv = *reinterpret_cast<const float4*>(
            x + c * PITCH + 4 * tc + 64 * jj);
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
}

// The same product with w read from shared memory, where this warp's
// threads left their w[i][j] at row tg + 16 i, column tc + 16 j (pitch BT +
// 4): one 16-byte read gives four columns of a row, a quarter of the reads
// of the shuffles.  The sum runs over c in the same order.
template <int DP>
__device__ __forceinline__ void accumulate_staged(float (&acc)[4][DP / 16],
                                                  const float* w,
                                                  const float* x, int tg,
                                                  int tc) {
  constexpr int PITCH = DP + 4, SPITCH = BT + 4, NJ = DP / 64;
#pragma unroll 2
  for (int c4 = 0; c4 < BT; c4 += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wv[i] = *reinterpret_cast<const float4*>(w + (tg + 16 * i) * SPITCH +
                                               c4);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c4 + e;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 xv = *reinterpret_cast<const float4*>(
            x + c * PITCH + 4 * tc + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wi = e == 0 ? wv[i].x
                           : e == 1 ? wv[i].y
                           : e == 2 ? wv[i].z
                                    : wv[i].w;
          acc[i][4 * jj] = fmaf(wi, xv.x, acc[i][4 * jj]);
          acc[i][4 * jj + 1] = fmaf(wi, xv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(wi, xv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(wi, xv.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// acc += W X for the pair tile W of which this thread holds w[i][j] (row
// tg + 16 i, column tc + 16 j): through the team's pair tile `pairs` where
// the layout has one (a warp writes and reads only its own rows, so a
// warp's barrier orders them), else by warp shuffles.
template <int DP>
__device__ __forceinline__ void pair_product(float (&acc)[4][DP / 16],
                                             const float (&w)[4][4],
                                             float* pairs, const float* x,
                                             int tg, int tc) {
  if constexpr (Layout<DP>::STAGED) {
    constexpr int SPITCH = BT + 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pairs[(tg + 16 * i) * SPITCH + tc + 16 * j] = w[i][j];
      }
    __syncwarp();
    accumulate_staged<DP>(acc, pairs, x, tg, tc);
    __syncwarp();   // read before the next pair tile overwrites it
  } else {
    accumulate<DP>(acc, w, x, tc);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.0f;
}

// Team 1 leaves its sums in `buf` (thread-major, so the 256 threads' stores
// and loads are consecutive); team 0 adds them to its own: team 0's +
// team 1's, one order.  Both teams must have finished with the stages.
template <int N>
__device__ __forceinline__ void hand_over(float (&acc)[4][N], float* buf,
                                          int team, int t) {
  __syncthreads();   // every team is done with the stages
  if (team == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) buf[(i * N + j) * TEAM + t] = acc[i][j];
  }
  __syncthreads();
  if (team == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] += buf[(i * N + j) * TEAM + t];
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

// 64 rows' lse (log2 units; +inf past Sq) and delta from row i0 of head bh,
// by the team's threads t < 64
__device__ __forceinline__ void load_stats(float* ls, const float* lse,
                                           const float* delta, size_t bh,
                                           int i0, int Sq, int t) {
  if (t < BT) {
    const int i = i0 + t;
    ls[t] = i < Sq ? lse[bh * Sq + i] * flash_bwd::kLog2e : INFINITY;
    ls[BT + t] = i < Sq ? delta[bh * Sq + i] : 0.0f;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, KH, Sq, Sk, D, causal;
  float scale, scale_log2;
};

// One dK/dV unit: keys 64 kt.. of kv head g of batch b.
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void dkdv_unit(float* smem, const Args& a, int kt,
                                          int g, int b) {
  using LY = Layout<DP>;
  const int team = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
  const int tg = t / 16, tc = t % 16;
  float* ks = smem + LY::OWN;
  float* vs = ks + LY::TILE;
  float* qs = smem + LY::STAGE(team);   // this team's stage
  float* dos = qs + LY::TILE;
  float* ls = dos + LY::TILE;           // its rows' lse (log2) and delta
  const float* dl = ls + BT;

  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int k0 = kt * BT;
  const int G = a.H / a.KH;
  const int n_q = (a.Sq + BT - 1) / BT;
  // query tile qt holds rows 64 qt..64 qt + 63: under the causal mask the
  // tiles before this unit's first key see none of its keys
  const int q_first = a.causal ? min(kt, n_q) : 0;
  const int per_head = n_q - q_first;
  const int n_steps = G * per_head;
  const size_t kv_row0 = (static_cast<size_t>(b) * a.KH + g) * a.Sk + k0;

  // step s: query tile q_first + s % per_head of query head g G + s /
  // per_head
  auto issue = [&](int s) {
    const size_t bh = static_cast<size_t>(b) * a.H +
                      static_cast<size_t>(g) * G + s / per_head;
    const int i0 = (q_first + s % per_head) * BT;
    load<T, DP, VEC>(qs, q + (bh * a.Sq + i0) * a.D, a.Sq - i0, a.D, t, TEAM);
    load<T, DP, VEC>(dos, dout + (bh * a.Sq + i0) * a.D, a.Sq - i0, a.D, t,
                     TEAM);
    load_stats(ls, a.lse, a.delta, bh, i0, a.Sq, t);
    if constexpr (VEC) simt::cp_async_commit();
  };

  load<T, DP, VEC>(ks, static_cast<const T*>(a.k) + kv_row0 * a.D,
                   a.Sk - k0, a.D, threadIdx.x, THREADS);
  load<T, DP, VEC>(vs, static_cast<const T*>(a.v) + kv_row0 * a.D,
                   a.Sk - k0, a.D, threadIdx.x, THREADS);
  if constexpr (VEC) simt::cp_async_commit();
  if (team < n_steps) issue(team);
  if constexpr (VEC) simt::cp_async_wait<0>();
  __syncthreads();   // K and V, and each team's first stage

  float dka[4][DP / 16], dva[4][DP / 16];
  zero(dka);
  zero(dva);
  for (int s = team; s < n_steps; s += TEAMS) {
    if (s != team) {
      if constexpr (VEC) simt::cp_async_wait<0>();
      team_sync(team);   // the stage's tiles and rows have landed
    }
    const int i0 = (q_first + s % per_head) * BT;
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    dots<DP>(st, ks, tg, qs, tc);      // S^T: keys x queries
    dots<DP>(dpt, vs, tg, dos, tc);    // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tg + 16 * i, col = tc + 16 * j;
        float p = exp2f(st[i][j] * a.scale_log2 - ls[col]);
        if (a.causal && key > i0 + col) p = 0.0f;
        st[i][j] = as_input<T>(p);                // P, rounded for dV
        dpt[i][j] = p * (dpt[i][j] - dl[col]);    // dS^T
      }
    float* pairs = smem + LY::PAIRS(team);
    pair_product<DP>(dva, st, pairs, dos, tg, tc);    // dV += P^T dO
    pair_product<DP>(dka, dpt, pairs, qs, tg, tc);    // dK += dS^T Q
    if (s + TEAMS < n_steps) {
      team_sync(team);   // every thread of the team is done with the stage
      issue(s + TEAMS);
    }
  }
  hand_over(dka, smem + LY::STAGE(0), team, t);
  hand_over(dva, smem + LY::STAGE(0), team, t);
  if (team == 0) {
    T* dk = static_cast<T*>(a.dk) + kv_row0 * a.D;
    T* dv = static_cast<T*>(a.dv) + kv_row0 * a.D;
    store_rows<T, DP>(dk, dka, a.Sk - k0, a.D, a.scale, tg, tc);
    store_rows<T, DP>(dv, dva, a.Sk - k0, a.D, 1.0f, tg, tc);
  }
}

// One dQ unit: query rows 64 qt.. of head h of batch b.
template <typename T, int DP, bool VEC>
__device__ __forceinline__ void dq_unit(float* smem, const Args& a, int qt,
                                        int h, int b) {
  using LY = Layout<DP>;
  const int team = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
  const int tg = t / 16, tc = t % 16;
  float* qs = smem + LY::OWN;
  float* dos = qs + LY::TILE;
  float* ls = smem + LY::OWN_STATS;   // the unit's rows' lse and delta
  const float* dl = ls + BT;
  float* ks = smem + LY::STAGE(team);   // this team's stage
  float* vs = ks + LY::TILE;

  const int r0 = qt * BT;
  const int g = h / (a.H / a.KH);
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const int rows = min(BT, a.Sq - r0);
  // keys past the tile's last row are masked for all of its rows
  const int kv_end = a.causal ? min(a.Sk, r0 + rows) : a.Sk;
  const int n_tiles = (kv_end + BT - 1) / BT;
  const T* kp = static_cast<const T*>(a.k) +
                (static_cast<size_t>(b) * a.KH + g) * a.Sk * a.D;
  const T* vp = static_cast<const T*>(a.v) +
                (static_cast<size_t>(b) * a.KH + g) * a.Sk * a.D;

  auto issue = [&](int s) {
    const int c0 = s * BT;
    load<T, DP, VEC>(ks, kp + static_cast<size_t>(c0) * a.D, a.Sk - c0, a.D,
                     t, TEAM);
    load<T, DP, VEC>(vs, vp + static_cast<size_t>(c0) * a.D, a.Sk - c0, a.D,
                     t, TEAM);
    if constexpr (VEC) simt::cp_async_commit();
  };

  load<T, DP, VEC>(qs, static_cast<const T*>(a.q) + (bh * a.Sq + r0) * a.D,
                   rows, a.D, threadIdx.x, THREADS);
  load<T, DP, VEC>(dos,
                   static_cast<const T*>(a.dout) + (bh * a.Sq + r0) * a.D,
                   rows, a.D, threadIdx.x, THREADS);
  load_stats(ls, a.lse, a.delta, bh, r0, a.Sq, threadIdx.x);
  if constexpr (VEC) simt::cp_async_commit();
  if (team < n_tiles) issue(team);
  if constexpr (VEC) simt::cp_async_wait<0>();
  __syncthreads();   // Q, dO, their rows, and each team's first stage

  float dqa[4][DP / 16];
  zero(dqa);
  for (int s = team; s < n_tiles; s += TEAMS) {
    if (s != team) {
      if constexpr (VEC) simt::cp_async_wait<0>();
      team_sync(team);
    }
    const int c0 = s * BT;
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    dots<DP>(sc, qs, tg, ks, tc);      // S: queries x keys
    dots<DP>(dp, dos, tg, vs, tc);     // dP
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = tg + 16 * i, key = c0 + tc + 16 * j;
        float p = exp2f(sc[i][j] * a.scale_log2 - ls[row]);
        if (key >= a.Sk || (a.causal && key > r0 + row)) p = 0.0f;
        dp[i][j] = p * (dp[i][j] - dl[row]);   // dS
      }
    pair_product<DP>(dqa, dp, smem + LY::PAIRS(team), ks, tg,
                     tc);   // dQ += dS K
    if (s + TEAMS < n_tiles) {
      team_sync(team);
      issue(s + TEAMS);
    }
  }
  hand_over(dqa, smem + LY::STAGE(0), team, t);
  if (team == 0) {
    store_rows<T, DP>(static_cast<T*>(a.dq) + (bh * a.Sq + r0) * a.D, dqa,
                      rows, a.D, a.scale, tg, tc);
  }
}

// Block i runs unit units[i] = (kind, tile, head, batch): kind 0 a dK/dV
// unit (tile of 64 keys, kv head), kind 1 a dQ unit (tile of 64 queries,
// query head).
template <typename T, int DP, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_kernel(const int4* __restrict__ units, const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int4 u = units[blockIdx.x];
  if (u.x == 0) {
    dkdv_unit<T, DP, VEC>(smem, a, u.y, u.z, u.w);
  } else {
    dq_unit<T, DP, VEC>(smem, a, u.y, u.z, u.w);
  }
}

template <typename T, int DP, bool VEC>
cudaError_t launch_dp(const int4* units, int n_units, const Args& a,
                      cudaStream_t s) {
  constexpr int bytes = Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, DP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<T, DP, VEC><<<n_units, THREADS, bytes, s>>>(units, a);
  return cudaGetLastError();
}

template <typename T, int DP, bool VEC>
cudaError_t resources_dp(int* out) {
  constexpr int bytes = Layout<DP>::BYTES;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, DP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, flash_bwd_kernel<T, DP, VEC>);
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_bwd_kernel<T, DP, VEC>, THREADS, bytes);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes) + bytes;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = THREADS;
  out[4] = blocks;
  return cudaSuccess;
}

// float32 tiles go by cp.async when every row is a whole number of 16-byte
// copies and every tensor the loads read starts on a 16-byte boundary
template <typename T>
bool vector_loads(const void* q, const void* k, const void* v,
                  const void* dout, int D) {
  const auto at16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return sizeof(T) == 4 && D % 4 == 0 && at16(q) && at16(k) && at16(v) &&
         at16(dout);
}

template <typename T, int DP>
cudaError_t launch_route(const int4* units, int n_units, const Args& a,
                         bool vec, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (vec) return launch_dp<T, DP, true>(units, n_units, a, s);
  }
  return launch_dp<T, DP, false>(units, n_units, a, s);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, const void* units, int n_units, int B, int H, int KH,
           int Sq, int Sk, int D, int causal, int device, void* stream) {
  if (B < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || D > MAX_D || B > 65535 || H > 65535 || n_units < 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* dl = static_cast<float*>(delta);
  err = flash_bwd::launch_delta<T>(
      out, dout, dl, static_cast<size_t>(B) * H * Sq, D, s);
  if (err != cudaSuccess) return err;
  const double rs = 1.0 / std::sqrt(static_cast<double>(D));
  const Args a{q, k, v, dout, static_cast<const float*>(lse), dl, dq, dk, dv,
               H, KH, Sq, Sk, D, causal, static_cast<float>(rs),
               static_cast<float>(rs * 1.4426950408889634)};
  const auto* up = static_cast<const int4*>(units);
  const bool vec = vector_loads<T>(q, k, v, dout, D);
  if (D <= 64) return launch_route<T, 64>(up, n_units, a, vec, s);
  return launch_route<T, 128>(up, n_units, a, vec, s);
}

template <typename T>
int resources(int D, int vec, int* out) {
  if (D < 1 || D > MAX_D) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      return D <= 64 ? resources_dp<T, 64, true>(out)
                     : resources_dp<T, 128, true>(out);
    }
  }
  return D <= 64 ? resources_dp<T, 64, false>(out)
                 : resources_dp<T, 128, false>(out);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous row-major tensors: q, out, dout, dq (B,H,Sq,D); k, v, dk, dv
// (B,KH,Sk,D); lse (B,H,Sq) float32 from the forward; delta (B,H,Sq)
// float32 scratch the pre-pass fills; units (n_units, 4) int32, every unit
// of kernels/flash_attention.py::backward_schedule for these sizes with
// rows = 64, in the order to run.  B, Sq, Sk >= 1; `causal` is 0 or 1;
// `stream` is the caller's cudaStream_t.  The call only queues the
// pre-pass and the units' launch and returns the first launch error.
extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, const void* units, int n_units, int B, int H, int KH,
    int Sq, int Sk, int D, int causal, int device, void* stream) {
  return launch<float>(q, k, v, out, dout, lse, dq, dk, dv, delta, units,
                       n_units, B, H, KH, Sq, Sk, D, causal, device, stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, const void* units, int n_units, int B, int H, int KH,
    int Sq, int Sk, int D, int causal, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, dout, lse, dq, dk, dv, delta,
                               units, n_units, B, H, KH, Sq, Sk, D, causal,
                               device, stream);
}

// The kernel that a float32 (bf16 = 0) or bf16 call of head dim D takes,
// with cp.async loads (vec = 1: float32, D % 4 == 0, aligned) or plain
// ones: its registers a thread, shared memory a block (static and
// dynamic), local (spill) bytes a thread, threads a block and resident
// blocks an SM, into out[0..4].
extern "C" int repro_flash_attention_bwd_resources(int bf16, int D, int vec,
                                                   int* out) {
  return bf16 ? resources<__nv_bfloat16>(D, vec, out)
              : resources<float>(D, vec, out);
}
