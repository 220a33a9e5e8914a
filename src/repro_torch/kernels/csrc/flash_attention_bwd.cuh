// The pre-pass of flash attention's backward, shared by its two routes
// (flash_attention_bwd.cu on the CUDA cores, flash_attention_bwd_wgmma.cu
// on the tensor cores): delta[r] = sum_d out[r,d] * dout[r,d] in float32,
// for every row r of the (B*H*Sq, D) output and its upstream gradient.
// Both passes of the backward read it as dS = P o (dP - delta).
//
// One warp a row: lane l reads d = l, l + 32, ..., so a warp's loads are
// consecutive, and the butterfly sums the lanes in one fixed order (two
// launches give the same bits).  Each row is read once: 2 * D elements.
//
// The kernel sits in an anonymous namespace so that each source that
// includes this header has its own copy and no symbol is shared between
// the library's objects.

#pragma once

#include "simt.cuh"

#include <cstddef>

namespace {
namespace flash_bwd {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
    delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, size_t rows, int D) {
  const size_t r = static_cast<size_t>(blockIdx.x) * kDeltaWarps +
                   threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;   // the whole warp leaves together
  const T* o = out + r * D;
  const T* g = dout + r * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) {
    acc = fmaf(simt::to_f32(o[d]), simt::to_f32(g[d]), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  }
  if (lane == 0) delta[r] = acc;
}

// Queues the pre-pass over `rows` rows of D elements; returns the launch's
// error.
template <typename T>
cudaError_t launch_delta(const void* out, const void* dout, float* delta,
                         size_t rows, int D, cudaStream_t stream) {
  const size_t blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 2147483647u) return cudaErrorInvalidValue;
  delta_kernel<T><<<static_cast<unsigned>(blocks), 32 * kDeltaWarps, 0,
                    stream>>>(static_cast<const T*>(out),
                              static_cast<const T*>(dout), delta, rows, D);
  return cudaGetLastError();
}

}  // namespace flash_bwd
}  // namespace
