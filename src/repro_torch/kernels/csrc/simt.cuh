// CUDA-core primitives shared by the port's simt kernels, matmul.cu and
// ssm_scan.cu: widening the input types to float32 and rounding back, and
// asynchronous global -> shared copies (cp.async, sm_80 and later) that
// stage the next tiles while the current ones are computed.
//
// A cp.async copy moves 4, 8 or 16 bytes and lands in shared memory without
// passing through registers.  With `valid` false it reads nothing (`src`
// may then point anywhere) and writes zeros, which is how the kernels mask
// their ragged edges.  Copies issued by one thread are grouped by
// cp_async_commit(); cp_async_wait<n>() waits until at most n of the
// thread's groups are in flight, and a __syncthreads() after it makes every
// thread's landed copies visible to the block.  bf16 elements are 2 bytes, under the smallest copy, so the
// bf16 instantiations stage through registers instead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace simt {

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, cached in L1 (neighbouring copies read the rest of the sector)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace simt
