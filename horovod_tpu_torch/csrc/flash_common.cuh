// Building blocks of the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) that are not Hopper
// machinery (that is hopper_common.cuh): the 16-bit types, the log2
// constants and the rounding of a float pair to one 16-bit register.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Two floats rounded (to nearest even) to T, as one register.
template <typename T>
__device__ __forceinline__ uint32_t pack_float2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack_float2<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack_float2<f16>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace hvd_flash
