// Building blocks of the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the 16-bit types,
// constants and fragment packing they all use, and, for the dQ kernel,
// the mma.sync tensor-core product (bf16 or f16 operands, f32
// accumulate), cp.async copies and the padded, zero-filled tile load.
//
// Fragment layouts of mma.sync.m16n8k16 (row.col), g = lane / 4 and
// t = lane % 4: A (16 x 16, row-major) a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];
// B (16 x 8, column-major) b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
// C (16 x 8) c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

typedef __nv_bfloat16 bf16;
typedef __half f16;

constexpr int kPad = 8;  // elements of row padding: conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// C += A B on the tensor cores, A and B of the 16-bit type T.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<bf16>(float (&c)[4], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint32_t b0,
                                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<f16>(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two 16-bit values as one register, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack_pair(T lo, T hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi))
          << 16);
}

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

// 16 bytes from gmem when `valid`, else 16 zero bytes (nothing is read).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// rows x D tile from global (row stride in elements, head dim
// contiguous) into shared memory with row stride D + kPad, copied by
// the kThreads threads of the block. With kGuard, rows at or past
// `valid` (the ragged end of the sequence) are zero-filled and not read;
// without it every row is read.
template <int D, int kThreads, bool kGuard = true, typename T>
__device__ __forceinline__ void load_tile(T* s, const T* g,
                                          int64_t row_stride, int rows,
                                          int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    if constexpr (kGuard) {
      const bool ok = r < valid;
      cp_async16_zfill(s + r * (D + kPad) + c,
                       ok ? g + r * row_stride + c : g, ok);
    } else {
      cp_async16(s + r * (D + kPad) + c, g + r * row_stride + c);
    }
  }
}

}  // namespace hvd_flash
