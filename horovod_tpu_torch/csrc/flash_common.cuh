// Building blocks shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu): the bf16 tensor-core
// product, fragment packing, cp.async copies and the padded tile load.
//
// Fragment layouts of mma.sync.m16n8k16 (row.col), g = lane / 4 and
// t = lane % 4: A (16 x 16, row-major) a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];
// B (16 x 8, column-major) b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
// C (16 x 8) c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd_flash {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;  // bf16 of row padding: conflict-free fragment loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_float2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x D tile from global (row stride in elements, head dim
// contiguous) into shared memory with row stride D + kPad, copied by
// the kThreads threads of the block.
template <int D, int kThreads>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          int64_t row_stride, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    cp_async16(s + r * (D + kPad) + c, g + r * row_stride + c);
  }
}

// n contiguous floats (n % 4 == 0, 16-byte aligned) into shared memory.
__device__ __forceinline__ void load_floats(float* s, const float* g, int n) {
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    cp_async16(s + 4 * i, g + 4 * i);
}

}  // namespace hvd_flash
