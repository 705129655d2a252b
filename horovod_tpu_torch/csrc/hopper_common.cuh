// Hopper building blocks of the flash-attention forward and of the dK/dV
// and dQ backward kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): mbarriers, TMA tile loads and the host-side
// tensor-map encoder, warpgroup register reallocation and the
// asynchronous warpgroup product (wgmma) with its shared-memory
// descriptors.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a
// tile of R rows and 64 16-bit columns (one "panel", 128 bytes a row)
// lies at a 1024-byte-aligned address, 16-byte chunk c of row r at
// chunk c ^ (r % 8). A row of D > 64 columns is D / 64 panels, each a
// whole R x 64 block. wgmma reads such panels through a descriptor of
// the same swizzle:
// - K-major (the reduction dim contiguous: Q and K for S = Q K^T): rows
//   128 bytes apart, 8-row groups 1024 bytes apart (SBO); the k-th
//   slice of 16 columns starts 32 * (k % 4) bytes into panel k / 4.
// - MN-major (the output dim contiguous: V for O += P V, read with the
//   transpose bit): 64 output columns a row, the next 64 one panel on
//   (LBO = the panel's bytes), 8 key rows 1024 bytes on (SBO); the
//   k-th slice of 16 keys starts 2048 * k bytes into every panel.
// So one TMA layout serves both kinds of descriptor: a tile of Q is
// K-major in S = Q K^T and MN-major in dK += dS^T Q.
//
// Fragment layouts of wgmma m64nNk16 for warp w (0..3) of the
// warpgroup, g = lane / 4, t = lane % 4: accumulator d[4j + i] is
// C[16w + g + 8 (i / 2)][8j + 2t + (i % 2)]; the register A operand
// (16-bit) is a[0] = A[16w + g][2t..2t+1], a[1] = A[16w + g + 8][2t..],
// a[2] = A[16w + g][2t+8..], a[3] = A[16w + g + 8][2t+8..]. So the
// accumulator of S, rounded to 16 bits in pairs, is the A operand of
// P V with no data movement.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hvd_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the barrier's phase of this parity has completed. A wait
// that lasts kHangNs traps, so a pipeline fault fails the launch
// instead of holding the card.
constexpr uint64_t kHangNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 1; !mbar_try_wait(bar, parity); ++n) {
    if ((n & 0xffff) == 0) {
      const uint64_t now = globaltimer_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > kHangNs) {
        __trap();
      }
    }
  }
}

// True on one lane of a converged warp, the same lane on every call.
__device__ __forceinline__ bool elect_one() {
  uint32_t pred = 0;
  asm volatile(
      "{\n.reg .b32 rx;\n.reg .pred px;\n"
      "elect.sync rx|px, %1;\n"
      "@px mov.s32 %0, 1;\n}\n"
      : "+r"(pred)
      : "r"(0xffffffffu));
  return pred != 0;
}

// Named barrier over `threads` threads (ids 1..15; 0 is __syncthreads):
// sync waits until `threads` threads have reached it, arrive counts
// this thread and goes on.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- TMA ----------------------------------------------------------------

constexpr int kPanelCols = 64;  // 16-bit columns of one swizzled panel
constexpr int kRowBytes = 128;  // bytes of one panel row

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box of a rank-4 tensor map into shared memory at `dst`, completing
// on barrier `bar`. Coordinates innermost first; rows past the tensor's
// end are zero-filled.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point so the libraries do not link libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Returned for a failed encode: kTensorMapError + the CUresult (or + 0
// when the driver has no cuTensorMapEncodeTiled).
constexpr int kTensorMapError = 100000;

// A rank-4 map over (D, H, L, B) of a 16-bit tensor with strides in
// elements, read in boxes of 64 columns x `rows` rows, 128-byte swizzle.
inline int encode(CUtensorMap* map, const void* ptr, bool f16, int B, int L,
                  int H, int D, int64_t sb, int64_t sl, int64_t sh,
                  int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kPanelCols, 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// --- warpgroup registers -----------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle; offsets in
// bytes (multiples of 16).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The operand lists of wgmma.mma_async m64nNk16 with f32 accumulators,
// for a 16-bit input type TY ("bf16" or "f16"). SS: A and B from shared
// memory, both K-major. RS: A from registers, B from shared memory,
// MN-major (transposed). scale_d == 0 overwrites d, 1 accumulates.

#define HVD_WGMMA_SS_N32(TY)                                                \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY               \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15}, "                                                              \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15])                                                         \
      : "l"(a), "l"(b), "r"(scale_d))

#define HVD_WGMMA_SS_N64(TY)                                                \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY               \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, "                                               \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(a), "l"(b), "r"(scale_d))

#define HVD_WGMMA_SS_N128(TY)                                               \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY              \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                 \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "l"(a), "l"(b), "r"(scale_d))

#define HVD_WGMMA_SS_N96(TY)                                                \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY               \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47}, "                                \
      "%48, %49, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                               \
      : "l"(a), "l"(b), "r"(scale_d))

#define HVD_WGMMA_RS_N64(TY)                                                \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY               \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, "                                               \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                 \
        "r"(scale_d))

#define HVD_WGMMA_RS_N128(TY)                                               \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY              \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                 \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                 \
        "r"(scale_d))

#define HVD_WGMMA_RS_N256(TY)                                               \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY              \
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "   \
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "   \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "   \
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "   \
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "  \
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "  \
      "%127}, "                                                             \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),    \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),    \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),    \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),    \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),    \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),    \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),    \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),    \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),             \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),             \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),             \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),             \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),             \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),             \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                 \
        "r"(scale_d))

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// d (m64 x N, f32) (+)= A (m64 x k16, shared, K-major) B (k16 x N,
// shared, K-major).
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128,
                "wgmma_ss: N is 32, 64, 96 or 128");
  if constexpr (N == 32) {
    if constexpr (kIsBf16<T>) HVD_WGMMA_SS_N32("bf16");
    else HVD_WGMMA_SS_N32("f16");
  } else if constexpr (N == 64) {
    if constexpr (kIsBf16<T>) HVD_WGMMA_SS_N64("bf16");
    else HVD_WGMMA_SS_N64("f16");
  } else if constexpr (N == 96) {
    if constexpr (kIsBf16<T>) HVD_WGMMA_SS_N96("bf16");
    else HVD_WGMMA_SS_N96("f16");
  } else {
    if constexpr (kIsBf16<T>) HVD_WGMMA_SS_N128("bf16");
    else HVD_WGMMA_SS_N128("f16");
  }
}

// d (m64 x N, f32) (+)= A (m64 x k16, registers) B (k16 x N, shared,
// MN-major).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256,
                "wgmma_rs: N is 64, 128 or 256");
  if constexpr (N == 64) {
    if constexpr (kIsBf16<T>) HVD_WGMMA_RS_N64("bf16");
    else HVD_WGMMA_RS_N64("f16");
  } else if constexpr (N == 128) {
    if constexpr (kIsBf16<T>) HVD_WGMMA_RS_N128("bf16");
    else HVD_WGMMA_RS_N128("f16");
  } else {
    if constexpr (kIsBf16<T>) HVD_WGMMA_RS_N256("bf16");
    else HVD_WGMMA_RS_N256("f16");
  }
}

// d (m64 x N) = A B^T over a reduction of K columns, A (64 rows) and B
// (N rows) both K-major in swizzled panels of kAPanel and kBPanel bytes
// (S = Q K^T in the forward and in dQ; S^T = K Q^T and dP^T = V dO^T in
// dK/dV; dP = dO V^T in dQ):
// issued and committed, not waited for.
template <typename T, int K, int N, int kAPanel, int kBPanel>
__device__ __forceinline__ void issue_kmajor(float (&d)[N / 2], uint32_t a,
                                             uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < K / 16; ++kd) {
    const uint32_t off = (kd % 4) * 32;
    wgmma_ss<T, N>(d, smem_desc(a + (kd / 4) * kAPanel + off, 16, 1024),
                   smem_desc(b + (kd / 4) * kBPanel + off, 16, 1024),
                   kd > 0);
  }
  wgmma_commit();
}

// d (m64 x N) += A B over a reduction of K rows, A in registers (the
// 16-bit A fragments of K / 16 slices) and B MN-major in swizzled panels
// of kBPanel bytes (O += P V in the forward; dV += P^T dO and dK +=
// dS^T Q in dK/dV; dQ += dS K in dQ): issued and committed, not waited
// for.
template <typename T, int K, int N, int kBPanel>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<T, N>(d, a[kk],
                   smem_desc(b + kk * 16 * kRowBytes, kBPanel, 1024), 1);
  wgmma_commit();
}

}  // namespace hvd_hopper
