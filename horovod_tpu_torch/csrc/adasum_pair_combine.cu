// Adasum pair combine for Hopper (sm_90a): K1 (the three partial sums and
// the blend coefficients) and K2 (the scaled add), each with a plain C
// interface that horovod_tpu_torch/ops/adasum_kernels.py loads through
// ctypes.
//
// Replaces: horovod_tpu/ops/pallas_kernels.py `_partials_kernel` (l.50,
// pallas_call l.94) and `_scaled_add_kernel` (l.70, pallas_call l.111),
// the two passes of `adasum_pair_combine` (l.79), which the JAX package
// runs inside the gather fold's `_pair_combine` (ops/adasum.py:110).
//
// Function, for two equal-length vectors a and b of f32, bf16 or f16:
//   K1: dot = a.b, asq = |a|^2, bsq = |b|^2, accumulated in f32; then
//       ca = asq == 0 ? 1 : 1 - dot / (2 max(asq, 1e-30)), cb likewise
//       with bsq (the JAX kernel's zero-norm guards, l.105-108).
//       stats = [ca, cb, dot, asq, bsq], five f32 in device memory.
//   K2: out = cast(ca * float(a) + cb * float(b)), one rounding to the
//       input dtype; ca and cb are read from `stats` on the device, so
//       there is no host sync between the two kernels. out may be a.
//
// What bounds it on an H100: bytes. K1 reads 2n elements and does 6
// operations per element pair; K2 reads 2n and writes n with 3
// operations: about 1 operation per byte against the card's ~20 f32
// operations per byte, so memory bandwidth (3.35 TB/s) is the limit.
// What the design does about it: each thread moves 16 bytes per load
// (8 bf16/f16 or 4 f32) over a grid-stride loop, so every byte is read
// once; K1 keeps its three sums in registers, reduces them by warp
// shuffle and then across the block's warps in shared memory, and writes
// one f32 triple per block; a second, single-block stage sums the triples
// and computes the coefficients. The TPU kernel's padding to a (rows, 128)
// grid of 256-row blocks exists for the TPU's tiling and has no
// counterpart here: any n is taken, with a scalar tail and no copy.
//
// Determinism: no float atomics, the grid of K1 depends only on n and the
// dtype, and the second stage sums the block triples in a fixed order, so
// every rank and every repeat gets bitwise the same coefficients for the
// same inputs (the gather fold relies on it: every rank folds the same rows
// and must end with the same parameters). K2 rounds ca*a and cb*b each to
// f32 before the add (no fused multiply-add), as the plain PyTorch version
// does, so with the same coefficients the two agree bitwise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPartialBlocks = 1024;
constexpr int kVectorsPerThread = 4;  // per block-sized slice of the grid
constexpr int kMaxAddBlocks = 8192;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / sizeof(T);


__device__ __forceinline__ void warp_sum3(float& x, float& y, float& z) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffff, x, off);
    y += __shfl_xor_sync(0xffffffff, y, off);
    z += __shfl_xor_sync(0xffffffff, z, off);
  }
}

// Sum (x, y, z) over the block in a fixed order; thread 0 gets the total.
__device__ __forceinline__ void block_sum3(float& x, float& y, float& z) {
  __shared__ float part[kWarps][3];
  warp_sum3(x, y, z);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[warp][0] = x;
    part[warp][1] = y;
    part[warp][2] = z;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    x = y = z = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      x += part[w][0];
      y += part[w][1];
      z += part[w][2];
    }
  }
}

// K1, first stage: each block's (a.b, |a|^2, |b|^2) into scratch[3 * block].
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    adasum_partials_kernel(const T* __restrict__ a, const T* __restrict__ b,
                           float* __restrict__ scratch, int64_t n) {
  float dot = 0.f, asq = 0.f, bsq = 0.f;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t done = 0;
  if (kVectorized) {
    const int64_t nvec = n / kVec<T>;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    for (int64_t i = tid; i < nvec; i += stride) {
      const uint4 xr = av[i];
      const uint4 yr = bv[i];
      const T* x = reinterpret_cast<const T*>(&xr);
      const T* y = reinterpret_cast<const T*>(&yr);
#pragma unroll
      for (int j = 0; j < kVec<T>; ++j) {
        const float p = to_float(x[j]);
        const float q = to_float(y[j]);
        dot = fmaf(p, q, dot);
        asq = fmaf(p, p, asq);
        bsq = fmaf(q, q, bsq);
      }
    }
    done = nvec * kVec<T>;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const float p = to_float(a[i]);
    const float q = to_float(b[i]);
    dot = fmaf(p, q, dot);
    asq = fmaf(p, p, asq);
    bsq = fmaf(q, q, bsq);
  }
  block_sum3(dot, asq, bsq);
  if (threadIdx.x == 0) {
    scratch[3 * blockIdx.x + 0] = dot;
    scratch[3 * blockIdx.x + 1] = asq;
    scratch[3 * blockIdx.x + 2] = bsq;
  }
}

__device__ __forceinline__ float coeff(float dot, float sq) {
  if (sq == 0.f) return 1.f;
  return __fsub_rn(1.f, __fdiv_rn(dot, __fmul_rn(2.f, fmaxf(sq, 1e-30f))));
}

// K1, second stage: one block sums the block triples in a fixed order and
// writes stats = [ca, cb, dot, asq, bsq].
__global__ void __launch_bounds__(kThreads)
    adasum_coeffs_kernel(const float* __restrict__ scratch, int blocks,
                         float* __restrict__ stats) {
  float dot = 0.f, asq = 0.f, bsq = 0.f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    dot += scratch[3 * i + 0];
    asq += scratch[3 * i + 1];
    bsq += scratch[3 * i + 2];
  }
  block_sum3(dot, asq, bsq);
  if (threadIdx.x == 0) {
    stats[0] = coeff(dot, asq);
    stats[1] = coeff(dot, bsq);
    stats[2] = dot;
    stats[3] = asq;
    stats[4] = bsq;
  }
}

// K2: out = cast(ca * a + cb * b). a and out may alias.
template <typename T, bool kVectorized>
__global__ void __launch_bounds__(kThreads)
    adasum_scaled_add_kernel(const T* a, const T* __restrict__ b,
                             const float* __restrict__ stats, T* out,
                             int64_t n) {
  const float ca = stats[0];
  const float cb = stats[1];
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t done = 0;
  if (kVectorized) {
    const int64_t nvec = n / kVec<T>;
    const uint4* av = reinterpret_cast<const uint4*>(a);
    const uint4* bv = reinterpret_cast<const uint4*>(b);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int64_t i = tid; i < nvec; i += stride) {
      const uint4 xr = av[i];
      const uint4 yr = bv[i];
      const T* x = reinterpret_cast<const T*>(&xr);
      const T* y = reinterpret_cast<const T*>(&yr);
      uint4 zr;
      T* z = reinterpret_cast<T*>(&zr);
#pragma unroll
      for (int j = 0; j < kVec<T>; ++j)
        z[j] = from_float<T>(__fadd_rn(__fmul_rn(ca, to_float(x[j])),
                                       __fmul_rn(cb, to_float(y[j]))));
      ov[i] = zr;
    }
    done = nvec * kVec<T>;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = from_float<T>(__fadd_rn(__fmul_rn(ca, to_float(a[i])),
                                     __fmul_rn(cb, to_float(b[i]))));
}

int64_t ceil_div(int64_t x, int64_t y) { return (x + y - 1) / y; }

int element_size(int dtype) { return dtype == 1 ? 4 : 2; }

// The first stage's grid: a function of n and the dtype only.
int partial_blocks(int64_t n, int dtype) {
  const int64_t per_block =
      static_cast<int64_t>(kThreads) * (16 / element_size(dtype)) *
      kVectorsPerThread;
  const int64_t blocks = ceil_div(n, per_block);
  return static_cast<int>(blocks < 1 ? 1
                          : blocks > kMaxPartialBlocks ? kMaxPartialBlocks
                                                       : blocks);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t partials(const void* a, const void* b, float* scratch,
                     float* stats, int64_t n, int blocks,
                     cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (aligned16(a) && aligned16(b))
    adasum_partials_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        ta, tb, scratch, n);
  else
    adasum_partials_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        ta, tb, scratch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adasum_coeffs_kernel<<<1, kThreads, 0, stream>>>(scratch, blocks, stats);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scaled_add(const void* a, const void* b, const float* stats,
                       void* out, int64_t n, cudaStream_t stream) {
  int64_t blocks = ceil_div(ceil_div(n, kVec<T>), kThreads);
  blocks = blocks < 1 ? 1 : blocks > kMaxAddBlocks ? kMaxAddBlocks : blocks;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(out);
  if (aligned16(a) && aligned16(b) && aligned16(out))
    adasum_scaled_add_kernel<T, true>
        <<<static_cast<int>(blocks), kThreads, 0, stream>>>(ta, tb, stats, to,
                                                            n);
  else
    adasum_scaled_add_kernel<T, false>
        <<<static_cast<int>(blocks), kThreads, 0, stream>>>(ta, tb, stats, to,
                                                            n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, 2 = float16. Vectors are contiguous.

// The number of blocks of K1's first stage, so that the caller can size
// `scratch` (3 floats per block).
extern "C" int hvd_adasum_partials_blocks(long long n, int dtype) {
  return partial_blocks(n, dtype);
}

// K1: stats (5 floats) = [ca, cb, a.b, |a|^2, |b|^2]; scratch holds
// 3 * hvd_adasum_partials_blocks(n, dtype) floats. Returns the
// cudaError_t of the launches.
extern "C" int hvd_adasum_partials(const void* a, const void* b,
                                   void* scratch, void* stats, int dtype,
                                   long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = partial_blocks(n, dtype);
  float* s = static_cast<float*>(scratch);
  float* st = static_cast<float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(
        partials<__nv_bfloat16>(a, b, s, st, n, blocks, cs));
    case 1: return static_cast<int>(partials<float>(a, b, s, st, n, blocks, cs));
    case 2: return static_cast<int>(partials<__half>(a, b, s, st, n, blocks, cs));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2: out = cast(stats[0] * a + stats[1] * b); out may be a.
extern "C" int hvd_adasum_scaled_add(const void* a, const void* b,
                                     const void* stats, void* out, int dtype,
                                     long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* st = static_cast<const float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(
        scaled_add<__nv_bfloat16>(a, b, st, out, n, cs));
    case 1: return static_cast<int>(scaled_add<float>(a, b, st, out, n, cs));
    case 2: return static_cast<int>(scaled_add<__half>(a, b, st, out, n, cs));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
