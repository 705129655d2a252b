// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that horovod_tpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces: the TPU kernel behind horovod_tpu/parallel/ring_attention.py
// `flash_attention_path` (l.163), i.e. the forward of
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention
// (`_flash_attention_kernel`). Its dK/dV and dQ backward kernels are
// in flash_attention_bwd.cu; the building blocks both files use are in
// flash_common.cuh.
//
// Function: o = softmax(scale * q k^T [+ causal mask]) v and
// lse = logsumexp of the scaled, masked scores, per (b, h, query row).
// q, k, v and o are (B, L, H, D) with the head dim contiguous and any
// other strides (the JAX call site's public layout, read in place);
// o is written contiguous; lse is (B, H, L) float32. Causal means query
// i sees keys 0..i (top-left aligned, L == Lk). Any L >= 1: the last
// query and key tiles may be ragged; their missing rows are zero-filled
// in shared memory, key columns at or past L are masked to -inf, and
// rows at or past L are not stored. Those guards are a second
// instantiation (kRagged), launched only when L % 64 != 0, so a whole
// number of tiles runs the unguarded loop: measured on the card, the
// guards cost that loop about 30 %.
//
// What bounds it on an H100: at the serving shapes (L = 2048, D = 128)
// the scores need 4*L*L*D operations per (b, h) against 8*L*D bytes of
// q, k, v and o, about 1000 operations per byte, far above the card's
// ~295 bf16 operations per byte: the tensor cores bound it, not memory.
// What the design does about it: the two products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate); the scores and
// probabilities stay in registers (the accumulator layout of Q K^T is
// reused as the A operand of P V, FlashAttention-2 style), so nothing of
// size L*L touches memory; K and V tiles are staged in padded shared
// memory with cp.async, the V copy overlapping the Q K^T product; the
// causal grid launches the longest query tiles first. It does not yet
// use wgmma, TMA, warp specialisation or a multi-stage pipeline.
//
// bf16 is the served type; f16 runs the same kernel with the f16 form
// of the tensor-core product. The float32 entry point is a plain scalar
// kernel (CUDA cores, exact f32 arithmetic) for tests against the plain
// PyTorch version; no served path runs it.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

using namespace hvd_flash;

namespace {

constexpr int kBlockM = 64;   // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Strides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh;
};

// T: bf16 or f16. kRagged: L is not a multiple of the 64-row tile.
template <typename T, int D, bool kCausal, bool kRagged>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int L, int H, Strides st,
                  float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kS = D + kPad;
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kBlockM * kS;
  T* v_s = k_s + kBlockN * kS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  // Longest causal tiles first: the last query tile has the most keys.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = q_tile * kBlockM;

  const T* qg = q + b * st.qb + static_cast<int64_t>(q0) * st.ql + h * st.qh;
  const T* kg = k + b * st.kb + h * st.kh;
  const T* vg = v + b * st.vb + h * st.vh;

  load_tile<D, kThreads, kRagged>(q_s, qg, st.ql, kBlockM, L - q0);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // Running max (log2 domain) and this thread's partial row sums for
  // rows g and g + 8 of the warp's 16.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_tiles = kCausal ? q_tile + 1 : (L + kBlockN - 1) / kBlockN;
  const int wrow = warp * 16;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kThreads, kRagged>(
        k_s, kg + static_cast<int64_t>(k0) * st.kl, st.kl, kBlockN, L - k0);
    cp_async_commit();
    load_tile<D, kThreads, kRagged>(
        v_s, vg + static_cast<int64_t>(k0) * st.vl, st.vl, kBlockN, L - k0);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V may be in flight
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const T* qa = q_s + (wrow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(qa);
      const uint32_t a1 = ld_pair(qa + 8 * kS);
      const uint32_t a2 = ld_pair(qa + 8);
      const uint32_t a3 = ld_pair(qa + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const T* kb = k_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816<T>(s[n], a0, a1, a2, a3, ld_pair(kb), ld_pair(kb + 8));
      }
    }

    // Scale into the log2 domain, mask above the diagonal and past the
    // ragged end of the keys, row max.
    const bool diag = kCausal && j == q_tile;
    const bool ragged = kRagged && k0 + kBlockN > L;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale_log2;
        if (diag || ragged) {  // uniform across the tile
          const int key = n * 8 + 2 * t + (i & 1);
          const int row = wrow + g + (i >= 2 ? 8 : 0);
          if ((diag && key > row) || (ragged && k0 + key >= L)) x = -INFINITY;
        }
        s[n][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // A row that has seen only masked keys keeps a finite subtrahend.
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = exp2f(m0 - base0);
    const float corr1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - base0);
      s[n][1] = exp2f(s[n][1] - base0);
      s[n][2] = exp2f(s[n][2] - base1);
      s[n][3] = exp2f(s[n][3] - base1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr0;
      acc[dt][1] *= corr0;
      acc[dt][2] *= corr1;
      acc[dt][3] *= corr1;
    }

    cp_async_wait<0>();
    __syncthreads();  // V visible to every warp
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // P's accumulator layout for keys 16kk..16kk+15 is the A operand.
      const uint32_t a0 = pack_float2<T>(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_float2<T>(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_float2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_float2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* vb = v_s + (kk * 16 + 2 * t) * kS + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const T* p = vb + dt * 8;
        const uint32_t b0 = pack_pair(p[0], p[kS]);
        const uint32_t b1 = pack_pair(p[8 * kS], p[9 * kS]);
        mma_16816<T>(acc[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int r0 = q0 + wrow + g;
  const int r1 = r0 + 8;
  T* o0 = o + (static_cast<int64_t>(b) * L + r0) * H * D +
          static_cast<int64_t>(h) * D;
  T* o1 = o + (static_cast<int64_t>(b) * L + r1) * H * D +
          static_cast<int64_t>(h) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (!kRagged || r0 < L)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          pack_float2<T>(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (!kRagged || r1 < L)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          pack_float2<T>(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (t == 0) {
    float* lrow = lse + (static_cast<int64_t>(b) * H + h) * L;
    if (!kRagged || r0 < L)
      lrow[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : -INFINITY;
    if (!kRagged || r1 < L)
      lrow[r1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : -INFINITY;
  }
}

// float32: one thread per query row, keys one at a time, K/V tiles of
// kKeyTile rows in static shared memory (rows past L zero-filled; a
// thread whose row is past L computes on zeros and stores nothing).
constexpr int kKeyTile = 16;

template <int D, bool kCausal>
__global__ void __launch_bounds__(kBlockM)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int L, int H, Strides st,
                  float scale_log2) {
  __shared__ float k_s[kKeyTile][D];
  __shared__ float v_s[kKeyTile][D];
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q_tile * kBlockM + threadIdx.x;
  const bool live = row < L;
  const float* qr = q + b * st.qb + static_cast<int64_t>(row) * st.ql + h * st.qh;
  float qv[D], acc[D];
  for (int d = 0; d < D; ++d) {
    qv[d] = live ? qr[d] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int k_end = min(kCausal ? (q_tile + 1) * kBlockM : L, L);
  for (int k0 = 0; k0 < k_end; k0 += kKeyTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKeyTile * D; i += kBlockM) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < L;
      k_s[r][c] = ok ? k[b * st.kb + static_cast<int64_t>(k0 + r) * st.kl + h * st.kh + c] : 0.f;
      v_s[r][c] = ok ? v[b * st.vb + static_cast<int64_t>(k0 + r) * st.vl + h * st.vh + c] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kKeyTile; ++r) {
      if (k0 + r >= L || (kCausal && k0 + r > row)) break;
      float x = 0.f;
      for (int d = 0; d < D; ++d) x = fmaf(qv[d], k_s[r][d], x);
      const float mn = fmaxf(m, x);
      const float corr = exp2f(m - mn);
      const float p = exp2f(x - mn);
      l = l * corr + p;
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[r][d], acc[d] * corr);
      m = mn;
    }
  }
  if (!live) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* orow = o + (static_cast<int64_t>(b) * L + row) * H * D +
                static_cast<int64_t>(h) * D;
  for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  lse[(static_cast<int64_t>(b) * H + h) * L + row] =
      l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

int q_tiles(int L) { return (L + kBlockM - 1) / kBlockM; }

template <typename T, int D, bool kCausal, bool kRagged>
cudaError_t launch_tiles(const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int L, int H,
                         const Strides& st, float scale_log2,
                         cudaStream_t stream) {
  auto kernel = flash_fwd_mma<T, D, kCausal, kRagged>;
  const int smem = (kBlockM + 2 * kBlockN) * (D + kPad) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q_tiles(L), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, st,
      scale_log2);
  return cudaGetLastError();
}

template <typename T, int D, bool kCausal>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int L, int H, const Strides& st,
                       float scale_log2, cudaStream_t stream) {
  return L % kBlockM == 0
             ? launch_tiles<T, D, kCausal, false>(q, k, v, o, lse, B, L, H,
                                                 st, scale_log2, stream)
             : launch_tiles<T, D, kCausal, true>(q, k, v, o, lse, B, L, H,
                                                st, scale_log2, stream);
}

template <int D, bool kCausal>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int L, int H, const Strides& st,
                       float scale_log2, cudaStream_t stream) {
  const dim3 grid(q_tiles(L), H, B);
  flash_fwd_f32<D, kCausal><<<grid, kBlockM, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, L, H, st,
      scale_log2);
  return cudaGetLastError();
}

typedef cudaError_t (*Launcher)(const void*, const void*, const void*, void*,
                                float*, int, int, int, const Strides&, float,
                                cudaStream_t);

template <int D>
Launcher pick(int dtype, int causal) {
  if (dtype == 1) return causal ? launch_f32<D, true> : launch_f32<D, false>;
  if (dtype == 2)
    return causal ? launch_mma<f16, D, true> : launch_mma<f16, D, false>;
  return causal ? launch_mma<bf16, D, true> : launch_mma<bf16, D, false>;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, 2 = float16. L >= 1. Strides are in
// elements; the head dim must be contiguous. Returns the cudaError_t of
// the launch.
extern "C" int hvd_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int L, int H, int D, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, int causal, float scale,
    void* stream) {
  if (L < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Launcher fn = nullptr;
  switch (D) {
    case 64: fn = pick<64>(dtype, causal); break;
    case 128: fn = pick<128>(dtype, causal); break;
    case 256: fn = pick<256>(dtype, causal); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides st{q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  return static_cast<int>(fn(q, k, v, o, static_cast<float*>(lse), B, L, H,
                             st, scale * kLog2e,
                             static_cast<cudaStream_t>(stream)));
}
