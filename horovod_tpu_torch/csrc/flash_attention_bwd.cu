// Flash-attention backward for Hopper (sm_90a): a dK/dV kernel and a dQ
// kernel, each with a plain C interface that
// horovod_tpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces: the backward kernels of
// jax.experimental.pallas.ops.tpu.flash_attention, which the JAX
// package reaches through horovod_tpu/parallel/ring_attention.py
// `flash_attention_path` (l.163): `_flash_attention_dkv_kernel`
// (pallas_call in `_flash_attention_bwd_dkv`) and
// `_flash_attention_dq_kernel` (pallas_call in `_flash_attention_bwd_dq`).
//
// Function: with P = exp(scale * q k^T - lse) [causal mask: query i sees
// keys 0..i], dP = dO v^T and dS = P * (dP - di), where di = rowsum(o * dO)
// comes in precomputed (as in the TPU library, which computes it outside
// its kernels):
//   dK/dV kernel: dV = P^T dO and dK = scale * dS^T q;
//   dQ kernel:    dQ = scale * dS k.
// q, k, v and dO are (B, L, H, D) with the head dim contiguous and any
// other strides; lse and di are (B, H, L) float32, contiguous; dq, dk and
// dv are written contiguous in the inputs' dtype. Any L >= 1: the last
// query and key tiles may be ragged; their missing rows are zero-filled
// in shared memory, P is zero for queries or keys at or past L, and rows
// at or past L are not stored. Those guards are a second instantiation
// (kRagged), launched only when L % 64 != 0, so a whole number of tiles
// runs the unguarded loops.
//
// What bounds it on an H100: at the training shape (L = 2048, D = 128)
// dK/dV does four products (8*D operations per visible (query, key)
// pair) and dQ three (6*D), against 4 to 5 reads or writes of L*D per
// (b, h): about 1000 operations per byte, far above the card's ~295 bf16
// operations per byte, so the tensor cores bound both, not memory.
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); P and dS live only in
// registers. The dK/dV kernel computes the transposed scores S^T = K Q^T
// directly, so the accumulator layout of P^T and dS^T is, repacked to
// bf16, the A operand of P^T dO and dS^T Q (no transposition through
// shared memory); the dQ kernel reuses the forward's layout the same way
// for dS K. The "B" operands that run along the query or key axis (dO and
// Q in dK/dV, K in dQ) are read as 16-bit pairs from padded shared memory.
// Each CTA owns its output tile and writes it once: no atomics, so the
// gradients are bitwise the same from run to run. Causal CTAs skip the
// tiles above the diagonal. It does not yet use wgmma, TMA, ldmatrix or a
// multi-stage pipeline.
//
// Registers: a dK/dV warp holds two 16 x D f32 accumulators plus the
// 16 x 64 P^T and dP^T tiles. At D = 256 that is past 255 registers, so
// there the head dim is split across two groups of four warps, each
// group accumulating half of dK and dV (the two scores products are then
// computed by both groups).
//
// bf16 is the trained type; f16 runs the same kernels with the f16 form
// of the tensor-core product. The float32 entry points are plain scalar
// kernels (CUDA cores, f32 arithmetic) for tests against the plain
// PyTorch version; no training path runs them.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

using namespace hvd_flash;

namespace {

constexpr int kBlockM = 64;  // queries per tile
constexpr int kBlockN = 64;  // keys per tile
static_assert(kBlockM == kBlockN, "the causal diagonal is one tile");

struct Strides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh;  // d*: dO
};

// Head-dim groups of the dK/dV kernel (see the header).
template <int D>
constexpr int kDkvSplit = D == 256 ? 2 : 1;

// ---------------------------------------------------------------------------
// dK/dV, bf16 or f16 (T): one CTA per (key tile, h, b); each group of four
// warps holds the tile's 64 keys, 16 per warp, and walks the query tiles.

template <typename T, int D, bool kCausal, bool kRagged>
__global__ void __launch_bounds__(128 * kDkvSplit<D>)
    flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, T* __restrict__ dk,
                      T* __restrict__ dv, int L, int H, Strides st,
                      float scale, float scale_log2) {
  constexpr int kThreads = 128 * kDkvSplit<D>;
  constexpr int kDw = D / kDkvSplit<D>;  // head-dim columns per warp
  constexpr int kS = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kBlockN * kS;
  T* q_s = v_s + kBlockN * kS;
  T* do_s = q_s + kBlockM * kS;
  float* lse_s = reinterpret_cast<float*>(do_s + kBlockM * kS);
  float* di_s = lse_s + kBlockM;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow = (warp % 4) * 16;  // the warp's keys in the tile
  const int d0 = (warp / 4) * kDw;   // the warp's head-dim columns
  // Causal: key tile 0 sees every query tile, so low tiles go first.
  const int k_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = k_tile * kBlockN;

  load_tile<D, kThreads, kRagged>(
      k_s, k + b * st.kb + k0 * st.kl + h * st.kh, st.kl, kBlockN, L - k0);
  load_tile<D, kThreads, kRagged>(
      v_s, v + b * st.vb + k0 * st.vl + h * st.vh, st.vl, kBlockN, L - k0);
  cp_async_commit();

  const T* qg = q + b * st.qb + h * st.qh;
  const T* dg = dout + b * st.db + h * st.dh;
  const float* lse_bh = lse + (static_cast<int64_t>(b) * H + h) * L;
  const float* di_bh = di + (static_cast<int64_t>(b) * H + h) * L;

  float dk_acc[kDw / 8][4];
  float dv_acc[kDw / 8][4];
#pragma unroll
  for (int i = 0; i < kDw / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  const int n_q_tiles = (L + kBlockM - 1) / kBlockM;
  for (int i = kCausal ? k_tile : 0; i < n_q_tiles; ++i) {
    const int q0 = i * kBlockM;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D, kThreads, kRagged>(
        q_s, qg + static_cast<int64_t>(q0) * st.ql, st.ql, kBlockM, L - q0);
    // A query past L gets lse = +inf, so its P is exactly zero.
    load_floats<kRagged>(lse_s, lse_bh + q0, kBlockM, L - q0, INFINITY);
    cp_async_commit();
    load_tile<D, kThreads, kRagged>(
        do_s, dg + static_cast<int64_t>(q0) * st.dl, st.dl, kBlockM, L - q0);
    load_floats<kRagged>(di_s, di_bh + q0, kBlockM, L - q0, 0.f);
    cp_async_commit();
    cp_async_wait<1>();  // K, V, Q and lse have landed; dO may be in flight
    __syncthreads();

    // S^T = K Q^T: the warp's 16 keys x 64 queries.
    float p[kBlockM / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockM / 8; ++n)
      p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const T* ka = k_s + (krow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(ka);
      const uint32_t a1 = ld_pair(ka + 8 * kS);
      const uint32_t a2 = ld_pair(ka + 8);
      const uint32_t a3 = ld_pair(ka + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
        const T* qb = q_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816<T>(p[n], a0, a1, a2, a3, ld_pair(qb), ld_pair(qb + 8));
      }
    }
    // P^T = exp(scale S^T - lse[query]), zero above the diagonal and for
    // queries past L.
    const bool diag = kCausal && i == k_tile;
#pragma unroll
    for (int n = 0; n < kBlockM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);    // query in the tile
        const int row = krow + g + (e >= 2 ? 8 : 0);  // key in the tile
        const float x = exp2f(fmaf(p[n][e], scale_log2,
                                   -lse_s[col] * kLog2e));
        p[n][e] = ((diag && row > col) || (kRagged && q0 + col >= L))
                      ? 0.f : x;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // dO and di visible to every warp

    // dV += P^T dO.
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      const uint32_t a0 = pack_float2<T>(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_float2<T>(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_float2<T>(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_float2<T>(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const T* ob = do_s + (kk * 16 + 2 * t) * kS + d0 + g;
#pragma unroll
      for (int dt = 0; dt < kDw / 8; ++dt) {
        const T* x = ob + dt * 8;
        mma_16816<T>(dv_acc[dt], a0, a1, a2, a3, pack_pair(x[0], x[kS]),
                     pack_pair(x[8 * kS], x[9 * kS]));
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - di[query]) in place.
    float ds[kBlockM / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockM / 8; ++n)
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const T* va = v_s + (krow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(va);
      const uint32_t a1 = ld_pair(va + 8 * kS);
      const uint32_t a2 = ld_pair(va + 8);
      const uint32_t a3 = ld_pair(va + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
        const T* ob = do_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816<T>(ds[n], a0, a1, a2, a3, ld_pair(ob), ld_pair(ob + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = p[n][e] * (ds[n][e] - di_s[n * 8 + 2 * t + (e & 1)]);
    }

    // dK += dS^T Q (scaled once at the end).
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      const uint32_t a0 = pack_float2<T>(ds[2 * kk][0], ds[2 * kk][1]);
      const uint32_t a1 = pack_float2<T>(ds[2 * kk][2], ds[2 * kk][3]);
      const uint32_t a2 = pack_float2<T>(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      const uint32_t a3 = pack_float2<T>(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
      const T* qb = q_s + (kk * 16 + 2 * t) * kS + d0 + g;
#pragma unroll
      for (int dt = 0; dt < kDw / 8; ++dt) {
        const T* x = qb + dt * 8;
        mma_16816<T>(dk_acc[dt], a0, a1, a2, a3, pack_pair(x[0], x[kS]),
                     pack_pair(x[8 * kS], x[9 * kS]));
      }
    }
  }

  const int r0 = k0 + krow + g;
  const int r1 = r0 + 8;
  const int64_t o0 = (static_cast<int64_t>(b) * L + r0) * H * D +
                     static_cast<int64_t>(h) * D;
  const int64_t o1 = (static_cast<int64_t>(b) * L + r1) * H * D +
                     static_cast<int64_t>(h) * D;
#pragma unroll
  for (int dt = 0; dt < kDw / 8; ++dt) {
    const int c = d0 + dt * 8 + 2 * t;
    if (!kRagged || r0 < L) {
      *reinterpret_cast<uint32_t*>(dk + o0 + c) =
          pack_float2<T>(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o0 + c) =
          pack_float2<T>(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (!kRagged || r1 < L) {
      *reinterpret_cast<uint32_t*>(dk + o1 + c) =
          pack_float2<T>(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o1 + c) =
          pack_float2<T>(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ, bf16 or f16 (T): one CTA per (query tile, h, b), 16 queries per warp,
// walking the key tiles up to the diagonal.

constexpr int kDqThreads = 128;

template <typename T, int D, bool kCausal, bool kRagged>
__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dq, int L,
                     int H, Strides st, float scale, float scale_log2) {
  constexpr int kS = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kBlockM * kS;
  T* k_s = do_s + kBlockM * kS;
  T* v_s = k_s + kBlockN * kS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // Longest causal tiles first: the last query tile has the most keys.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = q_tile * kBlockM;
  const int wrow = warp * 16;

  load_tile<D, kDqThreads, kRagged>(
      q_s, q + b * st.qb + q0 * st.ql + h * st.qh, st.ql, kBlockM, L - q0);
  load_tile<D, kDqThreads, kRagged>(
      do_s, dout + b * st.db + q0 * st.dl + h * st.dh, st.dl, kBlockM,
      L - q0);
  cp_async_commit();

  const int r0 = q0 + wrow + g;
  const int r1 = r0 + 8;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * L;
  // Rows past L compute on zeros and are not stored.
  const bool in0 = !kRagged || r0 < L;
  const bool in1 = !kRagged || r1 < L;
  const float lse0 = in0 ? lse[bh + r0] * kLog2e : 0.f;
  const float lse1 = in1 ? lse[bh + r1] * kLog2e : 0.f;
  const float di0 = in0 ? di[bh + r0] : 0.f;
  const float di1 = in1 ? di[bh + r1] : 0.f;
  const T* kg = k + b * st.kb + h * st.kh;
  const T* vg = v + b * st.vb + h * st.vh;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_tiles = kCausal ? q_tile + 1 : (L + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kDqThreads, kRagged>(
        k_s, kg + static_cast<int64_t>(k0) * st.kl, st.kl, kBlockN, L - k0);
    cp_async_commit();
    load_tile<D, kDqThreads, kRagged>(
        v_s, vg + static_cast<int64_t>(k0) * st.vl, st.vl, kBlockN, L - k0);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and K have landed; V may be in flight
    __syncthreads();

    // S = Q K^T: the warp's 16 queries x 64 keys, then P.
    float p[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
      p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
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
        mma_16816<T>(p[n], a0, a1, a2, a3, ld_pair(kb), ld_pair(kb + 8));
      }
    }
    const bool diag = kCausal && j == q_tile;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * t + (e & 1);
        const int row = wrow + g + (e >= 2 ? 8 : 0);
        const float x =
            exp2f(fmaf(p[n][e], scale_log2, e >= 2 ? -lse1 : -lse0));
        p[n][e] = ((diag && key > row) || (kRagged && k0 + key >= L))
                      ? 0.f : x;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // V visible to every warp

    // dP = dO V^T, then dS = P (dP - di[row]) in place.
    float ds[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const T* oa = do_s + (wrow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(oa);
      const uint32_t a1 = ld_pair(oa + 8 * kS);
      const uint32_t a2 = ld_pair(oa + 8);
      const uint32_t a3 = ld_pair(oa + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const T* vb = v_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816<T>(ds[n], a0, a1, a2, a3, ld_pair(vb), ld_pair(vb + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
      ds[n][0] = p[n][0] * (ds[n][0] - di0);
      ds[n][1] = p[n][1] * (ds[n][1] - di0);
      ds[n][2] = p[n][2] * (ds[n][2] - di1);
      ds[n][3] = p[n][3] * (ds[n][3] - di1);
    }

    // dQ += dS K (scaled once at the end).
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a0 = pack_float2<T>(ds[2 * kk][0], ds[2 * kk][1]);
      const uint32_t a1 = pack_float2<T>(ds[2 * kk][2], ds[2 * kk][3]);
      const uint32_t a2 = pack_float2<T>(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      const uint32_t a3 = pack_float2<T>(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
      const T* kb = k_s + (kk * 16 + 2 * t) * kS + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const T* x = kb + dt * 8;
        mma_16816<T>(acc[dt], a0, a1, a2, a3, pack_pair(x[0], x[kS]),
                     pack_pair(x[8 * kS], x[9 * kS]));
      }
    }
  }

  T* o0 = dq + (static_cast<int64_t>(b) * L + r0) * H * D +
          static_cast<int64_t>(h) * D;
  T* o1 = dq + (static_cast<int64_t>(b) * L + r1) * H * D +
          static_cast<int64_t>(h) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (in0)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          pack_float2<T>(acc[dt][0] * scale, acc[dt][1] * scale);
    if (in1)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          pack_float2<T>(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32: one thread per key row (dK/dV) or query row (dQ), the other
// side streamed through static shared memory kRowTile rows at a time
// (rows past L zero-filled; a thread whose row is past L computes on
// zeros and stores nothing).

constexpr int kRowTile = 16;
constexpr int kF32Threads = 64;  // rows per CTA, = kBlockM

template <int D, bool kCausal>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dk,
                      float* __restrict__ dv, int L, int H, Strides st,
                      float scale) {
  __shared__ float q_s[kRowTile][D];
  __shared__ float do_s[kRowTile][D];
  __shared__ float lse_s[kRowTile];
  __shared__ float di_s[kRowTile];
  const int k_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key = k_tile * kF32Threads + threadIdx.x;
  const bool live = key < L;
  const float* kr = k + b * st.kb + static_cast<int64_t>(key) * st.kl + h * st.kh;
  const float* vr = v + b * st.vb + static_cast<int64_t>(key) * st.vl + h * st.vh;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * L;
  float kv[D], vv[D], dkv[D], dvv[D];
  for (int d = 0; d < D; ++d) {
    kv[d] = live ? kr[d] : 0.f;
    vv[d] = live ? vr[d] : 0.f;
    dkv[d] = dvv[d] = 0.f;
  }
  for (int q0 = kCausal ? k_tile * kF32Threads : 0; q0 < L; q0 += kRowTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRowTile * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool ok = q0 + r < L;
      q_s[r][c] = ok ? q[b * st.qb + static_cast<int64_t>(q0 + r) * st.ql + h * st.qh + c] : 0.f;
      do_s[r][c] = ok ? dout[b * st.db + static_cast<int64_t>(q0 + r) * st.dl + h * st.dh + c] : 0.f;
    }
    if (threadIdx.x < kRowTile) {
      const bool ok = q0 + threadIdx.x < L;
      lse_s[threadIdx.x] = ok ? lse[bh + q0 + threadIdx.x] : 0.f;
      di_s[threadIdx.x] = ok ? di[bh + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kRowTile; ++r) {
      if (q0 + r >= L) break;
      if (kCausal && q0 + r < key) continue;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[r][d], kv[d], s);
        dp = fmaf(do_s[r][d], vv[d], dp);
      }
      const float p = expf(s * scale - lse_s[r]);
      const float ds = p * (dp - di_s[r]);
      for (int d = 0; d < D; ++d) {
        dvv[d] = fmaf(p, do_s[r][d], dvv[d]);
        dkv[d] = fmaf(ds, q_s[r][d], dkv[d]);
      }
    }
  }
  if (!live) return;
  float* dkr = dk + (static_cast<int64_t>(b) * L + key) * H * D +
               static_cast<int64_t>(h) * D;
  float* dvr = dv + (static_cast<int64_t>(b) * L + key) * H * D +
               static_cast<int64_t>(h) * D;
  for (int d = 0; d < D; ++d) {
    dkr[d] = dkv[d] * scale;
    dvr[d] = dvv[d];
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dq,
                     int L, int H, Strides st, float scale) {
  __shared__ float k_s[kRowTile][D];
  __shared__ float v_s[kRowTile][D];
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q_tile * kF32Threads + threadIdx.x;
  const bool live = row < L;
  const float* qr = q + b * st.qb + static_cast<int64_t>(row) * st.ql + h * st.qh;
  const float* dr = dout + b * st.db + static_cast<int64_t>(row) * st.dl + h * st.dh;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * L;
  const float lse_r = live ? lse[bh + row] : 0.f;
  const float di_r = live ? di[bh + row] : 0.f;
  float qv[D], dov[D], acc[D];
  for (int d = 0; d < D; ++d) {
    qv[d] = live ? qr[d] : 0.f;
    dov[d] = live ? dr[d] : 0.f;
    acc[d] = 0.f;
  }
  const int k_end = min(kCausal ? (q_tile + 1) * kF32Threads : L, L);
  for (int k0 = 0; k0 < k_end; k0 += kRowTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRowTile * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < L;
      k_s[r][c] = ok ? k[b * st.kb + static_cast<int64_t>(k0 + r) * st.kl + h * st.kh + c] : 0.f;
      v_s[r][c] = ok ? v[b * st.vb + static_cast<int64_t>(k0 + r) * st.vl + h * st.vh + c] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < kRowTile; ++r) {
      if (k0 + r >= L || (kCausal && k0 + r > row)) break;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qv[d], k_s[r][d], s);
        dp = fmaf(dov[d], v_s[r][d], dp);
      }
      const float ds = expf(s * scale - lse_r) * (dp - di_r);
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, k_s[r][d], acc[d]);
    }
  }
  if (!live) return;
  float* out = dq + (static_cast<int64_t>(b) * L + row) * H * D +
               static_cast<int64_t>(h) * D;
  for (int d = 0; d < D; ++d) out[d] = acc[d] * scale;
}

// ---------------------------------------------------------------------------
// Launchers.

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  int B, L, H;
  Strides st;
  float scale;
  cudaStream_t stream;
};

int tiles(int L) { return (L + kBlockM - 1) / kBlockM; }

template <typename T, int D, bool kCausal, bool kRagged>
cudaError_t dkv_mma(const Args& a) {
  auto kernel = flash_bwd_dkv_mma<T, D, kCausal, kRagged>;
  constexpr int kThreads = 128 * kDkvSplit<D>;
  const int smem = (2 * kBlockN + 2 * kBlockM) * (D + kPad) * sizeof(T) +
                   2 * kBlockM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(a.L), a.H, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.L, a.H, a.st, a.scale,
      a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int D, bool kCausal, bool kRagged>
cudaError_t dq_mma(const Args& a) {
  auto kernel = flash_bwd_dq_mma<T, D, kCausal, kRagged>;
  const int smem = (2 * kBlockM + 2 * kBlockN) * (D + kPad) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles(a.L), a.H, a.B), kDqThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dq), a.L, a.H, a.st, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t dkv_f32(const Args& a) {
  flash_bwd_dkv_f32<D, kCausal>
      <<<dim3(tiles(a.L), a.H, a.B), kF32Threads, 0, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
          a.L, a.H, a.st, a.scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t dq_f32(const Args& a) {
  flash_bwd_dq_f32<D, kCausal>
      <<<dim3(tiles(a.L), a.H, a.B), kF32Threads, 0, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.di, static_cast<float*>(a.dq), a.L, a.H, a.st, a.scale);
  return cudaGetLastError();
}

typedef cudaError_t (*Launcher)(const Args&);

template <typename T, int D, bool kRagged>
Launcher pick_mma(bool dkv, int causal) {
  if (dkv)
    return causal ? dkv_mma<T, D, true, kRagged> : dkv_mma<T, D, false, kRagged>;
  return causal ? dq_mma<T, D, true, kRagged> : dq_mma<T, D, false, kRagged>;
}

template <typename T, int D>
Launcher pick_mma(bool dkv, int causal, bool ragged) {
  return ragged ? pick_mma<T, D, true>(dkv, causal)
                : pick_mma<T, D, false>(dkv, causal);
}

template <int D>
Launcher pick(bool dkv, int dtype, int causal, bool ragged) {
  if (dtype == 1) {
    if (dkv) return causal ? dkv_f32<D, true> : dkv_f32<D, false>;
    return causal ? dq_f32<D, true> : dq_f32<D, false>;
  }
  return dtype == 2 ? pick_mma<f16, D>(dkv, causal, ragged)
                    : pick_mma<bf16, D>(dkv, causal, ragged);
}

int launch(bool dkv, int dtype, int D, int causal, const Args& a) {
  if (a.L < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Launcher fn = nullptr;
  switch (D) {
    case 64: fn = pick<64>(dkv, dtype, causal, a.L % kBlockM != 0); break;
    case 128: fn = pick<128>(dkv, dtype, causal, a.L % kBlockM != 0); break;
    case 256: fn = pick<256>(dkv, dtype, causal, a.L % kBlockM != 0); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(fn(a));
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, 2 = float16. L >= 1. Strides are in
// elements (q, k, v, dO, each (b, l, h)); the head dim must be
// contiguous. lse and di are
// (B, H, L) float32, contiguous; the outputs are (B, L, H, D),
// contiguous. Each returns the cudaError_t of its launch.
extern "C" int hvd_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int dtype, int B,
    int L, int H, int D, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long d_sb, long long d_sl,
    long long d_sh, int causal, float scale, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(di),
               nullptr, dk, dv, B, L, H,
               Strides{q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                       d_sb, d_sl, d_sh},
               scale, static_cast<cudaStream_t>(stream)};
  return launch(true, dtype, D, causal, a);
}

extern "C" int hvd_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int dtype, int B, int L,
    int H, int D, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long d_sb, long long d_sl,
    long long d_sh, int causal, float scale, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(di),
               dq, nullptr, nullptr, B, L, H,
               Strides{q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                       d_sb, d_sl, d_sh},
               scale, static_cast<cudaStream_t>(stream)};
  return launch(false, dtype, D, causal, a);
}
