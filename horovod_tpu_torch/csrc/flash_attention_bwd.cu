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
// dv are written contiguous in the inputs' dtype.
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
// bf16 is the trained type. The float32 entry points are plain scalar
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
// dK/dV, bf16: one CTA per (key tile, h, b); each group of four warps holds
// the tile's 64 keys, 16 per warp, and walks the query tiles.

template <int D, bool kCausal>
__global__ void __launch_bounds__(128 * kDkvSplit<D>)
    flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int L, int H, Strides st,
                       float scale, float scale_log2) {
  constexpr int kThreads = 128 * kDkvSplit<D>;
  constexpr int kDw = D / kDkvSplit<D>;  // head-dim columns per warp
  constexpr int kS = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBlockN * kS;
  bf16* q_s = v_s + kBlockN * kS;
  bf16* do_s = q_s + kBlockM * kS;
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

  load_tile<D, kThreads>(k_s, k + b * st.kb + k0 * st.kl + h * st.kh, st.kl,
                         kBlockN);
  load_tile<D, kThreads>(v_s, v + b * st.vb + k0 * st.vl + h * st.vh, st.vl,
                         kBlockN);
  cp_async_commit();

  const bf16* qg = q + b * st.qb + h * st.qh;
  const bf16* dg = dout + b * st.db + h * st.dh;
  const float* lse_bh = lse + (static_cast<int64_t>(b) * H + h) * L;
  const float* di_bh = di + (static_cast<int64_t>(b) * H + h) * L;

  float dk_acc[kDw / 8][4];
  float dv_acc[kDw / 8][4];
#pragma unroll
  for (int i = 0; i < kDw / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  const int n_q_tiles = L / kBlockM;
  for (int i = kCausal ? k_tile : 0; i < n_q_tiles; ++i) {
    const int q0 = i * kBlockM;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D, kThreads>(q_s, qg + static_cast<int64_t>(q0) * st.ql, st.ql,
                           kBlockM);
    load_floats(lse_s, lse_bh + q0, kBlockM);
    cp_async_commit();
    load_tile<D, kThreads>(do_s, dg + static_cast<int64_t>(q0) * st.dl, st.dl,
                           kBlockM);
    load_floats(di_s, di_bh + q0, kBlockM);
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
      const bf16* ka = k_s + (krow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(ka);
      const uint32_t a1 = ld_pair(ka + 8 * kS);
      const uint32_t a2 = ld_pair(ka + 8);
      const uint32_t a3 = ld_pair(ka + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
        const bf16* qb = q_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816(p[n], a0, a1, a2, a3, ld_pair(qb), ld_pair(qb + 8));
      }
    }
    // P^T = exp(scale S^T - lse[query]), zero above the diagonal.
    const bool diag = kCausal && i == k_tile;
#pragma unroll
    for (int n = 0; n < kBlockM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);    // query in the tile
        const int row = krow + g + (e >= 2 ? 8 : 0);  // key in the tile
        const float x = exp2f(fmaf(p[n][e], scale_log2,
                                   -lse_s[col] * kLog2e));
        p[n][e] = (diag && row > col) ? 0.f : x;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // dO and di visible to every warp

    // dV += P^T dO.
#pragma unroll
    for (int kk = 0; kk < kBlockM / 16; ++kk) {
      const uint32_t a0 = pack_float2(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_float2(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_float2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_float2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const bf16* ob = do_s + (kk * 16 + 2 * t) * kS + d0 + g;
#pragma unroll
      for (int dt = 0; dt < kDw / 8; ++dt) {
        const bf16* x = ob + dt * 8;
        mma_16816(dv_acc[dt], a0, a1, a2, a3, pack_pair(x[0], x[kS]),
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
      const bf16* va = v_s + (krow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(va);
      const uint32_t a1 = ld_pair(va + 8 * kS);
      const uint32_t a2 = ld_pair(va + 8);
      const uint32_t a3 = ld_pair(va + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockM / 8; ++n) {
        const bf16* ob = do_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816(ds[n], a0, a1, a2, a3, ld_pair(ob), ld_pair(ob + 8));
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
      const uint32_t a0 = pack_float2(ds[2 * kk][0], ds[2 * kk][1]);
      const uint32_t a1 = pack_float2(ds[2 * kk][2], ds[2 * kk][3]);
      const uint32_t a2 = pack_float2(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      const uint32_t a3 = pack_float2(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
      const bf16* qb = q_s + (kk * 16 + 2 * t) * kS + d0 + g;
#pragma unroll
      for (int dt = 0; dt < kDw / 8; ++dt) {
        const bf16* x = qb + dt * 8;
        mma_16816(dk_acc[dt], a0, a1, a2, a3, pack_pair(x[0], x[kS]),
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
    *reinterpret_cast<uint32_t*>(dk + o0 + c) =
        pack_float2(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
    *reinterpret_cast<uint32_t*>(dk + o1 + c) =
        pack_float2(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
    *reinterpret_cast<uint32_t*>(dv + o0 + c) =
        pack_float2(dv_acc[dt][0], dv_acc[dt][1]);
    *reinterpret_cast<uint32_t*>(dv + o1 + c) =
        pack_float2(dv_acc[dt][2], dv_acc[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// dQ, bf16: one CTA per (query tile, h, b), 16 queries per warp, walking
// the key tiles up to the diagonal.

constexpr int kDqThreads = 128;

template <int D, bool kCausal>
__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, bf16* __restrict__ dq,
                      int L, int H, Strides st, float scale,
                      float scale_log2) {
  constexpr int kS = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBlockM * kS;
  bf16* k_s = do_s + kBlockM * kS;
  bf16* v_s = k_s + kBlockN * kS;

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

  load_tile<D, kDqThreads>(q_s, q + b * st.qb + q0 * st.ql + h * st.qh,
                           st.ql, kBlockM);
  load_tile<D, kDqThreads>(do_s, dout + b * st.db + q0 * st.dl + h * st.dh,
                           st.dl, kBlockM);
  cp_async_commit();

  const int r0 = q0 + wrow + g;
  const int r1 = r0 + 8;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * L;
  const float lse0 = lse[bh + r0] * kLog2e;
  const float lse1 = lse[bh + r1] * kLog2e;
  const float di0 = di[bh + r0];
  const float di1 = di[bh + r1];
  const bf16* kg = k + b * st.kb + h * st.kh;
  const bf16* vg = v + b * st.vb + h * st.vh;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_tiles = kCausal ? q_tile + 1 : L / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, kDqThreads>(
        k_s, kg + static_cast<int64_t>(j) * kBlockN * st.kl, st.kl, kBlockN);
    cp_async_commit();
    load_tile<D, kDqThreads>(
        v_s, vg + static_cast<int64_t>(j) * kBlockN * st.vl, st.vl, kBlockN);
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
      const bf16* qa = q_s + (wrow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(qa);
      const uint32_t a1 = ld_pair(qa + 8 * kS);
      const uint32_t a2 = ld_pair(qa + 8);
      const uint32_t a3 = ld_pair(qa + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const bf16* kb = k_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816(p[n], a0, a1, a2, a3, ld_pair(kb), ld_pair(kb + 8));
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
        p[n][e] = (diag && key > row) ? 0.f : x;
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
      const bf16* oa = do_s + (wrow + g) * kS + kd * 16 + 2 * t;
      const uint32_t a0 = ld_pair(oa);
      const uint32_t a1 = ld_pair(oa + 8 * kS);
      const uint32_t a2 = ld_pair(oa + 8);
      const uint32_t a3 = ld_pair(oa + 8 * kS + 8);
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const bf16* vb = v_s + (n * 8 + g) * kS + kd * 16 + 2 * t;
        mma_16816(ds[n], a0, a1, a2, a3, ld_pair(vb), ld_pair(vb + 8));
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
      const uint32_t a0 = pack_float2(ds[2 * kk][0], ds[2 * kk][1]);
      const uint32_t a1 = pack_float2(ds[2 * kk][2], ds[2 * kk][3]);
      const uint32_t a2 = pack_float2(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      const uint32_t a3 = pack_float2(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
      const bf16* kb = k_s + (kk * 16 + 2 * t) * kS + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const bf16* x = kb + dt * 8;
        mma_16816(acc[dt], a0, a1, a2, a3, pack_pair(x[0], x[kS]),
                  pack_pair(x[8 * kS], x[9 * kS]));
      }
    }
  }

  bf16* o0 = dq + (static_cast<int64_t>(b) * L + r0) * H * D +
             static_cast<int64_t>(h) * D;
  bf16* o1 = dq + (static_cast<int64_t>(b) * L + r1) * H * D +
             static_cast<int64_t>(h) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(o0 + c) =
        pack_float2(acc[dt][0] * scale, acc[dt][1] * scale);
    *reinterpret_cast<uint32_t*>(o1 + c) =
        pack_float2(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32: one thread per key row (dK/dV) or query row (dQ), the other
// side streamed through static shared memory kRowTile rows at a time.

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
  const float* kr = k + b * st.kb + static_cast<int64_t>(key) * st.kl + h * st.kh;
  const float* vr = v + b * st.vb + static_cast<int64_t>(key) * st.vl + h * st.vh;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * L;
  float kv[D], vv[D], dkv[D], dvv[D];
  for (int d = 0; d < D; ++d) {
    kv[d] = kr[d];
    vv[d] = vr[d];
    dkv[d] = dvv[d] = 0.f;
  }
  for (int q0 = kCausal ? k_tile * kF32Threads : 0; q0 < L; q0 += kRowTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRowTile * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      q_s[r][c] = q[b * st.qb + static_cast<int64_t>(q0 + r) * st.ql + h * st.qh + c];
      do_s[r][c] = dout[b * st.db + static_cast<int64_t>(q0 + r) * st.dl + h * st.dh + c];
    }
    if (threadIdx.x < kRowTile) {
      lse_s[threadIdx.x] = lse[bh + q0 + threadIdx.x];
      di_s[threadIdx.x] = di[bh + q0 + threadIdx.x];
    }
    __syncthreads();
    for (int r = 0; r < kRowTile; ++r) {
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
  const float* qr = q + b * st.qb + static_cast<int64_t>(row) * st.ql + h * st.qh;
  const float* dr = dout + b * st.db + static_cast<int64_t>(row) * st.dl + h * st.dh;
  const int64_t bh = (static_cast<int64_t>(b) * H + h) * L;
  const float lse_r = lse[bh + row];
  const float di_r = di[bh + row];
  float qv[D], dov[D], acc[D];
  for (int d = 0; d < D; ++d) {
    qv[d] = qr[d];
    dov[d] = dr[d];
    acc[d] = 0.f;
  }
  const int k_end = kCausal ? (q_tile + 1) * kF32Threads : L;
  for (int k0 = 0; k0 < k_end; k0 += kRowTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRowTile * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      k_s[r][c] = k[b * st.kb + static_cast<int64_t>(k0 + r) * st.kl + h * st.kh + c];
      v_s[r][c] = v[b * st.vb + static_cast<int64_t>(k0 + r) * st.vl + h * st.vh + c];
    }
    __syncthreads();
    for (int r = 0; r < kRowTile; ++r) {
      if (kCausal && k0 + r > row) break;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(qv[d], k_s[r][d], s);
        dp = fmaf(dov[d], v_s[r][d], dp);
      }
      const float ds = expf(s * scale - lse_r) * (dp - di_r);
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, k_s[r][d], acc[d]);
    }
  }
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

template <int D, bool kCausal>
cudaError_t dkv_bf16(const Args& a) {
  auto kernel = flash_bwd_dkv_bf16<D, kCausal>;
  constexpr int kThreads = 128 * kDkvSplit<D>;
  const int smem = (2 * kBlockN + 2 * kBlockM) * (D + kPad) * sizeof(bf16) +
                   2 * kBlockM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.L / kBlockN, a.H, a.B), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.di, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.L, a.H,
      a.st, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t dq_bf16(const Args& a) {
  auto kernel = flash_bwd_dq_bf16<D, kCausal>;
  const int smem = (2 * kBlockM + 2 * kBlockN) * (D + kPad) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.L / kBlockM, a.H, a.B), kDqThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.di, static_cast<bf16*>(a.dq), a.L, a.H, a.st, a.scale,
      a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t dkv_f32(const Args& a) {
  flash_bwd_dkv_f32<D, kCausal>
      <<<dim3(a.L / kF32Threads, a.H, a.B), kF32Threads, 0, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
          a.L, a.H, a.st, a.scale);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t dq_f32(const Args& a) {
  flash_bwd_dq_f32<D, kCausal>
      <<<dim3(a.L / kF32Threads, a.H, a.B), kF32Threads, 0, a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.di, static_cast<float*>(a.dq), a.L, a.H, a.st, a.scale);
  return cudaGetLastError();
}

typedef cudaError_t (*Launcher)(const Args&);

template <int D>
Launcher pick(bool dkv, int is_f32, int causal) {
  if (dkv) {
    if (is_f32) return causal ? dkv_f32<D, true> : dkv_f32<D, false>;
    return causal ? dkv_bf16<D, true> : dkv_bf16<D, false>;
  }
  if (is_f32) return causal ? dq_f32<D, true> : dq_f32<D, false>;
  return causal ? dq_bf16<D, true> : dq_bf16<D, false>;
}

int launch(bool dkv, int dtype, int D, int causal, const Args& a) {
  if (a.L % kBlockM != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Launcher fn = nullptr;
  switch (D) {
    case 64: fn = pick<64>(dkv, dtype, causal); break;
    case 128: fn = pick<128>(dkv, dtype, causal); break;
    case 256: fn = pick<256>(dkv, dtype, causal); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(fn(a));
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Strides are in elements (q, k, v,
// dO, each (b, l, h)); the head dim must be contiguous. lse and di are
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
