// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that horovod_tpu_torch/ops/flash_attention.py loads through ctypes.
//
// Replaces: the TPU kernel behind horovod_tpu/parallel/ring_attention.py
// `flash_attention_path` (l.163), i.e. the forward of
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention
// (`_flash_attention_kernel`). Its dK/dV and dQ backward kernels are
// in flash_attention_bwd.cu; the types and roundings they share are in
// flash_common.cuh, the Hopper helpers (TMA, mbarrier, wgmma) in
// hopper_common.cuh.
//
// Function: o = softmax(scale * q k^T [+ causal mask]) v and
// lse = logsumexp of the scaled, masked scores, per (b, h, query row).
// q, k, v are (B, L, H, D) with the head dim contiguous and any other
// strides that are multiples of 16 bytes (the JAX call site's public
// layout, read in place); o is written contiguous (B, L, H, D) in the
// input's type; lse is (B, H, L) float32, natural log. Causal means
// query i sees keys 0..i (top-left aligned, L == Lk). Head dims 64,
// 128 and 256; the wrapper zero-pads any other D <= 256 to the next of
// them. Any L >= 1.
//
// What bounds it on an H100: at the serving shapes (L = 2048, D = 128)
// the scores need 4*L*L*D operations per (b, h) against 8*L*D bytes of
// q, k, v and o, about 1000 operations per byte, far above the card's
// ~295 bf16 operations per byte: the tensor cores bound it, not memory.
// Only wgmma reaches their full rate on Hopper, and it has to be kept
// fed while the softmax (exponentials, row max and sum) runs beside it.
//
// What the design does about it (FlashAttention-3's shape, without fp8
// and without clusters):
// - A CTA takes 128 query rows of one (b, h) and has three warpgroups.
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg to
//   24) and one elected thread of its first warp issues every load.
//   Warpgroups 1 and 2 are the consumers, 64 query rows each, with up to
//   240 registers a thread. Every role branch is warp-uniform.
// - Loads are TMA boxes of 64 columns (128 bytes) with the 128-byte
//   swizzle, from one rank-4 tensor map per operand over (D, H, L, B)
//   with the caller's strides. Q is loaded once. K and V tiles of
//   kBlockN keys go through two rings of kStages stages, each stage with
//   a "full" and an "empty" barrier: every consumer thread arrives on
//   K's empty barrier once S = Q K^T has retired and on V's once
//   O += P V has, so the producer refills each as early as it can.
// - S = Q K^T is wgmma m64n{kBlockN}k16 with Q and K both from shared
//   memory, K-major (the head dim contiguous in both): no transpose.
// - O += P V is wgmma m64n{D}k16 with A = P in registers (the S
//   accumulator rounded to 16 bits in pairs is the A fragment) and B =
//   V from shared memory with the transpose bit (V is N-major).
// - The online softmax stays in registers: a row's values lie on the
//   four threads of a quad (max and sum by shfl_xor 1 and 2), the scale
//   is folded into the log2 domain, and a row that has seen only masked
//   keys keeps a finite subtrahend.
// - Overlap (D = 64, 128): in turn j a consumer issues S of tile j and
//   O += P V of tile j - 1 back to back, then runs tile j's softmax
//   while its P V is still on the tensor cores. The two consumers take
//   turns through two named barriers, so one's softmax also runs under
//   the other's products. This keeps P of one tile in registers beside
//   S of the next, and the tile is sized so that fits with no spills:
//   kBlockN = 96 at D = 128 (at 128 ptxas spills and serialises the
//   products), 128 at D = 64. At D = 256 O alone is 128 floats a thread,
//   so the products of a tile run one after the other (kOverlap false).
// - Causal: key tiles run up to the diagonal; only tiles that cross a
//   warpgroup's rows are masked. Ragged L: TMA zero-fills rows past L;
//   key columns at or past L are masked on the last tile and rows past
//   L are not stored. Both masks are one uniform branch per tile, so
//   whole tiles run the unmasked code and no second instantiation is
//   needed.
// - Epilogue: O is normalised, rounded to the input's type, staged in
//   the warpgroup's own rows of the Q buffer (swizzled, conflict-free)
//   and written with 16-byte stores; lse as before.
// - No atomics: two launches on the same inputs are bitwise equal.
// - A barrier wait that lasts 10 s traps (hopper_common.cuh), so a
//   pipeline fault fails the launch instead of holding the card.
// Shared memory (Q + kStages x (K + V)): D = 64: 16 + 2 x 32 KB; D = 128:
// 32 + 2 x 48 KB; D = 256: 64 + 2 x 64 KB.
//
// bf16 is the served type; f16 runs the same kernel with the f16 form
// of the product. The float32 entry point is a plain scalar kernel
// (CUDA cores, exact f32 arithmetic) for tests against the plain
// PyTorch version; no served path runs it.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

using namespace hvd_flash;
using namespace hvd_hopper;

namespace {

constexpr int kBlockM = 128;    // query rows per CTA
constexpr int kConsumers = 2;   // consumer warpgroups, 64 rows each
constexpr int kWgThreads = 128;
constexpr int kThreads = kWgThreads * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct FwdTiles {
  // Keys per tile: as many as the consumers' registers hold with P of
  // one tile still in flight while S of the next is computed (ptxas:
  // no spills at 96 for D = 128). At D = 256 O alone takes 128 floats a
  // thread, so the products run one after the other (kOverlap false).
  static constexpr int kBlockN = D == 256 ? 64 : D == 128 ? 96 : 128;
  static constexpr bool kOverlap = D != 256;
  static constexpr int kStages = 2;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kQPanel = kBlockM * kRowBytes;   // bytes
  static constexpr int kKVPanel = kBlockN * kRowBytes;
  static constexpr int kQBytes = kQPanel * kPanels;
  static constexpr int kKVBytes = kKVPanel * kPanels;   // one K or V tile
  static constexpr int kTileBytes = kQBytes + 2 * kStages * kKVBytes;
  // Barriers after the tiles; 1024 bytes of slack to align the base.
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kSmemBytes = kTileBytes + 8 * kBarriers + 1024;
};

// Named barriers (0 is __syncthreads): the epilogue's, one per consumer
// warpgroup, and the two that take the consumers' products in turns.
constexpr int kEpilogueBarrier = 1;   // + c
constexpr int kSchedBarrier = 3;      // + c: warpgroup c's turn

// The online softmax of one tile's scores, in place: scale into the log2
// domain, mask above the diagonal and past the ragged end of the keys
// (only when `masked`), row max over the quad, P = exp2(s - max), row
// sums into l. corr is the factor that takes O and l from the old max
// to the new one. A row that has seen only masked keys keeps a finite
// subtrahend.
template <int kBlockN, bool kCausal>
__device__ __forceinline__ void online_softmax(
    float (&sc)[kBlockN / 2], float& m0, float& m1, float& l0, float& l1,
    float& corr0, float& corr1, bool masked, int k0, int row0, int row1,
    int t, int L, float scale_log2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = sc[4 * n + i] * scale_log2;
      if (masked) {
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        const int row = i >= 2 ? row1 : row0;
        if ((kCausal && key > row) || key >= L) x = -INFINITY;
      }
      sc[4 * n + i] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  const float base0 = mn0 == -INFINITY ? 0.f : mn0;
  const float base1 = mn1 == -INFINITY ? 0.f : mn1;
  corr0 = exp2f(m0 - base0);
  corr1 = exp2f(m1 - base1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    sc[4 * n] = exp2f(sc[4 * n] - base0);
    sc[4 * n + 1] = exp2f(sc[4 * n + 1] - base0);
    sc[4 * n + 2] = exp2f(sc[4 * n + 2] - base1);
    sc[4 * n + 3] = exp2f(sc[4 * n + 3] - base1);
    ps0 += sc[4 * n] + sc[4 * n + 1];
    ps1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
}

// O (at the old max) times corr, then P rounded to T in pairs: its
// accumulator layout for keys 16kk..16kk+15 is the A operand of P V.
template <typename T, int D, int kBlockN>
__device__ __forceinline__ void rescale_and_pack(
    float (&acc)[D / 2], uint32_t (&pa)[kBlockN / 16][4],
    const float (&sc)[kBlockN / 2], float corr0, float corr1) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[4 * dt] *= corr0;
    acc[4 * dt + 1] *= corr0;
    acc[4 * dt + 2] *= corr1;
    acc[4 * dt + 3] *= corr1;
  }
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    pa[kk][0] = pack_float2<T>(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_float2<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_float2<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_float2<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// T: bf16 or f16.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    T* __restrict__ o, float* __restrict__ lse, int L,
                    int H, float scale_log2) {
  using C = FwdTiles<D>;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + C::kQBytes;
  const uint32_t v_s = k_s + kStages * C::kKVBytes;
  const uint32_t bars = v_s + kStages * C::kKVBytes;
  // Barriers: Q; then per stage K full, V full, K empty, V empty.
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  // Longest causal tiles first: the last query tile has the most keys.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = q_tile * kBlockM;
  const int k_end = kCausal ? min(q0 + kBlockM, L) : L;
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;
  // Warp-uniform as far as the compiler can tell, so that each role's
  // register budget (setmaxnreg) holds for its whole branch.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / kWgThreads, 0);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumers * kWgThreads);
      mbar_init(empty_v(s), kConsumers * kWgThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: warp 0 keeps both rings full, one elected thread issuing
    // every load. A stage is free once both consumers released its last
    // use; a fresh barrier passes the wait on the opposite parity at
    // once. Every branch here is warp-uniform, so that the two roles
    // never share a reconvergence point and each keeps its register
    // budget.
    setmaxnreg_dec<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffff, (threadIdx.x / 32) % 4, 0);
    if (warp == 0) {
      const bool leader = elect_one();
      if (leader) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        mbar_arrive_expect_tx(full_q, C::kQBytes);
        for (int p = 0; p < C::kPanels; ++p)
          tma_load_4d(q_s + p * C::kQPanel, &tq, full_q, p * kPanelCols, h,
                      q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        const int k0 = j * kBlockN;
        mbar_wait(empty_k(s), parity);
        if (leader) {
          mbar_arrive_expect_tx(full_k(s), C::kKVBytes);
          for (int p = 0; p < C::kPanels; ++p)
            tma_load_4d(k_s + s * C::kKVBytes + p * C::kKVPanel, &tk,
                        full_k(s), p * kPanelCols, h, k0, b);
        }
        mbar_wait(empty_v(s), parity);
        if (leader) {
          mbar_arrive_expect_tx(full_v(s), C::kKVBytes);
          for (int p = 0; p < C::kPanels; ++p)
            tma_load_4d(v_s + s * C::kKVBytes + p * C::kKVPanel, &tv,
                        full_v(s), p * kPanelCols, h, k0, b);
        }
        __syncwarp();
      }
    }
  } else {
    // Consumers: warpgroup c takes query rows 64c..64c+63 of the tile.
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int wrow0 = q0 + 64 * c;               // the warpgroup's first row
    const int row0 = wrow0 + 16 * warp + g;      // this thread's rows:
    const int row1 = row0 + 8;                   // row0 and row0 + 8

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // Running max (log2 domain) and this thread's partial row sums.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float corr0, corr1;
    float sc[kBlockN / 2];          // S of tile j
    uint32_t pa[kBlockN / 16][4];   // P, the A operand of P V
    const uint32_t qa = q_s + 64 * c * kRowBytes;  // this warpgroup's rows
    auto masked = [&](int j) {      // uniform across the warpgroup
      const int k0 = j * kBlockN;
      return (kCausal && k0 + kBlockN - 1 > wrow0) || k0 + kBlockN > L;
    };

    mbar_wait(full_q, 0);
    if constexpr (C::kOverlap) {
      // The consumers take the tensor cores in turns: warpgroup c issues
      // its products once the other one has issued its own, so that one
      // warpgroup's softmax runs under the other's products. Warpgroup 0
      // goes first; there are n_tiles + 1 turns each.
      if (c == 1) named_barrier_arrive(kSchedBarrier, 2 * kWgThreads);

      // Turn 0: S of tile 0.
      named_barrier_sync(kSchedBarrier + c, 2 * kWgThreads);
      mbar_wait(full_k(0), 0);
      issue_kmajor<T, D, kBlockN, C::kQPanel, C::kKVPanel>(sc, qa, k_s);
      named_barrier_arrive(kSchedBarrier + 1 - c, 2 * kWgThreads);
      wgmma_wait<0>();
      reg_fence(sc);
      mbar_arrive(empty_k(0));
      online_softmax<kBlockN, kCausal>(sc, m0, m1, l0, l1, corr0, corr1,
                                       masked(0), 0, row0, row1, t, L,
                                       scale_log2);
      rescale_and_pack<T, D, kBlockN>(acc, pa, sc, corr0, corr1);

      // Turn j: S of tile j and O += P V of tile j - 1, then tile j's
      // softmax while P V is still on the tensor cores.
      for (int j = 1; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int sp = (j - 1) % kStages;
        named_barrier_sync(kSchedBarrier + c, 2 * kWgThreads);
        mbar_wait(full_k(s), (j / kStages) & 1);
        issue_kmajor<T, D, kBlockN, C::kQPanel, C::kKVPanel>(
            sc, qa, k_s + s * C::kKVBytes);
        mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
        issue_rs<T, kBlockN, D, C::kKVPanel>(acc, pa, v_s + sp * C::kKVBytes);
        named_barrier_arrive(kSchedBarrier + 1 - c, 2 * kWgThreads);
        wgmma_wait<1>();  // S is done; P V may still run
        reg_fence(sc);
        mbar_arrive(empty_k(s));
        online_softmax<kBlockN, kCausal>(sc, m0, m1, l0, l1, corr0, corr1,
                                         masked(j), j * kBlockN, row0, row1,
                                         t, L, scale_log2);
        wgmma_wait<0>();
        reg_fence(acc);
        mbar_arrive(empty_v(sp));
        rescale_and_pack<T, D, kBlockN>(acc, pa, sc, corr0, corr1);
      }

      // Last turn: P V of the last tile. Warpgroup 1 leaves it unanswered:
      // warpgroup 0 has no turn after it.
      named_barrier_sync(kSchedBarrier + c, 2 * kWgThreads);
      const int sl = (n_tiles - 1) % kStages;
      mbar_wait(full_v(sl), ((n_tiles - 1) / kStages) & 1);
      issue_rs<T, kBlockN, D, C::kKVPanel>(acc, pa, v_s + sl * C::kKVBytes);
      if (c == 0) named_barrier_arrive(kSchedBarrier + 1, 2 * kWgThreads);
      wgmma_wait<0>();
      reg_fence(acc);
    } else {
      // Serial: S, softmax, then P V of each tile in turn.
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = (j / kStages) & 1;
        mbar_wait(full_k(s), parity);
        issue_kmajor<T, D, kBlockN, C::kQPanel, C::kKVPanel>(
            sc, qa, k_s + s * C::kKVBytes);
        wgmma_wait<0>();
        reg_fence(sc);
        mbar_arrive(empty_k(s));
        online_softmax<kBlockN, kCausal>(sc, m0, m1, l0, l1, corr0, corr1,
                                         masked(j), j * kBlockN, row0, row1,
                                         t, L, scale_log2);
        rescale_and_pack<T, D, kBlockN>(acc, pa, sc, corr0, corr1);
        mbar_wait(full_v(s), parity);
        issue_rs<T, kBlockN, D, C::kKVPanel>(acc, pa, v_s + s * C::kKVBytes);
        wgmma_wait<0>();
        reg_fence(acc);
        mbar_arrive(empty_v(s));
      }
    }

    l0 += __shfl_xor_sync(0xffffffff, l0, 1);
    l0 += __shfl_xor_sync(0xffffffff, l0, 2);
    l1 += __shfl_xor_sync(0xffffffff, l1, 1);
    l1 += __shfl_xor_sync(0xffffffff, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;

    // Stage O in this warpgroup's own rows of the Q buffer, with the
    // TMA swizzle (16-byte chunk c of row r at c ^ (r % 8)): the quad's
    // four 4-byte writes to a chunk and the eight row groups fall on
    // distinct banks.
    const int r0 = 64 * c + 16 * warp + g;  // row in the CTA's Q buffer
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int chunk = (dt % 8) ^ (g % 8);  // r0 % 8 == (r0 + 8) % 8 == g
      unsigned char* p = smem + (dt / 8) * C::kQPanel + r0 * kRowBytes +
                         chunk * 16 + t * 4;
      *reinterpret_cast<uint32_t*>(p) =
          pack_float2<T>(acc[4 * dt] * inv0, acc[4 * dt + 1] * inv0);
      *reinterpret_cast<uint32_t*>(p + 8 * kRowBytes) =
          pack_float2<T>(acc[4 * dt + 2] * inv1, acc[4 * dt + 3] * inv1);
    }
    if (t == 0) {
      float* lrow = lse + (static_cast<int64_t>(b) * H + h) * L;
      if (row0 < L)
        lrow[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : -INFINITY;
      if (row1 < L)
        lrow[row1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : -INFINITY;
    }
    named_barrier_sync(kEpilogueBarrier + c, kWgThreads);
    constexpr int kChunks = D / 8;  // 16-byte chunks of an o row
    for (int i = tid; i < 64 * kChunks; i += kWgThreads) {
      const int r = i / kChunks;
      const int ch = i % kChunks;
      const int row = wrow0 + r;
      if (row >= L) break;  // rows grow with i
      const uint4 val = *reinterpret_cast<const uint4*>(
          smem + (ch / 8) * C::kQPanel + (64 * c + r) * kRowBytes +
          ((ch % 8) ^ (r % 8)) * 16);
      *reinterpret_cast<uint4*>(
          o + (static_cast<int64_t>(b) * L + row) * H * D +
          static_cast<int64_t>(h) * D + ch * 8) = val;
    }
  }
}

struct Strides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh;
};

// float32: one thread per query row, keys one at a time, K/V tiles of
// kKeyTile rows in static shared memory (rows past L zero-filled; a
// thread whose row is past L computes on zeros and stores nothing).
constexpr int kF32Rows = 64;  // query rows per CTA
constexpr int kKeyTile = 16;

template <int D, bool kCausal>
__global__ void __launch_bounds__(kF32Rows)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int L, int H, Strides st,
                  float scale_log2) {
  __shared__ float k_s[kKeyTile][D];
  __shared__ float v_s[kKeyTile][D];
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = q_tile * kF32Rows + threadIdx.x;
  const bool live = row < L;
  const float* qr = q + b * st.qb + static_cast<int64_t>(row) * st.ql + h * st.qh;
  float qv[D], acc[D];
  for (int d = 0; d < D; ++d) {
    qv[d] = live ? qr[d] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int k_end = min(kCausal ? (q_tile + 1) * kF32Rows : L, L);
  for (int k0 = 0; k0 < k_end; k0 += kKeyTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKeyTile * D; i += kF32Rows) {
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

typedef int (*Launcher)(const void*, const void*, const void*, void*,
                        float*, int, int, int, const Strides&, float,
                        cudaStream_t);

template <typename T, int D, bool kCausal>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int L, int H, const Strides& st,
                 float scale_log2, cudaStream_t stream) {
  using C = FwdTiles<D>;
  constexpr bool kF16 = !kIsBf16<T>;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, kF16, B, L, H, D, st.qb, st.ql, st.qh, kBlockM);
  if (err == 0)
    err = encode(&tk, k, kF16, B, L, H, D, st.kb, st.kl, st.kh, C::kBlockN);
  if (err == 0)
    err = encode(&tv, v, kF16, B, L, H, D, st.vb, st.vl, st.vh, C::kBlockN);
  if (err != 0) return err;
  auto kernel = flash_fwd_wgmma<T, D, kCausal>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, L, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int L, int H, const Strides& st,
               float scale_log2, cudaStream_t stream) {
  const dim3 grid((L + kF32Rows - 1) / kF32Rows, H, B);
  flash_fwd_f32<D, kCausal><<<grid, kF32Rows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, L, H, st,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
Launcher pick(int dtype, int causal) {
  if (dtype == 1) return causal ? launch_f32<D, true> : launch_f32<D, false>;
  if (dtype == 2)
    return causal ? launch_wgmma<f16, D, true> : launch_wgmma<f16, D, false>;
  return causal ? launch_wgmma<bf16, D, true> : launch_wgmma<bf16, D, false>;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, 2 = float16. L >= 1. Strides are in
// elements; the head dim must be contiguous. Returns the cudaError_t of
// the launch, or kTensorMapError + the CUresult of a failed tensor-map
// encode.
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
  return fn(q, k, v, o, static_cast<float*>(lse), B, L, H, st,
            scale * kLog2e, static_cast<cudaStream_t>(stream));
}

// The 16-bit kernel's dynamic shared memory for head dim D (0 for a D
// it is not built for); ptxas reports only static shared memory.
extern "C" int hvd_flash_attention_fwd_smem_bytes(int D) {
  switch (D) {
    case 64: return FwdTiles<64>::kSmemBytes;
    case 128: return FwdTiles<128>::kSmemBytes;
    case 256: return FwdTiles<256>::kSmemBytes;
    default: return 0;
  }
}
