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
// other strides that are multiples of 16 bytes; lse and di are (B, H, L)
// float32, contiguous; dq, dk and dv are written contiguous in the
// inputs' dtype. Any L >= 1: rows at or past L are never stored, and P
// is zero for queries or keys at or past L.
//
// What bounds it on an H100: at the training shape (L = 2048, D = 128)
// dK/dV does four products (8*D operations per visible (query, key)
// pair) and dQ three (6*D), against 4 to 5 reads or writes of L*D per
// (b, h): about 1000 operations per byte, far above the card's ~295 bf16
// operations per byte, so the tensor cores bound both, not memory. Only
// wgmma reaches their full rate on Hopper.
//
// The dK/dV kernel (flash_bwd_dkv_wgmma) and what its design does about
// that:
// - A CTA owns 64 keys of one (b, h) and walks the query tiles of kBlockM
//   rows (from the diagonal when causal). It has three warpgroups.
//   Warpgroup 0 is the producer: it gives up registers (setmaxnreg to
//   24) and one elected thread of its first warp issues every TMA load.
//   K and V are loaded once; Q, dO, lse and di of each query tile go
//   through a ring of kStages stages, each with a "full" and an "empty"
//   barrier. lse and di are copied into the stage by that warp's lanes
//   with plain loads: a tile's rows start anywhere in (B, H, L), and
//   rank-1 TMA boxes at such starts (not 16-byte aligned at a ragged L)
//   stopped the kernel with an illegal instruction on the card.
// - Warpgroup 1 owns dV. It computes S^T = K Q^T (wgmma, both K-major),
//   then P^T = exp2(scale_log2 S^T - lse log2e), masked, hands P^T in
//   float32 to warpgroup 2 through a double-buffered shared-memory slot,
//   and accumulates dV += P^T dO (wgmma with P^T, rounded to 16 bits in
//   pairs, as the register A operand and dO read MN-major).
// - Warpgroup 2 owns dK. It computes dP^T = V dO^T, takes P^T from the
//   slot, forms dS^T = P^T (dP^T - di) and accumulates dK += dS^T Q (Q
//   read MN-major). So each consumer issues two products of the same size
//   per tile and holds one 64 x D float32 accumulator, and the two
//   scores tiles have the same accumulator layout: thread i of warpgroup
//   2 reads from the slot exactly what thread i of warpgroup 1 wrote,
//   16 bytes a thread in a row of 128 threads, with no bank conflicts.
//   dS is formed from float32 P, as before; P^T and dS^T are rounded to
//   16 bits only as product operands.
// - Overlap: each consumer issues the scores product of tile j + 1 and
//   the gradient product of tile j back to back, then works on tile
//   j + 1's scores (exponentials, or dS) while the gradient product is
//   still on the tensor cores. A stage is released only when tile j's
//   gradient products have retired, one tile later than without the
//   overlap, so the ring has three stages and the producer still loads a
//   tile ahead.
// - Ragged L and causal: TMA zero-fills rows past L, and the producer
//   writes zero lse and di there. Tiles that cross the diagonal or the
//   end of L are masked with one uniform branch per tile: P^T is set to
//   zero above the diagonal and for queries at or past L explicitly,
//   since lse there is 0, not +inf. Keys past L are independent rows
//   that are not stored. So no second instantiation is needed.
// - Epilogue: dK (times scale) and dV are rounded to the input's type,
//   staged with the TMA swizzle in shared memory no other warpgroup reads
//   any more (dV in K's tile, dK in V's tile) and written with 16-byte
//   stores; rows past L are not stored.
// - No atomics: two launches on the same inputs are bitwise equal. A
//   barrier wait that lasts 10 s traps (hopper_common.cuh).
// - Registers: one accumulator (D / 2 floats a thread) plus the scores
//   tile (kBlockM / 2) and its 16-bit A operand (kBlockM / 4) have to fit
//   under the 168 registers a thread that three warpgroups get at launch:
//   kBlockM = 128 at D = 64 and 64 at D = 128 do with no spills. At
//   D = 256 the accumulator alone is 128 floats, so the query tile is 32
//   rows there, and ptxas still spills a little.
// Shared memory (K + V + kStages x (Q + dO + lse + di) + 2 slots):
// D = 64: 16 + 3 x 33 + 64 KB; D = 128: 32 + 3 x 32.5 + 32 KB;
// D = 256: 64 + 3 x 32.25 + 16 KB.
//
// The dQ kernel (flash_bwd_dq_wgmma) and what its design does about that:
// - A CTA owns kBlockM query rows of one (b, h) and walks the key tiles of
//   64 keys (up to the diagonal when causal, the longest rows first).
//   Warpgroup 0 is the producer; warpgroups 1.. are consumers of 64 rows
//   each: two at D = 64 and 128 (kBlockM = 128), one at D = 256
//   (kBlockM = 64), where two would need 256 KB of shared memory.
// - Q and dO are loaded once by TMA. K and V go through a ring of
//   kStages stages, a "full" and an "empty" barrier for each of K and V:
//   S is issued once K has landed, before V has, and V is released once
//   dP = dO V^T has retired, K once dQ += dS K has. (One barrier pair
//   for both was 2-4 % slower at the causal training shape on an H100,
//   and 8 % faster non-causal.)
//   lse and di are constant over the CTA's rows: the producer warp's
//   lanes copy them into shared memory with plain loads (lse times
//   log2 e; zero past L) and arrive on Q's barrier, never through rank-1
//   TMA boxes, whose starts are not 16-byte aligned at a ragged L.
// - Products (wgmma, f32 accumulate): S = Q K^T and dP = dO V^T with both
//   operands K-major (issue_kmajor); dQ += dS K with dS, rounded to 16
//   bits in pairs, as the register A operand and K read MN-major from the
//   same swizzled tile the scores product read K-major (issue_rs). dS =
//   P (dP - di) is formed from float32 P in place over dP, so the scores
//   tile and the dP tile are the only two live.
// - Schedule: a consumer runs each tile's products in series (S and dP
//   together, dS, then dS K); the two consumers' tiles interleave on the
//   tensor cores. Issuing the next tile's S and dP beside this tile's
//   dS K, as dK/dV does, needs 144 live floats a thread at D = 128:
//   ptxas spilled and serialised the products (C7512) there, and on an
//   H100 it was slower at D = 128 and 256 and 2 % faster at D = 64
//   (PERF.md), so there is one schedule. D = 64 and 128 run three
//   stages; D = 256 fits two.
// - Causal and ragged: TMA zero-fills rows past L; rows past L compute on
//   zeros (lse = di = 0) and are not stored. One uniform branch per tile
//   masks P above the diagonal and at keys past L, only on tiles that
//   cross either. A consumer stops at its own last visible key tile, so
//   the first consumer skips the CTA's last tile when causal. No second
//   instantiation.
// - Epilogue: dQ times scale, rounded to the input's type, staged in the
//   warpgroup's own rows of the Q tile (no other warpgroup reads them)
//   and written with 16-byte stores; rows past L are not stored. No
//   atomics: two launches on the same inputs are bitwise equal.
// - Registers, per consumer thread: the 64 x D accumulator (D / 2
//   floats), S and dP (32 floats each at 64 keys; the packed dS reuses
//   S's): 96 at D = 64 and 128 at D = 128, under the 168 that three
//   warpgroups get at launch; 192 at D = 256, under the 255 of two.
// Shared memory (Q + dO + kStages x (K + V) + lse + di): D = 64: 32 +
// 3 x 16 + 1 KB; D = 128: 64 + 3 x 32 + 1 KB; D = 256: 64 + 2 x 64 +
// 0.5 KB.
//
// bf16 is the trained type; f16 runs the same kernels with the f16 form
// of the product. The float32 entry points are plain scalar kernels
// (CUDA cores, f32 arithmetic) for tests against the plain PyTorch
// version; no training path runs them.

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

using namespace hvd_flash;
using namespace hvd_hopper;

namespace {

constexpr int kBlockN = 64;  // keys per tile of the 16-bit kernels

struct Strides {
  int64_t qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh;  // d*: dO
};

// ---------------------------------------------------------------------------
// dK/dV, bf16 or f16 (T): one CTA per (key tile, h, b), see the header.

constexpr int kWgThreads = 128;
constexpr int kDkvThreads = 3 * kWgThreads;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct DkvTiles {
  // Query rows per tile: as many as fit in a consumer's registers beside
  // its accumulator with no spills (see the header).
  static constexpr int kBlockM = D == 256 ? 32 : D == 128 ? 64 : 128;
  static constexpr int kStages = 3;
  static constexpr int kSlots = 2;   // P^T slots
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kKVPanel = kBlockN * kRowBytes;  // bytes
  static constexpr int kQPanel = kBlockM * kRowBytes;
  static constexpr int kKVBytes = kKVPanel * kPanels;   // the K or V tile
  static constexpr int kQBytes = kQPanel * kPanels;     // one Q or dO tile
  static constexpr int kRowBytesF32 = kBlockM * 4;      // one lse or di tile
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kRowBytesF32;
  static constexpr int kSlotBytes = kBlockN * kBlockM * 4;  // P^T, f32
  // K, V; Q and dO of every stage; lse and di of every stage; the slots.
  static constexpr int kTileBytes =
      2 * kKVBytes + kStages * kStageBytes + kSlots * kSlotBytes;
  // Barriers after the tiles: K/V; per stage full, empty; per slot
  // full, empty. 1024 bytes of slack to align the base.
  static constexpr int kBarriers = 1 + 2 * (kStages + kSlots);
  static constexpr int kSmemBytes = kTileBytes + 8 * kBarriers + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
};

// Named barriers (0 is __syncthreads): each consumer's epilogue.
constexpr int kEpilogueBarrier = 1;  // + consumer (dK/dV: 0 dV, 1 dK)

// A scores-shaped accumulator (64 rows x kBlockN keys), rounded to T in
// pairs: its layout for keys 16kk..16kk+15 is the register A operand of
// a product that reduces over the keys.
template <typename T, int kBlockN>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[kBlockN / 16][4],
                                       const float (&x)[kBlockN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    pa[kk][0] = pack_float2<T>(x[8 * kk], x[8 * kk + 1]);
    pa[kk][1] = pack_float2<T>(x[8 * kk + 2], x[8 * kk + 3]);
    pa[kk][2] = pack_float2<T>(x[8 * kk + 4], x[8 * kk + 5]);
    pa[kk][3] = pack_float2<T>(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// A 64 x D accumulator, scaled and rounded to T, into the warpgroup's 64
// rows of the swizzled panels at `tile` (panels kPanelBytes apart), then
// out to rows row0.. of the contiguous (B, L, H, D) output, rows past L
// left out.
template <typename T, int D, int kPanelBytes>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2],
                                           float scale, unsigned char* tile,
                                           T* out, int consumer, int row0,
                                           int L, int H, int h, int b) {
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;
  const int t = tid & 3;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int chunk = (dt % 8) ^ g;  // r0 % 8 == (r0 + 8) % 8 == g
    unsigned char* p =
        tile + (dt / 8) * kPanelBytes + r0 * kRowBytes + chunk * 16 + t * 4;
    *reinterpret_cast<uint32_t*>(p) =
        pack_float2<T>(acc[4 * dt] * scale, acc[4 * dt + 1] * scale);
    *reinterpret_cast<uint32_t*>(p + 8 * kRowBytes) =
        pack_float2<T>(acc[4 * dt + 2] * scale, acc[4 * dt + 3] * scale);
  }
  named_barrier_sync(kEpilogueBarrier + consumer, kWgThreads);
  constexpr int kChunks = D / 8;  // 16-byte chunks of an output row
  for (int i = tid; i < 64 * kChunks; i += kWgThreads) {
    const int r = i / kChunks;
    const int ch = i % kChunks;
    const int row = row0 + r;
    if (row >= L) break;  // rows grow with i
    const uint4 val = *reinterpret_cast<const uint4*>(
        tile + (ch / 8) * kPanelBytes + r * kRowBytes +
        ((ch % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(b) * L + row) *
                                        H * D +
                              static_cast<int64_t>(h) * D + ch * 8) = val;
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dk,
                        T* __restrict__ dv, int L, int H, float scale,
                        float scale_log2) {
  using C = DkvTiles<D>;
  constexpr int kBM = C::kBlockM;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + C::kKVBytes;
  const uint32_t q_s = v_s + C::kKVBytes;             // + stage * kQBytes
  const uint32_t do_s = q_s + kStages * C::kQBytes;   // + stage * kQBytes
  const uint32_t lse_s = do_s + kStages * C::kQBytes;  // + stage * rows
  const uint32_t di_s = lse_s + kStages * C::kRowBytesF32;
  const uint32_t slot_s = di_s + kStages * C::kRowBytesF32;
  const uint32_t bars = slot_s + C::kSlots * C::kSlotBytes;
  const uint32_t full_kv = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto slot_full = [&](int i) { return bars + 8u * (1 + 2 * kStages + i); };
  auto slot_empty = [&](int i) {
    return bars + 8u * (1 + 2 * kStages + C::kSlots + i);
  };
  auto at = [&](uint32_t a) { return smem + (a - base); };

  // Causal: key tile 0 sees every query tile, so low tiles go first.
  const int k0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int first = kCausal ? k0 / kBM : 0;  // the first query tile
  const int n_tiles = (L + kBM - 1) / kBM - first;  // >= 1: k0 < L
  // Warp-uniform as far as the compiler can tell, so that each role's
  // register budget (setmaxnreg) holds for its whole branch.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / kWgThreads, 0);

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA leader, then warp 0's rows
      mbar_init(empty(s), 2 * kWgThreads);
    }
    for (int i = 0; i < C::kSlots; ++i) {
      mbar_init(slot_full(i), kWgThreads);
      mbar_init(slot_empty(i), kWgThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: warp 0 keeps the ring full, one elected thread issuing
    // every load. A stage is free once both consumers released its last
    // use; a fresh barrier passes the wait on the opposite parity at
    // once.
    setmaxnreg_dec<kProducerRegs>();
    const int warp = __shfl_sync(0xffffffff, (threadIdx.x / 32) % 4, 0);
    if (warp == 0) {
      const bool leader = elect_one();
      if (leader) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        tma_prefetch_map(&tdo);
        mbar_arrive_expect_tx(full_kv, 2 * C::kKVBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(k_s + p * C::kKVPanel, &tk, full_kv, p * kPanelCols, h,
                      k0, b);
          tma_load_4d(v_s + p * C::kKVPanel, &tv, full_kv, p * kPanelCols, h,
                      k0, b);
        }
      }
      // (b, h)'s lse and di rows; the warp's lanes copy a tile's rows
      // into the stage (zero past L) and arrive on its full barrier.
      const int64_t row0 = (static_cast<int64_t>(b) * H + h) * L;
      const int lane = threadIdx.x % 32;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int q0 = (first + j) * kBM;
        mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        if (leader) {
          mbar_arrive_expect_tx(full(s), 2 * C::kQBytes);
          for (int p = 0; p < C::kPanels; ++p) {
            tma_load_4d(q_s + s * C::kQBytes + p * C::kQPanel, &tq, full(s),
                        p * kPanelCols, h, q0, b);
            tma_load_4d(do_s + s * C::kQBytes + p * C::kQPanel, &tdo,
                        full(s), p * kPanelCols, h, q0, b);
          }
        }
        float* lse_t = reinterpret_cast<float*>(
            at(lse_s + s * C::kRowBytesF32));
        float* di_t = reinterpret_cast<float*>(at(di_s + s * C::kRowBytesF32));
        for (int r = lane; r < kBM; r += 32) {
          const bool in = q0 + r < L;
          lse_t[r] = in ? lse[row0 + q0 + r] : 0.f;
          di_t[r] = in ? di[row0 + q0 + r] : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // Consumers: c = 0 owns dV, c = 1 owns dK (see the header).
  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;  // fragment row group
  const int t = tid & 3;          // thread in group
  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8

  float acc[D / 2];  // dV or dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[kBM / 2];           // S^T, then P^T (c = 0); dP^T, then dS^T
  uint32_t pa[kBM / 16][4];    // P^T or dS^T, the A operand
  // The scores product reads K (c = 0) or V (c = 1) against Q or dO of
  // the stage; the gradient product reads dO (c = 0) or Q (c = 1).
  const uint32_t kv_tile = c == 0 ? k_s : v_s;
  const uint32_t scores_b = c == 0 ? q_s : do_s;
  const uint32_t grad_b = c == 0 ? do_s : q_s;
  // Uniform across the warpgroup: does tile j cross the diagonal or L?
  auto masked = [&](int q0) {
    return (kCausal && q0 < k0 + kBlockN - 1) || q0 + kBM > L;
  };

  mbar_wait(full_kv, 0);
  mbar_wait(full(0), 0);
  issue_kmajor<T, D, kBM, C::kKVPanel, C::kQPanel>(sc, kv_tile, scores_b);
  wgmma_wait<0>();
  reg_fence(sc);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int q0 = (first + j) * kBM;
    // P^T's slot for this tile, in float4s: 16 bytes of thread tid at
    // [n * 128 + tid], the order of the scores accumulator.
    const int b_slot = j % C::kSlots;
    const int use = j / C::kSlots;  // this slot's use number
    float4* const slot = reinterpret_cast<float4*>(
        at(slot_s + b_slot * C::kSlotBytes));
    if (c == 0) {
      // P^T = exp2(scale_log2 S^T - lse log2e), zero above the diagonal
      // and for queries at or past L.
      const float* lse_t = reinterpret_cast<const float*>(
          at(lse_s + s * C::kRowBytesF32));
      const bool mask = masked(q0);
#pragma unroll
      for (int n = 0; n < kBM / 8; ++n) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_t + 8 * n + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * n + 2 * t + (i & 1);  // query in the tile
          float x = exp2f(fmaf(sc[4 * n + i], scale_log2,
                               -((i & 1) ? l2.y : l2.x) * kLog2e));
          if (mask) {
            const int key = key0 + 8 * (i >> 1);
            if ((kCausal && key > q0 + col) || q0 + col >= L) x = 0.f;
          }
          sc[4 * n + i] = x;
        }
      }
      // Hand P^T to warpgroup 1 once it has read this slot's last use.
      if (use > 0) mbar_wait(slot_empty(b_slot), (use - 1) & 1);
#pragma unroll
      for (int n = 0; n < kBM / 8; ++n)
        slot[n * kWgThreads + tid] =
            make_float4(sc[4 * n], sc[4 * n + 1], sc[4 * n + 2],
                        sc[4 * n + 3]);
      mbar_arrive(slot_full(b_slot));
    } else {
      // dS^T = P^T (dP^T - di), P^T from warpgroup 0's slot; zero for
      // queries at or past L.
      const float* di_t = reinterpret_cast<const float*>(
          at(di_s + s * C::kRowBytesF32));
      const bool ragged = q0 + kBM > L;
      mbar_wait(slot_full(b_slot), use & 1);
#pragma unroll
      for (int n = 0; n < kBM / 8; ++n) {
        const float4 p = slot[n * kWgThreads + tid];
        const float2 d2 =
            *reinterpret_cast<const float2*>(di_t + 8 * n + 2 * t);
        sc[4 * n] = p.x * (sc[4 * n] - d2.x);
        sc[4 * n + 1] = p.y * (sc[4 * n + 1] - d2.y);
        sc[4 * n + 2] = p.z * (sc[4 * n + 2] - d2.x);
        sc[4 * n + 3] = p.w * (sc[4 * n + 3] - d2.y);
        if (ragged) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (q0 + 8 * n + 2 * t + (i & 1) >= L) sc[4 * n + i] = 0.f;
        }
      }
      mbar_arrive(slot_empty(b_slot));
    }
    // The gradient product of tile j - 1 has retired (nothing is in
    // flight at j = 0): release its stage and take the A operand's
    // registers for tile j.
    wgmma_wait<0>();
    reg_fence(acc);
    if (j > 0) mbar_arrive(empty((j - 1) % kStages));
    pack_a<T, kBM>(pa, sc);
    if (j + 1 == n_tiles) break;
    // The scores product of tile j + 1, then the gradient product of
    // tile j; tile j + 1's scores are worked on while the latter runs.
    const int sn = (j + 1) % kStages;
    mbar_wait(full(sn), ((j + 1) / kStages) & 1);
    issue_kmajor<T, D, kBM, C::kKVPanel, C::kQPanel>(
        sc, kv_tile, scores_b + sn * C::kQBytes);
    issue_rs<T, kBM, D, C::kQPanel>(acc, pa, grad_b + s * C::kQBytes);
    wgmma_wait<1>();
    reg_fence(sc);
  }
  // The last tile's gradient product.
  const int sl = (n_tiles - 1) % kStages;
  issue_rs<T, kBM, D, C::kQPanel>(acc, pa, grad_b + sl * C::kQBytes);
  wgmma_wait<0>();
  reg_fence(acc);
  mbar_arrive(empty(sl));

  // dV into K's tile and dK into V's: each consumer is the only reader
  // of the tile it overwrites, and its last product has retired.
  if (c == 0)
    store_tile<T, D, C::kKVPanel>(acc, 1.f, at(k_s), dv, 0, k0, L, H, h, b);
  else
    store_tile<T, D, C::kKVPanel>(acc, scale, at(v_s), dk, 1, k0, L, H, h,
                                  b);
}

// ---------------------------------------------------------------------------
// dQ, bf16 or f16 (T): one CTA per (query tile, h, b), see the header.

template <int D>
struct DqTiles {
  // Consumer warpgroups of 64 query rows: two, but one at D = 256, where
  // two would need 256 KB of shared memory.
  static constexpr int kConsumers = D == 256 ? 1 : 2;
  static constexpr int kBlockM = 64 * kConsumers;  // query rows per CTA
  static constexpr int kThreads = kWgThreads * (1 + kConsumers);
  // setmaxnreg budgets: 24 + 2 x 240 of three warpgroups' 3 x 168 at
  // launch; 56 + 256 of two warpgroups' 2 x 255.
  static constexpr int kProducerRegs = kConsumers == 2 ? 24 : 56;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 256;
  // Three stages where shared memory allows; two at D = 256.
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kQPanel = kBlockM * kRowBytes;   // bytes
  static constexpr int kKVPanel = kBlockN * kRowBytes;
  static constexpr int kQBytes = kQPanel * kPanels;     // the Q or dO tile
  static constexpr int kKVBytes = kKVPanel * kPanels;   // one K or V tile
  static constexpr int kRowBytesF32 = kBlockM * 4;      // lse or di
  // Q, dO; K and V of every stage; lse and di.
  static constexpr int kTileBytes =
      2 * kQBytes + 2 * kStages * kKVBytes + 2 * kRowBytesF32;
  // Barriers after the tiles: Q; per stage K full, V full, K empty, V
  // empty. 1024 bytes of slack to align the base.
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kSmemBytes = kTileBytes + 8 * kBarriers + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
};

// dS = P (dP - di) in place over dP, with P = exp2(scale_log2 S - lse)
// (lse in the log2 domain) from S, zero above the diagonal and at keys
// past L when `masked`. row0 and row0 + 8 are this thread's query rows.
template <int kBlockN, bool kCausal>
__device__ __forceinline__ void form_ds(const float (&sc)[kBlockN / 2],
                                        float (&dp)[kBlockN / 2],
                                        bool masked, int k0, int row0, int t,
                                        int L, float scale_log2, float lse0,
                                        float lse1, float di0, float di1) {
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool hi = i >= 2;
      float p = exp2f(fmaf(sc[4 * n + i], scale_log2, -(hi ? lse1 : lse0)));
      if (masked) {
        const int key = k0 + 8 * n + 2 * t + (i & 1);
        if ((kCausal && key > row0 + (hi ? 8 : 0)) || key >= L) p = 0.f;
      }
      dp[4 * n + i] = p * (dp[4 * n + i] - (hi ? di1 : di0));
    }
  }
}

template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, T* __restrict__ dq,
                       int L, int H, float scale, float scale_log2) {
  using C = DqTiles<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + C::kQBytes;
  const uint32_t k_s = do_s + C::kQBytes;             // + stage * kKVBytes
  const uint32_t v_s = k_s + kStages * C::kKVBytes;   // + stage * kKVBytes
  const uint32_t lse_s = v_s + kStages * C::kKVBytes;
  const uint32_t di_s = lse_s + C::kRowBytesF32;
  const uint32_t bars = di_s + C::kRowBytesF32;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8u * (1 + s); };
  auto full_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };
  auto at = [&](uint32_t a) { return smem + (a - base); };

  // Longest causal rows first: the last query tile has the most keys.
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = q_tile * C::kBlockM;
  // The key tiles that rows below row_end see (>= 1: q0 < L).
  auto key_tiles = [&](int row_end) {
    return ((kCausal ? min(row_end, L) : L) + kBlockN - 1) / kBlockN;
  };
  // Warp-uniform as far as the compiler can tell, so that each role's
  // register budget (setmaxnreg) holds for its whole branch.
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / kWgThreads, 0);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1 + 32);  // the TMA leader, then warp 0's rows
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), C::kConsumers * kWgThreads);
      mbar_init(empty_v(s), C::kConsumers * kWgThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: warp 0 keeps the ring full, one elected thread issuing
    // every load. A stage is free once every consumer released its last
    // use; a fresh barrier passes the wait on the opposite parity at
    // once. The last consumer sees every tile the CTA loads.
    setmaxnreg_dec<C::kProducerRegs>();
    const int warp = __shfl_sync(0xffffffff, (threadIdx.x / 32) % 4, 0);
    if (warp == 0) {
      const bool leader = elect_one();
      if (leader) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        tma_prefetch_map(&tdo);
        mbar_arrive_expect_tx(full_q, 2 * C::kQBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(q_s + p * C::kQPanel, &tq, full_q, p * kPanelCols, h,
                      q0, b);
          tma_load_4d(do_s + p * C::kQPanel, &tdo, full_q, p * kPanelCols,
                      h, q0, b);
        }
      }
      // The tile's lse (log2 domain) and di rows, zero past L, copied by
      // the warp's lanes; each arrives on Q's barrier.
      const int64_t row0 = (static_cast<int64_t>(b) * H + h) * L + q0;
      float* lse_t = reinterpret_cast<float*>(at(lse_s));
      float* di_t = reinterpret_cast<float*>(at(di_s));
      for (int r = threadIdx.x % 32; r < C::kBlockM; r += 32) {
        const bool in = q0 + r < L;
        lse_t[r] = in ? lse[row0 + r] * kLog2e : 0.f;
        di_t[r] = in ? di[row0 + r] : 0.f;
      }
      mbar_arrive(full_q);
      const int n_tiles = key_tiles(q0 + C::kBlockM);
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
    return;
  }

  // Consumers: warpgroup c takes query rows 64c..64c+63 of the tile.
  setmaxnreg_inc<C::kConsumerRegs>();
  const int c = wg - 1;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32;
  const int g = (tid % 32) >> 2;  // fragment row group
  const int t = tid & 3;          // thread in group
  const int wrow0 = q0 + 64 * c;  // the warpgroup's first row
  const int r0 = 64 * c + 16 * warp + g;  // this thread's rows in the
  const int row0 = q0 + r0;               // tile: r0 and r0 + 8
  const int n_tiles = key_tiles(wrow0 + 64);

  float acc[D / 2];  // dQ
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[kBlockN / 2];         // S
  float dp[kBlockN / 2];         // dP, then dS
  uint32_t pa[kBlockN / 16][4];  // dS, the A operand of dS K
  const uint32_t qa = q_s + 64 * c * kRowBytes;   // this warpgroup's rows
  const uint32_t doa = do_s + 64 * c * kRowBytes;
  // Uniform across the warpgroup: does the tile at k0 cross the diagonal
  // or L?
  auto masked = [&](int k0) {
    return (kCausal && k0 + kBlockN - 1 > wrow0) || k0 + kBlockN > L;
  };

  mbar_wait(full_q, 0);
  const float* lse_t = reinterpret_cast<const float*>(at(lse_s));
  const float* di_t = reinterpret_cast<const float*>(at(di_s));
  const float lse0 = lse_t[r0], lse1 = lse_t[r0 + 8];
  const float di0 = di_t[r0], di1 = di_t[r0 + 8];

  // Each key tile in turn: S and dP, dS over dP, then dQ += dS K; the
  // two consumers' products interleave on the tensor cores.
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = j * kBlockN;
    mbar_wait(full_k(s), parity);
    issue_kmajor<T, D, kBlockN, C::kQPanel, C::kKVPanel>(
        sc, qa, k_s + s * C::kKVBytes);
    mbar_wait(full_v(s), parity);
    issue_kmajor<T, D, kBlockN, C::kQPanel, C::kKVPanel>(
        dp, doa, v_s + s * C::kKVBytes);
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    mbar_arrive(empty_v(s));
    form_ds<kBlockN, kCausal>(sc, dp, masked(k0), k0, row0, t, L,
                              scale_log2, lse0, lse1, di0, di1);
    pack_a<T, kBlockN>(pa, dp);
    issue_rs<T, kBlockN, D, C::kKVPanel>(acc, pa, k_s + s * C::kKVBytes);
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(empty_k(s));
  }

  // dQ into this warpgroup's own rows of the Q tile: its last product
  // has retired and no other warpgroup reads them.
  store_tile<T, D, C::kQPanel>(acc, scale, at(qa), dq, c, wrow0, L, H, h,
                               b);
}

// ---------------------------------------------------------------------------
// float32: one thread per key row (dK/dV) or query row (dQ), the other
// side streamed through static shared memory kRowTile rows at a time
// (rows past L zero-filled; a thread whose row is past L computes on
// zeros and stores nothing).

constexpr int kRowTile = 16;
constexpr int kF32Threads = 64;  // rows per CTA

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

// CTAs along L for tiles of `rows` rows.
int tiles(int L, int rows) { return (L + rows - 1) / rows; }

// The tensor maps of q, k, v and dO (in that order) of a 16-bit kernel
// that reads q and dO in boxes of q_rows rows and k, v in boxes of
// kBlockN: 0, or kTensorMapError + the CUresult of the failed encode.
template <typename T, int D>
int encode_maps(const Args& a, int q_rows, CUtensorMap (&m)[4]) {
  constexpr bool kF16 = !kIsBf16<T>;
  const Strides& st = a.st;
  int err = encode(&m[0], a.q, kF16, a.B, a.L, a.H, D, st.qb, st.ql, st.qh,
                   q_rows);
  if (err == 0)
    err = encode(&m[1], a.k, kF16, a.B, a.L, a.H, D, st.kb, st.kl, st.kh,
                 kBlockN);
  if (err == 0)
    err = encode(&m[2], a.v, kF16, a.B, a.L, a.H, D, st.vb, st.vl, st.vh,
                 kBlockN);
  if (err == 0)
    err = encode(&m[3], a.dout, kF16, a.B, a.L, a.H, D, st.db, st.dl, st.dh,
                 q_rows);
  return err;
}

template <typename T, int D, bool kCausal>
int dkv_wgmma(const Args& a) {
  using C = DkvTiles<D>;
  CUtensorMap m[4];
  const int err = encode_maps<T, D>(a, C::kBlockM, m);
  if (err != 0) return err;
  auto kernel = flash_bwd_dkv_wgmma<T, D, kCausal>;
  const cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<dim3(tiles(a.L, kBlockN), a.H, a.B), kDkvThreads, C::kSmemBytes,
           a.stream>>>(m[0], m[1], m[2], m[3], a.lse, a.di,
                       static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.L,
                       a.H, a.scale, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kCausal>
int dq_wgmma(const Args& a) {
  using C = DqTiles<D>;
  CUtensorMap m[4];
  const int err = encode_maps<T, D>(a, C::kBlockM, m);
  if (err != 0) return err;
  auto kernel = flash_bwd_dq_wgmma<T, D, kCausal>;
  const cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  kernel<<<dim3(tiles(a.L, C::kBlockM), a.H, a.B), C::kThreads,
           C::kSmemBytes, a.stream>>>(m[0], m[1], m[2], m[3], a.lse, a.di,
                                      static_cast<T*>(a.dq), a.L, a.H,
                                      a.scale, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int dkv_f32(const Args& a) {
  flash_bwd_dkv_f32<D, kCausal>
      <<<dim3(tiles(a.L, kF32Threads), a.H, a.B), kF32Threads, 0,
         a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
          a.L, a.H, a.st, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCausal>
int dq_f32(const Args& a) {
  flash_bwd_dq_f32<D, kCausal>
      <<<dim3(tiles(a.L, kF32Threads), a.H, a.B), kF32Threads, 0,
         a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
          a.lse, a.di, static_cast<float*>(a.dq), a.L, a.H, a.st, a.scale);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*Launcher)(const Args&);

// The 16-bit kernels take any L in one instantiation each.
template <typename T, int D>
Launcher pick_16(bool dkv, int causal) {
  if (dkv) return causal ? dkv_wgmma<T, D, true> : dkv_wgmma<T, D, false>;
  return causal ? dq_wgmma<T, D, true> : dq_wgmma<T, D, false>;
}

template <int D>
Launcher pick(bool dkv, int dtype, int causal) {
  if (dtype == 1) {
    if (dkv) return causal ? dkv_f32<D, true> : dkv_f32<D, false>;
    return causal ? dq_f32<D, true> : dq_f32<D, false>;
  }
  return dtype == 2 ? pick_16<f16, D>(dkv, causal)
                    : pick_16<bf16, D>(dkv, causal);
}

int launch(bool dkv, int dtype, int D, int causal, const Args& a) {
  if (a.L < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Launcher fn = nullptr;
  switch (D) {
    case 64: fn = pick<64>(dkv, dtype, causal); break;
    case 128: fn = pick<128>(dkv, dtype, causal); break;
    case 256: fn = pick<256>(dkv, dtype, causal); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(a);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32, 2 = float16. L >= 1. Strides are in
// elements (q, k, v, dO, each (b, l, h)); the head dim must be
// contiguous. lse and di are (B, H, L) float32, contiguous; the outputs
// are (B, L, H, D), contiguous. Each returns the cudaError_t of its
// launch, or, for a 16-bit launch, kTensorMapError + the CUresult of a
// failed tensor-map encode.
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

// The 16-bit kernels' dynamic shared memory for head dim D (0 for a D
// they are not built for); ptxas reports only static shared memory.
extern "C" int hvd_flash_attention_bwd_dkv_smem_bytes(int D) {
  switch (D) {
    case 64: return DkvTiles<64>::kSmemBytes;
    case 128: return DkvTiles<128>::kSmemBytes;
    case 256: return DkvTiles<256>::kSmemBytes;
    default: return 0;
  }
}

extern "C" int hvd_flash_attention_bwd_dq_smem_bytes(int D) {
  switch (D) {
    case 64: return DqTiles<64>::kSmemBytes;
    case 128: return DqTiles<128>::kSmemBytes;
    case 256: return DqTiles<256>::kSmemBytes;
    default: return 0;
  }
}
