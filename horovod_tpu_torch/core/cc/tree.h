// Hierarchical control-plane tree: topology arithmetic, rank
// bitsets, and the aggregated-announcement containers shared by
// controller.cc, the stress binaries, and tree_unit.cc.
//
// The flat star (every worker connected to the rank-0 coordinator)
// makes the root's per-cycle work O(N) ingest + O(N) fan-out; the
// measured agreement curve (benchmarks/control_plane_scale.md) grows
// superlinearly with world size and blows the 5 ms cycle budget
// somewhere past a few hundred ranks. This header is the pure logic
// of the fix: workers attach to intermediate aggregators
// (HOROVOD_CONTROL_TREE_ARITY fan-out) that merge readiness bitsets
// and request metadata upward and relay the agreed batch downward,
// so every node — including the root — touches O(arity) connections
// per cycle. No sockets here; everything is unit-testable
// (core/cc/tree_unit.cc).
//
// Reference analog: gloo's tree broadcast/rendezvous gave the
// reference this property for free (horovod/common/gloo/
// gloo_controller.cc); this build's point-to-point TCP control plane
// has to earn it explicitly.
// Thread-safety contract: nothing in this header locks. RankSet and
// AggMap/AggEntry are plain containers mutated by whichever
// controller thread holds the owning mutex — the GUARDED_BY
// declarations on `Controller::tensors_` / `agg_pending_` /
// `agg_reported_` (controller.h, thread_annotations.h) ARE the
// contract, and clang's -Wthread-safety leg of `make check` enforces
// it at every access. Keeping the containers lock-free is what lets
// the word-aligned bitset unions stay branch-and-allocation-free on
// the ingest hot path.
#pragma once

#include <cstdint>
#include <map>
#include <string>
#include <vector>

#include "thread_annotations.h"
#include "wire.h"

namespace hvdtpu {

// ---------------------------------------------------------------------------
// topology: contiguous-interval A-ary tree over ranks [0, size)
// ---------------------------------------------------------------------------
//
// The subtree rooted at `lo` owns the contiguous interval [lo, hi);
// its children are the first ranks of up to `arity` near-equal
// chunks of [lo+1, hi). Rank 0 is the root/coordinator. Contiguous
// subtrees keep readiness bitsets dense and make "which aggregator
// owns rank r" pure arithmetic on every node — no topology exchange
// on the wire. arity < 2 degenerates to the flat star.

struct TreePlace {
  int parent = -1;            // -1 for the root
  int tier = 0;               // 0 = root, 1 = attached to root, ...
  int lo = 0, hi = 0;         // this rank's subtree interval [lo, hi)
  std::vector<int> children;  // direct children, ascending
};

inline TreePlace TreePlaceOf(int rank, int size, int arity) {
  TreePlace p;
  p.lo = 0;
  p.hi = size;
  if (size <= 1) return p;
  if (arity < 2) {  // flat star
    if (rank == 0) {
      p.children.reserve(static_cast<size_t>(size - 1));
      for (int r = 1; r < size; ++r) p.children.push_back(r);
    } else {
      p.parent = 0;
      p.tier = 1;
      p.lo = rank;
      p.hi = rank + 1;
    }
    return p;
  }
  int lo = 0, hi = size;
  while (rank != lo) {
    // Descend into the chunk of [lo+1, hi) containing `rank`. The
    // first `rem` chunks carry one extra rank.
    int m = hi - lo - 1;
    int k = m < arity ? m : arity;
    int base = m / k, rem = m % k;
    int idx = rank - (lo + 1);
    int big = (base + 1) * rem;  // ranks covered by the big chunks
    int c, len;
    if (idx < big) {
      c = idx / (base + 1);
      len = base + 1;
    } else {
      c = rem + (idx - big) / base;
      len = base;
    }
    int start = lo + 1 + c * base + (c < rem ? c : rem);
    p.parent = lo;
    ++p.tier;
    lo = start;
    hi = start + len;
  }
  p.lo = lo;
  p.hi = hi;
  int m = hi - lo - 1;
  if (m > 0) {
    int k = m < arity ? m : arity;
    int base = m / k, rem = m % k;
    for (int c = 0; c < k; ++c)
      p.children.push_back(lo + 1 + c * base + (c < rem ? c : rem));
  }
  return p;
}

// Total tiers below the root (max tier over all ranks): 1 for the
// flat star, ceil-log_arity-ish for trees.
inline int TreeDepthOf(int size, int arity) {
  if (size <= 1) return 0;
  if (arity < 2) return 1;
  int d = 0, m = size;  // m = current (biggest) subtree size
  while (m > 1) {
    int below = m - 1;
    int k = below < arity ? below : arity;
    m = (below + k - 1) / k;  // biggest child chunk
    ++d;
  }
  return d;
}

// ---------------------------------------------------------------------------
// RankSet: dense readiness bitset over a contiguous rank interval
// ---------------------------------------------------------------------------
//
// The unit aggregators merge and the root stores per tensor
// (TensorState.ready_ranks): one bit per rank, O(N/64) unions,
// popcount-tracked cardinality — at 1024 ranks a full world set is
// 128 bytes, vs. a per-rank red-black node in the old std::set<int>
// (thousands of allocator round-trips per cycle at scale).

class RankSet {
 public:
  RankSet() = default;
  RankSet(int lo, int hi)
      : lo_(lo), hi_(hi < lo ? lo : hi),
        words_((static_cast<size_t>(hi_ - lo_) + 63) / 64, 0) {}

  int lo() const { return lo_; }
  int hi() const { return hi_; }
  int count() const { return count_; }

  bool test(int rank) const {
    if (rank < lo_ || rank >= hi_) return false;
    size_t i = static_cast<size_t>(rank - lo_);
    return (words_[i >> 6] >> (i & 63)) & 1u;
  }

  // True if the bit was newly set; out-of-range ranks are rejected.
  bool set(int rank) {
    if (rank < lo_ || rank >= hi_) return false;
    size_t i = static_cast<size_t>(rank - lo_);
    uint64_t bit = 1ull << (i & 63);
    if (words_[i >> 6] & bit) return false;
    words_[i >> 6] |= bit;
    ++count_;
    return true;
  }

  // Visit set ranks in ascending order.
  template <typename F>
  void ForEach(F f) const {
    for (size_t w = 0; w < words_.size(); ++w) {
      uint64_t bits = words_[w];
      while (bits) {
        int b = __builtin_ctzll(bits);
        bits &= bits - 1;
        f(lo_ + static_cast<int>(w * 64) + b);
      }
    }
  }

  // Union `o` into this set. False (and no change) when `o` does not
  // fit inside this set's interval — the caller treats that as a
  // malformed frame. Word-aligned fast path when the offsets line up
  // (the common case: world-rooted sets at every tier).
  bool OrWith(const RankSet& o) {
    if (o.count_ == 0) return true;
    if (o.lo_ < lo_ || o.hi_ > hi_) return false;
    if (((o.lo_ - lo_) & 63) == 0) {
      size_t shift = static_cast<size_t>(o.lo_ - lo_) >> 6;
      int newly = 0;
      for (size_t w = 0; w < o.words_.size(); ++w) {
        uint64_t add = o.words_[w] & ~words_[shift + w];
        words_[shift + w] |= add;
        newly += __builtin_popcountll(add);
      }
      count_ += newly;
      return true;
    }
    o.ForEach([&](int r) { set(r); });
    return true;
  }

  void PutTo(Buf* b) const {
    b->PutU32(static_cast<uint32_t>(lo_));
    b->PutU32(static_cast<uint32_t>(hi_ - lo_));
    for (uint64_t w : words_) b->PutU64(w);
  }

  bool GetFrom(Reader* rd) {
    uint32_t lo, nbits;
    if (!rd->GetU32(&lo) || !rd->GetU32(&nbits)) return false;
    // Wire-controlled width: cap it so a lying header cannot force a
    // huge allocation (1M ranks is far beyond any supported world).
    if (lo > (1u << 20) || nbits > (1u << 20)) return false;
    lo_ = static_cast<int>(lo);
    hi_ = lo_ + static_cast<int>(nbits);
    words_.assign((nbits + 63) / 64, 0);
    count_ = 0;
    for (size_t w = 0; w < words_.size(); ++w) {
      if (!rd->GetU64(&words_[w])) return false;
      count_ += __builtin_popcountll(words_[w]);
    }
    // Bits past nbits would desync count_ from ForEach — reject.
    uint32_t tail = nbits & 63;
    if (tail && words_.size() &&
        (words_.back() >> tail) != 0)
      return false;
    return true;
  }

  bool operator==(const RankSet& o) const {
    return lo_ == o.lo_ && hi_ == o.hi_ && words_ == o.words_;
  }

 private:
  int lo_ = 0, hi_ = 0;
  std::vector<uint64_t> words_;
  int count_ = 0;
};

// ---------------------------------------------------------------------------
// AggEntry: one merged announcement (the kReadyAgg wire unit)
// ---------------------------------------------------------------------------
//
// An aggregator folds its children's kReady/kReadyAgg frames plus its
// own submissions into a map of these: identical announcements from
// many ranks dedup into ONE entry with a rank bitset; per-rank
// request metadata (uneven allgather rows, alltoall splits) stays
// rank-attributed so the root can aggregate it exactly as it does
// for direct connections. Announcements that disagree on (name, sig)
// deliberately do NOT merge — they arrive at the root as separate
// entries and trip its existing cross-rank mismatch check.

struct AggEntry {
  uint32_t cache_id = 0;  // nonzero = response-cache announcement
  bool join = false;      // join pseudo-request (name/sig unused)
  std::string name;
  std::string sig;
  int64_t nbytes = 0;
  RankSet ranks;                      // who announced this
  std::map<int, std::string> metas;   // per-world-rank metadata
};

using AggMap = std::map<std::string, AggEntry>;

inline std::string AggKey(uint32_t cache_id, bool join,
                          const std::string& name,
                          const std::string& sig,
                          const std::string& meta) {
  if (join) return std::string(1, '\x01');
  std::string k;
  if (cache_id != 0) {
    k.push_back('\x02');
    k.append(reinterpret_cast<const char*>(&cache_id),
             sizeof(cache_id));
  } else {
    k.push_back('\x03');
    k += name;
    k.push_back('\x00');
    k += sig;
  }
  if (!meta.empty()) {
    // Meta varies per rank; entries with metadata still merge (the
    // metas map is rank-keyed), so the key ignores the VALUE — this
    // marker only keeps meta-carrying announcements from merging
    // with meta-less ones for the same name (distinct rounds).
    k.push_back('\x04');
  }
  return k;
}

inline AggEntry& MergeSlot(AggMap* m, int world_size, uint32_t cache_id,
                           bool join, const std::string& name,
                           const std::string& sig, int64_t nbytes,
                           const std::string& meta_marker) {
  std::string key = AggKey(cache_id, join, name, sig, meta_marker);
  auto it = m->find(key);
  if (it == m->end()) {
    AggEntry e;
    e.cache_id = cache_id;
    e.join = join;
    e.name = name;
    e.sig = sig;
    e.nbytes = nbytes;
    e.ranks = RankSet(0, world_size);
    it = m->emplace(std::move(key), std::move(e)).first;
  }
  return it->second;
}

// Fold one child Request (or this node's own submission) in,
// attributed to `rank`.
inline void MergeRequest(AggMap* m, int world_size, int rank,
                         const Request& r) {
  AggEntry& e = MergeSlot(m, world_size, r.cache_id, r.join, r.name,
                          r.sig, r.nbytes, r.meta);
  e.ranks.set(rank);
  if (!r.meta.empty()) e.metas[rank] = r.meta;
}

// Fold one child aggregator's entry in (bitset union + meta merge).
// False when the entry's rank interval does not fit the world — a
// malformed frame the caller drops.
inline bool MergeAgg(AggMap* m, int world_size, const AggEntry& in) {
  if (in.ranks.lo() < 0 || in.ranks.hi() > world_size) return false;
  AggEntry& e = MergeSlot(m, world_size, in.cache_id, in.join, in.name,
                          in.sig, in.nbytes,
                          in.metas.empty() ? std::string()
                                           : std::string("m"));
  if (!e.ranks.OrWith(in.ranks)) return false;
  for (const auto& kv : in.metas) e.metas[kv.first] = kv.second;
  return true;
}

// --- kReadyAgg wire format ------------------------------------------------
// [u32 count] then per entry:
//   u8 tag: 0 = full, 1 = cached, 2 = join
//   full:   str name, str sig, u64 nbytes
//   cached: u32 cache_id
//   join:   (nothing)
//   rank set: u32 lo, u32 nbits, nwords x u64
//   u32 nmetas, then nmetas x (u32 rank, str meta)

inline std::string SerializeAgg(const AggMap& m) {
  Buf b;
  b.PutU32(static_cast<uint32_t>(m.size()));
  for (const auto& kv : m) {
    const AggEntry& e = kv.second;
    if (e.join) {
      b.PutU8(2);
    } else if (e.cache_id != 0) {
      b.PutU8(1);
      b.PutU32(e.cache_id);
    } else {
      b.PutU8(0);
      b.PutStr(e.name);
      b.PutStr(e.sig);
      b.PutU64(static_cast<uint64_t>(e.nbytes));
    }
    e.ranks.PutTo(&b);
    b.PutU32(static_cast<uint32_t>(e.metas.size()));
    for (const auto& mkv : e.metas) {
      b.PutU32(static_cast<uint32_t>(mkv.first));
      b.PutStr(mkv.second);
    }
  }
  return b.data();
}

inline bool ParseAgg(const std::string& d, std::vector<AggEntry>* out) {
  Reader rd(d);
  uint32_t n;
  if (!rd.GetU32(&n)) return false;
  out->clear();
  // Every entry costs >= 10 payload bytes; an impossible count is a
  // lying header (see ParseRequests for the rationale).
  if (n > d.size()) return false;
  out->reserve(n < 4096 ? n : 4096);
  for (uint32_t i = 0; i < n; ++i) {
    AggEntry e;
    uint8_t tag;
    if (!rd.GetU8(&tag)) return false;
    if (tag == 2) {
      e.join = true;
    } else if (tag == 1) {
      if (!rd.GetU32(&e.cache_id)) return false;
    } else if (tag == 0) {
      uint64_t nb;
      if (!rd.GetStr(&e.name) || !rd.GetStr(&e.sig) || !rd.GetU64(&nb))
        return false;
      e.nbytes = static_cast<int64_t>(nb);
    } else {
      return false;
    }
    if (!e.ranks.GetFrom(&rd)) return false;
    uint32_t nm;
    if (!rd.GetU32(&nm)) return false;
    if (nm > d.size()) return false;
    for (uint32_t j = 0; j < nm; ++j) {
      uint32_t rank;
      std::string meta;
      if (!rd.GetU32(&rank) || !rd.GetStr(&meta)) return false;
      if (rank > (1u << 20)) return false;
      e.metas[static_cast<int>(rank)] = std::move(meta);
    }
    out->push_back(std::move(e));
  }
  return true;
}

}  // namespace hvdtpu
