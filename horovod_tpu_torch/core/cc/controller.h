// Negotiated-cycle controller: the native control plane.
//
// TPU-native re-design of the reference's background-thread core
// (reference: horovod/common/operations.cc BackgroundThreadLoop /
// RunLoopOnce; horovod/common/controller.cc Controller::
// ComputeResponseList / FuseResponses; horovod/common/tensor_queue.cc;
// horovod/common/stall_inspector.cc; horovod/common/response_cache.cc).
//
// What it does: every cycle (HOROVOD_CYCLE_TIME ms) each rank drains
// its pending-tensor queue and reports readiness to the rank-0
// coordinator over persistent TCP (wire.h). The coordinator counts
// readiness per tensor name, validates signature consistency across
// ranks (mismatch -> clean error entry, not a hang), greedily fuses
// fully-ready tensors with equal fuse-keys into batches up to the
// fusion threshold, and broadcasts one ordered entry list — identical
// on every rank, which is the whole point (SPMD programs must launch
// in an agreed order). Execution of the batches (the data plane) is
// NOT here: Python pulls agreed batches via NextBatch() and launches
// the fused XLA collectives.
//
// Deliberate departures from the reference:
//  * No MPI/gloo: transport is plain sockets; bootstrap address comes
//    from the launcher (HOROVOD_CONTROL_ADDR).
//  * No FlatBuffers: dependency-free length-prefixed binary format.
//  * Response cache uses coordinator-assigned u32 ids instead of the
//    reference's bit-vector AND-exchange: once a (name, sig) has been
//    agreed, workers announce readiness with a 5-byte id instead of
//    re-serializing name+sig+shape each cycle. Ids are never reused
//    (capacity bounds insertion, not eviction), so worker caches
//    cannot go stale; a sig change (e.g. dynamic loss-scale factors)
//    misses the cache and renegotiates cleanly.
#pragma once

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "tree.h"
#include "wire.h"

namespace hvdtpu {

struct ControllerOptions {
  int rank = 0;
  int size = 1;
  std::string coord_host = "127.0.0.1";
  int coord_port = 0;            // 0 with size==1 -> no sockets
  int64_t fusion_threshold = 64 << 20;
  double cycle_time_ms = 1.0;
  double stall_warn_s = 60.0;
  double stall_kill_s = 0.0;     // 0 = never
  double connect_timeout_s = 30.0;
  // Response cache capacity (reference: HOROVOD_CACHE_CAPACITY,
  // response_cache.cc). 0 disables caching entirely.
  int cache_capacity = 1024;
  // Per-job secret (HOROVOD_SECRET) for the rank-rendezvous mutual
  // challenge-response (HMAC-SHA256, sha256.h): the coordinator
  // challenges each connection with a fresh nonce and only hands out
  // a rank slot for a valid MAC (replay of a captured handshake is
  // useless — the nonce differs); the worker likewise verifies the
  // coordinator's MAC over its own nonce before trusting agreed
  // batches. Empty = unauthenticated (single-user runs without a
  // launcher secret), matching runner/secret.py verify() semantics.
  std::string auth_secret;
  // Hierarchical control tree (HOROVOD_CONTROL_TREE_ARITY; tree.h):
  // < 2 keeps the flat star. With a tree, non-root ranks connect to
  // their TreePlaceOf parent instead of rank 0, aggregator ranks
  // (those with children) listen for their subtree on listen_port,
  // merge readiness bitsets upward (kReadyAgg) and relay agreed
  // batches downward through the same broadcast pump the root uses.
  int tree_arity = 0;
  std::string parent_host;  // empty = coord_host
  int parent_port = 0;      // 0 = coord_port (the flat default)
  int listen_port = 0;      // aggregator ranks only (root: coord_port)
  // Aggregation window: after the first upward wake an aggregator
  // lingers this long so sibling subtrees' frames land in the SAME
  // forwarded frame (one kReadyAgg per tier per burst instead of one
  // per child). 0 forwards eagerly.
  int agg_linger_us = 200;
};

// Sentinel entry name broadcast when every rank has joined
// (reference: JoinOp completion).
extern const char kAllJoined[];

class Controller {
 public:
  explicit Controller(const ControllerOptions& opts);
  ~Controller();

  // Frontend (any thread): announce a pending tensor. sig encodes
  // "dtype|op|shape..." and doubles as the fuse key prefix
  // (everything before the first '#').
  void Submit(const std::string& name, const std::string& sig,
              int64_t nbytes, const std::string& meta = "");
  // Announce this rank is done submitting (reference: hvd.join()).
  void Join();

  // Worker thread: block up to timeout_s for the next agreed batch.
  // Returns false on shutdown; *error is set per-entry. (Opted out
  // of the thread-safety analysis: the cv-wait predicate lambda
  // reads ready_ under the held CondLock, which the intra-procedural
  // analysis cannot follow into the lambda.)
  bool NextBatch(double timeout_s, std::vector<Entry>* out)
      NO_THREAD_SAFETY_ANALYSIS;

  // -1 until the coordinator reports all ranks joined; then the rank
  // that joined last (the hvd.join() return value in the reference).
  int AllJoined();

  // Joins every controller thread, then tears the sockets down. The
  // post-join section touches GUARDED_BY state without locks — by
  // then the process is single-threaded again (quiescence the
  // analysis cannot express), hence the explicit opt-out.
  void Shutdown() NO_THREAD_SAFETY_ANALYSIS;
  // Live-tunable fusion threshold (reference: ParameterManager
  // adjusting HOROVOD_FUSION_THRESHOLD online). Coordinator-side.
  void SetFusionThreshold(int64_t bytes) {
    fusion_threshold_.store(bytes);
  }
  // Live-tunable cycle time (the other half of the reference
  // ParameterManager's search space).
  void SetCycleTime(double ms) { cycle_time_ms_.store(ms); }
  // Quiescence batching (no reference analog — an XLA-specific knob):
  // the coordinator defers cutting fused batches until the
  // fully-ready set has been stable for `cycles` cycles (or a batch
  // fills the fusion threshold). A per-tensor submission storm then
  // lands in ONE batch with a step-stable composition — and a stable
  // composition is a stable compiled XLA program, where a ragged cut
  // would recompile nearly every step. 0 (default) disables.
  void SetQuiescence(int cycles) { quiesce_cycles_.store(cycles); }
  bool ok() const { return ok_.load(); }
  // Returns a copy: the string may be rewritten by controller threads
  // (lost connection, reader errors) concurrently with this read.
  std::string last_error() const {
    MutexLock lk(err_mu_);
    return last_error_;
  }
  int64_t cycles() const { return cycles_; }
  // Control-plane bytes this rank sent for ready announcements —
  // observable proof the response cache shrinks steady-state traffic.
  int64_t control_bytes_sent() const { return control_bytes_sent_; }
  // This rank's control-tree tier: 0 = root/coordinator, 1 = attached
  // directly to it (every worker in the flat star), 2+ = below an
  // aggregator. Surfaces in Python as the hvd_control_tree_depth
  // gauge and on NEGOTIATE trace spans.
  int tree_tier() const { return place_.tier; }
  // Per-NODE control-plane accounting: CPU nanoseconds this node
  // spent doing coordinator/aggregator work (ingest + merge + cut +
  // fan-out enqueue) and upward/child frames it ingested. This is
  // the number the hierarchical tree exists to bound: on a pod each
  // node owns its own core, so the per-node work — not the
  // shared-core gang wall-clock a 1-core stress host measures — is
  // what must stay under the cycle budget as the world grows.
  int64_t control_work_ns() const { return work_ns_.load(); }
  int64_t frames_ingested() const { return frames_in_.load(); }

 private:
  // Condition-variable predicates capture guarded fields in lambdas
  // the (intra-procedural) thread-safety analysis cannot follow, so
  // the cv-wait loops opt out explicitly; every access in them still
  // happens under the right CondLock (reviewed, and dynamically
  // vetted by the TSAN stress binary).
  void CycleLoop() NO_THREAD_SAFETY_ANALYSIS;
  void PumpLoop() NO_THREAD_SAFETY_ANALYSIS;
  void EnqueueToWorkers(const std::string& frame);
  // Set shutdown + wake everything WITHOUT joining threads — safe to
  // call from the controller's own threads (Shutdown() joins and must
  // only run on an external thread). Opted out: it reads fd fields
  // that are written once before threads start and severed here
  // without locks (shutdown_ ordering, not locking, is the protocol).
  void Abort() NO_THREAD_SAFETY_ANALYSIS;
  void SetError(const std::string& msg);
  void CoordinatorIngest(int rank, std::vector<Request> reqs);
  void CoordinatorIngestAgg(std::vector<AggEntry> entries);
  struct TensorState;
  // Shared ingest helpers — the REQUIRES contract is what used to be
  // the "coord_mu_ held by the caller" comment, now machine-checked
  // at every call site under clang.
  TensorState& UpsertTensor(const std::string& name,
                            const std::string& sig, int64_t nbytes,
                            int reporting_rank, double now)
      REQUIRES(coord_mu_);
  void MarkReady(const std::string& name, TensorState& st, double now)
      REQUIRES(coord_mu_);
  // Aggregator side: fold a child's frame into agg_pending_ and wake
  // the cycle thread to forward it upward.
  void MergeChildRequests(int rank, std::vector<Request> reqs);
  void MergeChildAgg(int rank, std::vector<AggEntry> entries);
  void WakeCycleForAgg();
  bool AllChildrenReported() EXCLUDES(agg_mu_);
  void RunCoordinatorCycle();
  void BroadcastEntries(const std::vector<Entry>& entries);
  void DeliverEntries(const std::vector<Entry>& entries);
  void ServerAcceptLoop();
  void HandshakeConn(int fd);
  void ReaderLoop(int rank, int fd);
  void WorkerReaderLoop();
  void CheckStalls(double now) REQUIRES(coord_mu_);

  ControllerOptions opts_;
  std::atomic<int64_t> fusion_threshold_{64 << 20};
  std::atomic<double> cycle_time_ms_{1.0};
  std::atomic<int> quiesce_cycles_{0};
  std::atomic<bool> shutdown_{false};
  std::atomic<bool> ok_{true};
  mutable Mutex err_mu_;
  std::string last_error_ GUARDED_BY(err_mu_);
  std::atomic<int64_t> cycles_{0};
  std::atomic<int64_t> control_bytes_sent_{0};

  // --- tree placement (flat star when tree_arity < 2) ---
  TreePlace place_;
  std::set<int> children_set_;  // fast membership for handshakes

  // --- frontend pending queue (reference: TensorQueue) ---
  //
  // cycle_cv_ (round-9): the cycle threads are EVENT-DRIVEN, not
  // sleep-polled. The old 1 ms sleep per rank per cycle meant N
  // idle wakeups/ms across an N-rank gang — pure scheduler load that
  // dominated the measured agreement latency well before protocol
  // work did (the 128-worker wall in control_plane_scale.md). Now
  // workers/aggregators block until Submit/Join or child data wakes
  // them (idle ranks cost zero wakeups); ONLY the root keeps the
  // cycle_time_ms pacing, which is what preserves fusion batching
  // and quiescence semantics (a cut still collects everything that
  // arrived in the window).
  Mutex submit_mu_;
  std::condition_variable cycle_cv_;
  bool agg_wake_ GUARDED_BY(submit_mu_) = false;  // child data pending
  std::vector<Request> pending_ GUARDED_BY(submit_mu_);

  // --- aggregator merge state (non-root ranks with children) ---
  Mutex agg_mu_;
  AggMap agg_pending_ GUARDED_BY(agg_mu_);
  // Direct children that have reported since the last upward
  // forward: when every CONNECTED child has, the cycle forwards
  // immediately (steady state = exactly one merged frame per tier
  // per burst); otherwise the agg_linger_us cap bounds the wait.
  RankSet agg_reported_ GUARDED_BY(agg_mu_);
  std::atomic<int> connected_children_{0};

  // --- per-node control-plane accounting (see control_work_ns) ---
  std::atomic<int64_t> work_ns_{0};
  std::atomic<int64_t> frames_in_{0};

  // --- response cache, worker side (reference: response_cache.cc) ---
  // name -> (coordinator-assigned id, signature). Populated from
  // delivered entries; consulted at submit time so steady-state
  // announcements shrink to 5 bytes.
  struct CacheSlot {
    uint32_t id = 0;
    std::string sig;
  };
  Mutex cache_mu_;
  std::unordered_map<std::string, CacheSlot> submit_cache_
      GUARDED_BY(cache_mu_);

  // --- agreed batches awaiting execution ---
  Mutex ready_mu_;
  std::condition_variable ready_cv_;
  std::deque<Entry> ready_ GUARDED_BY(ready_mu_);
  int all_joined_last_rank_ GUARDED_BY(ready_mu_) = -1;

  // --- coordinator state (rank 0 only) ---
  struct TensorState {
    std::string sig;
    int64_t nbytes = 0;
    // Readiness as a dense bitset (tree.h RankSet): child
    // aggregators' merged bitsets OR in at O(words), and the flat
    // path's per-rank insert stops costing a red-black allocation
    // per (tensor, rank) per cycle.
    RankSet ready_ranks;
    std::map<int, std::string> metas;  // per-rank request metadata
    double first_seen = 0.0;
    double fully_ready_at = 0.0;
    bool error_sent = false;
    std::string error;
  };
  Mutex coord_mu_;
  // pending negotiation, fully-ready FIFO, joined set: the
  // tree.h containers (RankSet readiness bitsets inside TensorState,
  // the AggMap above) carry no internal locking by design — their
  // thread-safety contract is exactly these GUARDED_BY declarations.
  std::map<std::string, TensorState> tensors_ GUARDED_BY(coord_mu_);
  std::vector<std::string> ready_order_ GUARDED_BY(coord_mu_);
  std::set<int> joined_ranks_ GUARDED_BY(coord_mu_);
  // Response cache, coordinator side: id -> full request metadata, so
  // cached 5-byte announcements expand back losslessly. Ids are
  // assigned once per name (capacity-bounded, never reused), so
  // worker caches can never go stale — a sig change makes the worker
  // miss (sig compared at submit) and the full path renegotiates.
  struct CachedTensor {
    std::string name;
    std::string sig;
    int64_t nbytes = 0;
  };
  std::unordered_map<uint32_t, CachedTensor> coord_cache_
      GUARDED_BY(coord_mu_);
  std::unordered_map<std::string, uint32_t> coord_cache_ids_
      GUARDED_BY(coord_mu_);
  uint32_t next_cache_id_ GUARDED_BY(coord_mu_) = 1;
  int last_joined_rank_ GUARDED_BY(coord_mu_) = -1;
  bool join_announced_ GUARDED_BY(coord_mu_) = false;
  int32_t next_batch_id_ GUARDED_BY(coord_mu_) = 1;
  int64_t stall_warned_gen_ GUARDED_BY(coord_mu_) = 0;
  // Quiescence-gate state (coordinator cycle thread only; the cycle
  // thread always holds coord_mu_ when it touches these).
  size_t quiesce_last_ready_ GUARDED_BY(coord_mu_) = 0;
  int quiesce_stable_ GUARDED_BY(coord_mu_) = 0;

  // --- sockets ---
  // "coordinator side" below means ANY node with children — the root
  // in the flat star, the root plus every aggregator in tree mode
  // (each tier reuses the same accept/handshake/pump machinery for
  // its own subtree).
  int listen_fd_ = -1;
  int coord_fd_ = -1;                 // upward connection (to parent)
  // fd per CHILD rank (idx = rank), sized once in the constructor.
  std::vector<int> worker_fds_ GUARDED_BY(coord_mu_);
  // Severed-for-cap-breach fds: unlinked from worker_fds_ (so
  // broadcasts stop paying for the dead rank) but kept open until
  // Shutdown() — the pump may still hold the raw fd mid-write, and
  // close() under it would race fd reuse.
  std::vector<int> retired_fds_ GUARDED_BY(coord_mu_);
  // rank slot claimed (pre-fd)
  std::vector<char> worker_claimed_ GUARDED_BY(coord_mu_);
  std::atomic<int> handshaking_{0};   // in-flight handshake threads
  Mutex send_mu_;                     // worker side: serialize
                                      // coord_fd_ writes

  // --- broadcast pump (coordinator): the round-3 serial O(N)
  // fan-out under one lock replaced by per-rank outboxes drained by
  // ONE sender thread using MSG_DONTWAIT writes. The cycle thread
  // only memcpys the pre-built frame into N buffers; the pump
  // overlaps the actual sends with the next cycle, and a
  // backpressured (slow/wedged) worker can no longer head-of-line-
  // block the other N-1 — its bytes just sit in ITS outbox. A worker
  // whose outbox exceeds kPumpCap is severed (its reader path then
  // reports the loss), bounding coordinator memory.
  Mutex pump_mu_;
  std::condition_variable pump_cv_;
  // per-rank pending frames
  std::vector<std::string> pump_buf_ GUARDED_BY(pump_mu_);
  // Bytes the pump has swapped out of a rank's outbox but not yet
  // written — counted by the kPumpCap check so a wedged rank's
  // pending memory is bounded by ONE cap, not two.
  std::vector<size_t> pump_inflight_ GUARDED_BY(pump_mu_);
  std::atomic<bool> aborting_{false};
  static constexpr size_t kPumpCap = 64u << 20;

  std::vector<std::thread> threads_;
  // Per-connection reader threads, spawned by the accept loop while
  // Shutdown may run concurrently — guarded separately. Threads that
  // finish (failed handshake, closed connection) enqueue their id in
  // finished_thread_ids_; the accept loop joins and prunes them
  // before spawning the next, bounding thread accumulation.
  Mutex reader_threads_mu_;
  std::vector<std::thread> reader_threads_
      GUARDED_BY(reader_threads_mu_);
  std::vector<std::thread::id> finished_thread_ids_
      GUARDED_BY(reader_threads_mu_);
};

}  // namespace hvdtpu
