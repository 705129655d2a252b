#include "controller.h"

#include <algorithm>
#include <cerrno>
#include <random>
#include <sstream>

#include "sha256.h"

namespace hvdtpu {

const char kAllJoined[] = "__hvdtpu_all_joined__";

namespace {
// Fuse key = signature up to the first '#' (dtype|op); tensors with
// equal fuse keys may share a fused launch (reference:
// Controller::FuseResponses same-dtype/op rule).
std::string FuseKey(const std::string& sig) {
  auto pos = sig.find('#');
  return pos == std::string::npos ? sig : sig.substr(0, pos);
}

// Constant-time equality for handshake MACs (early-exit comparison
// would leak matching-prefix length via response timing — the same
// reason runner/secret.py uses hmac.compare_digest).
bool ConstTimeEq(const std::string& a, const std::string& b) {
  if (a.size() != b.size()) return false;
  volatile unsigned char acc = 0;
  for (size_t i = 0; i < a.size(); ++i)
    acc |= static_cast<unsigned char>(a[i]) ^
           static_cast<unsigned char>(b[i]);
  return acc == 0;
}

// 32-byte per-connection nonce: random_device entropy mixed with a
// counter and the clock, whitened through SHA-256.
std::string MakeNonce() {
  static std::atomic<uint64_t> ctr{0};
  std::random_device rd;
  uint64_t parts[4];
  parts[0] = (static_cast<uint64_t>(rd()) << 32) ^ rd();
  parts[1] = (static_cast<uint64_t>(rd()) << 32) ^ rd();
  parts[2] = static_cast<uint64_t>(
      std::chrono::steady_clock::now().time_since_epoch().count());
  parts[3] = ctr.fetch_add(1);
  return Sha256Bin(std::string(reinterpret_cast<char*>(parts),
                               sizeof(parts)));
}

std::string WorkerMac(const std::string& secret,
                      const std::string& coord_nonce, uint32_t rank) {
  // The claimed rank is bound into the MAC so a MITM cannot splice a
  // valid handshake onto a different rank claim.
  return HmacSha256(secret,
                    coord_nonce + "|worker|" + std::to_string(rank));
}

std::string CoordMac(const std::string& secret,
                     const std::string& worker_nonce) {
  return HmacSha256(secret, worker_nonce + "|coord");
}

// RAII accumulator for the per-node control-plane work counter
// (Controller::control_work_ns): brackets parse/ingest/merge/cut/
// fan-out sections so the stress harness can report per-NODE work
// per round — the number that must stay sub-cycle on a pod, where
// each node owns its core. THREAD CPU time, not wall: on an
// oversubscribed stress host a wall clock would charge this node
// for every other thread the scheduler ran inside the bracket.
struct WorkTimer {
  explicit WorkTimer(std::atomic<int64_t>* acc) : acc_(acc) {
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &t0_);
  }
  ~WorkTimer() {
    struct timespec t1;
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &t1);
    acc_->fetch_add((t1.tv_sec - t0_.tv_sec) * 1000000000ll +
                    (t1.tv_nsec - t0_.tv_nsec));
  }
  std::atomic<int64_t>* acc_;
  struct timespec t0_;
};
}  // namespace

Controller::Controller(const ControllerOptions& opts) : opts_(opts) {
  fusion_threshold_.store(opts.fusion_threshold);
  cycle_time_ms_.store(opts.cycle_time_ms);
  place_ = TreePlaceOf(opts_.rank, opts_.size, opts_.tree_arity);
  children_set_.insert(place_.children.begin(), place_.children.end());
  agg_reported_ = RankSet(0, opts_.size);
  if (opts_.size > 1) {
    if (!children_set_.empty()) {
      // This node fronts a subtree (the root always; aggregator
      // ranks in tree mode): listen for the children BEFORE any
      // upward connect, so tiers come up concurrently instead of
      // serializing down the tree.
      int lport = opts_.rank == 0 ? opts_.coord_port
                                  : opts_.listen_port;
      // Bounded bind retry: the launcher probes the port before
      // handing it out (TOCTOU), and elastic restarts can race the
      // previous epoch's listener tearing down. Workers retry their
      // connect within connect_timeout_s, so a few seconds of bind
      // retries here removes the flake without masking a genuinely
      // taken port.
      double deadline =
          NowSeconds() + std::min(opts_.connect_timeout_s / 2.0, 10.0);
      do {
        listen_fd_ = ListenOn(lport,
                              static_cast<int>(children_set_.size()) + 4);
        if (listen_fd_ < 0) usleep(200000);
      } while (listen_fd_ < 0 && NowSeconds() < deadline &&
               !shutdown_.load());
      if (listen_fd_ < 0) {
        SetError("failed to listen on control port " +
                 std::to_string(lport));
        return;
      }
      worker_fds_.assign(opts_.size, -1);
      worker_claimed_.assign(opts_.size, 0);
      pump_buf_.assign(opts_.size, std::string());
      pump_inflight_.assign(opts_.size, 0);
      threads_.emplace_back(&Controller::ServerAcceptLoop, this);
      threads_.emplace_back(&Controller::PumpLoop, this);
    }
    if (opts_.rank != 0) {
      const std::string& phost = opts_.parent_host.empty()
                                     ? opts_.coord_host
                                     : opts_.parent_host;
      int pport = opts_.parent_port > 0 ? opts_.parent_port
                                        : opts_.coord_port;
      coord_fd_ = ConnectTo(phost, pport, opts_.connect_timeout_s);
      if (coord_fd_ < 0) {
        SetError("failed to connect to controller at " + phost + ":" +
                 std::to_string(pport) +
                 (place_.parent > 0
                      ? " (tree parent rank " +
                            std::to_string(place_.parent) + ")"
                      : ""));
        return;
      }
      // Mutual challenge-response (see ControllerOptions.auth_secret):
      // challenge -> hello{rank, worker_nonce, mac} -> welcome{mac}.
      double hs_deadline = NowSeconds() + opts_.connect_timeout_s;
      MsgType t;
      std::string payload;
      if (!RecvMsgDeadline(coord_fd_, &t, &payload, hs_deadline,
                           4096) ||
          t != MsgType::kChallenge) {
        SetError("control-plane handshake failed: no challenge from "
                 "coordinator");
        return;
      }
      Reader crd(payload);
      std::string coord_nonce;
      crd.GetStr(&coord_nonce);
      std::string worker_nonce = MakeNonce();
      Buf hello;
      hello.PutU32(static_cast<uint32_t>(opts_.rank));
      hello.PutStr(worker_nonce);
      hello.PutStr(opts_.auth_secret.empty()
                       ? std::string()
                       : WorkerMac(opts_.auth_secret, coord_nonce,
                                   static_cast<uint32_t>(opts_.rank)));
      SendMsg(coord_fd_, MsgType::kHello, hello.data());
      if (!RecvMsgDeadline(coord_fd_, &t, &payload, hs_deadline,
                           4096) ||
          t != MsgType::kWelcome) {
        SetError("control-plane handshake failed: no welcome "
                 "(auth rejected, or not a horovod_tpu coordinator)");
        return;
      }
      if (!opts_.auth_secret.empty()) {
        Reader wrd(payload);
        std::string mac;
        wrd.GetStr(&mac);
        if (!ConstTimeEq(mac,
                         CoordMac(opts_.auth_secret, worker_nonce))) {
          SetError("coordinator failed authentication (wrong or "
                   "missing job secret)");
          return;
        }
      }
      threads_.emplace_back(&Controller::WorkerReaderLoop, this);
    }
  }
  threads_.emplace_back(&Controller::CycleLoop, this);
  HVD_LOG(kDebug, "controller up: rank=%d size=%d port=%d", opts_.rank,
          opts_.size, opts_.coord_port);
}

Controller::~Controller() { Shutdown(); }

void Controller::SetError(const std::string& msg) {
  {
    MutexLock lk(err_mu_);
    last_error_ = msg;
  }
  ok_.store(false);
}

void Controller::Abort() {
  bool expected = false;
  if (!aborting_.compare_exchange_strong(expected, true)) return;
  // Subtree front (root, or an aggregator in tree mode): tell the
  // children this is a clean teardown before the sockets drop, so
  // their reader loops don't report a lost connection — aggregators
  // relay the shutdown down their own subtree the same way. The
  // frame rides the pump like every post-handshake child write (a
  // direct send here could interleave with a pump write mid-frame);
  // it is enqueued BEFORE shutdown_ is raised so the pump cannot
  // observe empty outboxes + shutdown and exit early — it flushes
  // these frames and THEN severs the child fds.
  if (!children_set_.empty() && !worker_fds_.empty())
    EnqueueToWorkers(BuildFrame(MsgType::kShutdown, ""));
  shutdown_.store(true);
  {
    MutexLock lk(pump_mu_);
    pump_cv_.notify_all();
  }
  {
    MutexLock lk(ready_mu_);
    ready_cv_.notify_all();
  }
  {
    MutexLock lk(submit_mu_);
    cycle_cv_.notify_all();
  }
  if (coord_fd_ >= 0) ::shutdown(coord_fd_, SHUT_RDWR);
  if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR);
}

void Controller::Shutdown() {
  Abort();
  auto self = std::this_thread::get_id();
  for (auto& t : threads_)
    if (t.joinable() && t.get_id() != self) t.join();
  {
    // Swap out under the lock, join OUTSIDE it: exiting reader /
    // handshake threads take reader_threads_mu_ in their reap-marker
    // scope, so joining while holding it would deadlock.
    std::vector<std::thread> readers;
    {
      MutexLock lk(reader_threads_mu_);
      readers.swap(reader_threads_);
      finished_thread_ids_.clear();
    }
    for (auto& t : readers)
      if (t.joinable() && t.get_id() != self) t.join();
  }
  if (coord_fd_ >= 0) ::close(coord_fd_);
  if (listen_fd_ >= 0) ::close(listen_fd_);
  for (int fd : worker_fds_)
    if (fd >= 0) ::close(fd);
  for (int fd : retired_fds_) ::close(fd);
  retired_fds_.clear();
  worker_fds_.clear();
  coord_fd_ = listen_fd_ = -1;
}

void Controller::Submit(const std::string& name, const std::string& sig,
                        int64_t nbytes, const std::string& meta) {
  Request r;
  // Response-cache hit (reference: ResponseCache::Lookup): a
  // previously-negotiated (name, sig) collapses to its 5-byte id.
  // Only worth it on ranks that serialize over the wire; rank 0's
  // requests go to its own coordinator without serialization.
  // Requests carrying metadata (uneven allgather sizes / alltoall
  // splits — values that vary per call) always go the full path.
  if (opts_.rank != 0 && opts_.cache_capacity > 0 && meta.empty()) {
    MutexLock clk(cache_mu_);
    auto it = submit_cache_.find(name);
    if (it != submit_cache_.end() && it->second.sig == sig)
      r.cache_id = it->second.id;
  }
  if (r.cache_id == 0) {
    r.name = name;
    r.sig = sig;
    r.nbytes = nbytes;
    r.meta = meta;
  }
  {
    MutexLock lk(submit_mu_);
    pending_.push_back(std::move(r));
  }
  cycle_cv_.notify_one();
}

void Controller::Join() {
  {
    MutexLock lk(submit_mu_);
    Request r;
    r.join = true;
    pending_.push_back(std::move(r));
  }
  cycle_cv_.notify_one();
}

bool Controller::NextBatch(double timeout_s, std::vector<Entry>* out) {
  out->clear();
  CondLock lk(ready_mu_);
  // system_clock wait_until, not wait_for: libstdc++ lowers
  // steady-clock waits to pthread_cond_clockwait, which this
  // toolchain's ThreadSanitizer cannot see through (phantom
  // double-lock reports in the TSAN stress). A clock step stretches
  // one timeout; the caller re-polls, so that is harmless.
  if (!ready_cv_.wait_until(
          lk.native(),
          std::chrono::system_clock::now() +
              std::chrono::microseconds(
                  static_cast<int64_t>(timeout_s * 1e6)),
          [&] { return !ready_.empty() || shutdown_.load(); }))
    return true;  // timeout: empty batch, caller re-polls
  if (ready_.empty()) return false;  // shutdown
  int32_t bid = ready_.front().batch_id;
  while (!ready_.empty() && ready_.front().batch_id == bid) {
    out->push_back(std::move(ready_.front()));
    ready_.pop_front();
  }
  return true;
}

int Controller::AllJoined() {
  MutexLock lk(ready_mu_);
  return all_joined_last_rank_;
}

// --------------------------------------------------------------------------
// cycle loop (all ranks): drain local queue, feed the coordinator
// (reference: BackgroundThreadLoop / RunLoopOnce)
//
// Round-9 pacing model: the ROOT keeps the cycle_time_ms cadence
// (batch cuts, quiescence, and stall checks are defined in cycles);
// every other rank is event-driven — it sleeps until a Submit/Join
// or (aggregators) a child frame wakes it, then drains and forwards
// immediately. Idle ranks cost ZERO wakeups; at 1024 simulated ranks
// the old 1 ms sleep-poll per rank was ~1e6 wakeups/s of scheduler
// load on the stress host, drowning the protocol (see
// benchmarks/control_plane_scale.md round 9).
// --------------------------------------------------------------------------

void Controller::CycleLoop() {
  const bool paced = (opts_.rank == 0);
  const bool aggregator = (opts_.rank != 0 && !children_set_.empty());
  while (!shutdown_.load()) {
    std::vector<Request> mine;
    {
      CondLock lk(submit_mu_);
      if (paced) {
        // system_clock wait_until, NOT wait_for: libstdc++ lowers
        // steady-clock waits to pthread_cond_clockwait, which this
        // toolchain's ThreadSanitizer does not intercept (it then
        // misses the unlock inside the wait and reports phantom
        // double-locks/races). An NTP step can stretch or shrink ONE
        // pacing tick; the loop re-checks, so that is harmless.
        cycle_cv_.wait_until(
            lk.native(),
            std::chrono::system_clock::now() +
                std::chrono::microseconds(static_cast<int64_t>(
                    cycle_time_ms_.load() * 1000.0)),
            [&] { return shutdown_.load(); });
      } else {
        cycle_cv_.wait(lk.native(), [&] {
          return shutdown_.load() || !pending_.empty() || agg_wake_;
        });
      }
      if (shutdown_.load()) return;
      mine.swap(pending_);
      agg_wake_ = false;
    }
    if (aggregator && opts_.agg_linger_us > 0) {
      // Aggregation window: hold the forward until every CONNECTED
      // child has reported since the last one (the steady-state
      // submission storm then goes upward as exactly ONE merged
      // frame per tier per burst), capped at agg_linger_us so a
      // quiet child cannot delay its siblings' negotiation.
      // (system_clock for the same TSAN-interception reason as the
      // paced wait above.)
      auto deadline = std::chrono::system_clock::now() +
                      std::chrono::microseconds(opts_.agg_linger_us);
      CondLock lk(submit_mu_);
      cycle_cv_.wait_until(lk.native(), deadline, [&] {
        return shutdown_.load() || AllChildrenReported();
      });
      for (auto& r : pending_) mine.push_back(std::move(r));
      pending_.clear();
      agg_wake_ = false;
    }
    if (opts_.rank == 0 || opts_.size == 1) {
      if (!mine.empty()) {
        WorkTimer wt(&work_ns_);
        CoordinatorIngest(0, std::move(mine));
      }
    } else if (aggregator) {
      // Merge own submissions with the children's folded frames into
      // ONE upward kReadyAgg (rank-attributed bitsets; tree.h).
      WorkTimer wt(&work_ns_);
      AggMap out;
      {
        MutexLock alk(agg_mu_);
        out.swap(agg_pending_);
        agg_reported_ = RankSet(0, opts_.size);
      }
      for (auto& r : mine)
        MergeRequest(&out, opts_.size, opts_.rank, r);
      if (!out.empty()) {
        std::string payload = SerializeAgg(out);
        control_bytes_sent_.fetch_add(
            static_cast<int64_t>(payload.size()));
        if (!SendMsg(coord_fd_, MsgType::kReadyAgg, payload) &&
            !shutdown_.load()) {
          HVD_LOG(kError, "lost connection to controller");
          SetError("lost connection to controller");
          Abort();  // never Shutdown() from our own thread
          return;
        }
      }
    } else if (!mine.empty()) {
      std::string payload = SerializeRequests(mine);
      control_bytes_sent_.fetch_add(
          static_cast<int64_t>(payload.size()));
      if (!SendMsg(coord_fd_, MsgType::kReady, payload) &&
          !shutdown_.load()) {
        HVD_LOG(kError, "lost connection to controller");
        SetError("lost connection to controller");
        Abort();  // never Shutdown() from our own thread
        return;
      }
    }
    if (opts_.rank == 0) RunCoordinatorCycle();
    cycles_.fetch_add(1);
  }
}

// --------------------------------------------------------------------------
// coordinator (rank 0)
// --------------------------------------------------------------------------

Controller::TensorState& Controller::UpsertTensor(
    const std::string& name, const std::string& sig, int64_t nbytes,
    int reporting_rank, double now) {
  auto it = tensors_.find(name);
  if (it == tensors_.end()) {
    TensorState st;
    // Consistency is checked WITHIN a negotiation round only:
    // re-submitting a name with new metadata next round (e.g. a
    // changed prescale from dynamic loss scaling) renegotiates
    // cleanly, like the reference's ResponseCache miss path.
    st.sig = sig;
    st.nbytes = nbytes;
    st.first_seen = now;
    st.ready_ranks = RankSet(0, opts_.size);
    it = tensors_.emplace(name, std::move(st)).first;
  } else if (it->second.sig != sig && it->second.error.empty()) {
    it->second.error =
        "tensor '" + name +
        "' has mismatched signatures across ranks: '" +
        it->second.sig + "' vs rank " +
        std::to_string(reporting_rank) + "'s '" + sig + "'";
  }
  return it->second;
}

void Controller::MarkReady(const std::string& name, TensorState& st,
                           double now) {
  // Ready when every non-joined rank has submitted. Joined ranks
  // still execute the collective (SPMD requires all participants)
  // with zero contributions, decided Python-side.
  size_t needed =
      static_cast<size_t>(opts_.size) - joined_ranks_.size();
  if (st.fully_ready_at == 0.0 &&
      static_cast<size_t>(st.ready_ranks.count()) >= needed) {
    st.fully_ready_at = now;
    ready_order_.push_back(name);
  }
}

void Controller::CoordinatorIngest(int rank, std::vector<Request> reqs) {
  MutexLock lk(coord_mu_);
  double now = NowSeconds();
  for (auto& r : reqs) {
    if (r.cache_id != 0) {
      // Cache hit: expand the 5-byte announcement back to the full
      // request (reference: ResponseCache::Get in the coordinator's
      // cache-coordination path).
      auto ct = coord_cache_.find(r.cache_id);
      if (ct == coord_cache_.end()) {
        HVD_LOG(kWarning, "rank %d sent unknown cache id %u", rank,
                r.cache_id);
        continue;
      }
      r.name = ct->second.name;
      r.sig = ct->second.sig;
      r.nbytes = ct->second.nbytes;
    }
    if (r.join) {
      if (joined_ranks_.insert(rank).second) last_joined_rank_ = rank;
      continue;
    }
    TensorState& st = UpsertTensor(r.name, r.sig, r.nbytes, rank, now);
    st.ready_ranks.set(rank);
    if (!r.meta.empty()) st.metas[rank] = r.meta;
    MarkReady(r.name, st, now);
  }
}

void Controller::CoordinatorIngestAgg(std::vector<AggEntry> entries) {
  // Tree mode: a child aggregator's merged frame — each entry is one
  // announcement with a rank BITSET instead of one frame per rank.
  // Root-side work per burst is O(distinct tensors x arity), not
  // O(world): the unions are word-ops on dense sets.
  MutexLock lk(coord_mu_);
  double now = NowSeconds();
  for (auto& e : entries) {
    if (e.ranks.lo() < 0 || e.ranks.hi() > opts_.size ||
        e.ranks.count() == 0) {
      HVD_LOG(kWarning, "dropping malformed agg entry (ranks [%d,%d))",
              e.ranks.lo(), e.ranks.hi());
      continue;
    }
    if (e.cache_id != 0) {
      auto ct = coord_cache_.find(e.cache_id);
      if (ct == coord_cache_.end()) {
        HVD_LOG(kWarning, "agg frame carries unknown cache id %u",
                e.cache_id);
        continue;
      }
      e.name = ct->second.name;
      e.sig = ct->second.sig;
      e.nbytes = ct->second.nbytes;
    }
    if (e.join) {
      e.ranks.ForEach([&](int r) {
        if (joined_ranks_.insert(r).second) last_joined_rank_ = r;
      });
      continue;
    }
    int first_rank = -1;
    e.ranks.ForEach([&](int r) {
      if (first_rank < 0) first_rank = r;
    });
    TensorState& st =
        UpsertTensor(e.name, e.sig, e.nbytes, first_rank, now);
    st.ready_ranks.OrWith(e.ranks);
    for (auto& kv : e.metas) st.metas[kv.first] = std::move(kv.second);
    MarkReady(e.name, st, now);
  }
}

// --- aggregator side (tree mode, non-root ranks with children) ------------

void Controller::WakeCycleForAgg() {
  {
    MutexLock lk(submit_mu_);
    agg_wake_ = true;
  }
  cycle_cv_.notify_one();
}

void Controller::MergeChildRequests(int rank, std::vector<Request> reqs) {
  {
    MutexLock lk(agg_mu_);
    for (auto& r : reqs) MergeRequest(&agg_pending_, opts_.size, rank, r);
    agg_reported_.set(rank);
  }
  WakeCycleForAgg();
}

void Controller::MergeChildAgg(int rank, std::vector<AggEntry> entries) {
  {
    MutexLock lk(agg_mu_);
    for (auto& e : entries)
      if (!MergeAgg(&agg_pending_, opts_.size, e))
        HVD_LOG(kWarning, "dropping malformed agg entry from child");
    agg_reported_.set(rank);
  }
  WakeCycleForAgg();
}

bool Controller::AllChildrenReported() {
  MutexLock lk(agg_mu_);
  return agg_reported_.count() >= connected_children_.load();
}

void Controller::RunCoordinatorCycle() {
  std::vector<Entry> out;
  {
    // Work accounting scoped to the cut itself; BroadcastEntries'
    // fan-out is timed inside EnqueueToWorkers (no double count).
    WorkTimer wt(&work_ns_);
    MutexLock lk(coord_mu_);
    double now = NowSeconds();
    // Re-check readiness: a rank joining can make earlier tensors
    // eligible (their missing submitters are gone).
    for (auto& kv : tensors_) MarkReady(kv.first, kv.second, now);
    // Quiescence gate (see SetQuiescence): while the fully-ready set
    // is still growing, hold the cut so a submission storm agrees as
    // ONE stable-composition batch — unless some single fuse key has
    // enough ready bytes to fill the fusion threshold anyway. Per-KEY,
    // not whole-set: a cut only fuses one key, so a mixed-key backlog
    // must not release the hold when no single batch would fill the
    // threshold.
    bool hold = false;
    int q = quiesce_cycles_.load();
    if (q > 0 && !ready_order_.empty()) {
      if (ready_order_.size() != quiesce_last_ready_) {
        quiesce_last_ready_ = ready_order_.size();
        quiesce_stable_ = 0;
      } else {
        ++quiesce_stable_;
      }
      if (quiesce_stable_ < q) {
        std::map<std::string, int64_t> key_bytes;
        int64_t max_key_bytes = 0;
        for (const auto& nm : ready_order_) {
          auto it = tensors_.find(nm);
          if (it == tensors_.end()) continue;
          int64_t& b = key_bytes[FuseKey(it->second.sig)];
          b += it->second.nbytes;
          if (b > max_key_bytes) max_key_bytes = b;
        }
        hold = max_key_bytes < fusion_threshold_.load();
      }
    }
    if (!hold) {
      quiesce_last_ready_ = 0;
      quiesce_stable_ = 0;
    }
    // Greedy fusion over the fully-ready FIFO (reference:
    // FuseResponses): consecutive same-fuse-key tensors pack into one
    // batch up to the threshold.
    size_t i = hold ? ready_order_.size() : 0;
    while (i < ready_order_.size()) {
      const std::string& name = ready_order_[i];
      auto it = tensors_.find(name);
      if (it == tensors_.end()) {
        ++i;
        continue;
      }
      int32_t bid = next_batch_id_++;
      std::string key = FuseKey(it->second.sig);
      int64_t bytes = 0;
      size_t j = i;
      while (j < ready_order_.size()) {
        auto jt = tensors_.find(ready_order_[j]);
        if (jt == tensors_.end()) break;
        TensorState& st = jt->second;
        if (FuseKey(st.sig) != key) break;
        if (bytes > 0 && bytes + st.nbytes > fusion_threshold_.load())
          break;
        Entry e;
        e.name = ready_order_[j];
        e.sig = st.sig;
        e.batch_id = bid;
        e.active_ranks =
            opts_.size - static_cast<int>(joined_ranks_.size());
        // Non-allreduce ops (broadcast "bc|", allgather "ag|", and
        // generic "g|" alltoall/barrier) cannot zero-fill a joined
        // rank's contribution the way allreduce can (a joined root's
        // broadcast payload is unfabricatable); agreeing them with a
        // rank absent would leave the submitters blocked inside a
        // global XLA collective the joined rank never launches. The
        // reference rejects join with non-allreduce ops; same, cleanly.
        if (st.error.empty() && !joined_ranks_.empty() &&
            st.sig.rfind("ar|", 0) != 0) {
          st.error = "hvd.join() is only supported with "
                     "allreduce-style ops: op '" + e.name +
                     "' was agreed while " +
                     std::to_string(joined_ranks_.size()) +
                     " rank(s) had joined";
        }
        e.error = st.error;
        // Aggregate per-rank metadata into the agreed entry
        // (reference: the controller assembling uneven allgather
        // sizes from the Requests into the Response).
        if (!st.metas.empty()) {
          std::string agg;
          for (int rr = 0; rr < opts_.size; ++rr) {
            if (rr) agg.push_back(';');
            auto mi = st.metas.find(rr);
            if (mi != st.metas.end()) agg += mi->second;
          }
          e.meta = std::move(agg);
        }
        if (st.fully_ready_at >= st.first_seen)
          e.negotiate_us = static_cast<uint32_t>(
              (st.fully_ready_at - st.first_seen) * 1e6);
        // Assign a response-cache id the first time a name is agreed
        // (capacity-bounded; ids never reused so caches cannot go
        // stale). Every rank learns the mapping from the broadcast.
        if (opts_.cache_capacity > 0 && e.error.empty()) {
          auto idit = coord_cache_ids_.find(e.name);
          if (idit != coord_cache_ids_.end()) {
            e.cache_id = idit->second;
            CachedTensor& c = coord_cache_[e.cache_id];
            c.sig = st.sig;  // track latest sig (worker compares)
            c.nbytes = st.nbytes;
          } else if (coord_cache_.size() <
                     static_cast<size_t>(opts_.cache_capacity)) {
            e.cache_id = next_cache_id_++;
            coord_cache_ids_.emplace(e.name, e.cache_id);
            coord_cache_.emplace(
                e.cache_id, CachedTensor{e.name, st.sig, st.nbytes});
          }
        }
        out.push_back(std::move(e));
        bytes += st.nbytes;
        tensors_.erase(jt);
        ++j;
      }
      i = j;
    }
    if (!hold) ready_order_.clear();
    // all-joined announcement
    if (!join_announced_ &&
        joined_ranks_.size() == static_cast<size_t>(opts_.size)) {
      join_announced_ = true;
      Entry e;
      e.name = kAllJoined;
      e.batch_id = next_batch_id_++;
      e.active_ranks = last_joined_rank_;  // carries the join() result
      out.push_back(std::move(e));
    }
    CheckStalls(now);
  }
  if (!out.empty()) BroadcastEntries(out);
}

void Controller::CheckStalls(double now) {
  // reference: StallInspector::CheckForStalledTensors — warn listing
  // the ranks that have NOT submitted a tensor others are waiting on.
  if (opts_.stall_warn_s <= 0) return;
  int64_t gen = static_cast<int64_t>(now / opts_.stall_warn_s);
  if (gen == stall_warned_gen_) return;
  bool warned = false;
  for (auto& kv : tensors_) {
    TensorState& st = kv.second;
    if (st.fully_ready_at > 0.0) continue;
    double waited = now - st.first_seen;
    if (waited > opts_.stall_warn_s) {
      std::ostringstream missing;
      for (int r = 0; r < opts_.size; ++r) {
        if (!st.ready_ranks.test(r) && !joined_ranks_.count(r))
          missing << r << " ";
      }
      HVD_LOG(kWarning,
              "tensor '%s' stalled for %.0fs: waiting on ranks [ %s]",
              kv.first.c_str(), waited, missing.str().c_str());
      warned = true;
      if (opts_.stall_kill_s > 0 && waited > opts_.stall_kill_s &&
          st.error.empty()) {
        st.error = "tensor '" + kv.first + "' stalled beyond " +
                   std::to_string(opts_.stall_kill_s) + "s";
        st.fully_ready_at = now;
        ready_order_.push_back(kv.first);
      }
    }
  }
  if (warned) stall_warned_gen_ = gen;
}

void Controller::BroadcastEntries(const std::vector<Entry>& entries) {
  // Serialize + frame ONCE; the cycle thread's cost is N memcpys
  // into the outboxes, the pump owns the syscalls (round-3 weak #5:
  // the serial blocking fan-out under one lock was the first wall a
  // large-world coordinator hits).
  EnqueueToWorkers(BuildFrame(MsgType::kResponses,
                              SerializeEntries(entries)));
  DeliverEntries(entries);  // rank 0's own copy
}

void Controller::EnqueueToWorkers(const std::string& frame) {
  WorkTimer wt(&work_ns_);
  // Only CONNECTED workers receive this broadcast (same semantics as
  // the old direct loop): a rank that connects later re-announces and
  // renegotiates, it must not replay batches it never took part in.
  //
  // Fast path: the calling thread tries ONE non-blocking send per
  // idle rank inline (loopback/healthy sockets complete in µs, and
  // on a single-core coordinator this avoids a pump context switch
  // per cut). Only backpressured tails — and ranks that already have
  // queued bytes, to preserve per-fd frame order — go to the pump.
  // Inline sends run under pump_mu_ with pump_inflight_[r]==0, so
  // they can never interleave with a pump write to the same fd (the
  // pump marks inflight under pump_mu_ before it writes).
  std::vector<int> fds;
  {
    MutexLock clk(coord_mu_);
    fds = worker_fds_;
  }
  bool queued = false;
  std::vector<int> severed;
  {
    MutexLock lk(pump_mu_);
    for (int r : place_.children) {
      if (fds[r] < 0) continue;
      if (pump_buf_[r].size() + pump_inflight_[r] + frame.size() >
          kPumpCap) {
        // Outbox cap breached: this worker has not drained ~64 MB of
        // control traffic — it is wedged. Sever, drop its queue, and
        // mark it dead below so later broadcasts stop paying for it;
        // its reader path reports the loss.
        HVD_LOG(kError,
                "worker %d outbox exceeded %zu bytes; severing", r,
                kPumpCap);
        ::shutdown(fds[r], SHUT_RDWR);
        pump_buf_[r].clear();
        severed.push_back(r);
        continue;
      }
      size_t off = 0;
      if (pump_buf_[r].empty() && pump_inflight_[r] == 0) {
        while (off < frame.size()) {
          ssize_t w = ::send(fds[r], frame.data() + off,
                             frame.size() - off,
                             MSG_DONTWAIT | MSG_NOSIGNAL);
          if (w > 0) {
            off += static_cast<size_t>(w);
            continue;
          }
          if (w < 0 && errno == EINTR) continue;
          break;  // backpressure or error: tail goes to the pump
        }
      }
      if (off < frame.size()) {
        pump_buf_[r].append(frame, off, std::string::npos);
        queued = true;
      }
    }
  }
  if (!severed.empty()) {
    MutexLock clk(coord_mu_);
    for (int r : severed)
      if (r < static_cast<int>(worker_fds_.size()) &&
          worker_fds_[r] == fds[r]) {
        retired_fds_.push_back(worker_fds_[r]);
        worker_fds_[r] = -1;
      }
  }
  if (queued) pump_cv_.notify_one();
}

void Controller::PumpLoop() {
  // Drains per-rank outboxes with non-blocking sends, scanning
  // ROUND-ROBIN so a backpressured low rank cannot monopolize the
  // pump (every other rank gets its turn each pass); on shutdown,
  // flushes what it can within a bounded window, then severs the
  // worker fds (which unblocks their reader threads).
  constexpr double kFlushWindowS = 2.0;
  // Children only (in the flat star that is every rank but 0; in
  // tree mode, this node's direct subtree roots).
  const std::vector<int>& kids = place_.children;
  const int n = static_cast<int>(kids.size());
  double shutdown_seen_at = 0.0;
  std::string local;
  int rr = 0;                      // next child INDEX to consider
  int stall_anchor = -1;           // first rank of a no-progress run
  while (true) {
    int r_next = -1;
    {
      CondLock lk(pump_mu_);
      for (int k = 0; k < n; ++k) {
        int r = kids[(rr + k) % n];
        if (!pump_buf_[r].empty()) { r_next = r; rr = (rr + k) % n;
                                     break; }
      }
      if (r_next < 0) {
        if (shutdown_.load()) break;  // fully drained
        stall_anchor = -1;
        pump_cv_.wait_until(lk.native(), std::chrono::system_clock::now() +
                                    std::chrono::milliseconds(50));
        continue;
      }
      local.clear();
      local.swap(pump_buf_[r_next]);
      pump_inflight_[r_next] = local.size();
    }
    rr = (rr + 1) % n;             // resume AFTER this child
    if (shutdown_.load()) {
      if (shutdown_seen_at == 0.0) shutdown_seen_at = NowSeconds();
      if (NowSeconds() - shutdown_seen_at > kFlushWindowS) {
        MutexLock lk(pump_mu_);
        pump_inflight_[r_next] = 0;
        break;
      }
    }
    int fd;
    {
      MutexLock clk(coord_mu_);
      fd = r_next < static_cast<int>(worker_fds_.size())
               ? worker_fds_[r_next] : -1;
    }
    size_t off = 0;
    if (fd >= 0) {
      while (off < local.size()) {
        ssize_t w = ::send(fd, local.data() + off, local.size() - off,
                           MSG_DONTWAIT | MSG_NOSIGNAL);
        if (w > 0) {
          off += static_cast<size_t>(w);
          continue;
        }
        if (w < 0 && errno == EINTR) continue;      // transient: retry
        if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK ||
                      errno == ENOBUFS))
          break;  // backpressure: requeue the tail, move on
        off = local.size();  // dead peer: drop; reader reports it
        break;
      }
    } else {
      off = local.size();  // disconnected: drop
    }
    bool progressed = off > 0;
    {
      CondLock lk(pump_mu_);
      pump_inflight_[r_next] = 0;
      if (off < local.size()) {
        // Prepend the unsent tail so per-rank frame order is
        // preserved (only this thread writes worker fds
        // post-handshake); frames Enqueue added meanwhile follow it.
        pump_buf_[r_next].insert(0, local, off, std::string::npos);
      }
      if (progressed) {
        stall_anchor = -1;
      } else if (stall_anchor == r_next) {
        // The round-robin came back to the rank that started this
        // no-progress run without anything advancing in between:
        // every pending rank is backpressured — wait instead of
        // spinning on EAGAIN (with ONE stuck rank this sleeps after
        // a single futile revisit, not after n-1 of them).
        stall_anchor = -1;
        pump_cv_.wait_until(lk.native(), std::chrono::system_clock::now() +
                                    std::chrono::milliseconds(1));
      } else if (stall_anchor < 0) {
        stall_anchor = r_next;
      }
    }
  }
  // Shutdown: sever worker fds so reader threads unblock (the old
  // Abort() did this inline; it now belongs to the pump, after the
  // final kShutdown frames had their flush window).
  MutexLock clk(coord_mu_);
  for (int fd : worker_fds_)
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
}

void Controller::DeliverEntries(const std::vector<Entry>& entries) {
  // Learn response-cache assignments from the coordinator's broadcast
  // (reference: workers updating their ResponseCache from responses).
  if (opts_.rank != 0 && opts_.cache_capacity > 0) {
    MutexLock lk(cache_mu_);
    for (const auto& e : entries)
      if (e.cache_id != 0)
        submit_cache_[e.name] = CacheSlot{e.cache_id, e.sig};
  }
  MutexLock lk(ready_mu_);
  for (const auto& e : entries) {
    if (e.name == kAllJoined) {
      all_joined_last_rank_ = e.active_ranks;
      continue;
    }
    ready_.push_back(e);
  }
  ready_cv_.notify_all();
}

// --------------------------------------------------------------------------
// socket threads
// --------------------------------------------------------------------------

void Controller::ServerAcceptLoop() {
  // Each accepted connection's handshake runs on its own thread (the
  // thread then becomes that rank's reader), so N workers connecting
  // at once negotiate CONCURRENTLY — a slow or hostile peer can
  // stall only its own 10s handshake window, never the whole storm
  // (the reference inherits this property from gloo's rendezvous;
  // this build earns it here). The in-flight count is bounded so a
  // connection flood cannot spawn unbounded threads.
  while (!shutdown_.load()) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) break;
    if (handshaking_.load() > opts_.size + 16) {
      ::close(fd);  // flood guard: legitimate ranks retry
      continue;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    handshaking_.fetch_add(1);
    MutexLock lk(reader_threads_mu_);
    // Reap threads that announced completion (failed handshakes,
    // closed readers) so repeated connect attempts over a long job
    // cannot accumulate unbounded exited-but-joinable threads.
    if (!finished_thread_ids_.empty()) {
      for (auto id : finished_thread_ids_) {
        for (auto it = reader_threads_.begin();
             it != reader_threads_.end(); ++it) {
          if (it->get_id() == id) {
            it->join();  // already exited: returns immediately
            reader_threads_.erase(it);
            break;
          }
        }
      }
      finished_thread_ids_.clear();
    }
    reader_threads_.emplace_back(&Controller::HandshakeConn, this, fd);
  }
}

void Controller::HandshakeConn(int fd) {
  // Mutual challenge-response rank rendezvous (see
  // ControllerOptions.auth_secret). The whole handshake runs against
  // an ABSOLUTE deadline (per-read timeouts would reset on every
  // dripped byte) with a tight pre-auth frame cap, so a hostile peer
  // cannot force large allocations.
  struct Scope {
    Controller* self;
    ~Scope() {
      self->handshaking_.fetch_sub(1);
      // Mark this thread reapable by the accept loop (it holds
      // reader_threads_mu_ only briefly; we are off the hot path).
      MutexLock lk(self->reader_threads_mu_);
      self->finished_thread_ids_.push_back(
          std::this_thread::get_id());
    }
  } scope{this};
  double deadline = NowSeconds() + 10.0;
  std::string coord_nonce = MakeNonce();
  Buf ch;
  ch.PutStr(coord_nonce);
  SendMsg(fd, MsgType::kChallenge, ch.data());
  MsgType t;
  std::string payload;
  if (!RecvMsgDeadline(fd, &t, &payload, deadline, 4096) ||
      t != MsgType::kHello) {
    ::close(fd);
    return;
  }
  Reader rd(payload);
  uint32_t rank = 0;
  std::string worker_nonce, mac;
  rd.GetU32(&rank);
  rd.GetStr(&worker_nonce);
  rd.GetStr(&mac);
  if (rank == 0 || rank >= static_cast<uint32_t>(opts_.size) ||
      !children_set_.count(static_cast<int>(rank))) {
    // In tree mode only this node's DIRECT children may attach here;
    // a rank claiming someone else's slot (misconfigured parent
    // address) is rejected before it can claim a slot.
    ::close(fd);
    return;
  }
  if (!opts_.auth_secret.empty() &&
      !ConstTimeEq(mac, WorkerMac(opts_.auth_secret, coord_nonce,
                                  rank))) {
    HVD_LOG(kWarning,
            "rejected control-plane hello for rank %u: bad auth "
            "MAC", rank);
    ::close(fd);
    return;
  }
  {
    // Claim-once check under ONE lock: concurrent handshakes for the
    // same rank must not be able to interleave between check and
    // store.
    MutexLock lk(coord_mu_);
    if (worker_claimed_[rank]) {
      HVD_LOG(kWarning, "duplicate hello for rank %u rejected", rank);
      ::close(fd);
      return;
    }
    worker_claimed_[rank] = 1;
  }
  // Prove we hold the secret too (the worker will not trust agreed
  // batches from an unauthenticated coordinator). The Welcome goes
  // out BEFORE the fd becomes visible to BroadcastEntries: the
  // worker requires kWelcome as the first frame, and two threads
  // writing one fd would interleave frames.
  Buf wl;
  wl.PutStr(opts_.auth_secret.empty()
                ? std::string()
                : CoordMac(opts_.auth_secret, worker_nonce));
  SendMsg(fd, MsgType::kWelcome, wl.data());
  {
    MutexLock lk(coord_mu_);
    worker_fds_[rank] = fd;
  }
  connected_children_.fetch_add(1);
  HVD_LOG(kDebug, "rank %u connected", rank);
  // This thread is now the rank's reader.
  ReaderLoop(static_cast<int>(rank), fd);
}

void Controller::ReaderLoop(int rank, int fd) {
  // Parent side of a child connection: the root ingests directly;
  // an aggregator folds the child's announcements into its own
  // upward frame. A child disconnect ends only THIS loop — the rest
  // of the subtree (and every other subtree) keeps negotiating,
  // which is what bounds a failure's blast radius to its own branch.
  MsgType t;
  std::string payload;
  const bool root = opts_.rank == 0;
  while (!shutdown_.load() && RecvMsg(fd, &t, &payload)) {
    if (t == MsgType::kReady) {
      WorkTimer wt(&work_ns_);
      frames_in_.fetch_add(1);
      std::vector<Request> reqs;
      if (ParseRequests(payload, &reqs)) {
        if (root)
          CoordinatorIngest(rank, std::move(reqs));
        else
          MergeChildRequests(rank, std::move(reqs));
      }
    } else if (t == MsgType::kReadyAgg) {
      WorkTimer wt(&work_ns_);
      frames_in_.fetch_add(1);
      std::vector<AggEntry> entries;
      if (ParseAgg(payload, &entries)) {
        if (root)
          CoordinatorIngestAgg(std::move(entries));
        else
          MergeChildAgg(rank, std::move(entries));
      }
    } else if (t == MsgType::kShutdown) {
      break;
    }
  }
  connected_children_.fetch_sub(1);
  if (!shutdown_.load())
    HVD_LOG(kDebug, "rank %d control connection closed", rank);
}

void Controller::WorkerReaderLoop() {
  MsgType t;
  std::string payload;
  bool clean = false;
  while (!shutdown_.load() && RecvMsg(coord_fd_, &t, &payload)) {
    if (t == MsgType::kResponses) {
      std::vector<Entry> entries;
      if (ParseEntries(payload, &entries)) {
        // Tree mode: relay the agreed batch down this subtree FIRST
        // (one re-framed memcpy + the pump's non-blocking sends —
        // the deeper tiers' latency rides on it), then deliver
        // locally.
        if (!children_set_.empty())
          EnqueueToWorkers(BuildFrame(MsgType::kResponses, payload));
        DeliverEntries(entries);
      }
    } else if (t == MsgType::kShutdown) {
      clean = true;
      break;
    }
  }
  if (!shutdown_.load()) {
    bool joined;
    {
      MutexLock lk(ready_mu_);
      joined = all_joined_last_rank_ >= 0;
    }
    if (!clean && !joined) {
      HVD_LOG(kWarning, "controller connection lost");
      SetError("controller connection lost");
    }
    // Either way the control plane is gone: stop the core so
    // NextBatch() returns shutdown and pending ops fail fast instead
    // of hanging in synchronize().
    Abort();
  }
}

}  // namespace hvdtpu
