// extern "C" surface for ctypes (no pybind11 in this image; the
// ctypes boundary also keeps the core usable from any language).
//
// Reference analog: the C API at the bottom of
// horovod/common/operations.h (horovod_init / EnqueueTensorAllreduces
// / horovod_rank...) that every framework binding funnels into.

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "controller.h"

using hvdtpu::Controller;
using hvdtpu::ControllerOptions;
using hvdtpu::Entry;
using hvdtpu::Mutex;
using hvdtpu::MutexLock;

namespace {

// Handle = controller + a stash of the last serialized-but-undelivered
// batch. NextBatch consumes entries from the agreed queue, so if the
// caller's buffer is too small the serialization must survive until a
// retry — dropping it would desync this rank from the agreed order
// every peer executes.
struct CoreHandle {
  explicit CoreHandle(const ControllerOptions& o) : ctrl(o) {}
  Controller ctrl;
  Mutex mu;             // guards stash (+ serialization path)
  // pending serialized batch, empty = none
  std::string stash GUARDED_BY(mu);
  // distinguishes an empty batch from none
  bool stash_valid GUARDED_BY(mu) = false;
};

}  // namespace

extern "C" {

void* hvd_core_create(int rank, int size, const char* coord_host,
                      int coord_port, long long fusion_threshold,
                      double cycle_time_ms, double stall_warn_s,
                      double stall_kill_s, double connect_timeout_s,
                      int cache_capacity, const char* auth_secret,
                      int tree_arity, const char* parent_host,
                      int parent_port, int listen_port,
                      int agg_linger_us) {
  ControllerOptions o;
  o.rank = rank;
  o.size = size;
  o.coord_host = coord_host ? coord_host : "127.0.0.1";
  o.coord_port = coord_port;
  o.fusion_threshold = fusion_threshold;
  o.cycle_time_ms = cycle_time_ms;
  o.stall_warn_s = stall_warn_s;
  o.stall_kill_s = stall_kill_s;
  o.connect_timeout_s = connect_timeout_s;
  o.cache_capacity = cache_capacity;
  o.auth_secret = auth_secret ? auth_secret : "";
  o.tree_arity = tree_arity;
  o.parent_host = parent_host ? parent_host : "";
  o.parent_port = parent_port;
  o.listen_port = listen_port;
  o.agg_linger_us = agg_linger_us;
  return new CoreHandle(o);
}

void hvd_core_destroy(void* h) { delete static_cast<CoreHandle*>(h); }

int hvd_core_ok(void* h) {
  return static_cast<CoreHandle*>(h)->ctrl.ok() ? 1 : 0;
}

// Copies the error into the caller's buffer (always NUL-terminated).
// A returned pointer would dangle: controller threads may reassign
// the error string concurrently.
long long hvd_core_last_error(void* h, char* buf, long long bufsize) {
  if (bufsize <= 0) return 0;
  std::string err = static_cast<CoreHandle*>(h)->ctrl.last_error();
  size_t n = err.size() < static_cast<size_t>(bufsize - 1)
                 ? err.size()
                 : static_cast<size_t>(bufsize - 1);
  memcpy(buf, err.data(), n);
  buf[n] = '\0';
  return static_cast<long long>(n);
}

void hvd_core_submit(void* h, const char* name, const char* sig,
                     long long nbytes, const char* meta) {
  static_cast<CoreHandle*>(h)->ctrl.Submit(name, sig, nbytes,
                                           meta ? meta : "");
}

void hvd_core_join(void* h) {
  static_cast<CoreHandle*>(h)->ctrl.Join();
}

// -1 until all ranks joined; then the last-joining rank.
int hvd_core_all_joined(void* h) {
  return static_cast<CoreHandle*>(h)->ctrl.AllJoined();
}

long long hvd_core_cycles(void* h) {
  return static_cast<CoreHandle*>(h)->ctrl.cycles();
}

long long hvd_core_control_bytes(void* h) {
  return static_cast<CoreHandle*>(h)->ctrl.control_bytes_sent();
}

// Returns: >=0 bytes written into buf (a batch, possibly empty on
// timeout); -1 shutdown; <= -2: buffer too small, required size is
// -(ret) and the batch is retained for the retry (never dropped — the
// agreed order must be executed on every rank).
// Batch encoding: entries joined by '\x1e', fields by '\x1f':
//   name '\x1f' sig '\x1f' active_ranks '\x1f' negotiate_us
//   '\x1f' meta '\x1f' error
long long hvd_core_next_batch(void* h, char* buf, long long bufsize,
                              double timeout_s) {
  CoreHandle* ch = static_cast<CoreHandle*>(h);
  MutexLock lk(ch->mu);
  if (!ch->stash_valid) {
    std::vector<Entry> entries;
    if (!ch->ctrl.NextBatch(timeout_s, &entries)) return -1;
    std::string out;
    for (size_t i = 0; i < entries.size(); ++i) {
      if (i) out.push_back('\x1e');
      out += entries[i].name;
      out.push_back('\x1f');
      out += entries[i].sig;
      out.push_back('\x1f');
      out += std::to_string(entries[i].active_ranks);
      out.push_back('\x1f');
      out += std::to_string(entries[i].negotiate_us);
      out.push_back('\x1f');
      out += entries[i].meta;
      out.push_back('\x1f');
      out += entries[i].error;
    }
    ch->stash = std::move(out);
    ch->stash_valid = true;
  }
  if (static_cast<long long>(ch->stash.size()) > bufsize)
    return -static_cast<long long>(ch->stash.size());
  long long n = static_cast<long long>(ch->stash.size());
  memcpy(buf, ch->stash.data(), ch->stash.size());
  ch->stash.clear();
  ch->stash_valid = false;
  return n;
}

void hvd_core_shutdown(void* h) {
  static_cast<CoreHandle*>(h)->ctrl.Shutdown();
}

void hvd_core_set_fusion_threshold(void* h, long long bytes) {
  static_cast<CoreHandle*>(h)->ctrl.SetFusionThreshold(bytes);
}

void hvd_core_set_quiescence(void* h, int cycles) {
  static_cast<CoreHandle*>(h)->ctrl.SetQuiescence(cycles);
}

void hvd_core_set_cycle_time(void* h, double ms) {
  static_cast<CoreHandle*>(h)->ctrl.SetCycleTime(ms);
}

// This rank's control-tree tier (0 = root/coordinator; every worker
// is 1 in the flat star).
int hvd_core_tree_tier(void* h) {
  return static_cast<CoreHandle*>(h)->ctrl.tree_tier();
}

// Stateless topology arithmetic (tree.h), exposed so the Python
// wiring derives parent addresses/ports from the SAME placement the
// C++ core uses — duplicated arithmetic would drift.
int hvd_tree_parent(int rank, int size, int arity) {
  return hvdtpu::TreePlaceOf(rank, size, arity).parent;
}

int hvd_tree_tier(int rank, int size, int arity) {
  return hvdtpu::TreePlaceOf(rank, size, arity).tier;
}

int hvd_tree_depth(int size, int arity) {
  return hvdtpu::TreeDepthOf(size, arity);
}

// Whether a rank fronts a subtree (needs a listen port).
int hvd_tree_has_children(int rank, int size, int arity) {
  return hvdtpu::TreePlaceOf(rank, size, arity).children.empty() ? 0
                                                                 : 1;
}

}  // extern "C"
