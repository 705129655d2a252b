// Clang thread-safety annotations for the native control plane
// (satellite of the HVD007 static-analysis round: the C++ core gets
// the same class of machine-checked lock discipline hvdlint's
// HVD003/HVD006 give the Python side).
//
// Under clang, `make -C horovod_tpu/core/cc check` adds a
// -Wthread-safety leg that verifies every GUARDED_BY field is only
// touched with its capability held and every REQUIRES contract is
// met at each call site. Under gcc (which has no thread-safety
// analysis) every macro expands to nothing, so the annotations cost
// zero and the -Wall -Wextra -Werror gate is unchanged.
//
// The wrappers at the bottom exist because std::mutex and
// std::lock_guard carry no capability attributes on libstdc++ — the
// analysis cannot see their acquisitions, so annotating fields
// guarded by a bare std::mutex would only produce false positives.
// `Mutex` is a zero-cost annotated shell over std::mutex; `MutexLock`
// is the lock_guard analog; `CondLock` is the unique_lock analog
// whose `native()` handle feeds std::condition_variable::wait (the
// capability is considered held across the wait, the standard
// convention for cv annotations).
#pragma once

#include <mutex>

#if defined(__clang__) && (!defined(SWIG))
#define HVD_THREAD_ANNOTATION__(x) __attribute__((x))
#else
#define HVD_THREAD_ANNOTATION__(x)  // no-op under gcc
#endif

#define CAPABILITY(x) HVD_THREAD_ANNOTATION__(capability(x))
#define SCOPED_CAPABILITY HVD_THREAD_ANNOTATION__(scoped_lockable)
#define GUARDED_BY(x) HVD_THREAD_ANNOTATION__(guarded_by(x))
#define PT_GUARDED_BY(x) HVD_THREAD_ANNOTATION__(pt_guarded_by(x))
#define REQUIRES(...) \
  HVD_THREAD_ANNOTATION__(requires_capability(__VA_ARGS__))
#define ACQUIRE(...) \
  HVD_THREAD_ANNOTATION__(acquire_capability(__VA_ARGS__))
#define RELEASE(...) \
  HVD_THREAD_ANNOTATION__(release_capability(__VA_ARGS__))
#define TRY_ACQUIRE(...) \
  HVD_THREAD_ANNOTATION__(try_acquire_capability(__VA_ARGS__))
#define EXCLUDES(...) \
  HVD_THREAD_ANNOTATION__(locks_excluded(__VA_ARGS__))
#define NO_THREAD_SAFETY_ANALYSIS \
  HVD_THREAD_ANNOTATION__(no_thread_safety_analysis)

namespace hvdtpu {

// Annotated std::mutex shell: same size, same semantics, visible to
// the analysis.
class CAPABILITY("mutex") Mutex {
 public:
  Mutex() = default;
  Mutex(const Mutex&) = delete;
  Mutex& operator=(const Mutex&) = delete;
  void lock() ACQUIRE() { mu_.lock(); }
  void unlock() RELEASE() { mu_.unlock(); }
  bool try_lock() TRY_ACQUIRE(true) { return mu_.try_lock(); }
  // For std::condition_variable interop only — never lock/unlock the
  // native handle directly around annotated state.
  std::mutex& native() { return mu_; }

 private:
  std::mutex mu_;
};

// std::lock_guard analog the analysis can see.
class SCOPED_CAPABILITY MutexLock {
 public:
  explicit MutexLock(Mutex& mu) ACQUIRE(mu) : mu_(&mu) {
    mu_->lock();
  }
  ~MutexLock() RELEASE() { mu_->unlock(); }
  MutexLock(const MutexLock&) = delete;
  MutexLock& operator=(const MutexLock&) = delete;

 private:
  Mutex* mu_;
};

// std::unique_lock analog for condition-variable waits: the
// capability reads as continuously held across wait() (the analysis
// cannot model the unlock/relock inside, which is the convention).
class SCOPED_CAPABILITY CondLock {
 public:
  explicit CondLock(Mutex& mu) ACQUIRE(mu) : lk_(mu.native()) {}
  ~CondLock() RELEASE() {}
  CondLock(const CondLock&) = delete;
  CondLock& operator=(const CondLock&) = delete;
  std::unique_lock<std::mutex>& native() { return lk_; }

 private:
  std::unique_lock<std::mutex> lk_;
};

}  // namespace hvdtpu
