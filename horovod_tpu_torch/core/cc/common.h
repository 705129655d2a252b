// Shared utilities for the native control-plane core.
//
// TPU-native equivalent of the reference's horovod/common/ C++ layer
// (reference: horovod/common/common.h Status/enums,
// horovod/common/logging.cc LOG macros). The data plane (collective
// math) is NOT here — it is XLA over PJRT, driven from Python; this
// core owns the control plane: queueing, negotiation, fusion
// planning, caching, stall detection.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

#include "thread_annotations.h"

namespace hvdtpu {

enum class LogLevel : int {
  kTrace = 0,
  kDebug = 1,
  kInfo = 2,
  kWarning = 3,
  kError = 4,
  kFatal = 5,
};

// Leveled stderr logging, env-controlled like the reference
// (HOROVOD_LOG_LEVEL / HOROVOD_LOG_TIMESTAMP).
class Logger {
 public:
  static Logger& Get() {
    static Logger logger;
    return logger;
  }

  void SetLevel(LogLevel level) { level_.store(static_cast<int>(level)); }
  bool Enabled(LogLevel level) const {
    return static_cast<int>(level) >= level_.load();
  }

  void Log(LogLevel level, const char* fmt, ...) {
    if (!Enabled(level)) return;
    char buf[2048];
    va_list args;
    va_start(args, fmt);
    vsnprintf(buf, sizeof(buf), fmt, args);
    va_end(args);
    static const char* names[] = {"TRACE", "DEBUG", "INFO",
                                  "WARN",  "ERROR", "FATAL"};
    MutexLock lk(mu_);
    fprintf(stderr, "[hvdtpu_core %s] %s\n",
            names[static_cast<int>(level)], buf);
  }

 private:
  Logger() {
    const char* lvl = getenv("HOROVOD_LOG_LEVEL");
    int v = 3;  // warning
    if (lvl != nullptr) {
      std::string s(lvl);
      if (s == "trace") v = 0;
      else if (s == "debug") v = 1;
      else if (s == "info") v = 2;
      else if (s == "warning") v = 3;
      else if (s == "error") v = 4;
      else if (s == "fatal") v = 5;
    }
    level_.store(v);
  }
  std::atomic<int> level_;
  Mutex mu_;  // serializes the stderr write (one line per record)
};

#define HVD_LOG(level, ...)                                       \
  ::hvdtpu::Logger::Get().Log(::hvdtpu::LogLevel::level, __VA_ARGS__)

inline double NowSeconds() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch())
      .count();
}

}  // namespace hvdtpu
