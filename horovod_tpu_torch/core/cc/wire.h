// Control-plane wire format + TCP framing.
//
// Replaces the reference's FlatBuffers Request/Response messages and
// MPI_Gatherv/MPI_Bcast control exchange (reference:
// horovod/common/message.cc + wire/message.fbs;
// horovod/common/mpi/mpi_controller.cc SendReadyTensors /
// SendFinalTensors) with a dependency-free length-prefixed binary
// format over persistent TCP connections (rank 0 is the coordinator,
// like the reference's rank-0 controller; the transport role of
// MPI/gloo is played by plain sockets since TPU jobs have no MPI).
#pragma once

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "common.h"

namespace hvdtpu {

// Message types.
enum class MsgType : uint8_t {
  kHello = 1,      // worker -> coord: {rank, worker_nonce, mac_w}
  kReady = 2,      // worker -> coord: RequestList (ready tensors)
  kResponses = 3,  // coord -> worker: ResponseList (agreed batches)
  kShutdown = 4,   // either direction
  kChallenge = 5,  // coord -> new connection: {nonce}
  kWelcome = 6,    // coord -> worker: {mac over the worker's nonce}
  kReadyAgg = 7,   // aggregator -> parent: merged AggEntry list
                   // (tree mode; see tree.h)
};

// One pending-tensor announcement (reference: Request).
//
// cache_id != 0 marks a response-cache hit (reference:
// horovod/common/response_cache.cc bit-vector exchange): the worker
// sends just the coordinator-assigned id instead of name+sig+nbytes,
// shrinking steady-state control traffic from ~O(name+sig) bytes per
// tensor to 5 bytes per tensor.
struct Request {
  std::string name;
  std::string sig;    // "dtype|op|shape" signature for consistency checks
  int64_t nbytes = 0;
  bool join = false;  // a Join pseudo-request (reference: RequestType JOIN)
  uint32_t cache_id = 0;  // response-cache hit marker (0 = full request)
  // Per-rank metadata the coordinator aggregates into the agreed
  // entry (reference: Request carrying tensor shapes so the
  // controller can size uneven allgathers). Used for uneven
  // allgather row counts / alltoall split vectors; must not contain
  // ';'. Non-empty meta bypasses the response cache (it varies per
  // call).
  std::string meta;
};

// One agreed execution entry (reference: Response). Batches are runs
// of entries sharing batch_id.
struct Entry {
  std::string name;
  std::string sig;
  int32_t batch_id = 0;
  int32_t active_ranks = 0;  // non-joined ranks at agreement time
                             // (join-aware Average divides by this)
  std::string error;  // non-empty => deliver error to caller
  uint32_t cache_id = 0;     // coordinator-assigned response-cache id
                             // (0 = not cached); workers learn the
                             // name->id mapping from delivered entries
  uint32_t negotiate_us = 0;  // coordinator-measured submit->agreed
                              // time (feeds the timeline NEGOTIATE lane)
  std::string meta;  // ';'-joined per-world-rank request metadata
                     // (empty slots for ranks that sent none)
};

class Buf {
 public:
  void PutU32(uint32_t v) {
    v = htonl(v);
    const char* p = reinterpret_cast<const char*>(&v);
    data_.insert(data_.end(), p, p + 4);
  }
  void PutU64(uint64_t v) {
    PutU32(static_cast<uint32_t>(v >> 32));
    PutU32(static_cast<uint32_t>(v & 0xffffffffu));
  }
  void PutStr(const std::string& s) {
    PutU32(static_cast<uint32_t>(s.size()));
    data_.insert(data_.end(), s.begin(), s.end());
  }
  void PutU8(uint8_t v) { data_.push_back(static_cast<char>(v)); }
  const std::string& data() const { return data_; }

 private:
  std::string data_;
};

class Reader {
 public:
  explicit Reader(const std::string& d) : d_(d) {}
  bool GetU32(uint32_t* v) {
    if (off_ + 4 > d_.size()) return false;
    uint32_t raw;
    memcpy(&raw, d_.data() + off_, 4);
    *v = ntohl(raw);
    off_ += 4;
    return true;
  }
  bool GetU64(uint64_t* v) {
    uint32_t hi, lo;
    if (!GetU32(&hi) || !GetU32(&lo)) return false;
    *v = (static_cast<uint64_t>(hi) << 32) | lo;
    return true;
  }
  bool GetStr(std::string* s) {
    uint32_t n;
    if (!GetU32(&n)) return false;
    if (off_ + n > d_.size()) return false;
    s->assign(d_.data() + off_, n);
    off_ += n;
    return true;
  }
  bool GetU8(uint8_t* v) {
    if (off_ + 1 > d_.size()) return false;
    *v = static_cast<uint8_t>(d_[off_++]);
    return true;
  }

 private:
  const std::string& d_;
  size_t off_ = 0;
};

// --- framing: [u8 type][u32 len][payload] -------------------------------

inline bool WriteAll(int fd, const char* p, size_t n) {
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

inline bool ReadAll(int fd, char* p, size_t n) {
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Pre-framed message bytes (header + payload) for paths that
// serialize once and hand the same frame to many receivers (the
// coordinator's broadcast pump).
inline std::string BuildFrame(MsgType t, const std::string& payload) {
  std::string out;
  out.resize(5 + payload.size());
  out[0] = static_cast<char>(t);
  uint32_t len = htonl(static_cast<uint32_t>(payload.size()));
  memcpy(&out[1], &len, 4);
  if (!payload.empty()) memcpy(&out[5], payload.data(), payload.size());
  return out;
}

inline bool SendMsg(int fd, MsgType t, const std::string& payload) {
  char hdr[5];
  hdr[0] = static_cast<char>(t);
  uint32_t len = htonl(static_cast<uint32_t>(payload.size()));
  memcpy(hdr + 1, &len, 4);
  if (!WriteAll(fd, hdr, 5)) return false;
  return payload.empty() || WriteAll(fd, payload.data(), payload.size());
}

inline bool RecvMsg(int fd, MsgType* t, std::string* payload) {
  char hdr[5];
  if (!ReadAll(fd, hdr, 5)) return false;
  *t = static_cast<MsgType>(hdr[0]);
  uint32_t len;
  memcpy(&len, hdr + 1, 4);
  len = ntohl(len);
  if (len > (1u << 30)) return false;  // sanity cap
  payload->resize(len);
  return len == 0 || ReadAll(fd, payload->data(), len);
}

// Deadline-bounded read for PRE-AUTH frames (the rank-rendezvous
// handshake): an absolute wall-clock deadline defeats byte-dripping
// (a per-read timeout would reset on every byte), and the tight
// payload cap stops an unauthenticated peer from forcing a large
// allocation (RecvMsg's 1 GiB sanity cap is for trusted peers).
inline bool ReadAllDeadline(int fd, char* p, size_t n,
                            double deadline_s) {
  while (n > 0) {
    double remain = deadline_s - NowSeconds();
    if (remain <= 0) return false;
    struct pollfd pf;
    pf.fd = fd;
    pf.events = POLLIN;
    pf.revents = 0;
    int pr = ::poll(&pf, 1, static_cast<int>(remain * 1000) + 1);
    if (pr <= 0) return false;
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

inline bool RecvMsgDeadline(int fd, MsgType* t, std::string* payload,
                            double deadline_s, uint32_t max_len) {
  char hdr[5];
  if (!ReadAllDeadline(fd, hdr, 5, deadline_s)) return false;
  *t = static_cast<MsgType>(hdr[0]);
  uint32_t len;
  memcpy(&len, hdr + 1, 4);
  len = ntohl(len);
  if (len > max_len) return false;
  payload->resize(len);
  return len == 0 ||
         ReadAllDeadline(fd, payload->data(), len, deadline_s);
}

// --- serialization ------------------------------------------------------

inline std::string SerializeRequests(const std::vector<Request>& reqs) {
  Buf b;
  b.PutU32(static_cast<uint32_t>(reqs.size()));
  for (const auto& r : reqs) {
    // Cached requests collapse to the 5-byte {u8 tag, u32 id} form.
    if (r.cache_id != 0) {
      b.PutU8(1);
      b.PutU32(r.cache_id);
      continue;
    }
    b.PutU8(0);
    b.PutStr(r.name);
    b.PutStr(r.sig);
    b.PutU64(static_cast<uint64_t>(r.nbytes));
    b.PutU8(r.join ? 1 : 0);
    b.PutStr(r.meta);
  }
  return b.data();
}

inline bool ParseRequests(const std::string& d, std::vector<Request>* out) {
  Reader rd(d);
  uint32_t n;
  if (!rd.GetU32(&n)) return false;
  out->clear();
  // n is wire-controlled. Two bounds: an impossible count (every
  // entry costs >= 5 payload bytes, so n can never exceed the
  // payload size) is rejected outright — otherwise a well-formed
  // frame of minimal entries could legally materialize tens of GB of
  // structs; and the speculative reserve is clamped so a lying
  // header cannot force a huge allocation before per-entry parses
  // fail.
  if (n > d.size()) return false;
  out->reserve(n < 4096 ? n : 4096);
  for (uint32_t i = 0; i < n; ++i) {
    Request r;
    uint8_t cached;
    if (!rd.GetU8(&cached)) return false;
    if (cached) {
      if (!rd.GetU32(&r.cache_id)) return false;
      out->push_back(std::move(r));
      continue;
    }
    uint64_t nb;
    uint8_t j;
    if (!rd.GetStr(&r.name) || !rd.GetStr(&r.sig) || !rd.GetU64(&nb) ||
        !rd.GetU8(&j) || !rd.GetStr(&r.meta))
      return false;
    r.nbytes = static_cast<int64_t>(nb);
    r.join = j != 0;
    out->push_back(std::move(r));
  }
  return true;
}

inline std::string SerializeEntries(const std::vector<Entry>& es) {
  Buf b;
  b.PutU32(static_cast<uint32_t>(es.size()));
  for (const auto& e : es) {
    b.PutStr(e.name);
    b.PutStr(e.sig);
    b.PutU32(static_cast<uint32_t>(e.batch_id));
    b.PutU32(static_cast<uint32_t>(e.active_ranks));
    b.PutStr(e.error);
    b.PutU32(e.cache_id);
    b.PutU32(e.negotiate_us);
    b.PutStr(e.meta);
  }
  return b.data();
}

inline bool ParseEntries(const std::string& d, std::vector<Entry>* out) {
  Reader rd(d);
  uint32_t n;
  if (!rd.GetU32(&n)) return false;
  out->clear();
  if (n > d.size()) return false;     // see ParseRequests
  out->reserve(n < 4096 ? n : 4096);
  for (uint32_t i = 0; i < n; ++i) {
    Entry e;
    uint32_t bid, act;
    if (!rd.GetStr(&e.name) || !rd.GetStr(&e.sig) || !rd.GetU32(&bid) ||
        !rd.GetU32(&act) || !rd.GetStr(&e.error) ||
        !rd.GetU32(&e.cache_id) || !rd.GetU32(&e.negotiate_us) ||
        !rd.GetStr(&e.meta))
      return false;
    e.batch_id = static_cast<int32_t>(bid);
    e.active_ranks = static_cast<int32_t>(act);
    out->push_back(std::move(e));
  }
  return true;
}

// --- sockets ------------------------------------------------------------

inline int ListenOn(int port, int backlog) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, backlog) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

inline int ConnectTo(const std::string& host, int port,
                     double timeout_s) {
  double deadline = NowSeconds() + timeout_s;
  while (NowSeconds() < deadline) {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0 ||
        res == nullptr) {
      usleep(100000);
      continue;
    }
    int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd >= 0 &&
        connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
      freeaddrinfo(res);
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    if (fd >= 0) ::close(fd);
    freeaddrinfo(res);
    usleep(100000);
  }
  return -1;
}

}  // namespace hvdtpu
