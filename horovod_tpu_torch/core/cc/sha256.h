// Dependency-free SHA-256 + HMAC-SHA256 for the control-plane
// challenge-response handshake (controller.cc). Straight FIPS 180-4 /
// RFC 2104 implementation — the core links no crypto library by
// design (the reference vendors whole dependency trees; this build's
// native layer stays self-contained).
#pragma once

#include <cstdint>
#include <cstring>
#include <string>

namespace hvdtpu {

class Sha256 {
 public:
  Sha256() { Reset(); }

  void Reset() {
    h_[0] = 0x6a09e667u; h_[1] = 0xbb67ae85u;
    h_[2] = 0x3c6ef372u; h_[3] = 0xa54ff53au;
    h_[4] = 0x510e527fu; h_[5] = 0x9b05688cu;
    h_[6] = 0x1f83d9abu; h_[7] = 0x5be0cd19u;
    len_ = 0;
    buf_used_ = 0;
  }

  void Update(const void* data, size_t n) {
    const uint8_t* p = static_cast<const uint8_t*>(data);
    len_ += n;
    while (n > 0) {
      size_t take = 64 - buf_used_;
      if (take > n) take = n;
      memcpy(buf_ + buf_used_, p, take);
      buf_used_ += take;
      p += take;
      n -= take;
      if (buf_used_ == 64) {
        Compress(buf_);
        buf_used_ = 0;
      }
    }
  }

  // 32-byte binary digest.
  std::string Digest() {
    uint64_t bits = len_ * 8;
    uint8_t pad[72];
    size_t padlen = (buf_used_ < 56) ? 56 - buf_used_ : 120 - buf_used_;
    pad[0] = 0x80;
    memset(pad + 1, 0, padlen - 1);
    for (int i = 0; i < 8; ++i)
      pad[padlen + i] = static_cast<uint8_t>(bits >> (56 - 8 * i));
    Update(pad, padlen + 8);
    std::string out(32, '\0');
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = static_cast<char>(h_[i] >> 24);
      out[4 * i + 1] = static_cast<char>(h_[i] >> 16);
      out[4 * i + 2] = static_cast<char>(h_[i] >> 8);
      out[4 * i + 3] = static_cast<char>(h_[i]);
    }
    return out;
  }

 private:
  static uint32_t Rotr(uint32_t x, int r) {
    return (x >> r) | (x << (32 - r));
  }

  void Compress(const uint8_t* block) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (static_cast<uint32_t>(block[4 * i]) << 24) |
             (static_cast<uint32_t>(block[4 * i + 1]) << 16) |
             (static_cast<uint32_t>(block[4 * i + 2]) << 8) |
             static_cast<uint32_t>(block[4 * i + 3]);
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = Rotr(w[i - 15], 7) ^ Rotr(w[i - 15], 18) ^
                    (w[i - 15] >> 3);
      uint32_t s1 = Rotr(w[i - 2], 17) ^ Rotr(w[i - 2], 19) ^
                    (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h_[0], b = h_[1], c = h_[2], d = h_[3];
    uint32_t e = h_[4], f = h_[5], g = h_[6], h = h_[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t s1 = Rotr(e, 6) ^ Rotr(e, 11) ^ Rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = h + s1 + ch + k[i] + w[i];
      uint32_t s0 = Rotr(a, 2) ^ Rotr(a, 13) ^ Rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h_[0] += a; h_[1] += b; h_[2] += c; h_[3] += d;
    h_[4] += e; h_[5] += f; h_[6] += g; h_[7] += h;
  }

  uint32_t h_[8];
  uint64_t len_ = 0;
  uint8_t buf_[64];
  size_t buf_used_ = 0;
};

inline std::string Sha256Bin(const std::string& s) {
  Sha256 h;
  h.Update(s.data(), s.size());
  return h.Digest();
}

// RFC 2104 HMAC-SHA256, binary 32-byte output.
inline std::string HmacSha256(const std::string& key,
                              const std::string& msg) {
  std::string k = key.size() > 64 ? Sha256Bin(key) : key;
  k.resize(64, '\0');
  std::string ipad(64, '\x36'), opad(64, '\x5c');
  for (int i = 0; i < 64; ++i) {
    ipad[i] = static_cast<char>(ipad[i] ^ k[i]);
    opad[i] = static_cast<char>(opad[i] ^ k[i]);
  }
  Sha256 inner;
  inner.Update(ipad.data(), 64);
  inner.Update(msg.data(), msg.size());
  std::string id = inner.Digest();
  Sha256 outer;
  outer.Update(opad.data(), 64);
  outer.Update(id.data(), id.size());
  return outer.Digest();
}

}  // namespace hvdtpu
