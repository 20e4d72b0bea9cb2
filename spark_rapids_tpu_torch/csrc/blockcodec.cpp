// Native block compression codec for the host shuffle data plane: the
// port's own copy of spark_rapids_tpu/native/src/blockcodec.cpp (the port
// imports nothing of the JAX package), so that the two packages write
// byte-identical frames for the same batch.
//
// The reference compresses device shuffle blocks with nvcomp LZ4
// (NvcompLZ4CompressionCodec.scala, TableCompressionCodec.scala); this is
// the host-side equivalent: an LZ4 *block format* codec
// (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md) implemented
// from the format spec, compiled with g++ into spark_rapids_tpu_torch/_build/
// at first use (kernels/build.build_host) and driven from Python over
// ctypes (native/__init__.py), which releases the GIL for each call: host
// shuffle blocks are compressed on the writer thread pool and
// decompressed on the reader pool (RapidsShuffleInternalManagerBase.scala
// :238/:569 threading model).
//
// Exported C ABI:
//   int64_t tpu_lz4_compress_bound(int64_t n)
//   int64_t tpu_lz4_compress(const uint8_t* src, int64_t n,
//                            uint8_t* dst, int64_t dst_cap)
//       -> compressed size, or -1 if dst_cap too small
//   int64_t tpu_lz4_decompress(const uint8_t* src, int64_t n,
//                              uint8_t* dst, int64_t raw_len)
//       -> raw_len on success, -1 on malformed input
//   uint64_t tpu_xxh64(const uint8_t* src, int64_t n, uint64_t seed)
//       -> frame checksum (canonical xxhash64)

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMinMatch = 4;
constexpr int kHashLog = 16;
constexpr int kMaxOffset = 65535;
// spec: the last match must start at least 12 bytes before block end and
// the last 5 bytes are always literals
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kHashLog);
}

}  // namespace

extern "C" {

int64_t tpu_lz4_compress_bound(int64_t n) {
  // worst case: incompressible data expands by 1 byte per 255 + header slop
  return n + n / 255 + 16;
}

int64_t tpu_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t dst_cap) {
  if (n < 0) return -1;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  const uint8_t* anchor = src;

  auto emit = [&](const uint8_t* lit_start, int64_t lit_len, int64_t offset,
                  int64_t match_len) -> bool {
    // token + literal length
    int64_t need = 1 + lit_len / 255 + 1 + lit_len + (offset ? 2 : 0) +
                   (match_len >= 15 ? match_len / 255 + 1 : 0) + 8;
    if (op + need > oend) return false;
    uint8_t* token = op++;
    int64_t ll = lit_len;
    if (ll >= 15) {
      *token = 15 << 4;
      ll -= 15;
      while (ll >= 255) { *op++ = 255; ll -= 255; }
      *op++ = static_cast<uint8_t>(ll);
    } else {
      *token = static_cast<uint8_t>(ll << 4);
    }
    std::memcpy(op, lit_start, lit_len);
    op += lit_len;
    if (offset == 0) return true;  // final literals-only sequence
    op[0] = static_cast<uint8_t>(offset & 0xff);
    op[1] = static_cast<uint8_t>(offset >> 8);
    op += 2;
    int64_t ml = match_len - kMinMatch;
    if (ml >= 15) {
      *token |= 15;
      ml -= 15;
      while (ml >= 255) { *op++ = 255; ml -= 255; }
      *op++ = static_cast<uint8_t>(ml);
    } else {
      *token |= static_cast<uint8_t>(ml);
    }
    return true;
  };

  if (n >= kMfLimit) {
    int32_t table[1 << kHashLog];
    std::memset(table, -1, sizeof(table));
    const uint8_t* const mflimit = iend - kMfLimit;
    while (ip <= mflimit) {
      uint32_t h = hash4(read32(ip));
      int32_t cand = table[h];
      table[h] = static_cast<int32_t>(ip - src);
      if (cand >= 0 && (ip - src) - cand <= kMaxOffset &&
          read32(src + cand) == read32(ip)) {
        // extend the match forward
        const uint8_t* m = src + cand;
        const uint8_t* p = ip + kMinMatch;
        const uint8_t* q = m + kMinMatch;
        const uint8_t* const match_limit = iend - kLastLiterals;
        while (p < match_limit && *p == *q) { ++p; ++q; }
        int64_t match_len = p - ip;
        if (!emit(anchor, ip - anchor, ip - m, match_len)) return -1;
        ip += match_len;
        anchor = ip;
        if (ip <= mflimit) {
          table[hash4(read32(ip - 2))] = static_cast<int32_t>(ip - 2 - src);
        }
      } else {
        ++ip;
      }
    }
  }
  if (!emit(anchor, iend - anchor, 0, 0)) return -1;
  return op - dst;
}

int64_t tpu_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t raw_len) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + n;
  uint8_t* op = dst;
  uint8_t* const oend = dst + raw_len;
  while (ip < iend) {
    uint8_t token = *ip++;
    int64_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit_len += b;
      } while (b == 255);
    }
    if (ip + lit_len > iend || op + lit_len > oend) return -1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // literals-only terminal sequence
    if (ip + 2 > iend) return -1;
    int64_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || offset > op - dst) return -1;
    int64_t match_len = (token & 15);
    if (match_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    match_len += kMinMatch;
    if (op + match_len > oend) return -1;
    const uint8_t* m = op - offset;
    // overlapping copy must run byte-forward (RLE-style matches)
    for (int64_t i = 0; i < match_len; ++i) op[i] = m[i];
    op += match_len;
  }
  return (op == oend && ip == iend) ? raw_len : -1;
}

// xxhash64 (canonical constants) for frame checksums — the same hash
// family the device kernels implement in ops/hashing.py.
uint64_t tpu_xxh64(const uint8_t* src, int64_t n, uint64_t seed) {
  constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
  constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
  constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
  constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
  constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;
  auto rotl = [](uint64_t v, int r) { return (v << r) | (v >> (64 - r)); };
  auto read64 = [](const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
  };
  const uint8_t* p = src;
  const uint8_t* const end = src + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
             v4 = seed - P1;
    do {
      v1 = rotl(v1 + read64(p) * P2, 31) * P1; p += 8;
      v2 = rotl(v2 + read64(p) * P2, 31) * P1; p += 8;
      v3 = rotl(v3 + read64(p) * P2, 31) * P1; p += 8;
      v4 = rotl(v4 + read64(p) * P2, 31) * P1; p += 8;
    } while (p + 32 <= end);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    auto merge = [&](uint64_t v) {
      h ^= rotl(v * P2, 31) * P1;
      h = h * P1 + P4;
    };
    merge(v1); merge(v2); merge(v3); merge(v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    h ^= rotl(read64(p) * P2, 31) * P1;
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    h ^= static_cast<uint64_t>(v) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

}  // extern "C"
