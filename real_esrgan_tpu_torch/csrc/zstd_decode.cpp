// A zstd decoder (RFC 8878), decode only, for reading Orbax checkpoints: the
// OCDBT nodes and the zarr chunks of a checkpoint are zstd frames.
//
// Covered: frame headers (dictionary id 0 only), raw, RLE and compressed
// blocks; raw, RLE and Huffman literals (1 or 4 streams, treeless); the
// sequences section with predefined, RLE, FSE-compressed and repeat tables
// and the three repeat offsets; several frames back to back, skippable
// frames, and the XXH64 content checksum (checked).
//
// Every read of the input is bounded, and a malformed frame returns a
// negative code (ERR_*), never reads or writes out of bounds.
//
// Plain C interface for ctypes:
//   long long zstd_content_size(src, n)  sum of the frames' declared sizes,
//                                        -1 if a frame declares none
//   long long zstd_decompress(src, n, dst, cap)  bytes written, or < 0
//   unsigned crc32c(data, n)             CRC-32C (Castagnoli)
//
// Build: g++ -O2 -fPIC -shared -std=c++17 zstd_decode.cpp -o zstd_decode.so

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum : long long {
  ERR_CORRUPT = -2,       // malformed input
  ERR_DST_SMALL = -3,     // output does not fit in cap
  ERR_CHECKSUM = -4,      // content checksum differs
  ERR_DICTIONARY = -5,    // frame needs a dictionary
  ERR_TRUNCATED = -6,     // input ends inside a frame
  ERR_SIZE = -7,          // decoded size differs from the declared one
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 128 * 1024;

struct Error {
  long long code;
};

inline uint32_t highbit(uint32_t v) { return 31u - static_cast<uint32_t>(__builtin_clz(v)); }

inline uint64_t read_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= static_cast<uint64_t>(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                   P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                   P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxmerge(uint64_t acc, uint64_t v) { return (acc ^ xxround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxround(v1, read_le(p, 8));
      v2 = xxround(v2, read_le(p + 8, 8));
      v3 = xxround(v3, read_le(p + 16, 8));
      v4 = xxround(v4, read_le(p + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(xxmerge(xxmerge(xxmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += static_cast<uint64_t>(len);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxround(0, read_le(p, 8)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (read_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ----------------------------------------------------------- bit readers
// Forward reader (FSE table descriptions): bits from the least significant
// of the first byte on; bits past the end read as zero, and `pos` says how
// far the reader went, so the caller checks it against the size.
struct ForwardBits {
  const uint8_t* p;
  size_t size;
  size_t pos = 0;  // in bits
  uint32_t peek(int n) const {  // n <= 24
    size_t byte = pos >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 5 && byte + i < size; ++i) w |= static_cast<uint64_t>(p[byte + i]) << (8 * i);
    return static_cast<uint32_t>((w >> (pos & 7)) & ((1ull << n) - 1));
  }
  void skip(int n) { pos += n; }
};

// Backward reader (Huffman and FSE streams): the stream is read from its
// last bit towards its first, past the final byte's marker bit.  `pos` is
// the number of bits left; it may go below 0, where the missing bits read as
// zero (the decoders check it).
struct BackBits {
  const uint8_t* p;
  int64_t size;
  int64_t pos;

  void init(const uint8_t* data, size_t n) {
    p = data;
    size = static_cast<int64_t>(n);
    if (n == 0 || data[n - 1] == 0) throw Error{ERR_CORRUPT};
    pos = 8 * size - 8 + static_cast<int64_t>(highbit(data[n - 1]));
  }
  inline uint64_t load(int64_t byte) const {
    uint64_t w;
    if (byte + 8 <= size) {
      std::memcpy(&w, p + byte, 8);
    } else {
      w = 0;
      for (int64_t i = 0; byte + i < size; ++i) w |= static_cast<uint64_t>(p[byte + i]) << (8 * i);
    }
    return w;
  }
  // the next n bits (n <= 56), the first of them as the most significant
  inline uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t start = pos - n;
    if (start >= 0) return (load(start >> 3) >> (start & 7)) & ((1ull << n) - 1);
    if (pos <= 0) return 0;
    return (load(0) & ((1ull << pos) - 1)) << (-start);
  }
  inline uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

// ------------------------------------------------------------------ FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> cells;
};

// Reads a normalized-count description; returns bytes used.
size_t read_fse_counts(const uint8_t* src, size_t n, int max_log, int max_symbol, int16_t* norm,
                       int* log_out, int* symbols_out) {
  ForwardBits br{src, n};
  int log = static_cast<int>(br.peek(4)) + 5;
  br.skip(4);
  if (log > max_log) throw Error{ERR_CORRUPT};
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int repeat;
      do {
        repeat = static_cast<int>(br.peek(2));
        br.skip(2);
        for (int i = 0; i < repeat; ++i) {
          if (symbol > max_symbol) throw Error{ERR_CORRUPT};
          norm[symbol++] = 0;
        }
        if (br.pos > 8 * n) throw Error{ERR_CORRUPT};
      } while (repeat == 3);
      if (symbol > max_symbol) throw Error{ERR_CORRUPT};
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t bits = br.peek(nbits);
    if (static_cast<int>(bits & (threshold - 1)) < max) {
      count = static_cast<int>(bits & (threshold - 1));
      br.skip(nbits - 1);
    } else {
      count = static_cast<int>(bits & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    --count;  // -1: probability "less than one"
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = static_cast<int16_t>(count);
    previous0 = count == 0;
    if (remaining < 1) throw Error{ERR_CORRUPT};
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
    if (br.pos > 8 * n) throw Error{ERR_CORRUPT};
  }
  if (remaining != 1) throw Error{ERR_CORRUPT};
  size_t used = (br.pos + 7) / 8;
  if (used > n) throw Error{ERR_TRUNCATED};
  *log_out = log;
  *symbols_out = symbol;
  return used;
}

void build_fse(FseTable& t, const int16_t* norm, int symbols, int log) {
  int size = 1 << log;
  t.log = log;
  t.cells.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(symbols);
  int high = size - 1;
  for (int s = 0; s < symbols; ++s) {
    if (norm[s] == -1) {
      t.cells[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, position = 0;
  for (int s = 0; s < symbols; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[position].symbol = static_cast<uint16_t>(s);
      do {
        position = (position + step) & mask;
      } while (position > high);
    }
  }
  if (position != 0) throw Error{ERR_CORRUPT};
  for (int u = 0; u < size; ++u) {
    FseEntry& e = t.cells[u];
    uint32_t state = next[e.symbol]++;
    if (state == 0) throw Error{ERR_CORRUPT};
    int bits = log - static_cast<int>(highbit(state));
    e.bits = static_cast<uint8_t>(bits);
    e.base = static_cast<uint16_t>((state << bits) - size);
  }
}

void build_rle(FseTable& t, int symbol) {
  t.log = 0;
  t.cells.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
}

// -------------------------------------------------------------- Huffman
struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufEntry> cells;
};

// The tree description; returns bytes used.
size_t read_huffman(HufTable& t, const uint8_t* src, size_t n) {
  if (n < 1) throw Error{ERR_TRUNCATED};
  uint8_t weights[256];
  int count = 0;
  size_t used;
  int header = src[0];
  if (header < 128) {  // FSE-compressed weights, two interleaved states
    size_t csize = header;
    if (csize == 0 || 1 + csize > n) throw Error{ERR_CORRUPT};
    int16_t norm[256];
    int log, symbols;
    size_t desc = read_fse_counts(src + 1, csize, 6, 255, norm, &log, &symbols);
    FseTable table;
    build_fse(table, norm, symbols, log);
    if (desc >= csize) throw Error{ERR_CORRUPT};
    BackBits br;
    br.init(src + 1 + desc, csize - desc);
    uint32_t s1 = static_cast<uint32_t>(br.read(log)), s2 = static_cast<uint32_t>(br.read(log));
    if (br.pos < 0) throw Error{ERR_CORRUPT};
    uint32_t* states[2] = {&s1, &s2};
    for (int turn = 0;; turn ^= 1) {
      if (count > 253) throw Error{ERR_CORRUPT};
      uint32_t& s = *states[turn];
      const FseEntry& e = table.cells[s];
      weights[count++] = static_cast<uint8_t>(e.symbol);
      s = e.base + static_cast<uint32_t>(br.read(e.bits));
      if (br.pos < 0) {  // overflow: the other state gives the last weight
        weights[count++] = static_cast<uint8_t>(table.cells[*states[turn ^ 1]].symbol);
        break;
      }
    }
    used = 1 + csize;
  } else {  // 4-bit weights, two a byte
    count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) throw Error{ERR_TRUNCATED};
    for (int i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  }
  if (count < 1 || count > 255) throw Error{ERR_CORRUPT};
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 12) throw Error{ERR_CORRUPT};
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) throw Error{ERR_CORRUPT};
  int max_bits = static_cast<int>(highbit(total)) + 1;
  if (max_bits > 12) throw Error{ERR_CORRUPT};
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) throw Error{ERR_CORRUPT};
  weights[count++] = static_cast<uint8_t>(highbit(rest) + 1);
  t.max_bits = max_bits;
  t.cells.assign(size_t{1} << max_bits, HufEntry{0, 0});
  size_t position = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < count; ++s) {
      if (weights[s] != w) continue;
      size_t len = size_t{1} << (w - 1);
      if (position + len > t.cells.size()) throw Error{ERR_CORRUPT};
      for (size_t i = 0; i < len; ++i)
        t.cells[position + i] = HufEntry{static_cast<uint8_t>(s), static_cast<uint8_t>(max_bits + 1 - w)};
      position += len;
    }
  }
  if (position != t.cells.size()) throw Error{ERR_CORRUPT};
  return used;
}

void huffman_stream(const HufTable& t, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits br;
  br.init(src, n);
  const int mb = t.max_bits;
  const uint64_t mask = (1ull << mb) - 1;
  const HufEntry* cells = t.cells.data();
  size_t i = 0;
  // four symbols (at most 4 x 12 bits) from each 56-bit load
  while (i + 4 <= count && br.pos >= 56) {
    int64_t start = br.pos - 56;
    uint64_t w = br.load(start >> 3) >> (start & 7);
    int avail = 56;
    for (int k = 0; k < 4; ++k) {
      const HufEntry& e = cells[(w >> (avail - mb)) & mask];
      out[i++] = e.symbol;
      avail -= e.bits;
    }
    br.pos -= 56 - avail;
  }
  for (; i < count; ++i) {
    const HufEntry& e = cells[br.peek(mb)];
    out[i] = e.symbol;
    br.pos -= e.bits;
  }
  if (br.pos != 0) throw Error{ERR_CORRUPT};
}

// ------------------------------------------------------------ sequences
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  HufTable huf;
  bool have_huf = false;
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals = std::vector<uint8_t>(kBlockMax + 64);
};

// One of the three tables of a compressed block; returns bytes used.
size_t read_table(int mode, FseTable& t, bool& have, const int16_t* defaults, int default_symbols,
                  int default_log, int max_log, int max_symbol, const uint8_t* src, size_t n) {
  switch (mode) {
    case 0:
      build_fse(t, defaults, default_symbols, default_log);
      have = true;
      return 0;
    case 1:
      if (n < 1) throw Error{ERR_TRUNCATED};
      if (src[0] > max_symbol) throw Error{ERR_CORRUPT};
      build_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      int16_t norm[64];
      int log, symbols;
      size_t used = read_fse_counts(src, n, max_log, max_symbol, norm, &log, &symbols);
      build_fse(t, norm, symbols, log);
      have = true;
      return used;
    }
    default:
      if (!have) throw Error{ERR_CORRUPT};
      return 0;
  }
}

// Copies `len` bytes from `out - offset` to `out`; the ranges may overlap.
inline void copy_match(uint8_t* out, size_t offset, size_t len) {
  const uint8_t* from = out - offset;
  if (offset >= len) {
    std::memcpy(out, from, len);
  } else if (offset >= 8) {
    for (size_t i = 0; i < len; i += 8) std::memcpy(out + i, from + i, len - i < 8 ? len - i : 8);
  } else {
    for (size_t i = 0; i < len; ++i) out[i] = from[i];
  }
}

// Decodes one compressed block into dst[pos...]; returns the new position.
size_t compressed_block(FrameState& fs, const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                        size_t frame_start, size_t pos) {
  if (n < 1) throw Error{ERR_CORRUPT};
  // literals section
  int type = src[0] & 3, format = (src[0] >> 2) & 3;
  size_t regen, csize = 0, header;
  if (type < 2) {
    if (format == 0 || format == 2) {
      header = 1;
      regen = src[0] >> 3;
    } else if (format == 1) {
      header = 2;
      if (n < 2) throw Error{ERR_TRUNCATED};
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4);
    } else {
      header = 3;
      if (n < 3) throw Error{ERR_TRUNCATED};
      regen = (src[0] >> 4) + (static_cast<size_t>(src[1]) << 4) + (static_cast<size_t>(src[2]) << 12);
    }
  } else {
    header = format < 2 ? 3 : format == 2 ? 4 : 5;
    if (n < header) throw Error{ERR_TRUNCATED};
    uint64_t h = read_le(src, static_cast<int>(header));
    if (header == 3) {
      regen = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (header == 4) {
      regen = (h >> 4) & 0x3FFF;
      csize = (h >> 18) & 0x3FFF;
    } else {
      regen = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
    }
  }
  if (regen > kBlockMax) throw Error{ERR_CORRUPT};
  uint8_t* lit = fs.literals.data();
  const uint8_t* ip = src + header;
  size_t left = n - header;
  if (type == 0) {
    if (regen > left) throw Error{ERR_TRUNCATED};
    std::memcpy(lit, ip, regen);
    ip += regen;
    left -= regen;
  } else if (type == 1) {
    if (left < 1) throw Error{ERR_TRUNCATED};
    std::memset(lit, ip[0], regen);
    ip += 1;
    left -= 1;
  } else {
    if (csize > left) throw Error{ERR_TRUNCATED};
    const uint8_t* cp = ip;
    size_t cleft = csize;
    if (type == 2) {
      size_t used = read_huffman(fs.huf, cp, cleft);
      fs.have_huf = true;
      cp += used;
      cleft -= used;
    } else if (!fs.have_huf) {
      throw Error{ERR_CORRUPT};
    }
    if (format == 0) {
      huffman_stream(fs.huf, cp, cleft, lit, regen);
    } else {
      if (cleft < 6) throw Error{ERR_CORRUPT};
      size_t s1 = read_le(cp, 2), s2 = read_le(cp + 2, 2), s3 = read_le(cp + 4, 2);
      if (6 + s1 + s2 + s3 > cleft) throw Error{ERR_CORRUPT};
      size_t s4 = cleft - 6 - s1 - s2 - s3;
      size_t quarter = (regen + 3) / 4;
      if (3 * quarter > regen) throw Error{ERR_CORRUPT};
      const uint8_t* sp = cp + 6;
      huffman_stream(fs.huf, sp, s1, lit, quarter);
      huffman_stream(fs.huf, sp + s1, s2, lit + quarter, quarter);
      huffman_stream(fs.huf, sp + s1 + s2, s3, lit + 2 * quarter, quarter);
      huffman_stream(fs.huf, sp + s1 + s2 + s3, s4, lit + 3 * quarter, regen - 3 * quarter);
    }
    ip += csize;
    left -= csize;
  }

  // sequences section
  if (left < 1) throw Error{ERR_TRUNCATED};
  size_t nseq = ip[0];
  if (nseq == 0) {
    ip += 1;
    left -= 1;
  } else if (nseq < 128) {
    ip += 1;
    left -= 1;
  } else if (nseq < 255) {
    if (left < 2) throw Error{ERR_TRUNCATED};
    nseq = ((nseq - 128) << 8) + ip[1];
    ip += 2;
    left -= 2;
  } else {
    if (left < 3) throw Error{ERR_TRUNCATED};
    nseq = ip[1] + (static_cast<size_t>(ip[2]) << 8) + 0x7F00;
    ip += 3;
    left -= 3;
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (left < 1) throw Error{ERR_TRUNCATED};
    int modes = ip[0];
    if (modes & 3) throw Error{ERR_CORRUPT};
    ip += 1;
    left -= 1;
    size_t used = read_table(modes >> 6, fs.ll, fs.have_ll, kLLDefault, 36, 6, 9, 35, ip, left);
    ip += used;
    left -= used;
    used = read_table((modes >> 4) & 3, fs.of, fs.have_of, kOFDefault, 29, 5, 8, 31, ip, left);
    ip += used;
    left -= used;
    used = read_table((modes >> 2) & 3, fs.ml, fs.have_ml, kMLDefault, 53, 6, 9, 52, ip, left);
    ip += used;
    left -= used;

    BackBits br;
    br.init(ip, left);
    uint32_t sll = static_cast<uint32_t>(br.read(fs.ll.log));
    uint32_t sof = static_cast<uint32_t>(br.read(fs.of.log));
    uint32_t sml = static_cast<uint32_t>(br.read(fs.ml.log));
    uint32_t* rep = fs.rep;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& ell = fs.ll.cells[sll];
      const FseEntry& eof = fs.of.cells[sof];
      const FseEntry& eml = fs.ml.cells[sml];
      int ofcode = eof.symbol;
      if (ofcode > 31) throw Error{ERR_CORRUPT};
      uint64_t ofvalue = (1ull << ofcode) + br.read(ofcode);
      size_t ml = kMLBase[eml.symbol] + br.read(kMLBits[eml.symbol]);
      size_t ll = kLLBase[ell.symbol] + br.read(kLLBits[ell.symbol]);
      if (br.pos < 0) throw Error{ERR_CORRUPT};
      uint64_t offset;
      if (ofvalue > 3) {
        offset = ofvalue - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = static_cast<uint32_t>(offset);
      } else {
        int idx = static_cast<int>(ofvalue) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? static_cast<uint64_t>(rep[0]) - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = static_cast<uint32_t>(offset);
        }
      }
      if (ll > regen - lit_pos) throw Error{ERR_CORRUPT};
      if (ll + ml > cap - pos) throw Error{ERR_DST_SMALL};
      std::memcpy(dst + pos, lit + lit_pos, ll);
      pos += ll;
      lit_pos += ll;
      if (offset == 0 || offset > pos - frame_start) throw Error{ERR_CORRUPT};
      copy_match(dst + pos, static_cast<size_t>(offset), ml);
      pos += ml;
      if (i + 1 < nseq) {
        sll = ell.base + static_cast<uint32_t>(br.read(ell.bits));
        sml = eml.base + static_cast<uint32_t>(br.read(eml.bits));
        sof = eof.base + static_cast<uint32_t>(br.read(eof.bits));
        if (br.pos < 0) throw Error{ERR_CORRUPT};
      }
    }
    if (br.pos != 0) throw Error{ERR_CORRUPT};
  } else if (left != 0) {
    throw Error{ERR_CORRUPT};
  }
  size_t tail = regen - lit_pos;
  if (tail > cap - pos) throw Error{ERR_DST_SMALL};
  std::memcpy(dst + pos, lit + lit_pos, tail);
  return pos + tail;
}

struct FrameHeader {
  size_t size;            // header bytes after the magic
  long long content;      // declared content size, -1 if none
  bool checksum;
};

FrameHeader frame_header(const uint8_t* p, size_t n) {
  if (n < 1) throw Error{ERR_TRUNCATED};
  int desc = p[0];
  int fcs_flag = desc >> 6, single = (desc >> 5) & 1, did_flag = desc & 3;
  if (desc & 8) throw Error{ERR_CORRUPT};
  size_t at = 1;
  if (!single) {
    if (n < 2) throw Error{ERR_TRUNCATED};
    int exponent = p[1] >> 3;
    if (exponent > 31 - 10) throw Error{ERR_CORRUPT};
    at = 2;
  }
  static const int did_bytes[4] = {0, 1, 2, 4};
  int db = did_bytes[did_flag];
  if (n < at + db) throw Error{ERR_TRUNCATED};
  if (db && read_le(p + at, db) != 0) throw Error{ERR_DICTIONARY};
  at += db;
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 ? single : fcs_bytes[fcs_flag];
  if (n < at + fb) throw Error{ERR_TRUNCATED};
  long long content = -1;
  if (fb) {
    uint64_t v = read_le(p + at, fb);
    if (fb == 2) v += 256;
    if (v > (1ull << 62)) throw Error{ERR_CORRUPT};
    content = static_cast<long long>(v);
  }
  at += fb;
  return FrameHeader{at, content, ((desc >> 2) & 1) != 0};
}

// Walks the frames; with dst == nullptr it sums the declared sizes instead.
long long run(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t at = 0, pos = 0;
  long long declared = 0;
  if (n == 0) throw Error{ERR_TRUNCATED};
  while (at < n) {
    if (n - at < 4) throw Error{ERR_TRUNCATED};
    uint32_t magic = static_cast<uint32_t>(read_le(src + at, 4));
    at += 4;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (n - at < 4) throw Error{ERR_TRUNCATED};
      size_t skip = read_le(src + at, 4);
      at += 4;
      if (skip > n - at) throw Error{ERR_TRUNCATED};
      at += skip;
      continue;
    }
    if (magic != kMagic) throw Error{ERR_CORRUPT};
    FrameHeader fh = frame_header(src + at, n - at);
    at += fh.size;
    if (dst == nullptr) {
      if (fh.content < 0) return -1;
      declared += fh.content;
    }
    FrameState fs;
    size_t frame_start = pos;
    for (bool last = false; !last;) {
      if (n - at < 3) throw Error{ERR_TRUNCATED};
      uint32_t bh = static_cast<uint32_t>(read_le(src + at, 3));
      at += 3;
      last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) throw Error{ERR_CORRUPT};
      if (size > kBlockMax) throw Error{ERR_CORRUPT};
      size_t in = type == 1 ? 1 : size;
      if (in > n - at) throw Error{ERR_TRUNCATED};
      if (dst != nullptr) {
        if (type == 0) {
          if (size > cap - pos) throw Error{ERR_DST_SMALL};
          std::memcpy(dst + pos, src + at, size);
          pos += size;
        } else if (type == 1) {
          if (size > cap - pos) throw Error{ERR_DST_SMALL};
          std::memset(dst + pos, src[at], size);
          pos += size;
        } else {
          size_t before = pos;
          pos = compressed_block(fs, src + at, size, dst, cap, frame_start, pos);
          if (pos - before > kBlockMax) throw Error{ERR_CORRUPT};
        }
      }
      at += in;
    }
    if (fh.checksum) {
      if (n - at < 4) throw Error{ERR_TRUNCATED};
      if (dst != nullptr &&
          static_cast<uint32_t>(xxh64(dst + frame_start, pos - frame_start)) != read_le(src + at, 4))
        throw Error{ERR_CHECKSUM};
      at += 4;
    }
    if (dst != nullptr && fh.content >= 0 && static_cast<long long>(pos - frame_start) != fh.content)
      throw Error{ERR_SIZE};
  }
  return dst == nullptr ? declared : static_cast<long long>(pos);
}

uint32_t crc_table[256];
bool crc_ready = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_table[i] = c;
  }
  return true;
}();

}  // namespace

extern "C" {

long long zstd_content_size(const uint8_t* src, size_t n) {
  try {
    return run(src, n, nullptr, 0);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return ERR_CORRUPT;
  }
}

long long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  try {
    return run(src, n, dst, cap);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return ERR_CORRUPT;
  }
}

uint32_t crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
