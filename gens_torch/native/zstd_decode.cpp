// A Zstandard decoder (RFC 8878) for the host: every frame of a buffer,
// decoded whole into memory. It reads what tensorstore's zstd writer puts in
// an OCDBT node or a zarr chunk of an orbax checkpoint, and any other frame
// without a dictionary: raw, RLE and compressed blocks; raw, RLE, Huffman
// (one or four streams) and treeless literals; predefined, RLE, FSE and
// repeat sequence tables; the three repeat offsets; the content checksum
// (the low 32 bits of XXH64); skippable and concatenated frames.
//
// The whole content of a frame stays in the output buffer, so a match may
// reach back to the frame's start and no window is kept. Every read of the
// input is bounds-checked; a corrupt frame ends the call with a message.
//
// C interface (bound with ctypes in gens_torch/utils/zstd.py):
//   void* zstd_decompress(const uint8_t* src, size_t n, size_t* out_n,
//                         uint64_t* stats, char* err, size_t err_cap);
//     returns a malloc'd buffer of *out_n bytes, or NULL with the reason in
//     err. stats, when not NULL, receives zstd_num_stats() counts of the
//     format's features met (see the enum below).
//   void zstd_free(void* p);
//   int zstd_num_stats(void);

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

namespace {

// the order of gens_torch/utils/zstd.py::STAT_NAMES
enum Stat {
  kFrames, kSkippableFrames, kRawBlocks, kRleBlocks, kCompressedBlocks,
  kRawLiterals, kRleLiterals, kHuffman1Stream, kHuffman4Streams,
  kTreelessLiterals, kFseWeights, kDirectWeights, kSeqPredefined, kSeqRle,
  kSeqFse, kSeqRepeat, kRepeatOffsets, kChecksums, kNoSequences,
  kNumStats
};

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Error(what); }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd32(const uint8_t* p) {
  return p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
inline uint64_t rd64(const uint8_t* p) {
  return uint64_t(rd32(p)) | (uint64_t(rd32(p + 4)) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// -- XXH64 (seed 0), for the content checksum --------------------------------

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, rd64(p));
      v2 = xxh_round(v2, rd64(p + 8));
      v3 = xxh_round(v3, rd64(p + 16));
      v4 = xxh_round(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
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

// -- bit readers ---------------------------------------------------------------

// Little-endian bits read forward (the FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) {
      size_t b = bit + i;
      if ((b >> 3) >= n) fail("an FSE table description overruns its block");
      v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    bit += k;
    return v;
  }
};

// The backward bitstreams of Huffman literals, FSE weights and sequences:
// the last byte's highest set bit marks the start, and values come off
// from the high end. ``pos`` counts the bits not yet read; reading past the
// start gives zero bits and a negative ``pos``.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;
  BackBits(const uint8_t* src, size_t len) : p(src), n(len) {
    if (len == 0) fail("an empty bitstream");
    if (src[len - 1] == 0) fail("a bitstream without its end mark");
    pos = int64_t(len) * 8 - 8 + highbit(src[len - 1]);
  }
  uint64_t word(int64_t bit) const {  // 57+ bits from ``bit`` (>= 0)
    size_t byte = size_t(bit >> 3);
    uint64_t w = 0;
    if (byte + 8 <= n) {
      std::memcpy(&w, p + byte, 8);
    } else {
      for (size_t i = byte; i < n; ++i) w |= uint64_t(p[i]) << (8 * (i - byte));
    }
    return w >> (bit & 7);
  }
  uint64_t peek(int k) const {  // k <= 56
    if (k == 0) return 0;
    int64_t lo = pos - k;
    if (lo >= 0) return word(lo) & ((uint64_t(1) << k) - 1);
    if (pos <= 0) return 0;
    return (word(0) & ((uint64_t(1) << pos) - 1)) << (-lo);
  }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// -- FSE -----------------------------------------------------------------------

struct FseCell {
  uint16_t base;  // the next state's baseline
  uint8_t sym;
  uint8_t nb;     // bits read to reach the next state
};

struct FseTable {
  int log = 0;
  std::vector<FseCell> cells;
};

void build_fse(FseTable& t, const int16_t* norm, int max_sym, int log) {
  const uint32_t size = 1u << log;
  t.log = log;
  t.cells.assign(size, FseCell{0, 0, 0});
  std::vector<uint32_t> next(max_sym + 1);
  int64_t high = int64_t(size) - 1;
  for (int s = 0; s <= max_sym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("an FSE distribution overfills its table");
      t.cells[high--].sym = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s <= max_sym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].sym = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (int64_t(pos) > high);
    }
  }
  if (pos != 0) fail("an FSE distribution does not fill its table");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t x = next[t.cells[u].sym]++;
    if (x == 0) fail("an FSE distribution with an empty symbol in use");
    int nb = log - highbit(x);
    t.cells[u].nb = uint8_t(nb);
    t.cells[u].base = uint16_t((x << nb) - size);
  }
}

// Reads an FSE table description at src; returns the bytes it took.
size_t read_fse(FseTable& t, const uint8_t* src, size_t n, int max_sym,
                int max_log) {
  ForwardBits br{src, n};
  int log = int(br.read(4)) + 5;
  if (log > max_log) fail("an FSE accuracy log above the format's limit");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int16_t norm[256] = {0};
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      for (;;) {
        uint32_t r = br.read(2);
        sym += int(r);
        if (r != 3) break;
      }
      if (sym > max_sym) fail("an FSE distribution past its last symbol");
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1);
    if (int(low) < max) {
      count = int(low);
      br.bit += nbits - 1;
    } else {
      count = int(br.read(nbits));
      if (count >= threshold) count -= max;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("an FSE distribution whose counts do not add up");
  build_fse(t, norm, sym - 1, log);
  return (br.bit + 7) >> 3;
}

void rle_fse(FseTable& t, uint8_t sym) {
  t.log = 0;
  t.cells.assign(1, FseCell{0, sym, 0});
}

// -- Huffman literals ----------------------------------------------------------

struct HufCell {
  uint8_t sym;
  uint8_t nb;
};

struct HufTable {
  int log = 0;
  std::vector<HufCell> cells;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman(HufTable& h, const uint8_t* src, size_t n, uint64_t* st) {
  if (n < 1) fail("a Huffman tree description overruns its literals");
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  uint32_t head = src[0];
  if (head < 128) {
    st[kFseWeights]++;
    used = 1 + head;
    if (head == 0 || used > n) fail("a Huffman weight stream overruns its literals");
    FseTable t;
    size_t tsz = read_fse(t, src + 1, head, 255, 6);
    if (tsz >= head) fail("a Huffman weight stream without a bitstream");
    BackBits b(src + 1 + tsz, head - tsz);
    uint32_t s1 = uint32_t(b.read(t.log)), s2 = uint32_t(b.read(t.log));
    if (b.pos < 0) fail("a Huffman weight stream too short for its states");
    // the two states take turns; the first to read past the stream's
    // start ends it, after one more symbol from the other
    uint32_t* s[2] = {&s1, &s2};
    for (int turn = 0;; turn ^= 1) {
      uint32_t& cur = *s[turn];
      if (nw > 253) fail("too many Huffman weights");
      weights[nw++] = t.cells[cur].sym;
      cur = t.cells[cur].base + uint32_t(b.read(t.cells[cur].nb));
      if (b.pos < 0) {
        weights[nw++] = t.cells[*s[turn ^ 1]].sym;
        break;
      }
    }
  } else {
    st[kDirectWeights]++;
    nw = int(head) - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n) fail("Huffman weights overrun their literals");
    for (int i = 0; i < nw; ++i) {
      uint8_t byte = src[1 + i / 2];
      weights[i] = (i & 1) ? (byte & 15) : (byte >> 4);
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("a Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights that are all zero");
  int log = highbit(total) + 1;
  if (log > 11) fail("a Huffman code longer than 11 bits");
  uint32_t rest = (1u << log) - total;
  if (rest & (rest - 1)) fail("Huffman weights that do not sum to a power of 2");
  weights[nw++] = uint8_t(highbit(rest) + 1);
  h.log = log;
  h.cells.assign(size_t(1) << log, HufCell{0, 0});
  size_t pos = 0;
  for (int w = 1; w <= log; ++w) {
    for (int s = 0; s < nw; ++s) {
      if (weights[s] != w) continue;
      size_t len = size_t(1) << (w - 1);
      for (size_t i = 0; i < len; ++i) {
        h.cells[pos + i] = HufCell{uint8_t(s), uint8_t(log + 1 - w)};
      }
      pos += len;
    }
  }
  return used;
}

// One Huffman stream being decoded into ``out[0, count)``.
struct HufStream {
  BackBits b;
  uint8_t* out;
  size_t count, i = 0;
  HufStream(const uint8_t* src, size_t n, uint8_t* o, size_t c)
      : b(src, n), out(o), count(c) {}
  // room for four symbols (at most 44 bits) from one load
  bool roomy() const { return i + 4 <= count && b.pos >= 64; }
  // the 8 bytes that end at the unread bits, the next bit on top
  uint64_t load() const {
    size_t end = size_t((b.pos + 7) >> 3);
    uint64_t c;
    std::memcpy(&c, b.p + end - 8, 8);
    return c << (8 * int64_t(end) - b.pos);
  }
};

// Decodes NS streams, four symbols of each per round while all have room:
// the streams' table lookups are independent, so they overlap in the
// core. Each stream then ends on its own, one symbol at a time.
template <int NS>
void decode_huffman(const HufTable& h, HufStream* s) {
  const HufCell* cells = h.cells.data();
  const int drop = 64 - h.log;
  for (;;) {
    bool roomy = true;
    for (int k = 0; k < NS; ++k) roomy = roomy && s[k].roomy();
    if (!roomy) break;
    uint64_t c[NS];
    int used[NS];
    for (int k = 0; k < NS; ++k) {
      c[k] = s[k].load();
      used[k] = 0;
    }
    for (int r = 0; r < 4; ++r) {
      for (int k = 0; k < NS; ++k) {
        const HufCell e = cells[c[k] >> drop];
        s[k].out[s[k].i + r] = e.sym;
        c[k] <<= e.nb;
        used[k] += e.nb;
      }
    }
    for (int k = 0; k < NS; ++k) {
      s[k].b.pos -= used[k];
      s[k].i += 4;
    }
  }
  for (int k = 0; k < NS; ++k) {
    if (NS > 1) decode_huffman<1>(h, s + k);
    HufStream& t = s[k];
    for (; t.i < t.count; ++t.i) {
      const HufCell e = cells[t.b.peek(h.log)];
      t.out[t.i] = e.sym;
      t.b.pos -= e.nb;
      if (t.b.pos < 0) fail("a Huffman stream ends before its literals");
    }
    if (t.b.pos != 0) fail("a Huffman stream with bits left over");
  }
}

// -- frames --------------------------------------------------------------------

constexpr size_t kBlockMax = 128 * 1024;

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,  14,   15,   16,   18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// A growing output buffer handed to the caller at the end.
struct Out {
  uint8_t* data = nullptr;
  size_t size = 0, cap = 0;
  ~Out() { std::free(data); }
  void reserve(size_t want) {
    if (want <= cap) return;
    size_t c = cap ? cap : 4096;
    while (c < want) c = c > (SIZE_MAX >> 1) ? want : c * 2;
    void* p = std::realloc(data, c);
    if (!p) throw std::bad_alloc();
    data = static_cast<uint8_t*>(p);
    cap = c;
  }
  uint8_t* grow(size_t k) {
    reserve(size + k);
    uint8_t* p = data + size;
    size += k;
    return p;
  }
};

struct Frame {
  Out& out;
  uint64_t* st;
  size_t start;  // the frame's first byte in ``out``
  HufTable huf;
  bool huf_ok = false;
  FseTable ll, of, ml;
  bool ll_ok = false, of_ok = false, ml_ok = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;

  Frame(Out& o, uint64_t* s) : out(o), st(s), start(o.size) {}

  size_t literals(const uint8_t* p, size_t n) {
    if (n < 1) fail("a block without its literals section");
    int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {
      size_t hsz, regen;
      if (sf == 0 || sf == 2) {
        hsz = 1;
        regen = p[0] >> 3;
      } else if (sf == 1) {
        hsz = 2;
        if (n < 2) fail("a literals header overruns its block");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        hsz = 3;
        if (n < 3) fail("a literals header overruns its block");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (regen > kBlockMax) fail("literals larger than a block");
      lit.resize(regen);
      if (type == 0) {
        st[kRawLiterals]++;
        if (n < hsz + regen) fail("raw literals overrun their block");
        if (regen) std::memcpy(lit.data(), p + hsz, regen);
        return hsz + regen;
      }
      st[kRleLiterals]++;
      if (n < hsz + 1) fail("RLE literals overrun their block");
      std::memset(lit.data(), p[hsz], regen);
      return hsz + 1;
    }
    static const int kHsz[4] = {3, 3, 4, 5}, kBits[4] = {10, 10, 14, 18};
    size_t hsz = kHsz[sf];
    if (n < hsz) fail("a literals header overruns its block");
    uint64_t h = 0;
    for (size_t i = 0; i < hsz; ++i) h |= uint64_t(p[i]) << (8 * i);
    uint64_t mask = (uint64_t(1) << kBits[sf]) - 1;
    size_t regen = size_t((h >> 4) & mask), csize = size_t((h >> (4 + kBits[sf])) & mask);
    if (regen > kBlockMax) fail("literals larger than a block");
    if (n < hsz + csize) fail("compressed literals overrun their block");
    const uint8_t* q = p + hsz;
    size_t rem = csize;
    if (type == 2) {
      size_t used = read_huffman(huf, q, rem, st);
      huf_ok = true;
      q += used;
      rem -= used;
    } else {
      st[kTreelessLiterals]++;
      if (!huf_ok) fail("treeless literals without an earlier Huffman tree");
    }
    lit.resize(regen);
    if (sf == 0) {
      st[kHuffman1Stream]++;
      HufStream one(q, rem, lit.data(), regen);
      decode_huffman<1>(huf, &one);
    } else {
      st[kHuffman4Streams]++;
      if (rem < 6) fail("a Huffman jump table overruns its literals");
      size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
      if (s1 + s2 + s3 + 6 > rem) fail("Huffman streams overrun their literals");
      size_t s4 = rem - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("four Huffman streams for too few literals");
      const uint8_t* r = q + 6;
      HufStream four[4] = {
          HufStream(r, s1, lit.data(), seg),
          HufStream(r + s1, s2, lit.data() + seg, seg),
          HufStream(r + s1 + s2, s3, lit.data() + 2 * seg, seg),
          HufStream(r + s1 + s2 + s3, s4, lit.data() + 3 * seg,
                    regen - 3 * seg)};
      decode_huffman<4>(huf, four);
    }
    return hsz + csize;
  }

  size_t table(FseTable& t, bool& ok, int mode, const uint8_t* p, size_t n,
               const int16_t* norm, int norm_max, int norm_log, int max_sym,
               int max_log) {
    switch (mode) {
      case 0:
        st[kSeqPredefined]++;
        build_fse(t, norm, norm_max, norm_log);
        ok = true;
        return 0;
      case 1:
        st[kSeqRle]++;
        if (n < 1) fail("an RLE sequence table overruns its block");
        if (p[0] > max_sym) fail("an RLE sequence code out of range");
        rle_fse(t, p[0]);
        ok = true;
        return 1;
      case 2: {
        st[kSeqFse]++;
        size_t used = read_fse(t, p, n, max_sym, max_log);
        ok = true;
        return used;
      }
      default:
        st[kSeqRepeat]++;
        if (!ok) fail("a repeated sequence table without an earlier one");
        return 0;
    }
  }

  void copy_literals(size_t& at, size_t k) {
    if (k > lit.size() - at) fail("a sequence takes more literals than its block has");
    if (k) std::memcpy(out.grow(k), lit.data() + at, k);
    at += k;
  }

  void block(const uint8_t* p, size_t n) {
    size_t used = literals(p, n);
    p += used;
    n -= used;
    if (n < 1) fail("a block without its sequences section");
    size_t nseq = p[0], hdr = 1;
    if (nseq >= 128) {
      if (nseq < 255) {
        if (n < 2) fail("a sequence count overruns its block");
        nseq = ((nseq - 128) << 8) + p[1];
        hdr = 2;
      } else {
        if (n < 3) fail("a sequence count overruns its block");
        nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
        hdr = 3;
      }
    }
    size_t at = 0;
    if (nseq == 0) {
      st[kNoSequences]++;
      if (n != hdr) fail("bytes after a block's empty sequences section");
      copy_literals(at, lit.size());
      return;
    }
    if (n < hdr + 1) fail("sequence modes overrun their block");
    uint8_t modes = p[hdr];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    p += hdr + 1;
    n -= hdr + 1;
    size_t k = table(ll, ll_ok, modes >> 6, p, n, kLLNorm, 35, 6, 35, 9);
    p += k;
    n -= k;
    k = table(of, of_ok, (modes >> 4) & 3, p, n, kOFNorm, 28, 5, 31, 8);
    p += k;
    n -= k;
    k = table(ml, ml_ok, (modes >> 2) & 3, p, n, kMLNorm, 52, 6, 52, 9);
    p += k;
    n -= k;
    BackBits b(p, n);
    uint32_t sl = uint32_t(b.read(ll.log)), so = uint32_t(b.read(of.log)),
             sm = uint32_t(b.read(ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      uint32_t oc = of.cells[so].sym, mc = ml.cells[sm].sym, lc = ll.cells[sl].sym;
      if (oc > 31 || mc > 52 || lc > 35) fail("a sequence code out of range");
      uint64_t ofv = (uint64_t(1) << oc) + b.read(int(oc));
      size_t mlen = kMLBase[mc] + size_t(b.read(kMLBits[mc]));
      size_t llen = kLLBase[lc] + size_t(b.read(kLLBits[lc]));
      if (i + 1 < nseq) {
        sl = ll.cells[sl].base + uint32_t(b.read(ll.cells[sl].nb));
        sm = ml.cells[sm].base + uint32_t(b.read(ml.cells[sm].nb));
        so = of.cells[so].base + uint32_t(b.read(of.cells[so].nb));
      }
      if (b.pos < 0) fail("a sequence bitstream ends before its sequences");
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        st[kRepeatOffsets]++;
        int idx = int(ofv) - 1 + (llen == 0);
        if (idx == 0) {
          off = rep[0];
        } else if (idx == 1) {
          off = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        } else {
          off = idx == 2 ? rep[2] : rep[0] - 1;
          if (off == 0) fail("a repeat offset of zero");
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      copy_literals(at, llen);
      if (off > out.size - start) fail("a match offset before the frame's start");
      uint8_t* dst = out.grow(mlen);  // may move out.data
      const uint8_t* src = dst - off;
      if (off >= mlen) {
        std::memcpy(dst, src, mlen);
      } else {
        for (size_t j = 0; j < mlen; ++j) dst[j] = src[j];
      }
    }
    if (b.pos != 0) fail("a sequence bitstream with bits left over");
    copy_literals(at, lit.size() - at);
  }
};

// Decodes the frame at src (its magic already checked); returns its size.
size_t frame(const uint8_t* src, size_t n, Out& out, uint64_t* st) {
  st[kFrames]++;
  size_t i = 4;
  if (n < 5) fail("a frame header overruns the input");
  uint8_t fhd = src[i++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      did_flag = fhd & 3;
  if (fhd & 8) fail("a reserved bit set in a frame header");
  if (!single) ++i;  // the window descriptor: the whole frame stays in memory
  static const int kDid[4] = {0, 1, 2, 4};
  static const int kFcs[4] = {0, 2, 4, 8};
  size_t did_size = kDid[did_flag], fcs_size = fcs_flag == 0 ? size_t(single) : kFcs[fcs_flag];
  if (n < i + did_size + fcs_size) fail("a frame header overruns the input");
  uint64_t did = 0;
  for (size_t k = 0; k < did_size; ++k) did |= uint64_t(src[i + k]) << (8 * k);
  i += did_size;
  if (did != 0) fail("the frame needs a dictionary (it names a dictionary ID)");
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  for (size_t k = 0; k < fcs_size; ++k) fcs |= uint64_t(src[i + k]) << (8 * k);
  if (fcs_size == 2) fcs += 256;
  i += fcs_size;
  Frame f(out, st);
  if (has_fcs && fcs <= (uint64_t(1) << 40)) out.reserve(out.size + size_t(fcs));
  for (;;) {
    if (n < i + 3) fail("a block header overruns the input");
    uint32_t bh = src[i] | (uint32_t(src[i + 1]) << 8) | (uint32_t(src[i + 2]) << 16);
    i += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 1) {
      st[kRleBlocks]++;
      if (size > kBlockMax) fail("an RLE block larger than a block may be");
      if (n < i + 1) fail("an RLE block overruns the input");
      std::memset(out.grow(size), src[i], size);
      i += 1;
    } else {
      if (size > kBlockMax) fail("a block larger than a block may be");
      if (n < i + size) fail("a block overruns the input");
      if (type == 0) {
        st[kRawBlocks]++;
        if (size) std::memcpy(out.grow(size), src + i, size);
      } else if (type == 2) {
        st[kCompressedBlocks]++;
        f.block(src + i, size);
      } else {
        fail("a block of the reserved type");
      }
      i += size;
    }
    if (last) break;
  }
  size_t produced = out.size - f.start;
  if (has_fcs && produced != fcs) fail("a frame's content differs from its content size");
  if (checksum) {
    if (n < i + 4) fail("a frame's checksum overruns the input");
    st[kChecksums]++;
    uint32_t want = rd32(src + i);
    if (uint32_t(xxh64(out.data + f.start, produced)) != want) {
      fail("a frame's content checksum does not match");
    }
    i += 4;
  }
  return i;
}

void decompress(const uint8_t* src, size_t n, Out& out, uint64_t* st) {
  if (n == 0) fail("no zstd frame in an empty input");
  size_t i = 0;
  while (i < n) {
    if (n - i < 4) fail("a frame magic overruns the input");
    uint32_t magic = rd32(src + i);
    if (magic == 0xFD2FB528u) {
      i += frame(src + i, n - i, out, st);
    } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      st[kSkippableFrames]++;
      if (n - i < 8) fail("a skippable frame header overruns the input");
      size_t size = rd32(src + i + 4);
      if (n - i - 8 < size) fail("a skippable frame overruns the input");
      i += 8 + size;
    } else {
      fail("not a zstd frame (unknown magic number)");
    }
  }
}

void set_error(char* err, size_t cap, const char* what) {
  if (err && cap) {
    std::strncpy(err, what, cap - 1);
    err[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

int zstd_num_stats() { return kNumStats; }

void* zstd_decompress(const uint8_t* src, size_t n, size_t* out_n,
                      uint64_t* stats, char* err, size_t err_cap) {
  uint64_t local[kNumStats] = {0};
  uint64_t* st = stats ? stats : local;
  Out out;
  try {
    decompress(src, n, out, st);
    out.reserve(1);  // a buffer even for empty content
  } catch (const Error& e) {
    set_error(err, err_cap, e.what());
    return nullptr;
  } catch (const std::bad_alloc&) {
    set_error(err, err_cap, "out of memory");
    return nullptr;
  }
  *out_n = out.size;
  void* data = out.data;
  out.data = nullptr;
  return data;
}

void zstd_free(void* p) { std::free(p); }

}  // extern "C"
