// jpeg_entropy: the entropy decode of a JPEG file written by hand, for the
// card's decode route (posetpu_torch/native/jpeg_gpu.py), with a plain C
// interface for ctypes.  No libjpeg, no CUDA.
//
// It is the counterpart of libjpeg's marker reader (jdmarker.c) and of its
// Huffman decoder (jdhuff.c) for sequential files: it gives each file's
// quantised DCT coefficients, block by block, as libjpeg's coefficient
// controller holds them before the IDCT, and the quantisation table of each
// component.  The IDCT (jidctint.c's jpeg_idct_islow) is the idct_islow
// kernel's (native/kernels/idct_islow.cu); upsampling, color conversion, crop
// and pad are the ycc_canvas kernel's.  Together they give libjpeg's decode
// with its defaults (JDCT_ISLOW, fancy upsampling), as the reference's pool
// (posetpu/native/decode_pool.cpp) decodes.
//
// What it takes: baseline and extended-sequential Huffman files (SOF0, SOF1)
// at 8-bit precision with 1 or 3 components, 8- or 16-bit quantisation
// tables, restart intervals, APPn and COM segments, fill bytes.  It refuses,
// each with its own status, what it does not decode exactly as libjpeg does:
// progressive, arithmetic-coded, lossless or hierarchical files; 12-bit
// samples; component counts other than 1 and 3; sampling factors the
// ycc_canvas kernel does not upsample (a 3-component file's luma must carry
// the largest factors and each chroma factor must divide them by 1 or 2);
// anything but one scan of every component; DNL markers; headers whose
// blocks the file's bytes cannot hold (a forged size, refused before the
// caller allocates); and any corruption that libjpeg would only warn about
// (data that ends early, a bad Huffman code, extraneous bytes, a restart
// marker out of turn, a second scan); and any block whose IDCT libjpeg-turbo's
// 16-bit SIMD lanes compute otherwise than jidctint.c's int32 arithmetic,
// which the idct_islow kernel computes (large dequantised values: 16-bit
// tables past 8 bits, or forged coefficients; see lanes_agree()).  The
// caller decodes such files another way (the loader's Pillow path).
//
// Output layout (jpe_decode_batch): for file i, coef_ptrs[i] receives each
// component in frame order, blocks_w * blocks_h blocks of 64 int16 values in
// natural (row-major, de-zigzagged) order, blocks in raster order over the
// component's MCU-padded grid (for a 3-component file: MCUs across times h
// blocks wide, MCU rows times v high; for one component: ceil(W / 8) by
// ceil(H / 8)); qt_ptrs[i] receives 64 uint16 values a component, in frame
// order and natural order: the table libjpeg latches at the scan's start.
//
// The pool: jpe_create(n) starts exactly n worker threads or fails;
// jpe_decode_batch hands a batch's files to them, each takes files in turn
// from a shared counter and writes into the caller's disjoint slices, and it
// returns once every file is done.
//
// Build (jpeg_gpu.py, through utils/cuda_build.py):
//   g++ -O3 -shared -fPIC -std=c++17 -o <lib> jpeg_entropy.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum Status {
  JPE_OK = 0,
  JPE_NOT_JPEG = 1,       // no SOI, or no frame and scan
  JPE_PROGRESSIVE = 2,    // SOF2
  JPE_ARITHMETIC = 3,     // SOF9-SOF15, DAC
  JPE_LOSSLESS = 4,       // SOF3, and the hierarchical SOF5-SOF7
  JPE_PRECISION = 5,      // samples of other than 8 bits
  JPE_COMPONENTS = 6,     // other than 1 or 3 components
  JPE_SAMPLING = 7,       // factors the route does not upsample
  JPE_SCANS = 8,          // not one scan of every component
  JPE_DNL = 9,            // a DNL marker, or a height of 0 that asks for one
  JPE_CORRUPT = 10,       // anything libjpeg would warn about or refuse
  JPE_DIMENSIONS = 11,    // a size past 65500 or past what the bytes hold
  JPE_EXCEPTION = 12,     // a C++ exception inside a worker
  JPE_RANGE = 13,         // a block libjpeg-turbo's 16-bit SIMD IDCT computes otherwise
};

constexpr int kMaxDimension = 65500;  // libjpeg's JPEG_MAX_DIMENSION
constexpr int kInfoWords = 3 + 3 * 6;

// jutils.c's jpeg_natural_order, with its 16 extra entries: a corrupt run
// past the last coefficient writes the last one, as libjpeg does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// A Huffman table as DHT gives it and as jdhuff.c derives it
// (jpeg_make_d_derived_tbl): maxcode and valoffset a code length, and the
// lookahead table of HUFF_LOOKAHEAD = 8 bits.
struct Huff {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[256] = {};  // (length << 8) | symbol; 0: a code longer than 8 bits
  // AC tables: a nonzero coefficient whose code and value bits fit in the
  // next kFastBits bits, as (value << 9) | (run << 5) | bits used; 0: decode
  // the symbol, then its value
  int32_t fast_ac[1 << 9] = {};
};

constexpr int kFastBits = 9;

bool derive(Huff& t, bool dc) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.bits[l]; ++i) size[p++] = static_cast<uint8_t>(l);
  size[p] = 0;
  const int count = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code[p++] = c;
      ++c;
    }
    if (c >= (1u << si)) return false;  // libjpeg's JERR_BAD_HUFF_TABLE
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += t.bits[l];
      t.maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < t.bits[l]; ++i, ++p) {
      const uint32_t first = code[p] << (8 - l);
      for (uint32_t k = 0; k < (1u << (8 - l)); ++k)
        t.look[first + k] = static_cast<uint16_t>((l << 8) | t.vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < count; ++i)
      if (t.vals[i] > 15) return false;
    return true;
  }
  std::memset(t.fast_ac, 0, sizeof(t.fast_ac));
  p = 0;
  for (int l = 1; l <= kFastBits; ++l) {
    for (int i = 0; i < t.bits[l]; ++i, ++p) {
      const int run = t.vals[p] >> 4, z = t.vals[p] & 15;
      if (z == 0 || l + z > kFastBits) continue;
      const uint32_t first = code[p] << (kFastBits - l);
      for (uint32_t k = 0; k < (1u << (kFastBits - l)); ++k) {
        // the z bits after the code, HUFF_EXTENDed
        const int v = static_cast<int>((k >> (kFastBits - l - z)) & ((1u << z) - 1));
        const int value = v < (1 << (z - 1)) ? v - ((1 << z) - 1) : v;
        t.fast_ac[first + k] = value * (1 << 9) | run << 5 | (l + z);
      }
    }
  }
  return true;
}

struct Component {
  int id = 0, h = 0, v = 0, tq = 0;
  int td = 0, ta = 0;                  // the scan's table selectors
  int blocks_w = 0, blocks_h = 0;      // the MCU-padded grid
  int plane_w = 0, plane_h = 0;        // the stored size libjpeg's raw output crops to
};

struct Header {
  int W = 0, H = 0, nc = 0;
  Component comp[3];
  int order[3] = {0, 1, 2};            // frame index of each scan component
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart = 0;
  uint16_t qt[4][64] = {};
  bool qt_set[4] = {};
  Huff dc[4], ac[4];
  size_t scan = 0;                     // offset of the entropy-coded data
  int64_t blocks = 0;
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// The marker at data[*at], after any 0xFF fill bytes; *at moves past it.
// -1 where anything but 0xFF stands there (libjpeg skips such bytes with a
// warning) or the data ends.
int marker_at(const uint8_t* data, size_t len, size_t* at) {
  size_t i = *at;
  if (i >= len || data[i] != 0xFF) return -1;
  while (i < len && data[i] == 0xFF) ++i;
  if (i >= len) return -1;
  *at = i + 1;
  return data[i];
}

int parse_dqt(Header& hd, const uint8_t* s, int n) {
  while (n > 0) {
    const int pq = s[0] >> 4, tq = s[0] & 15;
    const int need = 1 + 64 * (pq + 1);
    if (pq > 1 || tq > 3 || n < need) return JPE_CORRUPT;
    for (int i = 0; i < 64; ++i) {
      const int q = pq ? be16(s + 1 + 2 * i) : s[1 + i];
      // libjpeg's SIMD builds hold a table entry in a short: a value past
      // 32767 would be another number there.  Below that, a block whose
      // products or sums the 16-bit lanes would compute otherwise is refused
      // as it is decoded (JPE_RANGE, lanes_agree())
      if (q > 32767) return JPE_CORRUPT;
      hd.qt[tq][kNatural[i]] = static_cast<uint16_t>(q);
    }
    hd.qt_set[tq] = true;
    s += need;
    n -= need;
  }
  return JPE_OK;
}

int parse_dht(Header& hd, const uint8_t* s, int n) {
  while (n > 0) {
    if (n < 17) return JPE_CORRUPT;
    const int tc = s[0] >> 4, th = s[0] & 15;
    if (tc > 1 || th > 3) return JPE_CORRUPT;
    Huff& t = tc ? hd.ac[th] : hd.dc[th];
    int count = 0;
    t.bits[0] = 0;
    for (int l = 1; l <= 16; ++l) count += (t.bits[l] = s[l]);
    if (count > 256 || n < 17 + count) return JPE_CORRUPT;
    std::memset(t.vals, 0, sizeof(t.vals));
    std::memcpy(t.vals, s + 17, static_cast<size_t>(count));
    if (!derive(t, tc == 0)) return JPE_CORRUPT;
    t.defined = true;
    s += 17 + count;
    n -= 17 + count;
  }
  return JPE_OK;
}

int parse_sof(Header& hd, int marker, const uint8_t* s, int n) {
  if (marker == 0xC2) return JPE_PROGRESSIVE;
  if (marker == 0xC3 || (marker >= 0xC5 && marker <= 0xC7)) return JPE_LOSSLESS;
  if (marker >= 0xC9) return JPE_ARITHMETIC;
  if (n < 6) return JPE_CORRUPT;
  if (s[0] != 8) return JPE_PRECISION;
  hd.H = be16(s + 1);
  hd.W = be16(s + 3);
  hd.nc = s[5];
  if (n != 6 + 3 * hd.nc) return JPE_CORRUPT;
  if (hd.nc != 1 && hd.nc != 3) return JPE_COMPONENTS;
  if (hd.W == 0) return JPE_CORRUPT;
  if (hd.H == 0) return JPE_DNL;
  if (hd.W > kMaxDimension || hd.H > kMaxDimension) return JPE_DIMENSIONS;
  for (int c = 0; c < hd.nc; ++c) {
    Component& k = hd.comp[c];
    k.id = s[6 + 3 * c];
    k.h = s[7 + 3 * c] >> 4;
    k.v = s[7 + 3 * c] & 15;
    k.tq = s[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return JPE_CORRUPT;
    for (int e = 0; e < c; ++e)
      if (hd.comp[e].id == k.id) return JPE_CORRUPT;
    hd.hmax = c ? (k.h > hd.hmax ? k.h : hd.hmax) : k.h;
    hd.vmax = c ? (k.v > hd.vmax ? k.v : hd.vmax) : k.v;
  }
  if (hd.nc == 3) {
    // the ycc_canvas kernel's upsampling: luma at the largest factors, each
    // chroma factor dividing them by 1 or 2
    const Component& y = hd.comp[0];
    if (y.h != hd.hmax || y.v != hd.vmax) return JPE_SAMPLING;
    for (int c = 1; c < 3; ++c) {
      const Component& k = hd.comp[c];
      if (hd.hmax % k.h || hd.vmax % k.v) return JPE_SAMPLING;
      const int fh = hd.hmax / k.h, fv = hd.vmax / k.v;
      if (fh > 2 || fv > 2) return JPE_SAMPLING;
    }
  }
  for (int c = 0; c < hd.nc; ++c) {
    Component& k = hd.comp[c];
    k.plane_w = static_cast<int>((static_cast<int64_t>(hd.W) * k.h + hd.hmax - 1) / hd.hmax);
    k.plane_h = static_cast<int>((static_cast<int64_t>(hd.H) * k.v + hd.vmax - 1) / hd.vmax);
  }
  if (hd.nc == 1) {
    // a non-interleaved scan: one block an MCU, the component's own grid
    Component& k = hd.comp[0];
    hd.mcus_x = k.blocks_w = (k.plane_w + 7) / 8;
    hd.mcus_y = k.blocks_h = (k.plane_h + 7) / 8;
  } else {
    hd.mcus_x = (hd.W + 8 * hd.hmax - 1) / (8 * hd.hmax);
    hd.mcus_y = (hd.H + 8 * hd.vmax - 1) / (8 * hd.vmax);
    for (int c = 0; c < 3; ++c) {
      hd.comp[c].blocks_w = hd.mcus_x * hd.comp[c].h;
      hd.comp[c].blocks_h = hd.mcus_y * hd.comp[c].v;
    }
  }
  hd.blocks = 0;
  for (int c = 0; c < hd.nc; ++c)
    hd.blocks += static_cast<int64_t>(hd.comp[c].blocks_w) * hd.comp[c].blocks_h;
  return JPE_OK;
}

int parse_sos(Header& hd, const uint8_t* s, int n) {
  if (n < 1) return JPE_CORRUPT;
  const int ns = s[0];
  if (ns < 1 || ns > 4 || n != 4 + 2 * ns) return JPE_CORRUPT;
  if (ns != hd.nc) return JPE_SCANS;
  for (int i = 0; i < ns; ++i) {
    const int id = s[1 + 2 * i];
    int c = 0;
    while (c < hd.nc && hd.comp[c].id != id) ++c;
    if (c == hd.nc) return JPE_CORRUPT;
    for (int e = 0; e < i; ++e)
      if (hd.order[e] == c) return JPE_CORRUPT;
    hd.order[i] = c;
    Component& k = hd.comp[c];
    k.td = s[2 + 2 * i] >> 4;
    k.ta = s[2 + 2 * i] & 15;
    if (k.td > 3 || k.ta > 3 || !hd.dc[k.td].defined || !hd.ac[k.ta].defined ||
        !hd.qt_set[k.tq])
      return JPE_CORRUPT;
  }
  const uint8_t* t = s + 1 + 2 * ns;
  // Ss, Se, Ah/Al of a sequential scan (libjpeg warns on others)
  if (t[0] != 0 || t[1] != 63 || t[2] != 0) return JPE_CORRUPT;
  return JPE_OK;
}

// The markers from SOI through the first SOS: the frame, its tables, and
// where the entropy-coded data starts.
int parse_header(const uint8_t* data, size_t len, Header& hd) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return JPE_NOT_JPEG;
  size_t at = 2;
  bool frame = false;
  for (;;) {
    const int m = marker_at(data, len, &at);
    if (m < 0) return frame ? JPE_CORRUPT : JPE_NOT_JPEG;
    if (m == 0xD8 || m == 0xD9 || m == 0x01 || (m >= 0xD0 && m <= 0xD7))
      return JPE_CORRUPT;  // SOI, EOI, TEM, RSTn before the scan
    if (at + 2 > len) return JPE_CORRUPT;
    const int length = be16(data + at);
    if (length < 2 || at + length > len) return JPE_CORRUPT;
    const uint8_t* s = data + at + 2;
    const int n = length - 2;
    at += length;
    int st = JPE_OK;
    if (m == 0xC4) {
      st = parse_dht(hd, s, n);
    } else if (m == 0xCC) {
      st = JPE_ARITHMETIC;  // DAC
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC8) {
      if (frame) return JPE_CORRUPT;
      frame = true;
      st = parse_sof(hd, m, s, n);
    } else if (m == 0xDB) {
      st = parse_dqt(hd, s, n);
    } else if (m == 0xDD) {
      if (n != 2) return JPE_CORRUPT;
      hd.restart = be16(s);
    } else if (m == 0xDC) {
      st = JPE_DNL;
    } else if (m == 0xDA) {
      if (!frame) return JPE_CORRUPT;
      st = parse_sos(hd, s, n);
      if (st != JPE_OK) return st;
      hd.scan = at;
      // at least 2 bits a block (a DC code and an EOB or AC code): a header
      // whose blocks the file cannot hold is refused before any allocation
      if (static_cast<uint64_t>(hd.blocks) * 2 > static_cast<uint64_t>(len - at) * 8)
        return JPE_DIMENSIONS;
      return JPE_OK;
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
      // APPn, COM: skipped
    } else {
      return JPE_CORRUPT;  // JPGn, reserved and unknown markers
    }
    if (st != JPE_OK) return st;
  }
}

// jdhuff.c's bit reader: bits left-aligned in a 64-bit buffer, 0xFF00 as a
// data byte 0xFF, and zeros after a marker (libjpeg's padding).  Consuming a
// padding bit marks the data as corrupt (libjpeg warns there): n - zeros,
// the real bits left, goes negative then and stays so, since later fills
// add padding only, so it is checked once a block (consumed()).
struct Bits {
  const uint8_t* data;
  size_t len;
  size_t at;            // the next byte; at a marker, its first 0xFF
  uint64_t buf = 0;
  int n = 0;            // bits in buf, real and padding
  int zeros = 0;        // padding bits at the tail of buf
  bool hit = false;     // a marker or the data's end met
  bool bad = false;

  void fill() {
    // eight bytes at once while none of them is 0xFF (a stuffed byte or
    // a marker), else byte by byte
    if (!hit && at + 8 <= len) {
      uint64_t x;
      std::memcpy(&x, data + at, 8);
      x = __builtin_bswap64(x);
      const uint64_t inv = ~x;
      if (!((inv - 0x0101010101010101ull) & ~inv & 0x8080808080808080ull)) {
        const int k = (64 - n) >> 3;  // whole bytes that fit, 1 to 8
        buf |= (k == 8 ? x : x >> (64 - 8 * k)) << (64 - n - 8 * k);
        n += 8 * k;
        at += static_cast<size_t>(k);
        return;
      }
    }
    while (n <= 56) {
      if (!hit) {
        if (at >= len) {
          hit = true;
        } else if (data[at] != 0xFF) {
          buf |= static_cast<uint64_t>(data[at++]) << (56 - n);
          n += 8;
          continue;
        } else {
          size_t i = at + 1;
          while (i < len && data[i] == 0xFF) ++i;
          if (i < len && data[i] == 0) {
            at = i + 1;
            buf |= static_cast<uint64_t>(0xFF) << (56 - n);
            n += 8;
            continue;
          }
          hit = true;
        }
      }
      n += 8;
      zeros += 8;
    }
  }

  inline uint32_t peek(int k) const { return static_cast<uint32_t>(buf >> (64 - k)); }

  inline void skip(int k) {
    buf <<= k;
    n -= k;
  }

  // Whether the data so far was real: no padding bit consumed, no bad code.
  bool consumed() const { return !bad && n >= zeros; }

  inline int decode(const Huff& t) {
    if (n < 32) fill();
    const uint32_t look = t.look[peek(8)];
    if (look) {
      skip(static_cast<int>(look >> 8));
      return look & 0xFF;
    }
    const uint32_t bits16 = peek(16);
    for (int l = 9; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(bits16 >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valoffset[l] + code];
      }
    }
    bad = true;  // libjpeg's JWRN_HUFF_BAD_CODE
    return 0;
  }

  // HUFF_EXTEND of the next s bits (1 <= s <= 15), without a branch on
  // the sign: v - (2^s - 1) where the top bit of v is clear
  inline int extend(int s) {
    const int v = static_cast<int>(peek(s));
    skip(s);
    const int clear = ((v >> (s - 1)) & 1) - 1;  // -1 where the top bit is 0
    return v - (clear & ((1 << s) - 1));
  }

  // Real bits left beyond the last symbol: the padding of a byte (< 8).
  int real_left() const { return n - zeros; }

  void reset() {
    buf = 0;
    n = 0;
    zeros = 0;
    hit = false;
  }
};

// --- libjpeg-turbo's 16-bit lanes -------------------------------------------------
//
// The reference decodes with the system's libjpeg-turbo, whose SIMD ISLOW
// IDCT (jidctint-sse2.asm, jidctint-avx2.asm, jidctint-neon.c) computes
// jidctint.c's arithmetic in 16-bit lanes: a 16-bit dequantising multiply;
// x0 + x4, x0 - x4 and sums of the odd inputs formed in 16 bits; each pass-1
// output packed to 16 bits (saturated on x86, truncated on NEON); each
// sample saturated where jidctint.c's range-limit table wraps past
// [-512, 511].  Its products and their sums are 32-bit, and agree with
// jidctint.c's modulo 2^32.  So the two give the same samples on a block
// where every dequantised value, every sum of two or four inputs that
// jidctint.c forms in either pass (x0 + x4, x0 - x4, z2 + z3, t0 + t3,
// t1 + t2, t0 + t2, t1 + t3, z3 + z4) and every pass-1 output stays in int16,
// and every descaled sample in [-512, 511]: a superset of the lanes' 16-bit
// values.  The route computes int32 (the idct_islow kernel), so a file with
// any other block is refused (JPE_RANGE) and the caller decodes it with the
// reference's own libjpeg.
//
// The cheap bound, per block as its coefficients are decoded.  jidctint.c's
// 1-D pass before its DESCALE is a linear map, pre_j = sum_k M[j][k] x[k]
// with integer M; kWeight[k] = max_j |M[j][k]|.  For a block's dequantised
// values d[k][c] (row k, column c) let P_c = sum_k kWeight[k] |d[k][c]| and
// T = sum_c kWeight[c] P_c = sum_{k,c} kWeight[k] kWeight[c] |d[k][c]|.
//  - A pass-1 output w[r][c] = (pre + 2^10) >> 11, or d[0][c] << 2 on a
//    zero-AC column, has |w[r][c]| <= (P_c + 1024) / 2048.
//  - A pass-2 value before its DESCALE has |pre2| <= sum_c kWeight[c] |w[r][c]|
//    <= (T + 1024 * sum_c kWeight[c]) / 2048, and the sample
//    (pre2 + 2^17) >> 18 lies in [-512, 511] when |pre2| < 512 * 2^18 - 2^17.
// So T <= kRangeBound (below) puts every sample in range.  It also keeps the
// rest in int16, as every weight is at least 8192 = 2^13: sum |d| <=
// T / 2^26 <= 4090 bounds every dequantised value and every pass-1 sum;
// P_c <= T / 8192 gives |w| <= 16,363; and a row's sum of |w| <=
// (T / 8192 + 8 * 1024) / 2048 <= 16,366 bounds every pass-2 sum.  Blocks
// over the bound take the exact check, lanes_agree().
constexpr uint64_t kWeight[8] = {8192, 11363, 10703, 11362, 8192, 11362, 10704, 11363};
constexpr uint64_t kWeightSum = 83241;
constexpr uint64_t kRangeBound = 2048 * ((512ull << 18) - (1ull << 17)) - 1024 * kWeightSum - 1;
static_assert(kWeight[0] + kWeight[1] + kWeight[2] + kWeight[3] + kWeight[4] + kWeight[5] +
                  kWeight[6] + kWeight[7] == kWeightSum,
              "kWeightSum");

// A component's weights for T: kWeight[k] * kWeight[c] * q at natural
// position 8k + c (at most 11363^2 * 32767; times a coefficient's magnitude,
// 2^15 at most, and summed over 64 positions, within 2^63).
void range_weights(const uint16_t* q, uint64_t* wq) {
  for (int p = 0; p < 64; ++p) wq[p] = kWeight[p >> 3] * kWeight[p & 7] * q[p];
}

inline bool fits16(int64_t v) { return v >= -32768 && v <= 32767; }

// jidctint.c's 1-D pass over x, exactly (64-bit), each output DESCALEd by
// shift; false where a sum of inputs that it forms leaves int16.
bool pass_in_range(const int64_t* x, int shift, int64_t* out) {
  const int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  const int64_t z1 = t0 + t3, z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  if (!fits16(x[0] + x[4]) || !fits16(x[0] - x[4]) || !fits16(x[2] + x[6]) || !fits16(z1) ||
      !fits16(z2) || !fits16(z3) || !fits16(z4) || !fits16(z3 + z4))
    return false;
  const int64_t e1 = (x[2] + x[6]) * 4433;
  const int64_t tmp2 = e1 - x[6] * 15137, tmp3 = e1 + x[2] * 6270;
  const int64_t tmp0 = (x[0] + x[4]) * 8192, tmp1 = (x[0] - x[4]) * 8192;
  const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int64_t z5 = (z3 + z4) * 9633;
  const int64_t a1 = z1 * -7373, a2 = z2 * -20995;
  const int64_t a3 = z3 * -16069 + z5, a4 = z4 * -3196 + z5;
  const int64_t o0 = t0 * 2446 + a1 + a3, o1 = t1 * 16819 + a2 + a4;
  const int64_t o2 = t2 * 25172 + a2 + a3, o3 = t3 * 12299 + a1 + a4;
  const int64_t v[8] = {tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
                        tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3};
  const int64_t r = int64_t{1} << (shift - 1);
  for (int j = 0; j < 8; ++j) out[j] = (v[j] + r) >> shift;
  return true;
}

// The exact check: whether block blk (natural order) at table q keeps every
// value of the list above in its range, by jidctint.c's two passes.
bool lanes_agree(const int16_t* blk, const uint16_t* q) {
  int64_t ws[8][8];  // pass 1's outputs, [row][column]
  for (int c = 0; c < 8; ++c) {
    int64_t x[8], out[8];
    bool ac = false;
    for (int k = 0; k < 8; ++k) {
      x[k] = int64_t{blk[8 * k + c]} * q[8 * k + c];
      if (!fits16(x[k])) return false;
      ac |= k > 0 && blk[8 * k + c] != 0;
    }
    if (!pass_in_range(x, 11, out)) return false;
    for (int r = 0; r < 8; ++r) {
      const int64_t w = ac ? out[r] : x[0] * 4;  // the zero-AC column shortcut
      if (!fits16(w)) return false;
      ws[r][c] = w;
    }
  }
  for (int r = 0; r < 8; ++r) {
    int64_t out[8];
    if (!pass_in_range(ws[r], 18, out)) return false;
    for (int j = 0; j < 8; ++j)
      if (out[j] < -512 || out[j] > 511) return false;
  }
  return true;
}

// One block's Huffman data into blk (natural order); returns its T, the
// cheap bound's sum, from the component's range_weights wq.
inline uint64_t decode_block(Bits& br, const Huff& dc, const Huff& ac, int* pred, int16_t* blk,
                             const uint64_t* wq) {
  std::memset(blk, 0, 64 * sizeof(int16_t));
  const int s = br.decode(dc);
  const int diff = s ? br.extend(s) : 0;
  // libjpeg sums in unsigned arithmetic and stores a JCOEF (16 bits)
  *pred = static_cast<int>(static_cast<unsigned>(*pred) + static_cast<unsigned>(diff));
  blk[0] = static_cast<int16_t>(*pred);
  uint64_t t = wq[0] * static_cast<uint64_t>(blk[0] < 0 ? -blk[0] : blk[0]);
  for (int k = 1; k < 64; ++k) {
    if (br.n < 32) br.fill();
    const int32_t fast = ac.fast_ac[br.peek(kFastBits)];
    int v;
    if (fast) {
      br.skip(fast & 31);
      k += (fast >> 5) & 15;
      v = fast >> 9;
    } else {
      const int rs = br.decode(ac);
      const int r = rs >> 4, z = rs & 15;
      if (!z) {
        if (r != 15) break;
        k += 15;
        continue;
      }
      k += r;
      v = br.extend(z);
    }
    const int p = kNatural[k];
    blk[p] = static_cast<int16_t>(v);
    t += wq[p] * static_cast<uint64_t>(v < 0 ? -v : v);
  }
  return t;
}

// One file into coefs and qt; adds its blocks and those over the cheap bound
// to *blocks and *flagged.
int decode_file(const uint8_t* data, size_t len, int16_t* coefs, uint16_t* qt, int64_t* blocks,
                int64_t* flagged) {
  Header hd;
  int st = parse_header(data, len, hd);
  if (st != JPE_OK) return st;
  int16_t* base[3];
  uint64_t wq[3][64];
  int64_t at = 0;
  for (int c = 0; c < hd.nc; ++c) {
    base[c] = coefs + at * 64;
    at += static_cast<int64_t>(hd.comp[c].blocks_w) * hd.comp[c].blocks_h;
    std::memcpy(qt + 64 * c, hd.qt[hd.comp[c].tq], 64 * sizeof(uint16_t));
    range_weights(hd.qt[hd.comp[c].tq], wq[c]);
  }
  Bits br{data, len, hd.scan};
  int pred[3] = {0, 0, 0};
  int next_rst = 0;
  const int64_t mcus = static_cast<int64_t>(hd.mcus_x) * hd.mcus_y;
  const bool one = hd.nc == 1;
  for (int64_t m = 0; m < mcus; ++m) {
    if (hd.restart && m > 0 && m % hd.restart == 0) {
      // jdhuff.c's process_restart: the interval's bits end within a byte,
      // then RSTn in turn (libjpeg warns on anything else)
      if (!br.consumed() || br.real_left() >= 8) return JPE_CORRUPT;
      size_t i = br.at;
      if (marker_at(data, len, &i) != 0xD0 + next_rst) return JPE_CORRUPT;
      next_rst = (next_rst + 1) & 7;
      br.at = i;
      br.reset();
      pred[0] = pred[1] = pred[2] = 0;
    }
    const int mx = static_cast<int>(m % hd.mcus_x), my = static_cast<int>(m / hd.mcus_x);
    for (int i = 0; i < hd.nc; ++i) {
      const int c = hd.order[i];
      const Component& k = hd.comp[c];
      const int h = one ? 1 : k.h, v = one ? 1 : k.v;
      for (int by = 0; by < v; ++by) {
        int16_t* row = base[c] + (static_cast<int64_t>(my * v + by) * k.blocks_w + mx * h) * 64;
        for (int bx = 0; bx < h; ++bx) {
          int16_t* blk = row + bx * 64;
          ++*blocks;
          if (decode_block(br, hd.dc[k.td], hd.ac[k.ta], &pred[i], blk, wq[c]) > kRangeBound) {
            ++*flagged;
            if (!lanes_agree(blk, hd.qt[k.tq])) return JPE_RANGE;
          }
        }
      }
    }
    if (!br.consumed()) return JPE_CORRUPT;
  }
  if (br.real_left() >= 8) return JPE_CORRUPT;
  size_t i = br.at;
  const int m = marker_at(data, len, &i);
  if (m == 0xD9) return JPE_OK;
  if (m == 0xDA) return JPE_SCANS;
  if (m == 0xDC) return JPE_DNL;
  return JPE_CORRUPT;
}

// One batch handed to the workers: the caller's arrays, n files.
struct Job {
  const unsigned char* const* datas;
  const size_t* lengths;
  int n;
  void* const* coefs;
  void* const* qts;
  int* statuses;
  std::atomic<int> next{0};
};

struct Pool {
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable wake;  // a new job, or stop
  std::condition_variable idle;  // every worker has left the job
  Job* job = nullptr;
  unsigned long long generation = 0;
  int finished = 0;
  bool stop = false;
  std::atomic<long long> blocks{0}, flagged{0};  // since jpe_create
};

void run_worker(Pool* pool) {
  unsigned long long seen = 0;
  for (;;) {
    Job* job;
    {
      std::unique_lock<std::mutex> lk(pool->mu);
      pool->wake.wait(lk, [&] { return pool->stop || pool->generation != seen; });
      if (pool->stop) return;
      seen = pool->generation;
      job = pool->job;
    }
    int64_t blocks = 0, flagged = 0;
    for (int i; (i = job->next.fetch_add(1)) < job->n;) {
      int st;
      try {
        st = decode_file(job->datas[i], job->lengths[i], static_cast<int16_t*>(job->coefs[i]),
                         static_cast<uint16_t*>(job->qts[i]), &blocks, &flagged);
      } catch (...) {
        st = JPE_EXCEPTION;
      }
      job->statuses[i] = st;
    }
    pool->blocks += blocks;
    pool->flagged += flagged;
    {
      std::lock_guard<std::mutex> lk(pool->mu);
      if (++pool->finished == static_cast<int>(pool->threads.size())) pool->idle.notify_all();
    }
  }
}

void stop_pool(Pool* pool) {
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    pool->stop = true;
  }
  pool->wake.notify_all();
  for (auto& t : pool->threads) t.join();
  delete pool;
}

}  // namespace

extern "C" {

// A pool of exactly num_threads workers, or NULL.
void* jpe_create(int num_threads) {
  if (num_threads < 1) return nullptr;
  auto* pool = new Pool();
  try {
    for (int i = 0; i < num_threads; ++i) pool->threads.emplace_back(run_worker, pool);
  } catch (...) {
    stop_pool(pool);
    return nullptr;
  }
  return pool;
}

void jpe_destroy(void* ptr) {
  if (ptr) stop_pool(static_cast<Pool*>(ptr));
}

// The header of one file (the markers through its scan's header) into info
// (kInfoWords ints): width, height, components, then for each component in
// frame order h and v sampling factors, blocks_w and blocks_h of its
// MCU-padded grid, and its stored width and height.  Returns a status; on a
// refusal info holds what was parsed.
int jpe_info(const unsigned char* data, size_t length, int* info) {
  Header hd;
  const int st = parse_header(data, length, hd);
  std::memset(info, 0, kInfoWords * sizeof(int));
  info[0] = hd.W;
  info[1] = hd.H;
  info[2] = hd.nc;
  for (int c = 0; c < hd.nc && c < 3; ++c) {
    const Component& k = hd.comp[c];
    int* w = info + 3 + 6 * c;
    w[0] = k.h;
    w[1] = k.v;
    w[2] = k.blocks_w;
    w[3] = k.blocks_h;
    w[4] = k.plane_w;
    w[5] = k.plane_h;
  }
  return st;
}

// Decode n files on the workers: file i's bytes datas[i] (lengths[i]), its
// coefficients into coef_ptrs[i] and its tables into qt_ptrs[i], laid out as
// jpe_info's words say (see the top of this file), its status in statuses[i].
// Returns once every file is done.  Calls on one pool must not overlap (the
// caller serialises them).
void jpe_decode_batch(void* ptr, const unsigned char* const* datas, const size_t* lengths,
                      int n, void* const* coef_ptrs, void* const* qt_ptrs, int* statuses) {
  auto* pool = static_cast<Pool*>(ptr);
  if (n <= 0) return;
  Job job;
  job.datas = datas;
  job.lengths = lengths;
  job.n = n;
  job.coefs = coef_ptrs;
  job.qts = qt_ptrs;
  job.statuses = statuses;
  std::unique_lock<std::mutex> lk(pool->mu);
  pool->job = &job;
  pool->finished = 0;
  ++pool->generation;
  pool->wake.notify_all();
  // every worker leaves the job before it goes out of scope
  pool->idle.wait(lk, [&] { return pool->finished == static_cast<int>(pool->threads.size()); });
  pool->job = nullptr;
}

// The pool's counts since jpe_create, once no batch runs: counts[0] the
// blocks decoded, counts[1] those over the cheap bound of libjpeg-turbo's
// 16-bit lanes, which took the exact check.
void jpe_counts(void* ptr, long long* counts) {
  const auto* pool = static_cast<const Pool*>(ptr);
  counts[0] = pool->blocks.load();
  counts[1] = pool->flagged.load();
}

}  // extern "C"
