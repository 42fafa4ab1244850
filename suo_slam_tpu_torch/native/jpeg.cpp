// jpeg: a baseline JPEG decoder for the BOP loader.
//
// The JAX package reads frames with `cv2.imread`, which runs libjpeg-turbo;
// the card's machine has no OpenCV, so the port decodes JPEG itself
// (`suo_slam_tpu_torch/data/jpeg.py` over this library, built with g++ at
// first use into `build/suo_native/`). It reproduces what libjpeg computes
// by default, whose C sources are the specification (the SIMD versions are
// bit-exact with them):
//   - the integer IDCT `jpeg_idct_islow` (jidctint.c), with its range limit;
//   - "fancy" triangle upsampling (jdsample.c: h2v1, h1v2, h2v2 with their
//     alternating biases, edge columns and replicated context rows; plain
//     replication where the chroma is at most 2 samples wide);
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16).
// Output: [H, W, 3] uint8 BGR for a 3-component file, [H, W] for a gray one.
//
// Supported: SOF0 / SOF1 with 8-bit samples; DQT with 8- and 16-bit tables;
// DHT; DRI and RST0-7; APPn (APP0 JFIF, APP1 EXIF orientation, APP14 Adobe),
// COM; one interleaved scan holding every component; 1 component, or 3 with
// the luma sampled 1x1, 2x1, 1x2 or 2x2 and the chroma 1x1. Anything else
// (progressive, arithmetic, lossless, hierarchical, 12-bit, CMYK, RGB
// colour space, multi-scan files) is refused with a message naming the
// marker; nothing falls back.
//
// No global mutable state: every call owns its decoder, so threads and
// processes call it concurrently.
//
// C API (ctypes): jpg_info (size, components, EXIF orientation) and
// jpg_decode (pixels into a caller buffer); both return 0, or -1 with a
// message in `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zigzag -> natural order, with 16 extra entries so a corrupt run past
// coefficient 63 lands on 63 (as libjpeg-turbo's table does)
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

struct Huff {
  bool set = false;
  uint8_t look_len[512];  // 9-bit lookahead: code length, 0 if longer
  uint8_t look_sym[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;      // blocks a row / a column in the plane
  int dw = 0, dh = 0;      // downsampled width / height (libjpeg's)
  std::vector<uint8_t> plane;
  int stride = 0;
  int pred = 0;
};

struct Frame {
  int width = 0, height = 0, ncomp = 0;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_set[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool saw_sof = false, saw_jfif = false, saw_adobe = false, saw_app1 = false;
  int adobe_transform = -1;
  int orientation = 1;
  int scan_order[3] = {0, 1, 2};
  size_t scan_pos = 0;  // first byte of the entropy-coded data
};

const char* marker_name(int m, char* buf) {
  switch (m) {
    case 0xC2: return "SOF2 (progressive)";
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
    case 0xF7: return "SOF55 (JPEG-LS)";
    case 0xDC: return "DNL";
    default: std::snprintf(buf, 16, "0x%02X", m); return buf;
  }
}

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

void build_huff(Huff& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) throw Error{"DHT: bad Huffman table (code space overflow)"};
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h.valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  std::memset(h.look_len, 0, sizeof(h.look_len));
  std::memset(h.look_sym, 0, sizeof(h.look_sym));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int look = huffcode[p] << (9 - l);
      for (int c = 0; c < (1 << (9 - l)); ++c) {
        h.look_len[look + c] = static_cast<uint8_t>(l);
        h.look_sym[look + c] = vals[p];
      }
    }
  }
  std::memset(h.vals, 0, sizeof(h.vals));
  std::memcpy(h.vals, vals, nvals);
  h.set = true;
}

// EXIF orientation as OpenCV reads it: the first APP1 segment, its TIFF
// header 6 bytes in, tag 0x0112 of IFD0. Anything unreadable leaves 1.
int exif_orientation(const uint8_t* d, int n) {
  if (n <= 6) return 1;
  d += 6;
  n -= 6;
  if (n < 8) return 1;
  bool le;
  if (d[0] == 'I' && d[1] == 'I') le = true;
  else if (d[0] == 'M' && d[1] == 'M') le = false;
  else return 1;
  auto u16 = [&](int o) -> int {
    return le ? (d[o] | (d[o + 1] << 8)) : ((d[o] << 8) | d[o + 1]);
  };
  auto u32 = [&](int o) -> uint32_t {
    return le ? (uint32_t(d[o]) | (uint32_t(d[o + 1]) << 8) | (uint32_t(d[o + 2]) << 16) |
                 (uint32_t(d[o + 3]) << 24))
              : ((uint32_t(d[o]) << 24) | (uint32_t(d[o + 1]) << 16) |
                 (uint32_t(d[o + 2]) << 8) | uint32_t(d[o + 3]));
  };
  uint32_t off = u32(4);
  if (off + 2 > uint32_t(n)) return 1;
  int count = u16(off);
  off += 2;
  for (int i = 0; i < count; ++i, off += 12) {
    if (off + 12 > uint32_t(n)) return 1;
    if (u16(off) == 0x0112) return u16(off + 8);
  }
  return 1;
}

// Markers from SOI to the first SOS; fills `f`.
void parse_headers(const uint8_t* d, size_t n, Frame& f) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Error{"not a JPEG file (no SOI marker)"};
  size_t pos = 2;
  char nb[16];
  for (;;) {
    while (pos < n && d[pos] != 0xFF) ++pos;  // garbage before a marker
    while (pos < n && d[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= n) throw Error{"unexpected end of data before SOS"};
    int m = d[pos++];
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xD9) throw Error{"EOI before any scan"};
    if (pos + 2 > n) throw Error{"truncated marker segment"};
    int len = be16(d + pos);
    if (len < 2 || pos + len > n) throw Error{"truncated marker segment"};
    const uint8_t* s = d + pos + 2;
    int sl = len - 2;
    pos += len;
    switch (m) {
      case 0xC0:
      case 0xC1: {
        if (f.saw_sof) throw Error{"two SOF markers"};
        if (sl < 6) throw Error{"SOF: truncated"};
        if (s[0] != 8)
          throw Error{std::string(m == 0xC0 ? "SOF0" : "SOF1") + ": " + std::to_string(s[0]) +
                      "-bit samples are not supported (8-bit only)"};
        f.height = be16(s + 1);
        f.width = be16(s + 3);
        f.ncomp = s[5];
        if (f.height == 0) throw Error{"SOF: height 0 (a DNL marker) is not supported"};
        if (f.width == 0) throw Error{"SOF: width 0"};
        if (f.ncomp == 4) throw Error{"SOF: 4 components (CMYK / YCCK) are not supported"};
        if (f.ncomp != 1 && f.ncomp != 3)
          throw Error{"SOF: " + std::to_string(f.ncomp) + " components are not supported"};
        if (sl < 6 + 3 * f.ncomp) throw Error{"SOF: truncated"};
        for (int c = 0; c < f.ncomp; ++c) {
          f.comp[c].id = s[6 + 3 * c];
          f.comp[c].h = s[7 + 3 * c] >> 4;
          f.comp[c].v = s[7 + 3 * c] & 15;
          f.comp[c].tq = s[8 + 3 * c];
          if (f.comp[c].tq > 3) throw Error{"SOF: bad quantization table index"};
          if (f.comp[c].h < 1 || f.comp[c].h > 4 || f.comp[c].v < 1 || f.comp[c].v > 4)
            throw Error{"SOF: bad sampling factors"};
        }
        f.saw_sof = true;
        break;
      }
      case 0xC4: {
        int o = 0;
        while (o < sl) {
          if (o + 17 > sl) throw Error{"DHT: truncated"};
          int tc = s[o] >> 4, th = s[o] & 15;
          if (tc > 1 || th > 3) throw Error{"DHT: bad table class or index"};
          int total = 0;
          for (int i = 0; i < 16; ++i) total += s[o + 1 + i];
          if (total > 256 || o + 17 + total > sl) throw Error{"DHT: bad table"};
          build_huff(tc ? f.ac[th] : f.dc[th], s + o + 1, s + o + 17, total);
          o += 17 + total;
        }
        break;
      }
      case 0xDB: {
        int o = 0;
        while (o < sl) {
          int pq = s[o] >> 4, tq = s[o] & 15;
          if (tq > 3 || pq > 1) throw Error{"DQT: bad table"};
          int need = 1 + 64 * (pq + 1);
          if (o + need > sl) throw Error{"DQT: truncated"};
          for (int k = 0; k < 64; ++k)
            f.qt[tq][kNatural[k]] =
                pq ? static_cast<uint16_t>(be16(s + o + 1 + 2 * k)) : s[o + 1 + k];
          f.qt_set[tq] = true;
          o += need;
        }
        break;
      }
      case 0xDD:
        if (sl < 2) throw Error{"DRI: truncated"};
        f.restart_interval = be16(s);
        break;
      case 0xE0:
        if (sl >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) f.saw_jfif = true;
        break;
      case 0xE1:
        if (!f.saw_app1) {
          f.saw_app1 = true;
          f.orientation = exif_orientation(s, sl);
        }
        break;
      case 0xEE:
        if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
          f.saw_adobe = true;
          f.adobe_transform = s[11];
        }
        break;
      case 0xDA: {
        if (!f.saw_sof) throw Error{"SOS before SOF"};
        int ns = sl > 0 ? s[0] : 0;
        if (ns != f.ncomp)
          throw Error{"SOS: a scan of " + std::to_string(ns) + " of " + std::to_string(f.ncomp) +
                      " components (multi-scan files are not supported)"};
        if (sl < 1 + 2 * ns + 3) throw Error{"SOS: truncated"};
        for (int i = 0; i < ns; ++i) {
          int cs = s[1 + 2 * i], c = -1;
          for (int k = 0; k < f.ncomp; ++k)
            if (f.comp[k].id == cs) c = k;
          if (c < 0) throw Error{"SOS: unknown component id"};
          f.comp[c].td = s[2 + 2 * i] >> 4;
          f.comp[c].ta = s[2 + 2 * i] & 15;
          if (f.comp[c].td > 3 || f.comp[c].ta > 3) throw Error{"SOS: bad table index"};
          f.scan_order[i] = c;
        }
        int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], a = s[3 + 2 * ns];
        if (ss != 0 || se != 63 || a != 0) throw Error{"SOS: not a sequential scan"};
        f.scan_pos = pos;
        return;
      }
      default:
        if ((m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) || m == 0xF7 ||
            m == 0xDC)
          throw Error{std::string(marker_name(m, nb)) + " is not supported"};
        break;  // APPn, COM, JPGn, DAC-less others: skipped
    }
  }
}

void check_frame(Frame& f) {
  if (f.ncomp == 3) {
    bool rgb;
    if (f.saw_jfif) rgb = false;
    else if (f.saw_adobe) rgb = f.adobe_transform == 0;
    else rgb = f.comp[0].id == 82 && f.comp[1].id == 71 && f.comp[2].id == 66;
    if (rgb) throw Error{"RGB colour space (APP14 Adobe transform 0 or 'RGB' ids) is not supported"};
    int h = f.comp[0].h, v = f.comp[0].v;
    if (h > 2 || v > 2 || f.comp[1].h != 1 || f.comp[1].v != 1 || f.comp[2].h != 1 ||
        f.comp[2].v != 1)
      throw Error{"SOF: sampling factors " + std::to_string(h) + "x" + std::to_string(v) + ", " +
                  std::to_string(f.comp[1].h) + "x" + std::to_string(f.comp[1].v) + ", " +
                  std::to_string(f.comp[2].h) + "x" + std::to_string(f.comp[2].v) +
                  " are not supported"};
  } else {
    f.comp[0].h = f.comp[0].v = 1;  // a lone component's scan is not interleaved
  }
  for (int c = 0; c < f.ncomp; ++c)
    if (!f.qt_set[f.comp[c].tq]) throw Error{"a component's quantization table is missing"};
}

// ------------------------------------------------------------ entropy ---
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t byte = 0;
      if (!marker && pos < n) {
        byte = d[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0) {
            pos = q + 1;  // stuffed 0xFF (fill bytes before it skipped)
          } else {
            marker = true;  // past the data: zeros, as libjpeg inserts
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - cnt);
      cnt += 8;
    }
  }
  inline int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = static_cast<int>(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  inline int decode(const Huff& h) {
    if (cnt < 16) fill();
    int look = static_cast<int>(buf >> 55);
    int l = h.look_len[look];
    if (l) {
      buf <<= l;
      cnt -= l;
      return h.look_sym[look];
    }
    l = 10;
    int code = static_cast<int>(buf >> (64 - l));
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = static_cast<int>(buf >> (64 - l));
    }
    if (l > 16) {  // corrupt data: libjpeg warns and yields 0
      buf <<= 16;
      cnt -= 16;
      return 0;
    }
    buf <<= l;
    cnt -= l;
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // After a restart interval: drop the partial byte, skip the RSTn marker.
  void restart() {
    buf = 0;
    cnt = 0;
    marker = false;
    size_t q = pos;
    while (q + 1 < n) {
      if (d[q] == 0xFF && d[q + 1] != 0 && d[q + 1] != 0xFF) {
        if (d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7) q += 2;
        break;
      }
      ++q;
    }
    pos = q;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------- IDCT ---
// jidctint.c jpeg_idct_islow, 8-bit samples: CONST_BITS 13, PASS1_BITS 2.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433,
                  F_0_765366865 = 6270, F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137, F_1_961570560 = 16069,
                  F_2_053119869 = 16819, F_2_562915447 = 20995, F_3_072711026 = 25172;

// libjpeg's post-IDCT range limit: x & 1023 as a signed 10-bit value, clamped
// to [-128, 127], plus 128.
inline uint8_t range_limit(int32_t x) {
  int m = x & 1023;
  if (m < 128) return static_cast<uint8_t>(m + 128);
  if (m < 512) return 255;
  if (m < 896) return 0;
  return static_cast<uint8_t>(m - 896);
}

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = (int32_t(in[0]) * qq[0]) * (1 << kPass1Bits);
      for (int k = 0; k < 8; ++k) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = int32_t(in[16]) * qq[16], z3 = int32_t(in[48]) * qq[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = int32_t(in[0]) * qq[0];
    z3 = int32_t(in[32]) * qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * qq[56];
    tmp1 = int32_t(in[40]) * qq[40];
    tmp2 = int32_t(in[24]) * qq[24];
    tmp3 = int32_t(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = range_limit(descale(w[0], kPass1Bits + 3));
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits + kPass1Bits + 3;
    o[0] = range_limit(descale(tmp10 + tmp3, sh));
    o[7] = range_limit(descale(tmp10 - tmp3, sh));
    o[1] = range_limit(descale(tmp11 + tmp2, sh));
    o[6] = range_limit(descale(tmp11 - tmp2, sh));
    o[2] = range_limit(descale(tmp12 + tmp1, sh));
    o[5] = range_limit(descale(tmp12 - tmp1, sh));
    o[3] = range_limit(descale(tmp13 + tmp0, sh));
    o[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

// Entropy-decode every MCU and inverse-transform each block into its
// component's plane.
void decode_scan(const uint8_t* d, size_t n, Frame& f) {
  int hmax = 1, vmax = 1;
  for (int c = 0; c < f.ncomp; ++c) {
    hmax = std::max(hmax, f.comp[c].h);
    vmax = std::max(vmax, f.comp[c].v);
  }
  int mcux = (f.width + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (f.height + 8 * vmax - 1) / (8 * vmax);
  for (int c = 0; c < f.ncomp; ++c) {
    Component& k = f.comp[c];
    k.bw = mcux * k.h;
    k.bh = mcuy * k.v;
    k.stride = 8 * k.bw;
    k.plane.assign(size_t(k.stride) * 8 * k.bh, 0);
    k.dw = (f.width * k.h + hmax - 1) / hmax;
    k.dh = (f.height * k.v + vmax - 1) / vmax;
    k.pred = 0;
    if (!f.dc[k.td].set || !f.ac[k.ta].set) throw Error{"SOS: a Huffman table is missing"};
  }
  Bits bits{d, n, f.scan_pos};
  int16_t coef[64];
  int64_t count = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (f.restart_interval && count > 0 && count % f.restart_interval == 0) {
        bits.restart();
        for (int c = 0; c < f.ncomp; ++c) f.comp[c].pred = 0;
      }
      for (int i = 0; i < f.ncomp; ++i) {
        Component& k = f.comp[f.scan_order[i]];
        const Huff& dc = f.dc[k.td];
        const Huff& ac = f.ac[k.ta];
        const uint16_t* q = f.qt[k.tq];
        for (int by = 0; by < k.v; ++by) {
          for (int bx = 0; bx < k.h; ++bx) {
            std::memset(coef, 0, sizeof(coef));
            int s = bits.decode(dc);
            if (s) {
              if (s > 16) s = 16;
              k.pred += extend(bits.get(s), s);
            }
            coef[0] = static_cast<int16_t>(k.pred);
            for (int z = 1; z < 64; ++z) {
              int rs = bits.decode(ac);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                z += r;
                coef[kNatural[z]] = static_cast<int16_t>(extend(bits.get(s), s));
              } else {
                if (r != 15) break;
                z += 15;
              }
            }
            int row = (my * k.v + by) * 8, col = (mx * k.h + bx) * 8;
            idct_islow(coef, q, k.plane.data() + size_t(row) * k.stride + col, k.stride);
          }
        }
      }
      ++count;
    }
  }
  // A second scan after this one (a multi-scan file) is refused.
  size_t q = bits.pos;
  while (q + 1 < n) {
    if (d[q] == 0xFF && d[q + 1] != 0 && d[q + 1] != 0xFF && !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7)) {
      int m = d[q + 1];
      if (m == 0xD9) break;
      if (m == 0xDA) throw Error{"a second SOS (multi-scan files are not supported)"};
      if (q + 4 > n) break;
      q += 2 + be16(d + q + 2);
      continue;
    }
    ++q;
  }
}

// ------------------------------------------------------ upsample + colour ---
// jdsample.c's fancy upsamplers for a chroma plane at (hmax, vmax) = (2, 1),
// (1, 2) or (2, 2) relative to the luma: writes [height][width] into `out`.
void upsample(const Component& k, int hf, int vf, int width, int height, uint8_t* out) {
  const uint8_t* in = k.plane.data();
  const int st = k.stride, dw = k.dw, dh = k.dh;
  auto row = [&](int r) { return in + size_t(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * st; };
  std::vector<uint8_t> line(size_t(2 * dw + 2));
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + size_t(y) * width;
    if (hf == 1 && vf == 1) {
      std::memcpy(o, row(y), width);
    } else if (hf == 2 && vf == 1) {
      const uint8_t* ip = row(y);
      if (dw > 2) {
        uint8_t* op = line.data();
        int v = ip[0];
        *op++ = static_cast<uint8_t>(v);
        *op++ = static_cast<uint8_t>((v * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = ip[x] * 3;
          *op++ = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
          *op++ = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
        }
        v = ip[dw - 1];
        *op++ = static_cast<uint8_t>((v * 3 + ip[dw - 2] + 1) >> 2);
        *op++ = static_cast<uint8_t>(v);
        std::memcpy(o, line.data(), width);
      } else {
        for (int x = 0; x < width; ++x) o[x] = ip[x >> 1];
      }
    } else if (hf == 1 && vf == 2) {
      int r = y >> 1;
      const uint8_t* i0 = row(r);
      const uint8_t* i1 = (y & 1) ? row(r + 1) : row(r - 1);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
    } else {  // 2 x 2
      int r = y >> 1;
      const uint8_t* i0 = row(r);
      if (dw > 2) {
        const uint8_t* i1 = (y & 1) ? row(r + 1) : row(r - 1);
        uint8_t* op = line.data();
        int this_sum = i0[0] * 3 + i1[0], next_sum = i0[1] * 3 + i1[1], last_sum;
        *op++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        *op++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < dw; ++x) {
          next_sum = i0[x] * 3 + i1[x];
          *op++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          *op++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *op++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        *op++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        std::memcpy(o, line.data(), width);
      } else {
        for (int x = 0; x < width; ++x) o[x] = i0[x >> 1];
      }
    }
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + kHalf);
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void convert(const Frame& f, uint8_t* out) {
  const int w = f.width, h = f.height;
  const Component& y = f.comp[0];
  if (f.ncomp == 1) {
    for (int r = 0; r < h; ++r) std::memcpy(out + size_t(r) * w, y.plane.data() + size_t(r) * y.stride, w);
    return;
  }
  static const ColorTables t;  // immutable once built (a thread-safe static)
  const int hf = y.h, vf = y.v;
  std::vector<uint8_t> cb(size_t(w) * h), cr(size_t(w) * h);
  upsample(f.comp[1], hf, vf, w, h, cb.data());
  upsample(f.comp[2], hf, vf, w, h, cr.data());
  for (int r = 0; r < h; ++r) {
    const uint8_t* yp = y.plane.data() + size_t(r) * y.stride;
    const uint8_t* bp = cb.data() + size_t(r) * w;
    const uint8_t* rp = cr.data() + size_t(r) * w;
    uint8_t* o = out + size_t(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      int yy = yp[x], b = bp[x], c = rp[x];
      o[3 * x + 2] = clamp255(yy + t.cr_r[c]);
      o[3 * x + 1] = clamp255(yy + ((t.cb_g[b] + t.cr_g[c]) >> 16));
      o[3 * x + 0] = clamp255(yy + t.cb_b[b]);
    }
  }
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// out4 = (height, width, components (1 or 3), EXIF orientation)
int jpg_info(const uint8_t* data, int64_t n, int32_t* out4, char* err, int errlen) {
  try {
    Frame f;
    parse_headers(data, size_t(n), f);
    check_frame(f);
    out4[0] = f.height;
    out4[1] = f.width;
    out4[2] = f.ncomp;
    out4[3] = f.orientation;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return -1;
}

// out: [H, W] (1 component) or [H, W, 3] BGR, out_size bytes
int jpg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, char* err,
               int errlen) {
  try {
    Frame f;
    parse_headers(data, size_t(n), f);
    check_frame(f);
    int64_t need = int64_t(f.height) * f.width * (f.ncomp == 1 ? 1 : 3);
    if (out_size != need) throw Error{"output buffer has the wrong size"};
    decode_scan(data, size_t(n), f);
    convert(f, out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
