// zoo_image: the image codec's native half for the PyTorch port.
//
// Decodes baseline, extended-sequential and progressive Huffman JPEG
// (8-bit, 1, 3 or 4 components, any integer sampling such as 4:4:4, 4:2:2,
// 4:2:0, restart intervals) to BGR uint8 HWC, the layout of
// cv2.imdecode(IMREAD_COLOR). To give libjpeg's pixels it uses libjpeg's
// own arithmetic: the islow integer IDCT (jidctint.c) with its range-limit
// table, the "fancy" triangular upsampling of h2v1, h1v2 and h2v2
// (jdsample.c; edge rows and columns replicated as jdmainct.c pads them)
// and the fixed-point YCbCr->RGB tables (jdcolor.c). A progressive file's
// scans (jdphuff.c: DC first and refine, AC first with EOB runs, AC
// refine) fill the whole image's coefficients; a file whose last scans
// leave low coefficients unrefined is block-smoothed as jdcoefct.c's
// decompress_smooth_data does. Four components are CMYK (or YCCK under an
// Adobe transform of 2), turned into BGR by OpenCV's own formula.
// Arithmetic-coded, lossless, hierarchical and 12-bit files are refused
// with a message naming the mode.
//
// Encodes baseline JPEG (4:2:0, the Annex K tables scaled by quality as
// jpeg_quality_scaling does, the standard Huffman tables, the islow
// forward DCT of jfdctint.c and the downsampling of jcsample.c), and
// reverses the five PNG row filters after zlib inflates the data.
//
// A plain C interface consumed through ctypes (feature/image/codec.py;
// utils/native_loader.py builds this file with g++ at first use).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the block's end lands on the last coefficient,
    // as libjpeg's extended natural-order table makes it
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

// cv2.imdecode refuses images over 2^30 pixels (CV_IO_MAX_IMAGE_PIXELS)
const uint64_t kMaxPixels = uint64_t{1} << 30;

// ---------------------------------------------------------------------------
// decoder
// ---------------------------------------------------------------------------

struct Huffman {
  bool present = false;
  int max_sym = 0;  // a DC table's symbols are bit counts, 0 to 15
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valptr[17];
  int mincode[17];

  void build(const uint8_t* bits) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;      // blocks across and down, padded to the MCU
  int dw = 0, dh = 0;      // the component's real ("downsampled") size
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  int pred = 0;
  bool scanned = false;
  // progressive only: the whole image's coefficients (bw x bh blocks of
  // 64, natural order, libjpeg's 16-bit JCOEF), and per coefficient the
  // Al of the last scan that touched it (-1: none yet) and its value when
  // the current scan began (jdphuff.c's coef_bits and their second half)
  std::vector<int16_t> coef;
  int coef_bits[64];
  int prev_coef_bits[64];
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

// The entropy-coded data of one scan, read as libjpeg's jdhuff.c reads
// it, so that a corrupt or cut file decodes as OpenCV decodes it: bits are
// fetched only when a code needs them; a marker in the data stops the
// fetch and zeros stand in for what is missing (`insufficient` then
// leaves the rest of the restart interval's MCUs at zero, uniform grey);
// data that ends with no marker is a truncated file, which OpenCV's
// memory source refuses.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // the next bits, left-aligned; zeros past `nbits`
  int nbits = 0;
  int marker = 0;  // libjpeg's unread_marker: the code the data ran into
  bool insufficient = false;

  [[noreturn]] static void truncated() {
    throw Error{"JPEG data ends inside a scan (truncated file)"};
  }
  // jpeg_fill_bit_buffer with libjpeg-turbo's 64-bit buffer: top up to
  // MIN_GET_BITS = 57 bits or to the next marker. How far it reads ahead
  // decides which cut files OpenCV refuses.
  void fill() {
    while (nbits < 57 && !marker) {
      if (p >= end) truncated();
      uint64_t b = *p++;
      if (b == 0xFF) {
        while (p < end && *p == 0xFF) ++p;  // fill bytes
        if (p >= end) truncated();
        int c = *p++;
        if (c != 0) {
          marker = c;
          break;
        }
      }
      acc |= b << (56 - nbits);
      nbits += 8;
    }
  }
  // Take `n` bits; past a marker they are zeros.
  void drop(int n) {
    if (n > nbits) {
      insufficient = true;
      nbits = n;
    }
    acc = n < 64 ? acc << n : 0;
    nbits -= n;
  }
  int bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = static_cast<int>(acc >> (64 - n));
    drop(n);
    return v;
  }
  int decode(const Huffman& h) {
    if (nbits < 8) fill();
    for (int l = 1; l <= 17; ++l) {
      if (l > nbits) fill();
      if (l == 17) break;
      int code = static_cast<int>(acc >> (64 - l));
      if (code <= h.maxcode[l]) {
        drop(l);
        int idx = h.valptr[l] + code - h.mincode[l];
        return h.vals[idx & 0xFF];
      }
    }
    drop(17);  // corrupt code: skip 17 bits and decode a zero, as
    return 0;  // libjpeg's jpeg_huff_decode does
  }
  // jdmarker.c's next_marker: discard data up to the next marker.
  void next_marker() {
    for (;;) {
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) truncated();
      int c = *p++;
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }
  // process_restart with read_restart_marker and jpeg_resync_to_restart:
  // drop the buffered bits and step over RSTn, `expected` (0..7); past a
  // corrupt or missing marker resynchronise as libjpeg does.
  void restart(int& expected) {
    acc = 0;
    nbits = 0;
    if (!marker) next_marker();
    if (marker == 0xD0 + expected) {
      marker = 0;
    } else {
      for (;;) {
        int action;
        if (marker < 0xC0) {
          action = 2;  // not a marker code: read on
        } else if (marker < 0xD0 || marker > 0xD7) {
          action = 3;  // a real marker: leave it, feed zeros
        } else if (marker == 0xD0 + ((expected + 1) & 7) ||
                   marker == 0xD0 + ((expected + 2) & 7)) {
          action = 3;  // a later RST: ours was lost
        } else if (marker == 0xD0 + ((expected - 1) & 7) ||
                   marker == 0xD0 + ((expected - 2) & 7)) {
          action = 2;  // an earlier RST: ours lies ahead
        } else {
          action = 1;  // too far off to trust: take it as ours
        }
        if (action == 1) {
          marker = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
      }
    }
    expected = (expected + 1) & 7;
    if (!marker) insufficient = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// libjpeg's post-IDCT range-limit table, indexed by (x & 1023).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(128 + i);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + (static_cast<int64_t>(1) << ((n)-1))) >> (n))

// jidctint.c's jpeg_idct_islow: coef in natural order, q the natural-order
// quantization table, out an 8x8 window of a plane with row pitch `pitch`.
void idct_islow(const int* coef, const uint16_t* q, uint8_t* out,
                int pitch) {
  const int CB = 13, P1 = 2;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int* in = coef + c;
    const uint16_t* qp = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = static_cast<int>(static_cast<int64_t>(in[0]) * qp[0] *
                                (1 << P1));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qp[16], z3 = in[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * qp[0];
    z3 = in[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qp[56];
    tmp1 = in[40] * qp[40];
    tmp2 = in[24] * qp[24];
    tmp3 = in[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = static_cast<int>(DESCALE(tmp10 + tmp3, CB - P1));
    w[56] = static_cast<int>(DESCALE(tmp10 - tmp3, CB - P1));
    w[8] = static_cast<int>(DESCALE(tmp11 + tmp2, CB - P1));
    w[48] = static_cast<int>(DESCALE(tmp11 - tmp2, CB - P1));
    w[16] = static_cast<int>(DESCALE(tmp12 + tmp1, CB - P1));
    w[40] = static_cast<int>(DESCALE(tmp12 - tmp1, CB - P1));
    w[24] = static_cast<int>(DESCALE(tmp13 + tmp0, CB - P1));
    w[32] = static_cast<int>(DESCALE(tmp13 - tmp0, CB - P1));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * pitch;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[static_cast<int>(DESCALE(
                              static_cast<int64_t>(w[0]), P1 + 3)) & 1023];
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << CB);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int S = CB + P1 + 3;
    o[0] = kRange.t[static_cast<int>(DESCALE(tmp10 + tmp3, S)) & 1023];
    o[7] = kRange.t[static_cast<int>(DESCALE(tmp10 - tmp3, S)) & 1023];
    o[1] = kRange.t[static_cast<int>(DESCALE(tmp11 + tmp2, S)) & 1023];
    o[6] = kRange.t[static_cast<int>(DESCALE(tmp11 - tmp2, S)) & 1023];
    o[2] = kRange.t[static_cast<int>(DESCALE(tmp12 + tmp1, S)) & 1023];
    o[5] = kRange.t[static_cast<int>(DESCALE(tmp12 - tmp1, S)) & 1023];
    o[3] = kRange.t[static_cast<int>(DESCALE(tmp13 + tmp0, S)) & 1023];
    o[4] = kRange.t[static_cast<int>(DESCALE(tmp13 - tmp0, S)) & 1023];
  }
}

struct Jpeg {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, jfif = false, adobe = false;
  bool progressive = false, eoi = false;
  int scans = 0;
  int adobe_transform = -1;

  int u8() {
    if (pos >= n) throw Error{"truncated JPEG segment"};
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void read_dqt(size_t seg_end) {
    while (pos < seg_end) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) throw Error{"DQT table id out of range"};
      for (int k = 0; k < 64; ++k) {
        int v = prec ? u16() : u8();
        qt[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      qt_present[tq] = true;
    }
  }

  void read_dht(size_t seg_end) {
    while (pos < seg_end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) throw Error{"DHT table id out of range"};
      uint8_t bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(u8());
        total += bits[l];
      }
      if (total > 256) throw Error{"DHT table holds over 256 symbols"};
      Huffman& h = tc ? ac[th] : dc[th];
      h.max_sym = 0;
      for (int k = 0; k < total; ++k) {
        h.vals[k] = static_cast<uint8_t>(u8());
        h.max_sym = std::max<int>(h.max_sym, h.vals[k]);
      }
      h.build(bits);
    }
  }

  void read_sof(int marker) {
    int prec = u8();
    if (prec != 8)
      throw Error{std::to_string(prec) + "-bit JPEG is not supported"};
    height = u16();
    width = u16();
    int nc = u8();
    if (height <= 0 || width <= 0)
      throw Error{"JPEG frame without a height (DNL) is not supported"};
    if (static_cast<uint64_t>(width) * height > kMaxPixels)
      throw Error{"JPEG of " + std::to_string(width) + "x" +
                  std::to_string(height) + " pixels is over the limit of " +
                  std::to_string(kMaxPixels)};
    if (nc != 1 && nc != 3 && nc != 4)
      throw Error{std::to_string(nc) + "-component JPEG is not supported"};
    progressive = marker == 0xC2;
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8() & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        throw Error{"bad JPEG sampling factor"};
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 1) comps[0].h = comps[0].v = hmax = vmax = 1;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        throw Error{"JPEG sampling factors with a fractional ratio are not "
                    "supported"};
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      if (progressive) {
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
        std::fill(c.prev_coef_bits, c.prev_coef_bits + 64, -1);
      }
    }
    frame = true;
  }

  // One block; `skip` (the data ran out earlier in this restart
  // interval) leaves its coefficients at zero, as libjpeg's decode_mcu.
  void decode_block(BitReader& br, Component& c, int bx, int by, bool skip) {
    int coef[64];
    std::memset(coef, 0, sizeof(coef));
    if (!skip) read_coefficients(br, c, coef);
    const int pitch = c.bw * 8;
    uint8_t* out = c.plane.data() + static_cast<size_t>(by) * 8 * pitch +
                   static_cast<size_t>(bx) * 8;
    idct_islow(coef, qt[c.tq], out, pitch);
  }

  void read_coefficients(BitReader& br, Component& c, int* coef) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    int diff = s ? extend(br.bits(s), s) : 0;
    // libjpeg lets a corrupt file's predictor wrap and stores the DC
    // coefficient as a 16-bit JCOEF; so does this, without overflow
    c.pred = static_cast<int>(static_cast<unsigned>(c.pred) +
                              static_cast<unsigned>(diff));
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k < 79 ? k : 79]] = extend(br.bits(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void read_sos(size_t seg_end) {
    if (!frame) throw Error{"SOS before the frame header"};
    int ns = u8();
    std::vector<Component*> scan;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) throw Error{"SOS names an unknown component"};
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3)
        throw Error{"SOS Huffman table id out of range"};
      if (!qt_present[found->tq])
        throw Error{"frame uses a quantization table never defined"};
      found->scanned = true;
      scan.push_back(found);
    }
    int ss = u8(), se = u8(), ahal = u8();
    int ah = ahal >> 4, al = ahal & 15;
    // the tables the scan decodes with: a progressive DC scan reads only
    // its DC table (a refinement none), an AC scan only its AC table
    const bool dc_band = ss == 0;
    for (auto* c : scan) {
      bool need_dc = !progressive || (dc_band && ah == 0);
      bool need_ac = !progressive || !dc_band;
      if ((need_dc && !dc[c->td].present) || (need_ac && !ac[c->ta].present))
        throw Error{"SOS uses a Huffman table never defined"};
      if (need_dc && dc[c->td].max_sym > 15)  // libjpeg's JERR_BAD_HUFF_TABLE
        throw Error{"bad Huffman table: DC symbol " +
                    std::to_string(dc[c->td].max_sym) + " is over 15"};
    }
    pos = seg_end;
    ++scans;
    if (progressive) {
      read_progressive_scan(scan, ss, se, ah, al);
      return;
    }
    if (ss != 0 || se != 63)
      throw Error{"spectral selection in a sequential scan"};
    for (auto* c : scan) c->pred = 0;
    BitReader br{data + pos, data + n};
    int mcus_left = restart_interval, expected_rst = 0;
    // before each MCU: the restart, then whether the MCU is read at all
    auto start_mcu = [&]() {
      if (restart_interval) {
        if (mcus_left == 0) {
          br.restart(expected_rst);
          for (auto* c : scan) c->pred = 0;
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      return br.insufficient;
    };
    if (scan.size() == 1) {
      Component& c = *scan[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          bool skip = start_mcu();
          decode_block(br, c, bx, by, skip);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          bool skip = start_mcu();
          for (auto* c : scan)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                decode_block(br, *c, mx * c->h + h, my * c->v + v, skip);
        }
    }
    // go on at the marker the data ran into, or at the next byte (the
    // marker loop discards data up to the next marker, as libjpeg does)
    pos = static_cast<size_t>(br.p - data) - (br.marker ? 2 : 0);
  }

  // One progressive scan (jdphuff.c), into the components' coefficients.
  void read_progressive_scan(const std::vector<Component*>& scan, int ss,
                             int se, int ah, int al) {
    // start_pass_phuff_decoder's checks
    const bool dc_band = ss == 0;
    bool bad = dc_band ? se != 0
                       : (ss > se || se > 63 || scan.size() != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) throw Error{"bad progressive JPEG scan parameters"};
    for (auto* c : scan) {
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
        c->prev_coef_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      c->pred = 0;
    }
    BitReader br{data + pos, data + n};
    int mcus_left = restart_interval, expected_rst = 0, eobrun = 0;
    auto start_mcu = [&]() {
      if (restart_interval) {
        if (mcus_left == 0) {
          br.restart(expected_rst);
          for (auto* c : scan) c->pred = 0;
          eobrun = 0;
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      return br.insufficient;
    };
    const int p1 = 1 << al, m1 = -(1 << al);
    // refine one nonzero coefficient's bit `al`, as jdphuff.c does
    auto refine = [&](int16_t& v) {
      if (br.bits(1) && (v & p1) == 0)
        v = static_cast<int16_t>(v + (v >= 0 ? p1 : m1));
    };
    auto block_dc = [&](Component& c, int16_t* b, bool skip) {
      if (ah == 0) {
        if (skip) return;
        int s = br.decode(dc[c.td]);
        int diff = s ? extend(br.bits(s), s) : 0;
        c.pred = static_cast<int>(static_cast<unsigned>(c.pred) +
                                  static_cast<unsigned>(diff));
        b[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
      } else if (br.bits(1)) {  // DC refine reads even past a marker
        b[0] = static_cast<int16_t>(b[0] | p1);
      }
    };
    auto block_ac_first = [&](Component& c, int16_t* b) {
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(ac[c.ta]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k < 79 ? k : 79]] = static_cast<int16_t>(
              static_cast<unsigned>(extend(br.bits(s), s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = (1 << r) + (r ? br.bits(r) : 0) - 1;
          break;
        }
      }
    };
    auto block_ac_refine = [&](Component& c, int16_t* b) {
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          int rs = br.decode(ac[c.ta]);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = br.bits(1) ? p1 : m1;  // s != 1 is a warning in libjpeg
          } else if (r != 15) {
            eobrun = (1 << r) + (r ? br.bits(r) : 0);
            break;
          }
          do {
            int16_t& v = b[kNatural[k < 79 ? k : 79]];
            if (v != 0) {
              refine(v);
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) b[kNatural[k < 79 ? k : 79]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t& v = b[kNatural[k]];
          if (v != 0) refine(v);
        }
        --eobrun;
      }
    };
    if (dc_band && scan.size() > 1) {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          bool skip = start_mcu();
          for (auto* c : scan)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                block_dc(*c, c->block(mx * c->h + h, my * c->v + v), skip);
        }
    } else {
      Component& c = *scan[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          bool skip = start_mcu();
          int16_t* b = c.block(bx, by);
          if (dc_band) block_dc(c, b, skip);
          else if (skip) continue;
          else if (ah == 0) block_ac_first(c, b);
          else block_ac_refine(c, b);
        }
    }
    pos = static_cast<size_t>(br.p - data) - (br.marker ? 2 : 0);
  }

  // Dequantize and inverse-transform a progressive file's coefficients
  // into the planes: jdcoefct.c's decompress_data, or, where the scans
  // left some of the first nine AC coefficients (or all of them) short
  // of their last bit, its decompress_smooth_data (libjpeg-turbo's 5x5
  // DC window; SAVED_COEFS = 10).
  void output_progressive() {
    bool smooth = false;
    for (auto& c : comps) {
      for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (qt[c.tq][k] == 0) return output_blocks(false);
      if (c.coef_bits[0] < 0) return output_blocks(false);
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) smooth = true;
    }
    output_blocks(smooth);
  }

  void output_blocks(bool smooth) {
    int ws[64];
    for (auto& c : comps) {
      const int wib = (c.dw + 7) / 8, hib = (c.dh + 7) / 8;
      const int pitch = c.bw * 8;
      const uint16_t* q = qt[c.tq];
      const int* cb = c.coef_bits;
      const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 &&
                             cb[4] == -1 && cb[5] == -1 && cb[6] == -1 &&
                             cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
      const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16],
                    Q11 = q[9], Q02 = q[2], Q03 = q[3], Q12 = q[10],
                    Q21 = q[17], Q30 = q[24];
      const int total = mcuy, v = c.v;
      for (int r = 0; r < total; ++r) {
        int block_rows = v;
        if (r == total - 1) {
          block_rows = hib % v;
          if (block_rows == 0) block_rows = v;
        }
        const int image_block_rows = block_rows * total;
        for (int brow = 0; brow < block_rows; ++brow) {
          const int R = r * v + brow;
          uint8_t* out_row = c.plane.data() + static_cast<size_t>(R) * 8 *
                                                  pitch;
          if (!smooth) {
            for (int bx = 0; bx < wib; ++bx) {
              const int16_t* b = c.block(bx, R);
              for (int k = 0; k < 64; ++k) ws[k] = b[k];
              idct_islow(ws, q, out_row + bx * 8, pitch);
            }
            continue;
          }
          const int ibr = r * block_rows + brow;
          int rp = ibr > 0 ? R - 1 : R;
          int rpp = ibr > 1 ? R - 2 : rp;
          int rn = ibr < image_block_rows - 1 ? R + 1 : R;
          int rnn = ibr < image_block_rows - 2 ? R + 2 : rn;
          const int rows[5] = {rpp, rp, R, rn, rnn};
          auto dcat = [&](int row, int col) -> int {
            row = std::min(std::max(row, 0), c.bh - 1);
            col = std::min(std::max(col, 0), c.bw - 1);
            return c.block(col, row)[0];
          };
          // DC[i][j]: libjpeg's DC01..DC25, row i of the window, column j
          int DC[5][5];
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j) DC[i][j] = dcat(rows[i], 0);
          const int last_col = wib - 1;
          for (int bx = 0; bx < wib; ++bx) {
            const int16_t* b = c.block(bx, R);
            int16_t wsb[64];
            std::memcpy(wsb, b, sizeof(wsb));
            // the window's right edge repeats the last block (a component
            // two blocks wide included)
            if (bx == 0 && bx < last_col)
              for (int i = 0; i < 5; ++i)
                DC[i][3] = DC[i][4] = dcat(rows[i], bx + 1);
            if (bx + 1 < last_col)
              for (int i = 0; i < 5; ++i) DC[i][4] = dcat(rows[i], bx + 2);
            auto D = [&](int n) { return DC[(n - 1) / 5][(n - 1) % 5]; };
            auto predict = [&](int pos, int coefi, int64_t qk, int64_t num) {
              int Al = cb[coefi];
              if (Al == 0 || wsb[pos] != 0) return;
              int pred;
              if (num >= 0) {
                pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
                if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
              } else {
                pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
                if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
                pred = -pred;
              }
              wsb[pos] = static_cast<int16_t>(pred);
            };
            predict(1, 1, Q01, Q00 * (change_dc
                ? (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) -
                   13 * D(9) + 3 * D(10) - 3 * D(11) + 38 * D(12) -
                   38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
                   13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25))
                : (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15))));
            predict(8, 2, Q10, Q00 * (change_dc
                ? (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) +
                   13 * D(7) + 38 * D(8) + 13 * D(9) - D(10) + D(16) -
                   13 * D(17) - 38 * D(18) - 13 * D(19) + D(20) + D(21) +
                   3 * D(22) + 3 * D(23) + 3 * D(24) + D(25))
                : (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23))));
            predict(16, 3, Q20, Q00 * (change_dc
                ? (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) -
                   14 * D(13) - 5 * D(14) + 2 * D(17) + 7 * D(18) +
                   2 * D(19) + D(23))
                : (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23))));
            predict(9, 4, Q11, Q00 * (change_dc
                ? (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) +
                   9 * D(19) + D(21) - D(25))
                : (D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) +
                   D(22) - D(24) + D(4) - D(6) + 10 * D(7) - 10 * D(9))));
            predict(2, 5, Q02, Q00 * (change_dc
                ? (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) -
                   14 * D(13) + 7 * D(14) + D(15) + 2 * D(17) - 5 * D(18) +
                   2 * D(19))
                : (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15))));
            if (change_dc) {
              predict(3, 6, Q03, Q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) +
                                        D(17) - D(19)));
              predict(10, 7, Q12, Q00 * (D(7) - 3 * D(8) + D(9) - D(17) +
                                         3 * D(18) - D(19)));
              predict(17, 8, Q21, Q00 * (D(7) - D(9) - 3 * D(12) +
                                         3 * D(14) + D(17) - D(19)));
              predict(24, 9, Q30, Q00 * (D(7) + 2 * D(8) + D(9) - D(17) -
                                         2 * D(18) - D(19)));
              int64_t num = Q00 * (
                  -2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) -
                  6 * D(6) + 6 * D(7) + 42 * D(8) + 6 * D(9) - 6 * D(10) -
                  8 * D(11) + 42 * D(12) + 152 * D(13) + 42 * D(14) -
                  8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) +
                  6 * D(19) - 6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) -
                  6 * D(24) - 2 * D(25));
              int pred = num >= 0
                  ? static_cast<int>(((Q00 << 7) + num) / (Q00 << 8))
                  : -static_cast<int>(((Q00 << 7) - num) / (Q00 << 8));
              wsb[0] = static_cast<int16_t>(pred);
            }
            for (int k = 0; k < 64; ++k) ws[k] = wsb[k];
            idct_islow(ws, q, out_row + bx * 8, pitch);
            for (int i = 0; i < 5; ++i)
              for (int j = 0; j < 4; ++j) DC[i][j] = DC[i][j + 1];
          }
        }
      }
    }
  }

  void parse() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      throw Error{"not a JPEG (no SOI marker)"};
    pos = 2;
    bool scanned = false;
    while (pos < n) {
      if (data[pos] != 0xFF) {
        ++pos;
        continue;
      }
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) break;
      int marker = data[pos++];
      if (marker == 0xD9) {  // EOI
        eoi = true;
        break;
      }
      // a stuffed zero (data), TEM and RSTn carry no segment
      if (marker == 0x00 || marker == 0x01 ||
          (marker >= 0xD0 && marker <= 0xD7))
        continue;
      int len = u16();
      if (len < 2 || pos + len - 2 > n) throw Error{"truncated JPEG segment"};
      size_t seg_end = pos + len - 2;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(marker);
          break;
        case 0xC3:
        case 0xC7:
          throw Error{"lossless JPEG is not supported"};
        case 0xC5:
        case 0xC6:
          throw Error{"hierarchical JPEG is not supported"};
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          throw Error{"arithmetic-coded JPEG is not supported"};
        case 0xC4:
          read_dht(seg_end);
          break;
        case 0xCC:
          throw Error{"arithmetic-coded JPEG is not supported"};
        case 0xDB:
          read_dqt(seg_end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos(seg_end);
          scanned = true;
          // every component of a sequential file decoded: the image is
          // whole, and what follows its last scan (EOI, or bytes a
          // corrupt file left) is not read; a progressive file's scans
          // run to its EOI
          if (!progressive &&
              std::all_of(comps.begin(), comps.end(),
                          [](const Component& c) { return c.scanned; }))
            return;
          continue;  // pos is already past the entropy-coded data
        case 0xE0:
          if (len >= 7 && std::memcmp(data + pos, "JFIF", 4) == 0)
            jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        default:
          break;
      }
      pos = seg_end;
    }
    if (!frame) throw Error{"JPEG without a frame header"};
    if (!scanned) throw Error{"JPEG without image data"};
    // libjpeg reads a multi-scan file to its EOI before any output, and
    // OpenCV's memory source cannot supply more data
    if (progressive && !eoi)
      throw Error{"progressive JPEG data ends before its EOI (truncated "
                  "file)"};
    if (progressive) output_progressive();
  }

  // libjpeg's default_decompress_parms: is a 3-component file RGB?
  bool is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  // Component `c` upsampled to the full width x height (jdsample.c).
  std::vector<uint8_t> upsample(const Component& c) const {
    const int W = width, H = height;
    const int pitch = c.bw * 8;
    const int fx = hmax / c.h, fy = vmax / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto in = [&](int r, int col) -> int {
      return c.plane[static_cast<size_t>(r) * pitch + col];
    };
    const int dw = c.dw, dh = c.dh;
    if (fx == 1 && fy == 1) {
      for (int y = 0; y < H; ++y)
        std::memcpy(&out[static_cast<size_t>(y) * W],
                    &c.plane[static_cast<size_t>(y) * pitch], W);
    } else if (fx == 2 && fy == 1 && dw > 2) {
      std::vector<uint8_t> row(2 * dw);
      for (int y = 0; y < H; ++y) {
        int v0 = in(y, 0);
        row[0] = static_cast<uint8_t>(v0);
        row[1] = static_cast<uint8_t>((v0 * 3 + in(y, 1) + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v = in(y, x) * 3;
          row[2 * x] = static_cast<uint8_t>((v + in(y, x - 1) + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>((v + in(y, x + 1) + 2) >> 2);
        }
        int vl = in(y, dw - 1);
        row[2 * dw - 2] = static_cast<uint8_t>((vl * 3 + in(y, dw - 2) + 1) >> 2);
        row[2 * dw - 1] = static_cast<uint8_t>(vl);
        std::memcpy(&out[static_cast<size_t>(y) * W], row.data(), W);
      }
    } else if (fx == 1 && fy == 2) {
      for (int y = 0; y < H; ++y) {
        int r0 = y / 2;
        int r1 = (y & 1) ? std::min(r0 + 1, dh - 1) : std::max(r0 - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x)
          out[static_cast<size_t>(y) * W + x] =
              static_cast<uint8_t>((in(r0, x) * 3 + in(r1, x) + bias) >> 2);
      }
    } else if (fx == 2 && fy == 2 && dw > 2) {
      std::vector<int> cs(dw);
      std::vector<uint8_t> row(2 * dw);
      for (int y = 0; y < H; ++y) {
        int r0 = y / 2;
        int r1 = (y & 1) ? std::min(r0 + 1, dh - 1) : std::max(r0 - 1, 0);
        for (int x = 0; x < dw; ++x) cs[x] = in(r0, x) * 3 + in(r1, x);
        row[0] = static_cast<uint8_t>((cs[0] * 4 + 8) >> 4);
        row[1] = static_cast<uint8_t>((cs[0] * 3 + cs[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; ++x) {
          row[2 * x] = static_cast<uint8_t>((cs[x] * 3 + cs[x - 1] + 8) >> 4);
          row[2 * x + 1] =
              static_cast<uint8_t>((cs[x] * 3 + cs[x + 1] + 7) >> 4);
        }
        row[2 * dw - 2] =
            static_cast<uint8_t>((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
        row[2 * dw - 1] = static_cast<uint8_t>((cs[dw - 1] * 4 + 7) >> 4);
        std::memcpy(&out[static_cast<size_t>(y) * W], row.data(), W);
      }
    } else {
      // int_upsample (and libjpeg-turbo's plain h2v1/h2v2 for a component
      // two samples wide or less): replicate each sample fx x fy times
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x)
          out[static_cast<size_t>(y) * W + x] =
              static_cast<uint8_t>(in(y / fy, x / fx));
    }
    return out;
  }

  void to_bgr(uint8_t* dst) const {
    const size_t N = static_cast<size_t>(width) * height;
    if (comps.size() == 1) {
      auto g = upsample(comps[0]);
      for (size_t i = 0; i < N; ++i) dst[3 * i] = dst[3 * i + 1] =
          dst[3 * i + 2] = g[i];
      return;
    }
    auto a = upsample(comps[0]);
    auto b = upsample(comps[1]);
    auto c = upsample(comps[2]);
    if (comps.size() == 3 && is_rgb()) {
      for (size_t i = 0; i < N; ++i) {
        dst[3 * i] = c[i];
        dst[3 * i + 1] = b[i];
        dst[3 * i + 2] = a[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table
    const int SB = 16;
    const int64_t HALF = static_cast<int64_t>(1) << (SB - 1);
    auto FIX = [](double x) {
      return static_cast<int64_t>(x * (1 << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((FIX(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((FIX(1.77200) * x + HALF) >> SB);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + HALF;
    }
    auto clamp = [](int v) -> uint8_t {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    if (comps.size() == 3) {
      for (size_t i = 0; i < N; ++i) {
        int y = a[i], cb = b[i], cr = c[i];
        dst[3 * i + 2] = clamp(y + cr_r[cr]);
        dst[3 * i + 1] =
            clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB));
        dst[3 * i] = clamp(y + cb_b[cb]);
      }
      return;
    }
    // four components: libjpeg's CMYK output (jdcolor.c's
    // ycck_cmyk_convert first where the Adobe transform says YCCK, as
    // default_decompress_parms reads it: 0 is CMYK, any other value
    // YCCK, no Adobe segment CMYK), then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
    auto d = upsample(comps[3]);
    const bool ycck = adobe && adobe_transform != 0;
    for (size_t i = 0; i < N; ++i) {
      int cc = a[i], mm = b[i], yy = c[i], k = d[i];
      if (ycck) {
        int y = a[i], cb = b[i], cr = c[i];
        cc = clamp(255 - (y + cr_r[cr]));
        mm = clamp(255 - (y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB)));
        yy = clamp(255 - (y + cb_b[cb]));
      }
      dst[3 * i + 2] = static_cast<uint8_t>(k - ((255 - cc) * k >> 8));
      dst[3 * i + 1] = static_cast<uint8_t>(k - ((255 - mm) * k >> 8));
      dst[3 * i] = static_cast<uint8_t>(k - ((255 - yy) * k >> 8));
    }
  }
};

// ---------------------------------------------------------------------------
// encoder
// ---------------------------------------------------------------------------

const uint8_t kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];
  HuffCode(const uint8_t* bits, const uint8_t* vals) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(c++);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  void put(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 7);  // pad with ones
    nbits = 0;
    acc = 0;
  }
};

// jfdctint.c's jpeg_fdct_islow on level-shifted samples, in place.
void fdct_islow(int* d) {
  const int CB = 13, P1 = 2;
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << P1));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << P1));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = static_cast<int>(DESCALE(z1 + tmp13 * FIX_0_765366865, CB - P1));
    p[6] = static_cast<int>(DESCALE(z1 + tmp12 * (-FIX_1_847759065), CB - P1));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(DESCALE(tmp4 + z1 + z3, CB - P1));
    p[5] = static_cast<int>(DESCALE(tmp5 + z2 + z4, CB - P1));
    p[3] = static_cast<int>(DESCALE(tmp6 + z2 + z3, CB - P1));
    p[1] = static_cast<int>(DESCALE(tmp7 + z1 + z4, CB - P1));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(DESCALE(tmp10 + tmp11, P1));
    p[32] = static_cast<int>(DESCALE(tmp10 - tmp11, P1));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = static_cast<int>(DESCALE(z1 + tmp13 * FIX_0_765366865, CB + P1));
    p[48] =
        static_cast<int>(DESCALE(z1 + tmp12 * (-FIX_1_847759065), CB + P1));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(DESCALE(tmp4 + z1 + z3, CB + P1));
    p[40] = static_cast<int>(DESCALE(tmp5 + z2 + z4, CB + P1));
    p[24] = static_cast<int>(DESCALE(tmp6 + z2 + z3, CB + P1));
    p[8] = static_cast<int>(DESCALE(tmp7 + z1 + z4, CB + P1));
  }
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t* bits,
             const uint8_t* vals) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put_u16(o, 2 + 1 + 16 + total);
  o.push_back(static_cast<uint8_t>(tc_th));
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  for (int k = 0; k < total; ++k) o.push_back(vals[k]);
}

int quality_scale(int quality) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

// Quantize and Huffman-code one block. A dummy block (past the
// component's own blocks, inside the last MCU) has zero AC terms and the
// quantized DC of `dummy_dc`, as jccoefct.c makes it. Returns the DC.
int encode_block(BitWriter& bw, int* blk, const uint16_t* q, int& pred,
                 const HuffCode& dc, const HuffCode& ac, bool dummy,
                 int dummy_dc) {
  int zz[64];
  if (dummy) {
    std::memset(zz, 0, sizeof(zz));
    zz[0] = dummy_dc;
  } else {
    fdct_islow(blk);
    for (int k = 0; k < 64; ++k) {
      int i = kNatural[k];
      int div = q[i] * 8, t = blk[i];
      // jcdctmgr.c quantize: round half away from zero
      zz[k] = t < 0 ? -((-t + (div >> 1)) / div) : (t + (div >> 1)) / div;
    }
  }
  auto emit = [&](const HuffCode& h, int sym) {
    bw.put(h.code[sym], h.size[sym]);
  };
  auto nbits_of = [](int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
      ++n;
      a >>= 1;
    }
    return n;
  };
  int diff = zz[0] - pred;
  pred = zz[0];
  int s = nbits_of(diff);
  emit(dc, s);
  if (s) bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = zz[k];
    if (!v) {
      ++run;
      continue;
    }
    while (run > 15) {
      emit(ac, 0xF0);
      run -= 16;
    }
    s = nbits_of(v);
    emit(ac, (run << 4) | s);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) emit(ac, 0x00);
  return zz[0];
}

}  // namespace

extern "C" {

void zoo_image_free(void* p) { std::free(p); }

// Decode a JPEG to BGR uint8 HWC. Returns a malloc'd buffer (free it with
// zoo_image_free) and sets *h, *w; on failure NULL with `err` filled.
uint8_t* zoo_jpeg_decode(const uint8_t* data, uint64_t n, int* h, int* w,
                         char* err, int errlen) {
  try {
    Jpeg j;
    j.data = data;
    j.n = static_cast<size_t>(n);
    j.parse();
    size_t bytes = static_cast<size_t>(j.width) * j.height * 3;
    uint8_t* out = static_cast<uint8_t*>(std::malloc(bytes));
    if (!out) throw Error{"out of memory"};
    j.to_bgr(out);
    *h = j.height;
    *w = j.width;
    return out;
  } catch (const Error& e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
  } catch (const std::exception& e) {
    std::snprintf(err, errlen, "%s", e.what());
  }
  return nullptr;
}

// Encode BGR uint8 HWC as a baseline 4:2:0 JFIF JPEG. Returns a malloc'd
// buffer of *out_len bytes (free with zoo_image_free), or NULL.
uint8_t* zoo_jpeg_encode(const uint8_t* bgr, int h, int w, int quality,
                         uint64_t* out_len, char* err, int errlen) {
  try {
    if (h <= 0 || w <= 0 || h > 65535 || w > 65535)
      throw Error{"JPEG sizes run from 1 to 65535"};
    int scale = quality_scale(quality);
    uint16_t q[2][64];
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < 64; ++i) {
        long v = ((t ? kChromaQ[i] : kLumaQ[i]) * static_cast<long>(scale) +
                  50L) / 100L;
        q[t][i] = static_cast<uint16_t>(v < 1 ? 1 : (v > 255 ? 255 : v));
      }
    // jccolor.c rgb_ycc tables
    const int SB = 16;
    const int64_t HALF = static_cast<int64_t>(1) << (SB - 1);
    const int64_t CBCR_OFF = static_cast<int64_t>(128) << SB;
    auto FIX = [](double x) {
      return static_cast<int64_t>(x * (1 << 16) + 0.5);
    };
    const int mw = (w + 15) / 16 * 16, mh = (h + 15) / 16 * 16;
    std::vector<uint8_t> Y(static_cast<size_t>(mw) * mh),
        Cb(static_cast<size_t>(mw) * mh), Cr(static_cast<size_t>(mw) * mh);
    for (int y = 0; y < mh; ++y)
      for (int x = 0; x < mw; ++x) {
        // jcprepct.c / jcsample.c pad right and bottom by replication
        int sy = y < h ? y : h - 1, sx = x < w ? x : w - 1;
        const uint8_t* px = bgr + (static_cast<size_t>(sy) * w + sx) * 3;
        int64_t r = px[2], g = px[1], b = px[0];
        size_t i = static_cast<size_t>(y) * mw + x;
        Y[i] = static_cast<uint8_t>(
            (FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b + HALF) >>
            SB);
        Cb[i] = static_cast<uint8_t>((-FIX(0.16874) * r - FIX(0.33126) * g +
                                      FIX(0.5) * b + CBCR_OFF + HALF - 1) >>
                                     SB);
        Cr[i] = static_cast<uint8_t>((FIX(0.5) * r - FIX(0.41869) * g -
                                      FIX(0.08131) * b + CBCR_OFF + HALF - 1) >>
                                     SB);
      }
    const int cw = mw / 2, ch = mh / 2;
    std::vector<uint8_t> Cb2(static_cast<size_t>(cw) * ch),
        Cr2(static_cast<size_t>(cw) * ch);
    // jcprepct.c pads the full-size rows to an even count, downsamples,
    // then repeats the last downsampled row down to the MCU's height
    const int real_ch = (h + 1) / 2;
    for (int y = 0; y < ch; ++y) {
      int bias = 1;
      int sy = std::min(y, real_ch - 1);
      for (int x = 0; x < cw; ++x) {
        size_t i0 = static_cast<size_t>(2 * sy) * mw + 2 * x, i1 = i0 + mw;
        Cb2[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
            (Cb[i0] + Cb[i0 + 1] + Cb[i1] + Cb[i1 + 1] + bias) >> 2);
        Cr2[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
            (Cr[i0] + Cr[i0 + 1] + Cr[i1] + Cr[i1 + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    std::vector<uint8_t> o;
    o.reserve(static_cast<size_t>(w) * h / 2 + 1024);
    const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',
                                'F',  'I',  'F',  0x00, 0x01, 0x01, 0x00,
                                0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    o.insert(o.end(), soi_app0, soi_app0 + sizeof(soi_app0));
    for (int t = 0; t < 2; ++t) {
      o.push_back(0xFF);
      o.push_back(0xDB);
      put_u16(o, 67);
      o.push_back(static_cast<uint8_t>(t));
      for (int k = 0; k < 64; ++k)
        o.push_back(static_cast<uint8_t>(q[t][kNatural[k]]));
    }
    o.push_back(0xFF);
    o.push_back(0xC0);
    put_u16(o, 17);
    o.push_back(8);
    put_u16(o, h);
    put_u16(o, w);
    o.push_back(3);
    const uint8_t comp_spec[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    o.insert(o.end(), comp_spec, comp_spec + 9);
    put_dht(o, 0x00, kDcLumaBits, kDcVals);
    put_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
    put_dht(o, 0x01, kDcChromaBits, kDcVals);
    put_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
    o.push_back(0xFF);
    o.push_back(0xDA);
    put_u16(o, 12);
    o.push_back(3);
    const uint8_t scan_spec[6] = {1, 0x00, 2, 0x11, 3, 0x11};
    o.insert(o.end(), scan_spec, scan_spec + 6);
    o.push_back(0);
    o.push_back(63);
    o.push_back(0);
    HuffCode dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals);
    HuffCode dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);
    BitWriter bw{o};
    int pred[3] = {0, 0, 0};
    int blk[64];
    auto load = [&](const std::vector<uint8_t>& plane, int pitch, int bx,
                    int by) {
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          blk[8 * r + c] =
              plane[static_cast<size_t>(by * 8 + r) * pitch + bx * 8 + c] -
              128;
    };
    const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;
    for (int my = 0; my < mh / 16; ++my)
      for (int mx = 0; mx < mw / 16; ++mx) {
        int dcs[4] = {0, 0, 0, 0};
        for (int v = 0; v < 2; ++v)
          for (int hh = 0; hh < 2; ++hh) {
            int bx = 2 * mx + hh, by = 2 * my + v, k = 2 * v + hh;
            bool dummy = bx >= ybw || by >= ybh;
            int prev = by >= ybh ? (v ? dcs[1] : 0) : (hh ? dcs[0 + 2 * v]
                                                          : 0);
            if (!dummy) load(Y, mw, bx, by);
            dcs[k] = encode_block(bw, blk, q[0], pred[0], dcl, acl, dummy,
                                  prev);
          }
        load(Cb2, cw, mx, my);
        encode_block(bw, blk, q[1], pred[1], dcc, acc, false, 0);
        load(Cr2, cw, mx, my);
        encode_block(bw, blk, q[1], pred[2], dcc, acc, false, 0);
      }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
    uint8_t* out = static_cast<uint8_t*>(std::malloc(o.size()));
    if (!out) throw Error{"out of memory"};
    std::memcpy(out, o.data(), o.size());
    *out_len = o.size();
    return out;
  } catch (const Error& e) {
    std::snprintf(err, errlen, "%s", e.msg.c_str());
  } catch (const std::exception& e) {
    std::snprintf(err, errlen, "%s", e.what());
  }
  return nullptr;
}

// Reverse the PNG row filters of one (non-interlaced) image: `raw` holds
// `rows` rows of 1 filter byte + `stride` bytes; `bpp` is the bytes of
// one pixel (at least 1). Writes rows*stride bytes to `out`. Returns 0, or
// -1 with `err` filled on a bad filter type or a short buffer.
int zoo_png_unfilter(const uint8_t* raw, uint64_t n, int rows,
                     uint64_t stride, int bpp, uint8_t* out, char* err,
                     int errlen) {
  if (n < static_cast<uint64_t>(rows) * (stride + 1)) {
    std::snprintf(err, errlen, "PNG image data is short: %llu of %llu bytes",
                  static_cast<unsigned long long>(n),
                  static_cast<unsigned long long>(rows * (stride + 1)));
    return -1;
  }
  std::vector<uint8_t> zero(stride, 0);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* in = raw + static_cast<uint64_t>(r) * (stride + 1);
    int ft = in[0];
    ++in;
    uint8_t* cur = out + static_cast<uint64_t>(r) * stride;
    const uint8_t* up = r ? cur - stride : zero.data();
    switch (ft) {
      case 0:
        std::memcpy(cur, in, stride);
        break;
      case 1:
        for (uint64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (i >= (uint64_t)bpp
                                                     ? cur[i - bpp] : 0));
        break;
      case 2:
        for (uint64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:
        for (uint64_t i = 0; i < stride; ++i) {
          int a = i >= (uint64_t)bpp ? cur[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (uint64_t i = 0; i < stride; ++i) {
          int a = i >= (uint64_t)bpp ? cur[i - bpp] : 0;
          int b = up[i];
          int c = i >= (uint64_t)bpp ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        std::snprintf(err, errlen, "bad PNG filter type %d in row %d", ft, r);
        return -1;
    }
  }
  return 0;
}

}  // extern "C"
