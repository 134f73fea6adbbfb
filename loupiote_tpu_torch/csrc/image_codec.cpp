// The serial byte work of loupiote_tpu_torch/image_codec.py, on the host:
// PNG's scanline unfiltering (Sub, Up, Average, Paeth carry a dependency
// from one byte to the next), the Huffman bit packing of a baseline JPEG
// scan and the Huffman decoding of a sequential one. The rest of both
// codecs (chunk and marker parsing, zlib, bit unpacking, colour
// conversion, the DCT and its inverse, quantisation, upsampling) is
// numpy / torch.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (image_codec.py, at first use,
// into loupiote_tpu_torch/_build/).

#include <stdint.h>
#include <string.h>

extern "C" {

// Unfilter `height` scanlines of `stride` bytes, each stored after its
// filter-type byte in `in` (in_len bytes), into `out` (height * stride
// bytes). `bpp`: bytes per complete pixel, at least 1. Returns 0, -1 where
// `in` is short, -2 on an unknown filter type.
int png_unfilter(const uint8_t* in, int64_t in_len, int32_t height,
                 int64_t stride, int32_t bpp, uint8_t* out) {
  if (in_len < static_cast<int64_t>(height) * (stride + 1)) return -1;
  for (int32_t y = 0; y < height; ++y) {
    const uint8_t* src = in + static_cast<int64_t>(y) * (stride + 1);
    const uint8_t ft = src[0];
    ++src;
    uint8_t* row = out + static_cast<int64_t>(y) * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;
    switch (ft) {
      case 0:
        memcpy(row, src, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          row[i] = src[i] + (i >= bpp ? row[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          row[i] = src[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          row[i] = src[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = src[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return -2;
    }
  }
  return 0;
}

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t cap, len;
  uint32_t acc;
  int nbits;
  bool overflow;

  void byte(uint8_t b) {
    if (len + 2 > cap) {
      overflow = true;
      return;
    }
    out[len++] = b;
    if (b == 0xFF) out[len++] = 0x00;  // byte stuffing
  }
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1u));
    nbits += size;
    while (nbits >= 8) {
      byte(static_cast<uint8_t>(acc >> (nbits - 8)));
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1u;
  }
  void flush() {  // pad the last byte with 1-bits
    if (nbits > 0) put((1u << (8 - nbits)) - 1u, 8 - nbits);
  }
};

inline int magnitude_bits(int v) {
  if (v < 0) v = -v;
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// A coefficient's extra bits: v itself if positive, else v - 1 in n bits.
inline uint32_t extra_bits(int v, int n) {
  return static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << n) - 1u);
}

}  // namespace

// Huffman-code the quantised blocks of one interleaved baseline scan.
// `blocks`: n_blocks x 64 int16 coefficients in zigzag order, in scan
// order; `table`: each block's table set (0 or 1); `comp`: each block's
// component (its DC predictor, 0..3). `dc_code` / `dc_size`: 2 x 16,
// `ac_code` / `ac_size`: 2 x 256 (code and length by symbol). Writes the
// entropy-coded bytes (stuffed, padded) to `out`; returns their count, or
// -1 if `cap` bytes do not hold them.
int64_t jpeg_scan(const int16_t* blocks, int64_t n_blocks,
                  const int8_t* table, const int8_t* comp,
                  const uint16_t* dc_code, const uint8_t* dc_size,
                  const uint16_t* ac_code, const uint8_t* ac_size,
                  uint8_t* out, int64_t cap) {
  BitWriter w{out, cap, 0, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int16_t* z = blocks + b * 64;
    const int t = table[b];
    const uint16_t* dcc = dc_code + 16 * t;
    const uint8_t* dcs = dc_size + 16 * t;
    const uint16_t* acc = ac_code + 256 * t;
    const uint8_t* acs = ac_size + 256 * t;
    const int diff = z[0] - pred[comp[b]];
    pred[comp[b]] = z[0];
    const int nd = magnitude_bits(diff);
    w.put(dcc[nd], dcs[nd]);
    if (nd) w.put(extra_bits(diff, nd), nd);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = z[k];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {  // ZRL
        w.put(acc[0xF0], acs[0xF0]);
        run -= 16;
      }
      const int n = magnitude_bits(v);
      const int sym = (run << 4) | n;
      w.put(acc[sym], acs[sym]);
      w.put(extra_bits(v, n), n);
      run = 0;
    }
    if (run > 0) w.put(acc[0x00], acs[0x00]);  // EOB
    if (w.overflow) return -1;
  }
  w.flush();
  return w.overflow ? -1 : w.len;
}

namespace {

// JPEG's zigzag order: kNatural[k] is the natural (row-major) index of
// the k-th coefficient of a block.
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A Huffman table (Annex C / F.2.2.3): per code length l, the smallest
// and largest code and the index of the first symbol of that length.
struct HuffTable {
  int32_t mincode[17], maxcode[18], valptr[17];
  uint8_t vals[256];
};

void build_table(const uint8_t* spec, HuffTable* t) {
  // spec: 16 code counts by length, then up to 256 symbols.
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = spec[l - 1];
    t->valptr[l] = k;
    t->mincode[l] = code;
    code += n;
    k += n;
    t->maxcode[l] = n ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  memcpy(t->vals, spec + 16, 256);
}

// Entropy-coded bytes: 0xFF 0x00 is a data 0xFF; any other 0xFF pair is
// a marker, where the reader stops and yields 0-bits from then on (as
// libjpeg does for a truncated scan).
struct BitReader {
  const uint8_t* data;
  int64_t len, pos;
  uint64_t acc;
  int nbits;
  bool at_marker;

  void fill() {
    while (nbits <= 56) {
      uint8_t b = 0;
      if (!at_marker && pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          int64_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;  // fill bytes
          if (q < len && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays at the marker's 0xFF
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int bits(int n) {  // n in 1..16
    if (nbits < n) fill();
    const int v = static_cast<int>(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int bit() { return bits(1); }
};

int decode_symbol(BitReader* r, const HuffTable* t) {
  int code = r->bit();
  int l = 1;
  while (code > t->maxcode[l]) {
    if (++l > 16) return -1;
    code = (code << 1) | r->bit();
  }
  return t->vals[(t->valptr[l] + code - t->mincode[l]) & 0xFF];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

}  // namespace

// Decode one sequential Huffman-coded scan starting at data[pos] into
// the coefficient blocks (int16, natural order, 64 a block).
// `comp`: n_comp x 6 int32 per scan component: h and v (its blocks in an
// MCU; 1 and 1 in a scan of one component), the blocks a row of its
// coefficient array, its first block's index, its DC and AC table ids.
// `tables`: 8 x 272 bytes (counts and symbols; DC tables 0-3, then AC
// tables 0-3). MCUs run mcus_x x mcus_y in raster order, with a restart
// marker every `restart` MCUs where `restart` > 0. Returns the offset at
// which the scan's entropy-coded bytes end, -1 for a code no table holds,
// -2 for a missing restart marker.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t len, int64_t pos,
                         int32_t n_comp, const int32_t* comp,
                         int32_t mcus_x, int32_t mcus_y, int32_t restart,
                         const uint8_t* tables, int16_t* coef) {
  HuffTable dc[4], ac[4];
  for (int i = 0; i < 4; ++i) {
    build_table(tables + 272 * i, &dc[i]);
    build_table(tables + 272 * (4 + i), &ac[i]);
  }
  BitReader r{data, len, pos, 0, 0, false};
  int pred[4] = {0, 0, 0, 0};
  const int64_t n_mcus = static_cast<int64_t>(mcus_x) * mcus_y;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      // Drop the partial byte, then the RSTn marker; the predictors
      // start again from 0.
      r.acc = 0;
      r.nbits = 0;
      while (!r.at_marker && r.pos < len) {
        if (data[r.pos] == 0xFF && r.pos + 1 < len &&
            data[r.pos + 1] != 0x00)
          break;
        ++r.pos;
      }
      while (r.pos + 1 < len && data[r.pos + 1] == 0xFF) ++r.pos;
      if (r.pos + 1 >= len || data[r.pos] != 0xFF ||
          (data[r.pos + 1] & 0xF8) != 0xD0)
        return -2;
      r.pos += 2;
      r.at_marker = false;
      for (int c = 0; c < 4; ++c) pred[c] = 0;
    }
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < n_comp; ++c) {
      const int32_t* cc = comp + 6 * c;
      const int h = cc[0], v = cc[1];
      const HuffTable* tdc = &dc[cc[4] & 3];
      const HuffTable* tac = &ac[cc[5] & 3];
      for (int by = 0; by < v; ++by) {
        for (int bx = 0; bx < h; ++bx) {
          const int64_t blk = cc[3] + (my * v + by) * cc[2] + mx * h + bx;
          int16_t* z = coef + blk * 64;
          const int s = decode_symbol(&r, tdc);
          if (s < 0) return -1;
          const int diff = s ? extend(r.bits(s), s) : 0;
          pred[c] += diff;
          z[0] = static_cast<int16_t>(pred[c]);
          for (int k = 1; k < 64;) {
            const int rs = decode_symbol(&r, tac);
            if (rs < 0) return -1;
            const int run = rs >> 4, size = rs & 15;
            if (size) {
              k += run;
              const int val = extend(r.bits(size), size);
              if (k < 64) z[kNatural[k]] = static_cast<int16_t>(val);
              ++k;
            } else if (run == 15) {
              k += 16;  // ZRL
            } else {
              break;  // EOB
            }
          }
        }
      }
    }
  }
  return r.pos;
}

}  // extern "C"
