// The serial byte work of loupiote_tpu_torch/image_codec.py, on the host:
// PNG's scanline unfiltering (Sub, Up, Average, Paeth carry a dependency
// from one byte to the next) and the Huffman bit packing of a baseline
// JPEG scan. The rest of both codecs (chunk parsing, zlib, bit unpacking,
// colour conversion, the DCT and quantisation) is numpy / torch.
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

}  // extern "C"
