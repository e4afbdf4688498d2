// Native data-pipeline ops, bound with ctypes by depthops.py.
//
// 1. simple_depth_completion: the scanline depth completion of the NYU
//    loader, four directional sweeps (down/up per column, right/left per
//    row) carrying (previous depth, previous distance); an empty pixel takes
//    the carried value, a filled one is replaced when a nearer source is
//    carried past it. float32, row-major (H, W); canvas and dist in place.
// 2. png_unfilter: undo the five PNG scanline filters of a non-interlaced
//    image whose zlib stream the caller has already inflated, and emit the
//    pixels (16-bit samples big-endian in the file, native-endian out).
// 3. crc32c: the Castagnoli CRC of the TFRecord framing of TensorBoard
//    event files (a summary panel is megabytes: a Python loop is too slow).
//
// No zlib here: Python's zlib inflates. Built at first use by depthops.py
// with the host C++ compiler (c++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>

namespace {

constexpr float kInf = 1e8f;

inline void sweep_step(float& cell, float& cell_dist, float& prev_depth,
                       float& prev_dist, float step_len) {
  if (cell == 0.0f) {
    cell = prev_depth;
    cell_dist = prev_dist;
  } else {
    if (cell_dist > prev_dist) {
      cell_dist = prev_dist;
      cell = prev_depth;
    }
    prev_depth = cell;
    prev_dist = cell_dist;
  }
  prev_dist += step_len;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// 4-direction scanline completion, in place. canvas: (h, w) depths with 0 ==
// missing; dist: (h, w) workspace that starts at 0.
void simple_depth_completion(float* canvas, float* dist, int64_t h, int64_t w) {
  for (int64_t c = 0; c < w; ++c) {  // column sweeps: down, then up
    float prev_depth = 0.0f, prev_dist = kInf;
    for (int64_t r = 0; r < h; ++r) {
      sweep_step(canvas[r * w + c], dist[r * w + c], prev_depth, prev_dist, 1.0f);
    }
    prev_depth = 0.0f;
    prev_dist = kInf;
    for (int64_t r = h - 1; r >= 0; --r) {
      sweep_step(canvas[r * w + c], dist[r * w + c], prev_depth, prev_dist, 1.0f);
    }
  }
  for (int64_t r = 0; r < h; ++r) {  // row sweeps: right, then left
    float prev_depth = 0.0f, prev_dist = kInf;
    for (int64_t c = 0; c < w; ++c) {
      sweep_step(canvas[r * w + c], dist[r * w + c], prev_depth, prev_dist, 1.0f);
    }
    prev_depth = 0.0f;
    prev_dist = kInf;
    for (int64_t c = w - 1; c >= 0; --c) {
      sweep_step(canvas[r * w + c], dist[r * w + c], prev_depth, prev_dist, 1.0f);
    }
  }
}

// Batched variant: (n, h, w) contiguous.
void simple_depth_completion_batch(float* canvas, float* dist, int64_t n,
                                   int64_t h, int64_t w) {
  for (int64_t i = 0; i < n; ++i) {
    simple_depth_completion(canvas + i * h * w, dist + i * h * w, h, w);
  }
}

// Unfilter h scanlines of the inflated stream raw (h * (stride + 1) bytes:
// a filter byte, then stride bytes per row; bpp bytes per pixel, at least
// 1) into out (h * stride bytes). With sixteen != 0 the samples are 16-bit
// big-endian and are written as native-endian uint16. raw is modified.
// Returns 0, or 1 for a filter type outside 0-4.
int png_unfilter(uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                 int sixteen, uint8_t* out) {
  const uint8_t* prev = nullptr;  // the previous unfiltered row
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* row = raw + y * (stride + 1);
    const uint8_t ft = row[0];
    uint8_t* cur = row + 1;
    switch (ft) {
      case 0:  // None
        break;
      case 1:  // Sub
        for (int64_t i = bpp; i < stride; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
        break;
      case 2:  // Up
        if (prev)
          for (int64_t i = 0; i < stride; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(cur[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = uint8_t(cur[i] + paeth(a, b, c));
        }
        break;
      default:
        return 1;
    }
    uint8_t* dst = out + y * stride;
    if (sixteen) {
      uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
      for (int64_t i = 0; i < stride / 2; ++i)
        d16[i] = uint16_t((uint16_t(cur[2 * i]) << 8) | cur[2 * i + 1]);
    } else {
      std::memcpy(dst, cur, size_t(stride));
    }
    prev = cur;
  }
  return 0;
}

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of n bytes.
uint32_t crc32c(const uint8_t* data, int64_t n) {
  static uint32_t table[256];
  static bool ready = false;
  if (!ready) {  // a race only writes the same values twice
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      table[i] = c;
    }
    ready = true;
  }
  uint32_t crc = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) crc = (crc >> 8) ^ table[(crc ^ data[i]) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
