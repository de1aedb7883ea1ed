// PNG row unfiltering on the host, for the port's frame loading
// (tsdf_tpu_torch/native/__init__.py, io/png.py).
//
// The JAX package decodes its frames through libpng
// (tsdf_tpu/native/tsdf_io.cpp); this file needs no library: Python's zlib
// inflates the image data (releasing the GIL), and this undoes the five
// row filters of the PNG specification (section 9) and, for 16-bit
// samples, swaps each big-endian sample to the host's order. The Average
// and Paeth filters make each byte depend on the reconstructed byte to its
// left: a loop over the bytes, which in Python (io/png.py:_unfilter, the
// plain twin this is held against) costs many times what the inflate
// does (PERF.md section 5 has the times). ctypes releases the GIL
// around the call, so a pool of Python threads decodes frames in parallel.
//
// Build (tsdf_tpu_torch/native/__init__.py:build does this at first use):
//   g++ -O2 -shared -fPIC -std=c++17 png_unfilter.cpp -o libtsdf_png.so

#include <cstddef>
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

}  // namespace

// raw: height rows of (1 filter byte + stride bytes), as inflated; out:
// height * stride bytes; bpp: bytes a pixel (the filters' left distance,
// at least 1); swap16: swap each byte pair of the result to the host's
// order when it is little-endian (16-bit samples). Returns 0, or 1 + the
// row whose filter type is not 0-4.
extern "C" int tsdf_png_unfilter(const uint8_t* raw, uint8_t* out, int height,
                                 int stride, int bpp, int swap16) {
  const size_t n = (size_t)stride;
  const uint8_t* prior = nullptr;  // the row above, reconstructed
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + (size_t)y * (n + 1);
    const uint8_t type = line[0];
    const uint8_t* src = line + 1;
    uint8_t* cur = out + (size_t)y * n;
    switch (type) {
      case 0:  // None
        for (size_t i = 0; i < n; ++i) cur[i] = src[i];
        break;
      case 1:  // Sub
        for (size_t i = 0; i < n; ++i)
          cur[i] = (uint8_t)(src[i] + (i >= (size_t)bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < n; ++i)
          cur[i] = (uint8_t)(src[i] + (prior ? prior[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < n; ++i) {
          const int left = i >= (size_t)bpp ? cur[i - bpp] : 0;
          const int up = prior ? prior[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < n; ++i) {
          const bool has_left = i >= (size_t)bpp;
          const int a = has_left ? cur[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = has_left && prior ? prior[i - bpp] : 0;
          cur[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prior = cur;
  }
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  if (swap16) {
    const size_t total = (size_t)height * n;
    for (size_t i = 0; i + 1 < total; i += 2) {
      const uint8_t t = out[i];
      out[i] = out[i + 1];
      out[i + 1] = t;
    }
  }
#else
  (void)swap16;
#endif
  return 0;
}
