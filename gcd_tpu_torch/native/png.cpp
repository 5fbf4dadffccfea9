// PNG row unfiltering for the port's PNG reader (gcd_tpu_torch/data/png.py).
//
// A PNG's decompressed image data is `height` rows, each a filter-type byte
// followed by `row_bytes` filtered bytes (PNG specification, section 9). The
// Sub, Average and Paeth filters predict each byte from the reconstructed
// byte `bpp` bytes to its left, so a row is a chain of dependent bytes: in
// Python that costs about a second for a 640x480 RGBA frame, here a few
// milliseconds. The plain Python version beside the reader
// (png.unfilter_plain) computes the same bytes for the tests.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 png.cpp -o libgcdpng.so
// (gcd_tpu_torch/native/__init__.py builds it at first use and raises if it
// cannot).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// The Paeth predictor: the neighbour nearest to a + b - c, ties to a, then b.
inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Reconstruct `height` filtered rows of `src` ((1 + row_bytes) bytes each)
// into `dst` (row_bytes bytes each); `bpp` is the bytes of one pixel (at
// least 1). Returns 0, or 1 + the index of the first row whose filter type
// is not 0-4 (dst is then incomplete).
int gcd_png_unfilter(const uint8_t* src, int64_t height, int64_t row_bytes, int bpp,
                     uint8_t* dst) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (row_bytes + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + y * row_bytes;
    const uint8_t* up = y > 0 ? out - row_bytes : nullptr;  // row 0: "up" is zero
    const int64_t lead = bpp < row_bytes ? bpp : row_bytes;
    switch (type) {
      case 0:  // None
        std::memcpy(out, in, static_cast<size_t>(row_bytes));
        break;
      case 1:  // Sub: + left
        std::memcpy(out, in, static_cast<size_t>(lead));
        for (int64_t i = bpp; i < row_bytes; ++i) out[i] = static_cast<uint8_t>(in[i] + out[i - bpp]);
        break;
      case 2:  // Up: + above
        if (up == nullptr) {
          std::memcpy(out, in, static_cast<size_t>(row_bytes));
        } else {
          for (int64_t i = 0; i < row_bytes; ++i) out[i] = static_cast<uint8_t>(in[i] + up[i]);
        }
        break;
      case 3:  // Average: + floor((left + above) / 2), summed wider than a byte
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up != nullptr ? up[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up != nullptr ? up[i] : 0;
          const int c = (up != nullptr && i >= bpp) ? up[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return static_cast<int>(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
