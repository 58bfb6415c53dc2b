// Row unfiltering of PNG image data for the port's PNG reader
// (eggfusion_tpu_torch/io/png.py): the five filter types of the PNG
// specification (section 9.2: None, Sub, Up, Average, Paeth). Sub, Average
// and Paeth depend on the byte `bpp` to the left in the same row, already
// unfiltered, so each row is one sequential pass; numpy cannot vectorize it.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// raw: h rows of 1 + rowbytes bytes (the filter type, then the filtered
// row); out: h rows of rowbytes bytes; bpp: bytes per pixel (>= 1).
// Returns 0, or 1 + the index of the first row with an unknown filter type.
int ef_png_unfilter(const uint8_t* raw, int h, int rowbytes, int bpp, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw + static_cast<size_t>(y) * (rowbytes + 1);
    const uint8_t type = *in++;
    uint8_t* cur = out + static_cast<size_t>(y) * rowbytes;
    const uint8_t* prev = y > 0 ? cur - rowbytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(cur, in, rowbytes);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
