// Native host-side image path: JPEG decode + person-crop bilinear resize.
//
// The port's own copy of dsnt_pose2d_tpu/native/src/canvasio.cpp, unchanged
// below this header.  Exposed as a plain C ABI consumed via ctypes + numpy
// buffers: no CPython API involved, so calls release the GIL and the
// loader's fetch threads scale across host cores.
//
// The crop/resize uses pure bilinear sampling at pixel centers with
// zero-fill out of bounds -- the same sampling as the device warp's
// (dsnt_pose2d_tpu_torch/data/augment.py: affine_warp_bilinear).
//
// Built at first use by dsnt_pose2d_tpu_torch/native/__init__.py
// (g++ -O3 -shared -fPIC ... -ljpeg, into native/_build/).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

inline float sample_channel(const uint8_t* img, int h, int w, int c, int ch,
                            int yi, int xi) {
  if (xi < 0 || xi >= w || yi < 0 || yi >= h) return 0.0f;
  return static_cast<float>(img[(static_cast<int64_t>(yi) * w + xi) * c + ch]);
}

}  // namespace

extern "C" {

// Returns 0 on success; fills width/height/components.
int canvasio_jpeg_info(const uint8_t* buf, int64_t len, int* width,
                       int* height, int* components) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *width = cinfo.image_width;
  *height = cinfo.image_height;
  *components = 3;  // we always decode to RGB
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to RGB uint8 (height*width*3, caller-allocated). 0 on success.
int canvasio_decode_jpeg(const uint8_t* buf, int64_t len, uint8_t* out,
                         int width, int height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != width ||
      static_cast<int>(cinfo.output_height) != height) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const int stride = width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<int64_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Crop the square [left, left+side) x [top, top+side) from an RGB image and
// bilinearly resample it to out_size x out_size.  Out-of-bounds reads are
// zero (black fill), matching the device warp and PIL's crop padding.
// Sampling: output pixel i center maps to input x = left + (i + 0.5) * side /
// out_size - 0.5 (pixel-center convention, identical to the device warp's
// inverse-affine sampling for this transform).
void canvasio_crop_resize(const uint8_t* img, int h, int w, float left,
                          float top, float side, uint8_t* out, int out_size) {
  const int c = 3;
  const float scale = side / static_cast<float>(out_size);
  for (int oy = 0; oy < out_size; ++oy) {
    const float sy = top + (static_cast<float>(oy) + 0.5f) * scale - 0.5f;
    const int y0 = static_cast<int>(std::floor(sy));
    const float fy = sy - static_cast<float>(y0);
    for (int ox = 0; ox < out_size; ++ox) {
      const float sx = left + (static_cast<float>(ox) + 0.5f) * scale - 0.5f;
      const int x0 = static_cast<int>(std::floor(sx));
      const float fx = sx - static_cast<float>(x0);
      for (int ch = 0; ch < c; ++ch) {
        const float v00 = sample_channel(img, h, w, c, ch, y0, x0);
        const float v01 = sample_channel(img, h, w, c, ch, y0, x0 + 1);
        const float v10 = sample_channel(img, h, w, c, ch, y0 + 1, x0);
        const float v11 = sample_channel(img, h, w, c, ch, y0 + 1, x0 + 1);
        const float top_v = v00 * (1.0f - fx) + v01 * fx;
        const float bot_v = v10 * (1.0f - fx) + v11 * fx;
        const float val = top_v * (1.0f - fy) + bot_v * fy;
        out[(static_cast<int64_t>(oy) * out_size + ox) * c + ch] =
            static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, std::round(val))));
      }
    }
  }
}

// Fused decode + crop + resize; returns 0 on success.
int canvasio_decode_crop_resize(const uint8_t* buf, int64_t len, float left,
                                float top, float side, uint8_t* out,
                                int out_size) {
  int w, h, comps;
  if (canvasio_jpeg_info(buf, len, &w, &h, &comps)) return 1;
  std::vector<uint8_t> full(static_cast<size_t>(w) * h * 3);
  if (canvasio_decode_jpeg(buf, len, full.data(), w, h)) return 1;
  canvasio_crop_resize(full.data(), h, w, left, top, side, out, out_size);
  return 0;
}

int canvasio_num_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 1;
}

}  // extern "C"
