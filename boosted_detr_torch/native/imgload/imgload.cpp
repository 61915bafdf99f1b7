// Native JPEG decode + bilinear resize batch loader, C++17 + libjpeg +
// pthreads.
//
// The reference's image input path is tf.data's C++ runtime
// (tf.io.decode_image + Resizing, reference pipeline.py:58-64); this is the
// framework's own native equivalent: decode a batch of JPEG files into a
// caller-provided float32 [B, H, W, 3] buffer (values in [0,1]) using a
// worker thread pool, bypassing Python/PIL entirely on the hot path.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to RGB8. Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>* out, int* w,
                 int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data()
        + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize RGB8 [sh, sw] -> float32 [th, tw] scaled to [0, 1].
void resize_to_float(const uint8_t* src, int sw, int sh, float* dst, int tw,
                     int th) {
  const float sx = static_cast<float>(sw) / tw;
  const float sy = static_cast<float>(sh) / th;
  for (int y = 0; y < th; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = fy - y0 < 0 ? 0 : fy - y0;
    for (int x = 0; x < tw; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      const int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = fx - x0 < 0 ? 0 : fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c];
        const float v01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c];
        const float v10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c];
        const float v11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c];
        const float top = v00 + (v01 - v00) * wx;
        const float bot = v10 + (v11 - v10) * wx;
        dst[(static_cast<size_t>(y) * tw + x) * 3 + c] =
            (top + (bot - top) * wy) / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// paths: array of b null-terminated strings; out: [b, th, tw, 3] f32.
// ok_out[i] = 1 on success, 0 on decode failure (output zeroed).
// Returns number of successfully decoded images.
int imgload_batch(const char* const* paths, int32_t b, int32_t th,
                  int32_t tw, int32_t num_threads, float* out,
                  int32_t* ok_out) {
  std::atomic<int> next(0);
  std::atomic<int> good(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    for (int i = next.fetch_add(1); i < b; i = next.fetch_add(1)) {
      float* dst = out + static_cast<size_t>(i) * th * tw * 3;
      if (decode_jpeg(paths[i], &rgb, &w, &h)) {
        resize_to_float(rgb.data(), w, h, dst, tw, th);
        ok_out[i] = 1;
        good.fetch_add(1);
      } else {
        std::memset(dst, 0, sizeof(float) * static_cast<size_t>(th) * tw * 3);
        ok_out[i] = 0;
      }
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return good.load();
}

}  // extern "C"
