// Native frame-decoding core for the host data pipeline.
//
// The reference decodes frames with PIL in torch DataLoader worker
// processes (reference mebt/data.py:488-517). Here the hot path —
// JPEG/PNG decode, center square crop, triangle-filter (PIL-bilinear
// style) resize, and [-0.5, 0.5] normalization — runs in C++ with an
// internal thread pool, exposed to Python via ctypes
// (mebt_tpu_torch/data/native.py, which builds it with g++ at first
// use). PIL remains the fallback.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, 8-bit
};

// ---------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG

bool decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->c = 3;
  out->data.resize(size_t(w) * h * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);
  }
  fclose(f);
  return ok && out->c == 3;
}

// --------------------------------------------------- resize (triangle)

// Separable resampling with a triangle filter whose support scales with
// the downscale factor — the same scheme PIL uses for Image.BILINEAR.
struct FilterTap {
  int start;
  std::vector<float> w;
};

std::vector<FilterTap> build_taps(int in_size, int out_size) {
  std::vector<FilterTap> taps(out_size);
  const double scale = double(in_size) / out_size;
  const double support = std::max(1.0, scale);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int lo = std::max(0, int(std::floor(center - support)));
    int hi = std::min(in_size, int(std::ceil(center + support)));
    FilterTap t;
    t.start = lo;
    t.w.resize(hi - lo);
    double sum = 0.0;
    for (int k = lo; k < hi; ++k) {
      double x = (k + 0.5 - center) / support;
      double v = std::max(0.0, 1.0 - std::fabs(x));
      t.w[k - lo] = float(v);
      sum += v;
    }
    if (sum > 0)
      for (auto& v : t.w) v = float(v / sum);
    taps[i] = std::move(t);
  }
  return taps;
}

// crop (square, centered) then resize to res x res, normalize to
// [-0.5, 0.5]; out: (res, res, 3) float32
void crop_resize_normalize(const Image& img, int res, float* out) {
  int side = std::min(img.w, img.h);
  int x0 = (img.w - side) / 2;
  int y0 = (img.h - side) / 2;

  auto xt = build_taps(side, res);
  auto yt = build_taps(side, res);

  // horizontal pass: (side, res, 3)
  std::vector<float> tmp(size_t(side) * res * 3);
  for (int y = 0; y < side; ++y) {
    const uint8_t* row = img.data.data() + (size_t(y0 + y) * img.w + x0) * 3;
    float* trow = tmp.data() + size_t(y) * res * 3;
    for (int x = 0; x < res; ++x) {
      const auto& t = xt[x];
      float acc[3] = {0, 0, 0};
      for (size_t k = 0; k < t.w.size(); ++k) {
        const uint8_t* p = row + size_t(t.start + k) * 3;
        acc[0] += t.w[k] * p[0];
        acc[1] += t.w[k] * p[1];
        acc[2] += t.w[k] * p[2];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass + normalize
  for (int y = 0; y < res; ++y) {
    const auto& t = yt[y];
    float* orow = out + size_t(y) * res * 3;
    for (int x = 0; x < res; ++x) {
      float acc[3] = {0, 0, 0};
      for (size_t k = 0; k < t.w.size(); ++k) {
        const float* p = tmp.data() + (size_t(t.start + k) * res + x) * 3;
        acc[0] += t.w[k] * p[0];
        acc[1] += t.w[k] * p[1];
        acc[2] += t.w[k] * p[2];
      }
      // PIL converts back to uint8 before the float conversion in the
      // reference pipeline; round to replicate the quantization
      orow[x * 3 + 0] = std::nearbyint(acc[0]) / 255.0f - 0.5f;
      orow[x * 3 + 1] = std::nearbyint(acc[1]) / 255.0f - 0.5f;
      orow[x * 3 + 2] = std::nearbyint(acc[2]) / 255.0f - 0.5f;
    }
  }
}

}  // namespace

extern "C" {

// Decode one frame: path -> (res, res, 3) float32 in [-0.5, 0.5].
// Returns 0 on success.
int mebt_decode_frame(const char* path, int res, float* out) {
  Image img;
  if (!decode_file(path, &img)) return 1;
  crop_resize_normalize(img, res, out);
  return 0;
}

// Decode a clip of `count` frames (paths as a NULL-free array of C
// strings) with `n_threads` workers into (count, res, res, 3) float32.
// Returns the number of failed frames (0 == full success).
int mebt_decode_clip(const char** paths, int count, int res, int n_threads,
                     float* out) {
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  const size_t frame_elems = size_t(res) * res * 3;
  n_threads = std::max(1, std::min(n_threads, count));

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) break;
      if (mebt_decode_frame(paths[i], res, out + frame_elems * i) != 0)
        failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Probe an image's dimensions without full decode of the pixel data.
int mebt_probe(const char* path, int* w, int* h) {
  Image img;
  if (!decode_file(path, &img)) return 1;
  *w = img.w;
  *h = img.h;
  return 0;
}
}
