// le_loader — native data-loading runtime (a copy of the JAX package's
// native/le_loader.cc for learning_embeddings_tpu_torch).
//
// The reference's input pipeline is torchvision transforms + cv2 reads in
// DataLoader worker *processes* (db.py:3792-3798, ethec_experiments.py:
// 263-291). This library replaces that host path with one fused native
// pass per image — JPEG decode (libjpeg) → bilinear resize → random crop →
// horizontal flip → float32 [0,1] normalize — executed by an internal
// std::thread pool directly into the caller's pinned batch buffer, so
// Python touches each image exactly zero times.
//
// C ABI (ctypes-friendly); see learning_embeddings_tpu_torch/data/
// native_loader.py, which builds it with Makefile beside this file.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <thread>
#include <type_traits>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG byte buffer into an RGB (or grayscale) uint8 image.
// min_dim > 0 enables libjpeg DCT-scaled decode: pick the largest 1/2^k
// scale whose output still keeps both dims >= min_dim — decoding a 2000px
// specimen photo destined for a 448 crop at 1/2 or 1/4 resolution cuts
// IDCT+color-convert cost ~4-16x with no quality impact on the downstream
// bilinear resample. Returns nullptr on failure.
uint8_t* decode_jpeg(const uint8_t* data, size_t size, int want_gray,
                     int min_dim, int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // volatile: `out` changes between setjmp and a possible longjmp (decode
  // errors mid-scanline); without it the error path could free a stale copy
  uint8_t* volatile out = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = want_gray ? JCS_GRAYSCALE : JCS_RGB;
  if (min_dim > 0) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    while (cinfo.scale_denom < 8) {
      unsigned next = cinfo.scale_denom * 2;
      if (cinfo.image_width / next >= static_cast<unsigned>(min_dim) &&
          cinfo.image_height / next >= static_cast<unsigned>(min_dim)) {
        cinfo.scale_denom = next;
      } else {
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  *c = cinfo.output_components;
  size_t stride = static_cast<size_t>(*w) * (*c);
  out = static_cast<uint8_t*>(malloc(stride * (*h)));
  if (!out) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

// Bilinear resize uint8 HWC -> (oh, ow), half-pixel-center convention
// (matches cv2.INTER_LINEAR / PIL sampling).
void resize_bilinear(const uint8_t* src, int h, int w, int c,
                     uint8_t* dst, int oh, int ow) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(fy, 0.f);
    int y0 = static_cast<int>(fy);
    y0 = std::min(y0, h - 1);
    int y1 = std::min(y0 + 1, h - 1);
    float wy = fy - y0;
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(fx, 0.f);
      int x0 = static_cast<int>(fx);
      x0 = std::min(x0, w - 1);
      int x1 = std::min(x0 + 1, w - 1);
      float wx = fx - x0;
      for (int k = 0; k < c; ++k) {
        float v00 = src[(y0 * w + x0) * c + k];
        float v01 = src[(y0 * w + x1) * c + k];
        float v10 = src[(y1 * w + x0) * c + k];
        float v11 = src[(y1 * w + x1) * c + k];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * ow + x) * c + k] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Output conversion: float32 normalizes to [0,1]; uint8 rounds to nearest
// (the TPU-first transfer format — 4x less host->device bandwidth, the
// /255 happens on device where XLA fuses it into the first conv).
inline void store_px(float v, float* dst) { *dst = v * (1.0f / 255.0f); }
inline void store_px(float v, uint8_t* dst) {
  v = std::min(std::max(v, 0.f), 255.f);
  *dst = static_cast<uint8_t>(v + 0.5f);
}

// One element of the batch: read file, decode (DCT-scaled when the source
// is much larger than needed), then ONE fused pass that bilinearly samples
// the virtual (S+pad)² resize at the random-crop window, applies the flip,
// and writes the output format — no intermediate resized buffer, no
// second normalize sweep. Equivalent math to resize→crop→flip→normalize
// (sampling at fy=(y0+y+0.5)·h/big−0.5), minus one uint8 rounding.
// Returns 0 on success.
template <typename OutT>
int load_one(const char* path, int size, int pad, int train, int gray,
             uint64_t seed, OutT* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    fclose(f);
    return 2;
  }
  fclose(f);

  int big = train ? size + pad : size;
  int h, w, c;
  uint8_t* img = decode_jpeg(buf.data(), buf.size(), gray, 2 * big,
                             &h, &w, &c);
  if (!img) return 3;

  std::mt19937_64 rng(seed);
  int y0 = 0, x0 = 0;
  bool flip = false;
  if (train) {
    y0 = static_cast<int>(rng() % (pad + 1));
    x0 = static_cast<int>(rng() % (pad + 1));
    flip = (rng() & 1) != 0;
  }

  const float sy = static_cast<float>(h) / big;
  const float sx = static_cast<float>(w) / big;
  // per-output-column source taps (post-flip), hoisted out of the row loop
  std::vector<int> xl0(size), xl1(size);
  std::vector<float> xw(size);
  for (int x = 0; x < size; ++x) {
    int cx = flip ? (size - 1 - x) : x;
    float fx = (x0 + cx + 0.5f) * sx - 0.5f;
    fx = std::max(fx, 0.f);
    int a = std::min(static_cast<int>(fx), w - 1);
    xl0[x] = a;
    xl1[x] = std::min(a + 1, w - 1);
    xw[x] = fx - a;
  }
  // compile-time channel count so the per-pixel loop fully unrolls
  auto sample_rows = [&](auto CC, int y) {
    constexpr int C = decltype(CC)::value;
    float fy = (y0 + y + 0.5f) * sy - 0.5f;
    fy = std::max(fy, 0.f);
    int b0 = std::min(static_cast<int>(fy), h - 1);
    int b1 = std::min(b0 + 1, h - 1);
    const float wy = fy - b0;
    const uint8_t* r0 = img + static_cast<size_t>(b0) * w * C;
    const uint8_t* r1 = img + static_cast<size_t>(b1) * w * C;
    OutT* orow = out + static_cast<size_t>(y) * size * C;
    for (int x = 0; x < size; ++x) {
      const float wx = xw[x];
      const uint8_t* p00 = r0 + xl0[x] * C;
      const uint8_t* p01 = r0 + xl1[x] * C;
      const uint8_t* p10 = r1 + xl0[x] * C;
      const uint8_t* p11 = r1 + xl1[x] * C;
      for (int k = 0; k < C; ++k) {
        const float top = p00[k] + (p01[k] - p00[k]) * wx;
        const float bot = p10[k] + (p11[k] - p10[k]) * wx;
        store_px(top + (bot - top) * wy, orow + x * C + k);
      }
    }
  };
  if (c == 3) {
    for (int y = 0; y < size; ++y)
      sample_rows(std::integral_constant<int, 3>{}, y);
  } else {
    for (int y = 0; y < size; ++y)
      sample_rows(std::integral_constant<int, 1>{}, y);
  }
  free(img);
  return 0;
}

template <typename OutT>
int load_batch_impl(const char** paths, int n, int size, int pad, int train,
                    int gray, uint64_t seed, OutT* out, int* status) {
  int c = gray ? 1 : 3;
  size_t elem = static_cast<size_t>(size) * size * c;
  int n_threads = std::min<unsigned>(std::thread::hardware_concurrency(),
                                     static_cast<unsigned>(n));
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = load_one(paths[i], size, pad, train, gray,
                        seed + static_cast<uint64_t>(i) * 0x9E3779B97F4A7C15ull,
                        out + elem * i);
      status[i] = rc;
      if (rc == 0) ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

}  // namespace

extern "C" {

// Load + augment a batch of images in parallel.
//   paths:  n file paths (jpeg)
//   size:   output side (SxS)
//   pad:    resize headroom for the random crop (train only; 64 upstream)
//   train:  1 = random crop + flip, 0 = plain resize
//   gray:   1 = grayscale (C=1), 0 = RGB (C=3)
//   seed:   base RNG seed; element i uses seed + i
//   out:    preallocated n*size*size*C float32 buffer
//   status: per-element return codes (0 ok)
// Returns the number of successfully loaded images.
int le_load_augment_batch(const char** paths, int n, int size, int pad,
                          int train, int gray, uint64_t seed, float* out,
                          int* status) {
  return load_batch_impl(paths, n, size, pad, train, gray, seed, out,
                         status);
}

// uint8 output variant: same decode/augment pass, batch stays uint8 for a
// 4x-smaller host->device transfer (scale-to-[0,1] happens on device).
int le_load_augment_batch_u8(const char** paths, int n, int size, int pad,
                             int train, int gray, uint64_t seed,
                             uint8_t* out, int* status) {
  return load_batch_impl(paths, n, size, pad, train, gray, seed, out,
                         status);
}

// Standalone bilinear resize for testing / preprocessing.
void le_resize_bilinear(const uint8_t* src, int h, int w, int c,
                        uint8_t* dst, int oh, int ow) {
  resize_bilinear(src, h, w, c, dst, oh, ow);
}

int le_version() { return 2; }

}  // extern "C"
