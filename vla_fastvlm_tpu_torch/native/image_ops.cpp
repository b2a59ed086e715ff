// Host-side image preprocessing of the PyTorch port (its own copy of the
// JAX package's native letterbox).
//
// Raw uint8 camera frames (HWC or CHW) -> letterboxed float32 CHW arrays,
// multithreaded across the batch, so host preprocessing overlaps the card's
// work instead of competing with the Python interpreter. Host code: no
// kernel of the card.
//
// Math parity with the reference letterbox (fastvlm_adapter.py:36-55):
//   ratio      = max(w / W, h / H)
//   resized_h  = int(h / ratio);  resized_w = int(w / ratio)   (truncating)
//   bilinear resize, align_corners=false, no antialias
//     src = (dst + 0.5) * (in / out) - 0.5, clamped to [0, in-1]
//   pad on the TOP and LEFT to (H, W) with pad_value.
// Output is scaled by `scale` (1/255 for [0,1] models).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct LerpCoef {
  int lo;
  int hi;
  float w_hi;  // weight of hi; weight of lo = 1 - w_hi
};

static void build_coeffs(int in_size, int out_size, std::vector<LerpCoef>& c) {
  c.resize(out_size);
  const float step = static_cast<float>(in_size) / static_cast<float>(out_size);
  for (int i = 0; i < out_size; ++i) {
    float src = (static_cast<float>(i) + 0.5f) * step - 0.5f;
    src = std::max(0.0f, std::min(src, static_cast<float>(in_size - 1)));
    int lo = static_cast<int>(src);
    int hi = std::min(lo + 1, in_size - 1);
    c[i] = {lo, hi, src - static_cast<float>(lo)};
  }
}

// One image: src uint8, CHW layout (c, h, w) -> dst float CHW (c, S, S),
// letterboxed with top/left padding.
static void letterbox_one(const uint8_t* src, int channels, int h, int w,
                          float* dst, int size, float pad_value, float scale) {
  const float ratio =
      std::max(static_cast<float>(w) / static_cast<float>(size),
               static_cast<float>(h) / static_cast<float>(size));
  const int rh = std::max(1, static_cast<int>(static_cast<float>(h) / ratio));
  const int rw = std::max(1, static_cast<int>(static_cast<float>(w) / ratio));
  const int pad_h = std::max(0, size - rh);
  const int pad_w = std::max(0, size - rw);

  std::vector<LerpCoef> ych, xch;
  build_coeffs(h, rh, ych);
  build_coeffs(w, rw, xch);

  for (int ch = 0; ch < channels; ++ch) {
    const uint8_t* plane = src + static_cast<size_t>(ch) * h * w;
    float* out_plane = dst + static_cast<size_t>(ch) * size * size;
    // top padding rows
    std::fill(out_plane, out_plane + static_cast<size_t>(pad_h) * size,
              pad_value);
    for (int oy = 0; oy < rh; ++oy) {
      float* row = out_plane + static_cast<size_t>(pad_h + oy) * size;
      // left padding cols
      std::fill(row, row + pad_w, pad_value);
      const LerpCoef& yc = ych[oy];
      const uint8_t* r0 = plane + static_cast<size_t>(yc.lo) * w;
      const uint8_t* r1 = plane + static_cast<size_t>(yc.hi) * w;
      const float wy1 = yc.w_hi, wy0 = 1.0f - yc.w_hi;
      for (int ox = 0; ox < rw; ++ox) {
        const LerpCoef& xc = xch[ox];
        const float wx1 = xc.w_hi, wx0 = 1.0f - xc.w_hi;
        const float top = wx0 * r0[xc.lo] + wx1 * r0[xc.hi];
        const float bot = wx0 * r1[xc.lo] + wx1 * r1[xc.hi];
        row[pad_w + ox] = (wy0 * top + wy1 * bot) * scale;
      }
    }
  }
}

}  // namespace

extern "C" {

// Batch letterbox: src (n, c, h, w) uint8 contiguous -> dst (n, c, S, S)
// float32. Threads: 0 = hardware concurrency.
void letterbox_u8_chw(const uint8_t* src, int n, int c, int h, int w,
                      float* dst, int size, float pad_value, float scale,
                      int num_threads) {
  const size_t in_stride = static_cast<size_t>(c) * h * w;
  const size_t out_stride = static_cast<size_t>(c) * size * size;
  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, n));

  auto work = [&](int start, int end) {
    for (int i = start; i < end; ++i) {
      letterbox_one(src + static_cast<size_t>(i) * in_stride, c, h, w,
                    dst + static_cast<size_t>(i) * out_stride, size, pad_value,
                    scale);
    }
  };

  if (threads == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int start = t * per;
    const int end = std::min(n, start + per);
    if (start >= end) break;
    pool.emplace_back(work, start, end);
  }
  for (auto& th : pool) th.join();
}

// HWC (n, h, w, c) uint8 -> CHW float32 letterbox. Transposes while reading.
void letterbox_u8_hwc(const uint8_t* src, int n, int h, int w, int c,
                      float* dst, int size, float pad_value, float scale,
                      int num_threads) {
  // Repack HWC -> CHW per image, then reuse the CHW kernel.
  const size_t img_elems = static_cast<size_t>(c) * h * w;
  std::vector<uint8_t> chw(static_cast<size_t>(n) * img_elems);
  for (int i = 0; i < n; ++i) {
    const uint8_t* in = src + static_cast<size_t>(i) * img_elems;
    uint8_t* out = chw.data() + static_cast<size_t>(i) * img_elems;
    for (int ch = 0; ch < c; ++ch)
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          out[(static_cast<size_t>(ch) * h + y) * w + x] =
              in[(static_cast<size_t>(y) * w + x) * c + ch];
  }
  letterbox_u8_chw(chw.data(), n, c, h, w, dst, size, pad_value, scale,
                   num_threads);
}

}  // extern "C"
