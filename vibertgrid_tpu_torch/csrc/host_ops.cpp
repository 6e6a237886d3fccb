// Host-side data-pipeline ops of vibertgrid_tpu_torch, bound with ctypes by
// vibertgrid_tpu_torch/data/native.py, which builds this file at first use:
//
//   g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off
//
// -ffp-contract=off keeps every `a * b + c` below a product rounded before
// the sum. Where the target has FMA in its base ISA (aarch64, or x86-64 under
// -march=native) GCC contracts such lines by default, and the resize then
// no longer gives the bits of its plain version
// (data/transform.py::resize_normalize_into), which rounds each product. No
// -march and no -ffast-math for the same reason.
//
//  - bilinear_resize_f32: torch `F.interpolate(..., mode='bilinear',
//    align_corners=False)` semantics (half-pixel source grid, edge clamp),
//    the source coordinates in float64, the taps in this order: the row
//    above lerped across, the row below lerped across, the two lerped down.
//  - bilinear_resize_norm_strided_f32 / bilinear_resize_norm_f32: the same
//    resize with `(value - mean) * (1 / std)` per channel, written into a
//    row-strided destination (a page's slot of a padded batch canvas).
//  - rasterize_winner_i32: later-box-wins winner map (the host-side twin of
//    ops/rasterize.py::box_winner_map).
//  - pad_batch_f32: copy a page into the top-left corner of a padded canvas.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// src: [h, w, c] float32 row-major -> dst: [oh, ow, c]
void bilinear_resize_f32(const float* src, int h, int w, int c, float* dst,
                         int oh, int ow) {
  const double sy = static_cast<double>(h) / oh;
  const double sx = static_cast<double>(w) / ow;

  // the x-axis taps, once for every row
  int* xlo = new int[ow];
  int* xhi = new int[ow];
  float* xf = new float[ow];
  for (int j = 0; j < ow; ++j) {
    double srcx = (j + 0.5) * sx - 0.5;
    srcx = std::min(std::max(srcx, 0.0), static_cast<double>(w - 1));
    int lo = static_cast<int>(std::floor(srcx));
    xlo[j] = lo;
    xhi[j] = std::min(lo + 1, w - 1);
    xf[j] = static_cast<float>(srcx - lo);
  }

  for (int i = 0; i < oh; ++i) {
    double srcy = (i + 0.5) * sy - 0.5;
    srcy = std::min(std::max(srcy, 0.0), static_cast<double>(h - 1));
    const int ylo = static_cast<int>(std::floor(srcy));
    const int yhi = std::min(ylo + 1, h - 1);
    const float fy = static_cast<float>(srcy - ylo);
    const float* top_row = src + static_cast<size_t>(ylo) * w * c;
    const float* bot_row = src + static_cast<size_t>(yhi) * w * c;
    float* out_row = dst + static_cast<size_t>(i) * ow * c;
    for (int j = 0; j < ow; ++j) {
      const float fx = xf[j];
      const float* tl = top_row + static_cast<size_t>(xlo[j]) * c;
      const float* tr = top_row + static_cast<size_t>(xhi[j]) * c;
      const float* bl = bot_row + static_cast<size_t>(xlo[j]) * c;
      const float* br = bot_row + static_cast<size_t>(xhi[j]) * c;
      float* o = out_row + static_cast<size_t>(j) * c;
      for (int k = 0; k < c; ++k) {
        const float topv = tl[k] * (1.0f - fx) + tr[k] * fx;
        const float botv = bl[k] * (1.0f - fx) + br[k] * fx;
        o[k] = topv * (1.0f - fy) + botv * fy;
      }
    }
  }
  delete[] xlo;
  delete[] xhi;
  delete[] xf;
}

// boxes: [s, 4] int32 (x0, y0, x1, y1) image px; mask: [s] uint8.
// out: [h, w] int32, 0 = uncovered, else 1 + index of last covering box.
void rasterize_winner_i32(const int32_t* boxes, const uint8_t* mask, int s,
                          int32_t* out, int h, int w, int stride) {
  std::memset(out, 0, static_cast<size_t>(h) * w * sizeof(int32_t));
  for (int i = 0; i < s; ++i) {
    if (!mask[i]) continue;
    // floor division for non-negative coordinates
    int x0 = boxes[i * 4 + 0] / stride;
    int y0 = boxes[i * 4 + 1] / stride;
    int x1 = boxes[i * 4 + 2] / stride;
    int y1 = boxes[i * 4 + 3] / stride;
    x0 = std::max(x0, 0);
    y0 = std::max(y0, 0);
    x1 = std::min(x1, w);
    y1 = std::min(y1, h);
    for (int y = y0; y < y1; ++y) {
      int32_t* row = out + static_cast<size_t>(y) * w;
      for (int x = x0; x < x1; ++x) row[x] = i + 1;
    }
  }
}

// src: [h, w, c] -> the top-left of dst: [bh, bw, c] (dst zeroed by the
// caller, or here when zero_first != 0).
void pad_batch_f32(const float* src, int h, int w, int c, float* dst, int bh,
                   int bw, int zero_first) {
  if (zero_first) {
    std::memset(dst, 0, static_cast<size_t>(bh) * bw * c * sizeof(float));
  }
  for (int i = 0; i < h; ++i) {
    std::memcpy(dst + static_cast<size_t>(i) * bw * c,
                src + static_cast<size_t>(i) * w * c,
                static_cast<size_t>(w) * c * sizeof(float));
  }
}

// o = (bilinear(src) - mean) * (1 / std) per channel, written into a
// row-strided destination (dst_row_elems floats between row starts), so the
// collator resizes each page straight into its slot of the padded canvas.
// Same taps as bilinear_resize_f32; oh == h && ow == w is a normalize copy.
void bilinear_resize_norm_strided_f32(const float* src, int h, int w, int c,
                                      float* dst, int oh, int ow,
                                      long dst_row_elems, const float* mean,
                                      const float* std_) {
  float inv_std_local[16];
  float* inv_std = inv_std_local;
  float* heap = nullptr;
  if (c > 16) {
    heap = new float[c];
    inv_std = heap;
  }
  for (int k = 0; k < c; ++k) inv_std[k] = 1.0f / std_[k];

  if (oh == h && ow == w) {
    for (int i = 0; i < h; ++i) {
      const float* srow = src + static_cast<size_t>(i) * w * c;
      float* orow = dst + static_cast<size_t>(i) * dst_row_elems;
      for (int j = 0; j < w; ++j) {
        const float* s = srow + static_cast<size_t>(j) * c;
        float* o = orow + static_cast<size_t>(j) * c;
        for (int k = 0; k < c; ++k) o[k] = (s[k] - mean[k]) * inv_std[k];
      }
    }
    delete[] heap;
    return;
  }

  const double sy = static_cast<double>(h) / oh;
  const double sx = static_cast<double>(w) / ow;
  int* xlo = new int[ow];
  int* xhi = new int[ow];
  float* xf = new float[ow];
  for (int j = 0; j < ow; ++j) {
    double srcx = (j + 0.5) * sx - 0.5;
    srcx = std::min(std::max(srcx, 0.0), static_cast<double>(w - 1));
    int lo = static_cast<int>(std::floor(srcx));
    xlo[j] = lo;
    xhi[j] = std::min(lo + 1, w - 1);
    xf[j] = static_cast<float>(srcx - lo);
  }
  for (int i = 0; i < oh; ++i) {
    double srcy = (i + 0.5) * sy - 0.5;
    srcy = std::min(std::max(srcy, 0.0), static_cast<double>(h - 1));
    const int ylo = static_cast<int>(std::floor(srcy));
    const int yhi = std::min(ylo + 1, h - 1);
    const float fy = static_cast<float>(srcy - ylo);
    const float* top_row = src + static_cast<size_t>(ylo) * w * c;
    const float* bot_row = src + static_cast<size_t>(yhi) * w * c;
    float* out_row = dst + static_cast<size_t>(i) * dst_row_elems;
    for (int j = 0; j < ow; ++j) {
      const float fx = xf[j];
      const float* tl = top_row + static_cast<size_t>(xlo[j]) * c;
      const float* tr = top_row + static_cast<size_t>(xhi[j]) * c;
      const float* bl = bot_row + static_cast<size_t>(xlo[j]) * c;
      const float* br = bot_row + static_cast<size_t>(xhi[j]) * c;
      float* o = out_row + static_cast<size_t>(j) * c;
      for (int k = 0; k < c; ++k) {
        const float topv = tl[k] * (1.0f - fx) + tr[k] * fx;
        const float botv = bl[k] * (1.0f - fx) + br[k] * fx;
        o[k] = (topv * (1.0f - fy) + botv * fy - mean[k]) * inv_std[k];
      }
    }
  }
  delete[] xlo;
  delete[] xhi;
  delete[] xf;
  delete[] heap;
}

void bilinear_resize_norm_f32(const float* src, int h, int w, int c,
                              float* dst, int oh, int ow, const float* mean,
                              const float* std_) {
  bilinear_resize_norm_strided_f32(src, h, w, c, dst, oh, ow,
                                   static_cast<long>(ow) * c, mean, std_);
}

}  // extern "C"
