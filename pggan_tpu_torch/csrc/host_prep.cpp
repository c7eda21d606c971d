// Host-side data preparation for pggan_tpu_torch: a copy of
// native/host_prep.cpp, the loader's per-batch hot path between the uint8
// pyramid in RAM (or on disk) and the float32 NHWC batch:
//
//   - box_downsample_u8: exact block-mean downsample (the pyramid builder,
//     semantics of reference dataset.py:244-251),
//   - prep_batch_f32: fused alpha-fade blend (2x2 box down+up, reference
//     dataset.py:109-113) + dynamic-range remap (reference utils.py:24-30)
//     producing the final float32 batch in one pass.
//
// One change from the copy: prep_batch_f32 takes the coarse image's weight
// (1 - alpha, rounded to float32 by the caller as numpy rounds it) and
// blends as the numpy version writes it, v + (t - v) * (1 - alpha), so the
// library's batches equal numpy's bit for bit (built with
// -ffp-contract=off, so no fused multiply-add changes a rounding).
//
// Built at first use by pggan_tpu_torch/data/native.py with
// `c++ -O3 -fPIC -fopenmp -ffp-contract=off -shared`, loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// dst[(h/factor) x (w/factor) x c] = round(block mean of src), clipped 0..255.
void box_downsample_u8(const uint8_t* src, int h, int w, int c, int factor,
                       uint8_t* dst) {
  const int oh = h / factor, ow = w / factor;
  const float inv = 1.0f / static_cast<float>(factor * factor);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int dy = 0; dy < factor; ++dy) {
          const uint8_t* row = src + ((y * factor + dy) * w + x * factor) * c + ch;
          for (int dx = 0; dx < factor; ++dx) acc += row[dx * c];
        }
        // round-half-even to match numpy's np.round exactly
        float v = std::nearbyintf(acc * inv);
        dst[(y * ow + x) * c + ch] =
            static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v)));
      }
    }
  }
}

// Fused fade + dynamic-range remap for a uint8 NHWC batch:
//   blended = v + (mean2x2(v) - v) * coarse   (skipped unless fade)
//   dst     = (blended - min_in) * scale + min_out
// h and w must be even when fading (power-of-two resolutions always are).
void prep_batch_f32(const uint8_t* src, int n, int h, int w, int c,
                    int fade, float coarse, float min_in, float scale,
                    float min_out, float* dst) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n; ++i) {
    const uint8_t* img = src + static_cast<long>(i) * h * w * c;
    float* out = dst + static_cast<long>(i) * h * w * c;
    if (!fade) {
      const long total = static_cast<long>(h) * w * c;
      for (long k = 0; k < total; ++k)
        out[k] = (static_cast<float>(img[k]) - min_in) * scale + min_out;
      continue;
    }
    for (int y = 0; y < h; y += 2) {
      for (int x = 0; x < w; x += 2) {
        for (int ch = 0; ch < c; ++ch) {
          const long p[4] = {(static_cast<long>(y) * w + x) * c + ch,
                             (static_cast<long>(y) * w + x + 1) * c + ch,
                             (static_cast<long>(y + 1) * w + x) * c + ch,
                             (static_cast<long>(y + 1) * w + x + 1) * c + ch};
          // numpy's float32 mean of the four: their sum is exact, then / 4
          const float t = (static_cast<float>(img[p[0]]) +
                           static_cast<float>(img[p[1]]) +
                           static_cast<float>(img[p[2]]) +
                           static_cast<float>(img[p[3]])) / 4.0f;
          for (int k = 0; k < 4; ++k) {
            const float v = static_cast<float>(img[p[k]]);
            out[p[k]] = ((v + (t - v) * coarse) - min_in) * scale + min_out;
          }
        }
      }
    }
  }
}

}  // extern "C"
