// Native host-side data-loader ops of csts_torch (the port's own copy of the
// JAX package's loader_ops.cpp, the same loops).
//
// The input pipeline's per-sample hot path (after the resize) is a chain of
// numpy passes: uint8->float normalize, crop slice, flip copy, heatmap stamping,
// STFT slice gathers, each materializing an intermediate. These are fused into
// single-pass C++ loops exposed through a plain C ABI for ctypes.
//
// Build: csts_torch/native/build.py (g++ -O3 -shared, no fused multiply-add,
// without OpenMP: the loader's worker processes are the parallelism, and the
// pragmas below are then ignored).

#include <cstdint>
#include <cmath>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// uint8 frames (T, H, W, 3) -> float32 (T, crop, crop, 3):
//   out = (frame[y0:y0+crop, x0:x0+crop] / 255 - mean) / std, optionally mirrored.
// Single pass, no intermediates.
void fused_crop_flip_normalize(
    const uint8_t* frames, int64_t t, int64_t h, int64_t w,
    int64_t y0, int64_t x0, int64_t crop,
    int flip,
    const float* mean, const float* inv_std,
    float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < t; ++f) {
    const uint8_t* src_frame = frames + f * h * w * 3;
    float* dst_frame = out + f * crop * crop * 3;
    for (int64_t y = 0; y < crop; ++y) {
      const uint8_t* src_row = src_frame + ((y0 + y) * w + x0) * 3;
      float* dst_row = dst_frame + y * crop * 3;
      if (!flip) {
        for (int64_t x = 0; x < crop; ++x) {
          for (int c = 0; c < 3; ++c) {
            dst_row[x * 3 + c] =
                (src_row[x * 3 + c] * (1.0f / 255.0f) - mean[c]) * inv_std[c];
          }
        }
      } else {
        for (int64_t x = 0; x < crop; ++x) {
          const uint8_t* s = src_row + (crop - 1 - x) * 3;
          for (int c = 0; c < 3; ++c) {
            dst_row[x * 3 + c] = (s[c] * (1.0f / 255.0f) - mean[c]) * inv_std[c];
          }
        }
      }
    }
  }
}

// Same fusion for float32 input frames (post-resize path).
void fused_crop_flip_normalize_f32(
    const float* frames, int64_t t, int64_t h, int64_t w,
    int64_t y0, int64_t x0, int64_t crop,
    int flip,
    const float* mean, const float* inv_std,
    int already_normalized,  // input is raw [0,1]? then just crop/flip
    float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < t; ++f) {
    const float* src_frame = frames + f * h * w * 3;
    float* dst_frame = out + f * crop * crop * 3;
    for (int64_t y = 0; y < crop; ++y) {
      const float* src_row = src_frame + ((y0 + y) * w + x0) * 3;
      float* dst_row = dst_frame + y * crop * 3;
      for (int64_t x = 0; x < crop; ++x) {
        const float* s = flip ? src_row + (crop - 1 - x) * 3 : src_row + x * 3;
        for (int c = 0; c < 3; ++c) {
          float v = s[c];
          if (!already_normalized) v = (v - mean[c]) * inv_std[c];
          dst_row[x * 3 + c] = v;
        }
      }
    }
  }
}

// Gather per-frame STFT slices: audio (F, L) + indices (T,) -> out (T, F, 2*half).
void audio_slice_gather(
    const float* audio, int64_t f_bins, int64_t length,
    const int64_t* centers, int64_t t, int64_t half,
    float* out) {
  const int64_t win = 2 * half;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < t; ++i) {
    int64_t c0 = centers[i] - half;
    for (int64_t fb = 0; fb < f_bins; ++fb) {
      std::memcpy(out + (i * f_bins + fb) * win,
                  audio + fb * length + c0,
                  sizeof(float) * win);
    }
  }
}

// Stamp a normalized Gaussian kernel patch per frame; uniform fallback off-image.
// gaze (T, 2) normalized [x, y]; kernel (k, k) L1-normalized; out (T, H, W).
void gaze_heatmaps(
    const double* gaze, int64_t t,
    const float* kernel, int64_t k,
    int64_t hh, int64_t ww,
    float* out) {
  const int64_t half = (k - 1) / 2;
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < t; ++f) {
    float* hm = out + f * hh * ww;
    std::memset(hm, 0, sizeof(float) * hh * ww);
    // round-half-to-even to match python round() in the reference
    double cx = gaze[f * 2 + 0] * ww;
    double cy = gaze[f * 2 + 1] * hh;
    auto rte = [](double v) -> int64_t {
      double fl = std::floor(v);
      double diff = v - fl;
      if (diff > 0.5) return (int64_t)fl + 1;
      if (diff < 0.5) return (int64_t)fl;
      return ((int64_t)fl % 2 == 0) ? (int64_t)fl : (int64_t)fl + 1;
    };
    int64_t mu_x = rte(cx), mu_y = rte(cy);
    int64_t left = mu_x - half < 0 ? 0 : mu_x - half;
    int64_t right = mu_x + half > ww - 1 ? ww - 1 : mu_x + half;
    int64_t top = mu_y - half < 0 ? 0 : mu_y - half;
    int64_t bottom = mu_y + half > hh - 1 ? hh - 1 : mu_y + half;
    double total = 0.0;
    if (left < right && top < bottom) {
      for (int64_t y = top; y <= bottom; ++y) {
        int64_t ky = half - mu_y + y;
        for (int64_t x = left; x <= right; ++x) {
          int64_t kx = half - mu_x + x;
          float v = kernel[ky * k + kx];
          hm[y * ww + x] = v;
          total += v;
        }
      }
    }
    if (total == 0.0) {
      float u = 1.0f / (float)(hh * ww);
      for (int64_t i = 0; i < hh * ww; ++i) hm[i] = u;
    } else if (total != 1.0) {
      float inv = (float)(1.0 / total);
      for (int64_t y = top; y <= bottom; ++y)
        for (int64_t x = left; x <= right; ++x) hm[y * ww + x] *= inv;
    }
  }
}

int loader_ops_version() { return 1; }

}  // extern "C"
