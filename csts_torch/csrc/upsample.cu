// K3: x2 half-pixel linear interpolation along T (the stride-(2,1,1) decoder
// skip, nn.Upsample(scale_factor=(2,1,1), mode='trilinear'), and the
// stem-skip T-resize at the head):
//   out[2m]   = 0.25·x[m-1] + 0.75·x[m]     (edge-clamped; t=0 copies x[0])
//   out[2m+1] = 0.75·x[m]   + 0.25·x[m+1]   (edge-clamped; last copies x[T-1])
//
// Replaces csts_tpu/kernels/upsample.py:_t2_kernel (called from
// t2_upsample_padded). The same two-tap formula in fp32 with one rounding,
// and exact copies on the clamped edge planes; the TPU kernel's 128-lane
// channel padding is not carried over (the output is the unpadded token grid).
//
// Bound on the H100: pure data movement, read x once (B·T·S elements) and
// write the output once (2·B·T·S), at 3.35 TB/s; ~3 operations per output.
// Design: one thread per output element over the flattened (B, 2T, S) grid,
// S = H·W·C contiguous, so neighbouring threads read and write neighbouring
// addresses; the two source planes of an output plane are re-read from L2.
#include "common.cuh"

using namespace csts;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    t2_upsample_kernel(const T* __restrict__ x, T* __restrict__ out, int Tc, long long S,
                       long long total) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const long long s = i % S, bt = i / S;
    const int t = static_cast<int>(bt % (2 * Tc));
    const long long b = bt / (2 * Tc);
    const int m = t >> 1;
    int lo, hi;
    float w_hi;
    if (t & 1) {
      lo = m;
      hi = min(m + 1, Tc - 1);
      w_hi = 0.25f;
    } else {
      lo = max(m - 1, 0);
      hi = m;
      w_hi = 0.75f;
    }
    const T* xb = x + b * Tc * S + s;
    if (lo == hi) {
      out[i] = xb[lo * S];
    } else {
      out[i] = from_f32<T>(to_f32(xb[lo * S]) * (1.f - w_hi) + to_f32(xb[hi * S]) * w_hi);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int Tc, long long S, cudaStream_t stream) {
  const long long total = (long long)B * 2 * Tc * S;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  t2_upsample_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), Tc, S, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" int csts_t2_upsample(int dtype, const void* x, void* out, int B, int Tc,
                                long long S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, out, B, Tc, S, s);
  if (dtype == kFloat32) return launch<float>(x, out, B, Tc, S, s);
  return cudaErrorInvalidValue;
}
