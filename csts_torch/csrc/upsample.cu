// K3 and B9a: the x2 half-pixel linear skip interpolations of the decoder.
//
// K3 (csts_t2_upsample): x2 along T (the stride-(2,1,1) decoder skip,
// nn.Upsample(scale_factor=(2,1,1), mode='trilinear'), and the stem-skip
// T-resize at the head):
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
// The first design (one thread an output element over a grid-stride loop,
// scalar 2-byte loads and stores, a 64-bit division and remainder per
// element, each input plane read twice) ran at a quarter of that bound,
// paced by its instructions. The redesign is a sliding window over T: one
// thread owns one 16-byte piece of S = H·W·C of one clip and walks its
// planes m = 0 .. T-1 in order, holding x[m-1], x[m] and x[m+1] in
// registers, so each input piece is loaded once and each output piece
// (out[2m], out[2m+1]) stored once, with 16-byte accesses and no division
// in the loop (the grid's y is the clip). Neighbouring threads own
// neighbouring pieces, so every load and store of a warp is contiguous.
// Where S·sizeof(T) or a pointer is not a multiple of 16 bytes, the same
// body runs one element a thread. The products and the sum round on their
// own (as B9a's tap2, no fused multiply-add), as the plain version and the
// JAX kernel compute them, so the outputs agree bit for bit.
//
// B9a (csts_hw2_upsample): x2 along H, then x2 along W (the stride-(1,2,2)
// decoder skips of d2 and d3 when HW2_SKIP_KERNEL is set), each pass the
// same two-tap formula with the clamped edge taps, in fp32:
//   h[2y]   = 0.25·x[y-1] + 0.75·x[y],   h[2y+1] = 0.75·x[y] + 0.25·x[y+1]
// and the same along W over h. Replaces csts_tpu/kernels/upsample.py:
// _hw2_kernel (pallas_call at :160) with its rounding points: the H pass is
// rounded to x's dtype before the W pass reads it (:118, :124), and the W
// pass once more. The products and the sum round separately (no fused
// multiply-add), as the JAX kernel and the plain version compute them; the
// clamped edges are copies, as in K3 (the JAX kernel's 0.25·a + 0.75·a
// there is the same value in bf16, and within one rounding in fp32).
//
// Bound on the H100: pure data movement, read x once (B·T·H·W·C) and write
// the output once (4x that), at 3.35 TB/s; ~18 fp32 operations per input
// element. Design: one thread takes 16 bytes of channels of one coarse
// position and writes its 2x2 fine outputs with 16-byte stores; it reads the
// 3x3 coarse neighbourhood (16 bytes a tap) it needs for both passes, so no
// pass goes through memory and no thread waits on another. Neighbouring
// threads take neighbouring channels, then neighbouring columns, so every
// load and store of a warp is contiguous; the taps a neighbour also reads
// come from L1/L2. Channels that are no multiple of 16 bytes, or unaligned
// pointers, take the same body one element a thread. The TPU kernel's whole
// plane in VMEM, and its lane, plane and size limits, are not carried over.
#include "common.cuh"

using namespace csts;

namespace {

constexpr int kThreads = 256;

// VEC consecutive channels, moved as one piece (16 bytes when VEC·sizeof(T) is)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// 0.25·lo + 0.75·hi (even output) or 0.75·lo + 0.25·hi (odd), each product
// and the sum rounded on their own
__device__ __forceinline__ float tap2(float a, float b, float wa, float wb) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// K3: one thread a VEC-element piece p of S for clip blockIdx.y, walking
// the clip's T planes with the window (prev, cur, next) in registers
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    t2_upsample_kernel(const T* __restrict__ x, T* __restrict__ out, int Tc, long long S) {
  using P = Pack<T, VEC>;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p * VEC >= S) return;
  const P* src = reinterpret_cast<const P*>(x + (long long)blockIdx.y * Tc * S) + p;
  P* dst = reinterpret_cast<P*>(out + (long long)blockIdx.y * 2 * Tc * S) + p;
  const long long plane = S / VEC;  // pieces a plane
  P cur = src[0], prev = cur;
  for (int m = 0; m < Tc; ++m) {
    const P nxt = m + 1 < Tc ? src[(m + 1) * plane] : cur;
    P even, odd;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float c = to_f32(cur.v[e]);
      // the clamped edge planes are copies: out[0] = x[0], out[2T-1] = x[T-1]
      even.v[e] = m == 0 ? cur.v[e] : from_f32<T>(tap2(to_f32(prev.v[e]), c, 0.25f, 0.75f));
      odd.v[e] = m + 1 == Tc ? cur.v[e] : from_f32<T>(tap2(c, to_f32(nxt.v[e]), 0.75f, 0.25f));
    }
    dst[2 * m * plane] = even;
    dst[(2 * m + 1) * plane] = odd;
    prev = cur;
    cur = nxt;
  }
}

template <typename T, int VEC>
cudaError_t launch_t2(const void* x, void* out, int B, int Tc, long long S,
                      cudaStream_t stream) {
  const long long blocks = (S / VEC + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  t2_upsample_kernel<T, VEC><<<dim3(static_cast<unsigned>(blocks), B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), Tc, S);
  return cudaGetLastError();
}

// 16 bytes of S a thread where S and both pointers allow it, else one
// element a thread
template <typename T>
cudaError_t launch(const void* x, void* out, int B, int Tc, long long S, cudaStream_t stream) {
  if ((long long)B * Tc * S == 0) return cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = S % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return wide ? launch_t2<T, kVec>(x, out, B, Tc, S, stream)
              : launch_t2<T, 1>(x, out, B, Tc, S, stream);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    hw2_upsample_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C,
                        long long total) {
  using P = Pack<T, VEC>;
  const int CV = C / VEC;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const int c0 = static_cast<int>(i % CV) * VEC;
    long long p = i / CV;
    const int xx = static_cast<int>(p % W);
    p /= W;
    const int y = static_cast<int>(p % H);
    const long long bt = p / H;  // b·T + t
    const T* src = x + bt * H * W * C + c0;
    const int ys[3] = {max(y - 1, 0), y, min(y + 1, H - 1)};
    const int xs[3] = {max(xx - 1, 0), xx, min(xx + 1, W - 1)};
    // the 3x3 coarse taps, all loads issued before any use
    P raw[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        raw[r][j] = *reinterpret_cast<const P*>(src + ((long long)ys[r] * W + xs[j]) * C);
    // H pass at the three columns, rounded to T: h[0] fine row 2y, h[1] row
    // 2y+1; a clamped edge row copies its one tap
    const bool top = y == 0, bottom = y == H - 1, left = xx == 0, right = xx == W - 1;
    float h[2][3][VEC];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float up = to_f32(raw[0][j].v[e]), mid = to_f32(raw[1][j].v[e]),
                    dn = to_f32(raw[2][j].v[e]);
        h[0][j][e] = top ? mid : to_f32(from_f32<T>(tap2(up, mid, 0.25f, 0.75f)));
        h[1][j][e] = bottom ? mid : to_f32(from_f32<T>(tap2(mid, dn, 0.75f, 0.25f)));
      }
    // W pass and the 2x2 fine outputs of this coarse position
    T* dst = out + bt * 4 * H * W * C + c0;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      P o[2];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float mid = h[dy][1][e];
        o[0].v[e] = from_f32<T>(left ? mid : tap2(h[dy][0][e], mid, 0.25f, 0.75f));
        o[1].v[e] = from_f32<T>(right ? mid : tap2(mid, h[dy][2][e], 0.75f, 0.25f));
      }
      T* row = dst + ((long long)(2 * y + dy) * 2 * W + 2 * xx) * C;
      *reinterpret_cast<P*>(row) = o[0];
      *reinterpret_cast<P*>(row + C) = o[1];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_hw2(const void* x, void* out, int BT, int H, int W, int C,
                       cudaStream_t stream) {
  const long long total = (long long)BT * H * W * (C / VEC);
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  hw2_upsample_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, total);
  return cudaGetLastError();
}

// 16 bytes of channels a thread where the channels and both pointers allow
// it, else one channel a thread
template <typename T>
cudaError_t launch_hw2_any(const void* x, void* out, int BT, int H, int W, int C,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool wide = C % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return wide ? launch_hw2<T, kVec>(x, out, BT, H, W, C, stream)
              : launch_hw2<T, 1>(x, out, BT, H, W, C, stream);
}

}  // namespace

extern "C" int csts_t2_upsample(int dtype, const void* x, void* out, int B, int Tc,
                                long long S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch<__nv_bfloat16>(x, out, B, Tc, S, s);
  if (dtype == kFloat32) return launch<float>(x, out, B, Tc, S, s);
  return cudaErrorInvalidValue;
}

// x (B·T, H, W, C) -> out (B·T, 2H, 2W, C), both contiguous
extern "C" int csts_hw2_upsample(int dtype, const void* x, void* out, int BT, int H, int W,
                                 int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_hw2_any<__nv_bfloat16>(x, out, BT, H, W, C, s);
  if (dtype == kFloat32) return launch_hw2_any<float>(x, out, BT, H, W, C, s);
  return cudaErrorInvalidValue;
}
