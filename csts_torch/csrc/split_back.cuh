// The back of the split whole blocks B3 (block.cu) and B4 (pool_block.cu),
// four launches of K2's bodies (mlp_tail.cuh) behind the attention:
//  * res1 = av·Wprojᵀ + bproj + skip (fc2_body with an fp32 output: res1
//    is never rounded), a persistent wgmma GEMM;
//  * LN2 of res1's fp32 rows into xn2 (ln_body), rounded once, or, where
//    one proj output tile holds whole rows, in the proj GEMM's epilogue;
//  * G = GELU(xn2·W1ᵀ + b1) (fc1_body), fc1 once per row;
//  * out = G·W2ᵀ [+ xn2·Wpᵀ] + b2 + (bp where dim != dim_out, else res1)
//    (fc2_body), rounded once.
// The caller's .cu defines the __global__ kernels around the bodies (their
// names tell the profiler which block ran) and hands them over as a kernel
// set K: K::proj<BN, EPI>(), K::ln(), K::fc1(), K::fc2<PROJ, BN>(), and
// K::kNarrow (whether 96-column output tiles are compiled; B3's 96-wide
// blocks take them). Each GEMM's output tile width is K2's choice
// (pick_bn) of 192, 128 and, with kNarrow, 96 columns.
#pragma once

#include <type_traits>

#include "fused_block.cuh"
#include "mlp_tail.cuh"

namespace {
namespace back {

using csts::fb::Args;

// f(integral_constant<int, BN>) at the output tile width pick_bn chooses for
// N columns over M rows
template <class K, class F>
cudaError_t by_width(int M, int N, F f) {
  static const int wide[2] = {192, 128}, narrow[3] = {192, 128, 96};
  const int bn = K::kNarrow ? pick_bn(M, N, narrow) : pick_bn(M, N, wide);
  if (bn == 192) return f(std::integral_constant<int, 192>{});
  if constexpr (K::kNarrow) {
    if (bn == 96) return f(std::integral_constant<int, 96>{});
  }
  return f(std::integral_constant<int, 128>{});
}

// res1 = av·Wprojᵀ + bproj + skip, fp32 (g.x: the skip, bf16), into res1
// (EPI kOutF32); or LN2 of those rows into g.xn and res1 only where given
// (kLnOut, N ≤ BN)
template <class K, int BN, int EPI>
cudaError_t launch_proj(const bf16* av, const void* wproj, float* res1, const GemmArgs& g,
                        cudaStream_t stream) {
  using P = GemmPlan<128, BN, 64>;
  static bool attr = false;
  const auto kern = K::template proj<BN, EPI>();
  cudaError_t e = set_smem(kern, P::kSmem, attr);
  if (e != cudaSuccess) return e;
  CUtensorMap am, bm;
  if (!map2d(&am, av, g.M, g.K1, 128) || !map2d(&bm, wproj, g.N, g.K1, BN))
    return cudaErrorInvalidValue;
  const int tiles = (g.M + 127) / 128 * ((g.N + BN - 1) / BN);
  kern<<<grid_for(tiles), kGemmThreads, P::kSmem, stream>>>(am, bm, res1, g);
  return cudaGetLastError();
}

// out = G·W2ᵀ [+ xn2·Wpᵀ] + b2 + (bp, or res1 from g.x32)
template <class K, bool PROJ, int BN>
cudaError_t launch_fc2(const bf16* gbuf, const void* w2, const bf16* xn2, const void* wp,
                       void* out, const GemmArgs& g, cudaStream_t stream) {
  using P = GemmPlan<128, BN, 64>;
  static bool attr = false;
  const auto kern = K::template fc2<PROJ, BN>();
  cudaError_t e = set_smem(kern, P::kSmem, attr);
  if (e != cudaSuccess) return e;
  CUtensorMap a1, b1, a2, b2;
  if (!map2d(&a1, gbuf, g.M, g.K1, 128) || !map2d(&b1, w2, g.N, g.K1, BN))
    return cudaErrorInvalidValue;
  if (PROJ) {
    if (!map2d(&a2, xn2, g.M, g.K2, 128) || !map2d(&b2, wp, g.N, g.K2, BN))
      return cudaErrorInvalidValue;
  } else {
    a2 = a1;
    b2 = b1;
  }
  const int tiles = (g.M + 127) / 128 * ((g.N + BN - 1) / BN);
  kern<<<grid_for(tiles), kGemmThreads, P::kSmem, stream>>>(a1, b1, a2, b2,
                                                            static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

// The back over the M = B·L rows of av: the proj GEMM into res1 (fp32, the
// skip `skip` added), LN2 into xn2, fc1 + GELU into G, fc2 (+ the dim-change
// proj where PROJ) into a.out. Where one of the proj GEMM's output tiles
// holds whole rows (dim ≤ its width: 96 at v0 and a0, 192 at v2, v1 and a1),
// LN2 runs in its epilogue (kLnOut) and res1 reaches memory only as an
// identity block's fc2 base; elsewhere LN2 is a launch of its own over res1.
template <class K, bool PROJ>
cudaError_t launch_back(const Args& a, int B, const bf16* av, const void* skip, float* res1,
                        bf16* xn2, bf16* gbuf, cudaStream_t s) {
  const int M = B * a.L;
  GemmArgs gp{M, a.C, a.C, 0, static_cast<const bf16*>(a.bproj), nullptr,
              static_cast<const bf16*>(skip), nullptr, 1};
  gp.ln_w = static_cast<const bf16*>(a.ln2_w);
  gp.ln_b = static_cast<const bf16*>(a.ln2_b);
  gp.xn = xn2;
  gp.eps = csts::fb::kLnEps;
  bool ln_done = false;
  cudaError_t e = by_width<K>(M, a.C, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    if (a.C > BN) return launch_proj<K, BN, kOutF32>(av, a.wproj, res1, gp, s);
    ln_done = true;
    return launch_proj<K, BN, kLnOut>(av, a.wproj, PROJ ? nullptr : res1, gp, s);
  });
  if (e != cudaSuccess) return e;
  if (!ln_done) {
    const auto ln = K::ln();
    ln<<<ln_blocks(M, a.C), 256, 0, s>>>(res1, static_cast<const bf16*>(a.ln2_w),
                                         static_cast<const bf16*>(a.ln2_b), xn2, M, a.C,
                                         csts::fb::kLnEps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  {
    using P = GemmPlan<128, 64, 128>;
    static bool attr = false;
    const auto fc1 = K::fc1();
    if ((e = set_smem(fc1, P::kSmem, attr)) != cudaSuccess) return e;
    CUtensorMap am, bm;
    if (!map2d(&am, xn2, M, a.C, 128) || !map2d(&bm, a.w1, a.H, a.C, 64))
      return cudaErrorInvalidValue;
    const GemmArgs g1{M, a.H, a.C, 0, static_cast<const bf16*>(a.b1), nullptr, nullptr, nullptr,
                      1};
    const int tiles = (M + 127) / 128 * ((a.H + 63) / 64);
    fc1<<<grid_for(tiles), kGemmThreads, P::kSmem, s>>>(am, bm, gbuf, g1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const GemmArgs g2{M, a.Cout, a.H, PROJ ? a.C : 0, static_cast<const bf16*>(a.b2),
                    static_cast<const bf16*>(a.bp), nullptr, nullptr, 1, res1};
  return by_width<K>(M, a.Cout, [&](auto bn) {
    return launch_fc2<K, PROJ, decltype(bn)::value>(gbuf, a.w2, xn2, a.wp, a.out, g2, s);
  });
}

}  // namespace back
}  // namespace
