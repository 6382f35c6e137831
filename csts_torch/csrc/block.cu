// B3: a whole identity-skip MViT block, given K/V already pooled:
//   LN1 -> Wq -> attention per head -> proj + x -> LN2 -> MLP (+proj) -> residual.
//
// Replaces csts_tpu/kernels/block.py:_block_kernel (the "loop" variant,
// called from _fused_block_impl; pallas_call at :250). It serves the blocks
// with at most two heads and no Q pooling (v0, a0 and v2 of the flagship).
// The rounding points are the TPU kernel's: LN1 rounded before Wq, q
// rounded per head, the probabilities rounded (unnormalised, as K1) before
// P·V, av rounded before proj, res1 fp32 and never rounded, LN2 (two-pass
// fp32 statistics) rounded before its products, the hidden rounded before
// fc2, one rounding of the output.
//
// B9b and B9c: the same kernel also replaces block.py:_block_hg_kernel (the
// head-grid variant, pallas_call at :434) and block.py:_block_bd_kernel (the
// block-diagonal variant, pallas_call at :554), the JAX package's whole
// block at 3-8 heads, reached there only through fused_block(variant=...)
// and here through csts_torch/tools/ab_block.py (block_route keeps JAX's
// two-head cap). One Hopper kernel, not three, is the choice: the three TPU
// variants compute the same function, held to one bar in
// tests/test_fused_block.py. hg's algebra, res1 = x + Σ_h av_h·Wproj_h, is
// how the proj GEMM builds res1 (one product over all heads' av); bd's
// block-diagonal K/V only hands the TPU's 128-wide matrix unit one large
// product, while wgmma's 64-row tiles already have the shape of one head's
// products, so the off-diagonal zeros would only multiply the attention
// products by the head count.
//
// Bound on the H100: the products (Wq, attention over 256 keys, proj, fc1,
// fc2) do ~100-300 tensor-core operations per byte the block must move at
// every site, so the tensor cores bound it. The first design
// (fused_block.cuh's whole-block body: one 8-warp block an SM on mma.sync, a
// block-wide barrier on every weight tile) ran 13x its bound and lost to
// its own K1+K2 route (PERF.md). The redesign is B4's (pool_block.cu): the
// block split into launches of one C call, each a body the port already
// runs on wgmma:
//  * q = LN1(x)·Wqᵀ + bq (block_q_kernel: K2's fc2 body, a persistent wgmma
//    GEMM on a TMA ring, with a bias-only bf16 epilogue) into a scratch,
//    token-major (head h at columns h·hd), rounded once. LN1(x) is the
//    caller's xn, rounded once: the rows phase 1 normalised for the K/V
//    projection (csts_torch/models/mvit.py MultiScaleBlock.forward_block).
//    The TPU kernel computes LN1 again in its body; here that second pass
//    over x (an ln_body launch, 38 µs at v0 on an H100, PERF.md) cost more
//    than the block's margin over its K1+K2 route, and the value is the same
//    (two-pass fp32 statistics, one rounding);
//  * the attention (block_attn_kernel): K1's wgmma body over the pooled
//    keys, q from that scratch, av token-major into a second one;
//  * the back (split_back.cuh, shared with B4): res1 = av·Wprojᵀ + bproj + x
//    in fp32 (block_proj_kernel), LN2 of its fp32 rows into the second
//    scratch (in the proj GEMM's epilogue where one output tile holds whole
//    rows, dim ≤ 192: v0, a0, v2, so that res1 never reaches memory there;
//    else block_ln_kernel), G = GELU(xn2·W1ᵀ + b1) (block_fc1_kernel)
//    and out = G·W2ᵀ [+ xn2·Wpᵀ] + b2 + (bp or res1) (block_fc2_kernel).
// At width 96 (v0, a0) the GEMMs' reduction is one and a half 64-column
// stages, whose tail TMA fills with zeros; their output tiles may be 96
// columns wide (pick_bn). q, av, xn2 and G reach device memory once each (res1, fp32, only where the tile does not hold whole rows or the
// block's fc2 adds it back); the probabilities and the GEMMs' fp32 sums
// never do. Widths outside the split's instances keep the first design's body
// (fused_block.cuh), chosen before the launch; fp32 inputs take its exact
// body.
#include "split_back.cuh"
#include "split_block.cuh"

using csts::fb::Args;
using csts::fb::Shape;
using csts::fb::kBlock;
using csts::fb::kNoInstance;
using csts::fb::launch_widest;
using csts::fb::pick_shape;

namespace {

// LN2 of res1's fp32 rows (mlp_tail.cuh ln_body), where the proj GEMM's
// tile does not hold whole rows
__global__ void __launch_bounds__(256) block_ln_kernel(const float* __restrict__ x,
                                                       const bf16* __restrict__ w,
                                                       const bf16* __restrict__ b,
                                                       bf16* __restrict__ y, int M, int C,
                                                       float eps) {
  ln_body<float>(x, w, b, y, M, C, C, eps);
}

// q = LN1(x)·Wqᵀ + bq, rounded once (mlp_tail.cuh fc2_body, kBiasOnly)
template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    block_q_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, bf16* out, GemmArgs g) {
  fc2_body<false, false, BN, kBiasOnly>(amap, bmap, amap, bmap, out, g);
}

// attention per head against the pooled K/V: K1's wgmma body
template <int HD>
__global__ void __launch_bounds__(csts::attn::WgPlan<HD, 2>::kThreads, 1)
    block_attn_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, csts::attn::AttnArgs a) {
  csts::attn::attn_wg_body<HD, 2, false>(qmap, kmap, vmap, a);
}

// res1 = av·Wprojᵀ + bproj + x, fp32 (mlp_tail.cuh fc2_body, kOutF32), or
// with LN2 in the epilogue where a tile holds whole rows (kLnOut)
template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    block_proj_kernel(const __grid_constant__ CUtensorMap a1map,
                      const __grid_constant__ CUtensorMap b1map, float* out, GemmArgs g) {
  fc2_body<false, false, BN, EPI>(a1map, b1map, a1map, b1map, out, g);
}

// G = GELU(xn2·W1ᵀ + b1) (mlp_tail.cuh fc1_body)
template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    block_fc1_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap, bf16* gout, GemmArgs g) {
  fc1_body<false, BN>(amap, bmap, gout, nullptr, g);
}

// out = G·W2ᵀ + xn2·Wpᵀ + b2 + bp (PROJ), or G·W2ᵀ + b2 + res1 (mlp_tail.cuh fc2_body)
template <bool PROJ, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    block_fc2_kernel(const __grid_constant__ CUtensorMap a1map,
                     const __grid_constant__ CUtensorMap b1map,
                     const __grid_constant__ CUtensorMap a2map,
                     const __grid_constant__ CUtensorMap b2map, bf16* out, GemmArgs g) {
  fc2_body<false, PROJ, BN, PROJ ? kBaseBf16 : kBaseF32>(a1map, b1map, a2map, b2map, out, g);
}

// the back's kernels (split_back.cuh); 96-column output tiles for the
// 96-wide blocks (v0, a0)
struct BlockBack {
  static constexpr bool kNarrow = true;
  template <int BN, int EPI>
  static auto proj() { return block_proj_kernel<BN, EPI>; }
  static auto ln() { return block_ln_kernel; }
  static auto fc1() { return block_fc1_kernel<64>; }
  template <bool PROJ, int BN>
  static auto fc2() { return block_fc2_kernel<PROJ, BN>; }
};

// q = xn·Wqᵀ + bq over M rows (xn, q: M x C)
template <int BN>
cudaError_t launch_q(const bf16* xn, const void* wq, bf16* q, const GemmArgs& g,
                     cudaStream_t stream) {
  using P = GemmPlan<128, BN, 64>;
  static bool attr = false;
  cudaError_t e = set_smem(block_q_kernel<BN>, P::kSmem, attr);
  if (e != cudaSuccess) return e;
  CUtensorMap am, bm;
  if (!map2d(&am, xn, g.M, g.K1, 128) || !map2d(&bm, wq, g.N, g.K1, BN))
    return cudaErrorInvalidValue;
  const int tiles = (g.M + 127) / 128 * ((g.N + BN - 1) / BN);
  block_q_kernel<BN><<<grid_for(tiles), kGemmThreads, P::kSmem, stream>>>(am, bm, q, g);
  return cudaGetLastError();
}

// the first design's body (one launch): its instances and, for any other
// width, the widest instance of its row split
int launch_first_design(const Args& a, int B, cudaStream_t stream) {
  const Shape s = pick_shape(a);
  if (a.wp == nullptr && (s.nt != s.ntp || a.Cout != a.C)) return kNoInstance;
  CSTS_FB_CASE(kBlock, 2, 3, 6, 128)   // 96 -> 192, one head
  CSTS_FB_CASE(kBlock, 2, 3, 3, 128)   // 96 -> 96
  CSTS_FB_CASE(kBlock, 2, 6, 12, 128)  // 192 -> 384, two heads
  CSTS_FB_CASE(kBlock, 2, 6, 6, 128)   // 192 -> 192
  CSTS_FB_CASE(kBlock, 2, 12, 12, 128) // 384 -> 384 and 384 -> 768, four heads
  CSTS_FB_CASE(kBlock, 1, 12, 12, 128) // 768 -> 768, eight heads
  CSTS_FB_CASE(kBlock, 2, 6, 12, 256)  // head dim 192
  return launch_widest<kBlock, true>(s, a, B, stream);  // any other width (small_cfg's among them)
}

// The split's instances: head dim 96 at the flagship's sites (v0 and a0:
// 96 -> 192, one head; v2: 192 -> 384, two heads) and at ab_block's
// (96 and 192 identity, 384 at four heads, 384 -> 768, 768 at eight heads),
// the hidden a multiple of 128, the dim-change proj exactly where
// dim != dim_out. Mirrored by csts_torch/models/mvit.py _split_instance.
bool split_instance(const Args& a) {
  const bool pair = (a.C == 96 && (a.Cout == 96 || a.Cout == 192)) ||
                    (a.C == 192 && (a.Cout == 192 || a.Cout == 384)) ||
                    (a.C == 384 && (a.Cout == 384 || a.Cout == 768)) ||
                    (a.C == 768 && a.Cout == 768);
  return a.hd == 96 && pair && a.H % 128 == 0 && (a.wp != nullptr) == (a.Cout != a.C);
}

// The split where the widths have an instance, else the first design (which
// computes LN1 from x itself). xn: LN1(x), B·L x C (the q slot of Args).
// Scratch: qs (B·L x C: q, then xn2), av (B·L x C), res1 (B·L x C, fp32)
// and G (B·L x H).
int launch_bf16(const Args& a, int B, bf16* qs, bf16* av, float* res1, bf16* gbuf,
                cudaStream_t s) {
  if (!split_instance(a)) return launch_first_design(a, B, s);
  if (a.q == nullptr || qs == nullptr || av == nullptr || res1 == nullptr || gbuf == nullptr)
    return cudaErrorInvalidValue;
  const int M = B * a.L;
  const GemmArgs gq{M, a.C, a.C, 0, static_cast<const bf16*>(a.bq), nullptr, nullptr, nullptr, 1};
  cudaError_t e = back::by_width<BlockBack>(M, a.C, [&](auto bn) {
    return launch_q<decltype(bn)::value>(static_cast<const bf16*>(a.q), a.wq, qs, gq, s);
  });
  if (e != cudaSuccess) return e;
  static bool attn_set = false;
  e = csts::split::launch_attention<96>(block_attn_kernel<96>, attn_set, a, B, qs, a.L, av, s);
  if (e != cudaSuccess) return e;
  return a.wp != nullptr ? back::launch_back<BlockBack, true>(a, B, av, a.x, res1, qs, gbuf, s)
                         : back::launch_back<BlockBack, false>(a, B, av, a.x, res1, qs, gbuf, s);
}

}  // namespace

// The shared whole-block signature (fused_block.cuh; its q is LN1(x), the
// caller's, read by the split only) plus the split's four scratch buffers:
// qs (B x (L + 64) x C; q, then xn2), av (B·L x C) and G (B·L x H), in the
// activation dtype, and res1 (B·L x C fp32), all unused (and null) in the
// fp32 body and the first design.
extern "C" int csts_fused_block(
    int dtype, const void* x, const void* q, const void* skip, const void* k, const void* v,
    const void* ln1_w, const void* ln1_b, const void* wq, const void* bq, const void* wconv,
    const void* nq_w, const void* nq_b, const void* wproj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wp, const void* bp, void* out, void* qs, void* av, void* res1, void* gbuf,
    long long q_rs, int B, int L, int C, int Cout, int H, int N, int hd, int Lk, int T, int Hh,
    int W, int Ts, int Hs, int Ws, int st, int sh, int sw, float scale, void* stream) {
  Args a{x,    q,     skip, k,  v,  ln1_w, ln1_b, wq, bq, wconv, nq_w, nq_b, wproj, bproj,
         ln2_w, ln2_b, w1,  b1, w2, b2,    wp,    bp, out, q_rs, L,   C,    Cout,  H,
         N,    hd,    Lk,   T,  Hh, W,     Ts,    Hs, Ws,  st,   sh,  sw,   scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csts::kFloat32) return csts::fb::launch_f32<kBlock>(a, B, s);
  if (dtype != csts::kBFloat16) return cudaErrorInvalidValue;
  return launch_bf16(a, B, static_cast<bf16*>(qs), static_cast<bf16*>(av),
                     static_cast<float*>(res1), static_cast<bf16*>(gbuf), s);
}
