// B4: an encoder Q-pool (stage-transition) MViT block: the depthwise 3x3x3
// conv at stride (1,2,2), padding 1, over the fine pre-pool Q -> norm_q ->
// attention against the pooled K/V -> proj summed over heads + the max-pooled
// skip -> LN2 -> MLP (+proj) -> residual.
//
// Replaces csts_tpu/kernels/block.py:_pool_block_kernel (called from
// _fused_pool_impl; pallas_call at :1528). It serves v1 (192 -> 192), a1
// (192 -> 384), v3 (384 -> 384) and a2 (384 -> 768) of the flagship, all at
// head dim 96 and Lk 1024, on 4096 (v1, a1) or 1024 (v3, a2) coarse tokens a
// clip. The rounding points are the TPU kernel's: q rounded per head after
// the conv and norm_q (both fp32), the probabilities rounded unnormalised
// before P·V, av rounded before proj, res1 fp32 and never rounded, LN2
// (two-pass fp32 statistics) rounded before its products, the hidden rounded
// before fc2, one rounding of the output.
//
// Bound on the H100: ~100-300 tensor-core operations per byte at every site
// (attention over 1024 keys, proj, fc1, fc2), so the products bound it. The
// first design (fused_block.cuh's whole-block body: one 8-warp block an SM
// on mma.sync, a block-wide barrier on every weight tile, the strided Q
// conv's gathers inside the same block) ran 12x its bound and lost to its
// own K1+K2 route. The redesign splits the block into launches of one C
// call, each a body the port already has:
//  * the Q conv (pool_conv_kernel): split_block.cuh's conv_body, conv_q in
//    its stride-(1,2,2) form over the fine Q (taps outside the grid
//    skipped: zero padding), fp32, then norm_q (eps 1e-5), on 32-64 coarse
//    tokens a block, three blocks an SM, into a bf16 scratch q;
//  * the attention (pool_attn_kernel): K1's wgmma body over the 1024 pooled
//    keys, q from that scratch, av token-major into a second one;
//  * the back, K2's split tail (mlp_tail.cuh) behind a proj GEMM, launched
//    by split_back.cuh (which B3 shares):
//    res1 = av·Wprojᵀ + bproj + skip (pool_proj_kernel, fc2's body with an
//    fp32 output: res1 is never rounded), LN2 of the fp32 rows into xn2
//    (in the proj GEMM's epilogue at v1 and a1, where a 192-wide output tile
//    holds whole rows; pool_ln_kernel at v3 and a2), G = GELU(xn2·W1ᵀ + b1)
//    (pool_fc1_kernel),
//    out = G·W2ᵀ [+ xn2·Wpᵀ] + b2 + (bp at a1/a2, res1 at v1/v3)
//    (pool_fc2_kernel). Each GEMM is persistent on wgmma with a producer
//    warp feeding a TMA ring, and fc1 runs once per row.
//    The alternative, B5's persistent back (split_block.cuh tail_body:
//    res1, LN2 and the MLP in one kernel on a weight ring, fc1 recomputed for
//    every 192 output columns), measured 1.477 ms device over the four
//    sites at batch 8 against this split's 1.231 on an H100 (PERF.md,
//    csts_torch/tools/ab_kernels.py): its fc1 recompute at a1, v3 and a2
//    cost more than the split's extra round trips of res1, xn2 and G (at
//    v1, one output pass, it was 0.05 ms faster).
// The fine Q, the probabilities and the hidden's fp32 sums never reach
// device memory; q, av, res1 (fp32; not at a1, whose fc2 base is bp), xn2
// and G do, once each. The skip
// arrives pre-pooled, so MaxPool's -inf padding stays outside. Widths
// outside these instances keep the first design's body (fused_block.cuh),
// chosen before the launch.
#include "split_back.cuh"
#include "split_block.cuh"

using csts::fb::Args;
using csts::fb::Shape;
using csts::fb::kNoInstance;
using csts::fb::kPool;
using csts::fb::launch_widest;
using csts::fb::pick_shape;
using csts::split::conv_body;
using csts::split::launch_front;

namespace {

// the Q conv at stride (1,2,2) (split_block.cuh conv_body)
__global__ void __launch_bounds__(csts::fb::kThreads, 3) pool_conv_kernel(Args a, bf16* q,
                                                                          int lpad) {
  conv_body<kPool>(a, q, lpad);
}

// attention per head against the pooled K/V: K1's wgmma body
template <int HD>
__global__ void __launch_bounds__(csts::attn::WgPlan<HD, 2>::kThreads, 1)
    pool_attn_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, csts::attn::AttnArgs a) {
  csts::attn::attn_wg_body<HD, 2, false>(qmap, kmap, vmap, a);
}

// res1 = av·Wprojᵀ + bproj + skip, fp32 (mlp_tail.cuh fc2_body, kOutF32), or
// with LN2 in the epilogue where a tile holds whole rows (kLnOut: v1, a1)
template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    pool_proj_kernel(const __grid_constant__ CUtensorMap a1map,
                     const __grid_constant__ CUtensorMap b1map, float* out, GemmArgs g) {
  fc2_body<false, false, BN, EPI>(a1map, b1map, a1map, b1map, out, g);
}

// LN2 of res1's fp32 rows into xn2 (mlp_tail.cuh ln_body)
__global__ void __launch_bounds__(256) pool_ln_kernel(const float* __restrict__ x,
                                                      const bf16* __restrict__ w,
                                                      const bf16* __restrict__ b,
                                                      bf16* __restrict__ y, int M, int C,
                                                      float eps) {
  ln_body<float>(x, w, b, y, M, C, C, eps);
}

// G = GELU(xn2·W1ᵀ + b1) (mlp_tail.cuh fc1_body)
template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    pool_fc1_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap, bf16* gout, GemmArgs g) {
  fc1_body<false, BN>(amap, bmap, gout, nullptr, g);
}

// out = G·W2ᵀ + xn2·Wpᵀ + b2 + bp (PROJ), or G·W2ᵀ + b2 + res1 (mlp_tail.cuh fc2_body)
template <bool PROJ, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    pool_fc2_kernel(const __grid_constant__ CUtensorMap a1map,
                    const __grid_constant__ CUtensorMap b1map,
                    const __grid_constant__ CUtensorMap a2map,
                    const __grid_constant__ CUtensorMap b2map, bf16* out, GemmArgs g) {
  fc2_body<false, PROJ, BN, PROJ ? kBaseBf16 : kBaseF32>(a1map, b1map, a2map, b2map, out, g);
}

// the back's kernels (split_back.cuh); output tiles of 192 or 128 columns,
// the widths that fill the card at these sites' 8192-32768 rows
struct PoolBack {
  static constexpr bool kNarrow = false;
  template <int BN, int EPI>
  static auto proj() { return pool_proj_kernel<BN, EPI>; }
  static auto ln() { return pool_ln_kernel; }
  static auto fc1() { return pool_fc1_kernel<64>; }
  template <bool PROJ, int BN>
  static auto fc2() { return pool_fc2_kernel<PROJ, BN>; }
};

// the first design's body (one launch): its instances and, for any other
// width, the widest instance of its row split
int launch_first_design(const Args& a, int B, cudaStream_t stream) {
  const Shape s = pick_shape(a);
  if (a.wp == nullptr && (s.nt != s.ntp || a.Cout != a.C)) return kNoInstance;
  CSTS_FB_CASE(kPool, 2, 6, 6, 128)     // 192 -> 192
  CSTS_FB_CASE(kPool, 2, 6, 12, 128)    // 192 -> 384
  CSTS_FB_CASE(kPool, 2, 12, 12, 128)   // 384 -> 384, 384 -> 768
  CSTS_FB_CASE(kPool, 2, 3, 6, 128)     // 96 -> 192
  return launch_widest<kPool, false>(s, a, B, stream);  // any other width (small_cfg's among them)
}

// The split where the widths have an instance (the flagship's four (C, Cout)
// pairs at head dim 96, the hidden a multiple of 128), else the first
// design. The conv's scratch q takes xn2 once the attention has read it.
int launch_bf16(const Args& a, int B, bf16* qf, bf16* av, float* res1, bf16* gbuf,
                cudaStream_t s) {
  const bool v1 = a.C == 192 && a.Cout == 192, a1 = a.C == 192 && a.Cout == 384,
             v3 = a.C == 384 && a.Cout == 384, a2 = a.C == 384 && a.Cout == 768;
  if (a.hd != 96 || !(v1 || a1 || v3 || a2) || a.H % 128 || (a.wp != nullptr) != (a1 || a2))
    return launch_first_design(a, B, s);
  if (qf == nullptr || av == nullptr || res1 == nullptr || gbuf == nullptr)
    return cudaErrorInvalidValue;
  static size_t conv_attr = 0;
  static bool attn_set = false;
  cudaError_t e = launch_front<96>(pool_conv_kernel, conv_attr, pool_attn_kernel<96>, attn_set,
                                   a, B, qf, av, s);
  if (e != cudaSuccess) return e;
  return a1 || a2 ? back::launch_back<PoolBack, true>(a, B, av, a.skip, res1, qf, gbuf, s)
                  : back::launch_back<PoolBack, false>(a, B, av, a.skip, res1, qf, gbuf, s);
}

}  // namespace

// The shared whole-block signature (fused_block.cuh) plus the split's four
// scratch buffers: q (B x (L + 64) x C; the attention's q, then xn2), av
// (B·L x C) and G (B·L x H), in the activation dtype, and res1 (B·L x C
// fp32), all unused (and null) in the fp32 body and the first design.
extern "C" int csts_fused_pool_block(
    int dtype, const void* x, const void* q, const void* skip, const void* k, const void* v,
    const void* ln1_w, const void* ln1_b, const void* wq, const void* bq, const void* wconv,
    const void* nq_w, const void* nq_b, const void* wproj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wp, const void* bp, void* out, void* qf, void* av, void* res1, void* gbuf,
    long long q_rs, int B, int L, int C, int Cout, int H, int N, int hd, int Lk, int T, int Hh,
    int W, int Ts, int Hs, int Ws, int st, int sh, int sw, float scale, void* stream) {
  Args a{x,    q,     skip, k,  v,  ln1_w, ln1_b, wq, bq, wconv, nq_w, nq_b, wproj, bproj,
         ln2_w, ln2_b, w1,  b1, w2, b2,    wp,    bp, out, q_rs, L,   C,    Cout,  H,
         N,    hd,    Lk,   T,  Hh, W,     Ts,    Hs, Ws,  st,   sh,  sw,   scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csts::kFloat32) return csts::fb::launch_f32<kPool>(a, B, s);
  if (dtype != csts::kBFloat16) return cudaErrorInvalidValue;
  return launch_bf16(a, B, static_cast<bf16*>(qf), static_cast<bf16*>(av),
                     static_cast<float*>(res1), static_cast<bf16*>(gbuf), s);
}
