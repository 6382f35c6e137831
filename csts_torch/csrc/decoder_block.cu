// B5: an upsample-Q decoder block: the depthwise transposed 3x3x3 conv
// (padding 1, stride (1,2,2) or (2,1,1), output_padding stride-1) over the
// coarse post-Wq Q -> norm_q -> attention against the pooled K/V -> proj over
// heads + the trilinear skip -> LN2 -> MLP (+proj) -> residual.
//
// Replaces csts_tpu/kernels/block.py:_decoder_kernel (called from
// _fused_decoder_impl; pallas_call at :1222). It serves d2, d3 and d4 (the
// JAX package's decoder blocks 1-3; block 0's 768->768 weights stay on K1+K2).
// The rounding points are the TPU kernel's (fused_block.cuh:12-18): q rounded
// per head after the conv and norm_q (both fp32), the probabilities rounded
// unnormalised before P·V, av rounded before proj, res1 fp32 and never
// rounded, LN2 (two-pass fp32 statistics) rounded before its products, the
// hidden rounded before fc2, one rounding of the output.
//
// Bound on the H100: 90-300 tensor-core operations per byte at every site,
// so the products bound it; proj, fc1, fc2 and the dim-change proj are ~95%
// of them (Lk is 64 at all three sites). The first design
// (fused_block.cuh's whole-block body, one 8-warp block an SM, mma.sync fed
// through two weight buffers with a block-wide barrier per tile, 32 tokens
// a block at d2) reached 46-72 TFLOP/s, and clock stamps in its phases
// (csts_torch/tools/b5_phases.py) gave the Q conv 17-38% of its time, the
// attention 12-15%, proj 10-14%, LN2 2-5% and the MLP tail 32-54%. This
// redesign is three launches of one C call (their bodies in split_block.cuh,
// which B4 has shared since its own redesign):
//
//  * the Q conv (decoder_conv_kernel): fused_block.cuh's conv_q, unchanged
//    (sub-pixel phases of the transposed conv in fp32, norm_q), on 16-64
//    fine tokens a block, three blocks an SM, into a bf16 scratch: the
//    first design ran it at one 8-warp block an SM, where its gathers
//    waited on L2.
//  * the attention (decoder_attn_kernel): K1's wgmma body (attention_wg.cuh)
//    with q from that scratch, av token-major into a second one.
//  * the back (decoder_tail_kernel): a persistent grid, one block an SM,
//    walking row tiles of 64 (d2, d3) or 128 (d4) tokens: res1 = skip +
//    av·Wprojᵀ + bproj in fp32 into an fp32 scratch that the block reads
//    back at once (from L2), LN2 from it, then fc1 -> GELU -> fc2 plus the
//    dim-change proj. Products on wgmma (m64nNk16, A and B from shared
//    memory, fp32 accumulators in registers). A producer warp streams every
//    weight tile (64 columns of the reduction, up to 192 rows) through a
//    TMA ring of 4-8 stages with full/empty mbarriers, and loads the next
//    row tile's av as soon as the current one's last fc1 has read LN2's
//    output; the consumer warpgroups wait only on the tile they need, so
//    one row tile's epilogue overlaps the next tile's loads. At d2 each
//    weight tile serves 64 rows, twice the first design's 32; at d4 128.
//    res1 goes to global memory because 64 rows x 768 fp32 (192 KB) beside
//    av/LN2 (96 KB) exceed shared memory. At d2 and d3 the two warpgroups
//    share the 64 rows and split the columns (each hidden chunk exchanged
//    through shared memory); at d4 each owns 64 of 128 rows and they wait
//    only for themselves between phases. The accumulators are sized to the
//    168 registers ptxas gives a 288-thread block (96 columns a warpgroup,
//    d2 in two output passes, fc1 recomputed in each): wider ones spilled
//    and ptxas serialised the wgmma; setmaxnreg did not lift the limit.
// The fine Q, the probabilities, the hidden and LN2 never reach device
// memory; q, av and res1 do, once each (~0.03-0.06 ms of HBM time a site).
// Widths outside these instances (other (C, Cout) pairs, head dims other than
// 96 and 192, no dim-change proj) keep the first design's body: its
// instances, and its widest instance of each row split for any other width.
#include "split_block.cuh"

using namespace csts;
using namespace csts::fb;
using namespace csts::split;

namespace {

// the Q conv: the transposed conv's sub-pixel phases (split_block.cuh conv_body)
__global__ void __launch_bounds__(kThreads, 3) decoder_conv_kernel(Args a, bf16* q, int lpad) {
  conv_body<kDecoder>(a, q, lpad);
}

// attention per head against the pooled K/V: K1's wgmma body
// (attention_wg.cuh), q from the conv's scratch, av token-major into its own
template <int HD>
__global__ void __launch_bounds__(csts::attn::WgPlan<HD, 2>::kThreads, 1)
    decoder_attn_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, csts::attn::AttnArgs a) {
  csts::attn::attn_wg_body<HD, 2, false>(qmap, kmap, vmap, a);
}

// the back: res1, LN2 and the MLP tail with the dim-change proj
template <int C, int COUT, int MS, int NCW, int TCW, int HCW, int ST>
__global__ void __launch_bounds__(288, 1)
    decoder_tail_kernel(const __grid_constant__ CUtensorMap avmap,
                        const __grid_constant__ CUtensorMap wprojmap,
                        const __grid_constant__ CUtensorMap wpmap,
                        const __grid_constant__ CUtensorMap w1map,
                        const __grid_constant__ CUtensorMap w2map, TailArgs t) {
  tail_body<C, COUT, MS, NCW, TCW, HCW, ST>(avmap, wprojmap, wpmap, w1map, w2map, t);
}

template <int C, int COUT, int MS, int NCW, int TCW, int HCW, int ST>
cudaError_t launch_back(const Args& a, int B, const bf16* av, float* res1, cudaStream_t s) {
  static bool attr_set = false;  // once per instance
  return launch_tail<C, COUT, MS, NCW, TCW, HCW, ST>(
      decoder_tail_kernel<C, COUT, MS, NCW, TCW, HCW, ST>, attr_set, a, B, av, res1, s);
}

// Widths the redesign has no instance for take the first design's body
// (fused_block.cuh's block_mma_kernel, one launch), with the instances it
// had and, for any other width, the widest instance of its row split.
int launch_first_design(const Args& a, int B, cudaStream_t stream) {
  const Shape s = pick_shape(a);
  if (a.wp == nullptr && (s.nt != s.ntp || a.Cout != a.C)) return kNoInstance;
  CSTS_FB_CASE(kDecoder, 1, 12, 6, 256)   // 768 -> 384, head dim 192
  CSTS_FB_CASE(kDecoder, 2, 12, 6, 128)   // 384 -> 192
  CSTS_FB_CASE(kDecoder, 2, 6, 3, 128)    // 192 -> 96
  CSTS_FB_CASE(kDecoder, 1, 12, 6, 128)   // 768 -> 384, head dim up to 128
  return launch_widest<kDecoder, true>(s, a, B, stream);  // any other width (small_cfg's among them)
}

// Three launches: the Q conv, the attention (head dims 96 and 192: d3, d4
// and d2), the back (its instances: (C, Cout) of d2, d3 and d4, H a multiple
// of the hidden chunk); any other widths go to the first design.
int launch_bf16(const Args& a, int B, bf16* qf, bf16* av, float* res1, cudaStream_t s) {
  const bool d2 = a.C == 768 && a.Cout == 384, d3 = a.C == 384 && a.Cout == 192,
             d4 = a.C == 192 && a.Cout == 96;
  if (a.wp == nullptr || (a.hd != 96 && a.hd != 192) || !(d2 || d3 || d4) ||
      a.H % (d4 ? 64 : 128))
    return launch_first_design(a, B, s);
  if (qf == nullptr || av == nullptr || res1 == nullptr) return cudaErrorInvalidValue;
  static size_t conv_attr = 0;
  static bool set96 = false, set192 = false;
  cudaError_t e = a.hd == 96 ? launch_front<96>(decoder_conv_kernel, conv_attr,
                                                decoder_attn_kernel<96>, set96, a, B, qf, av, s)
                             : launch_front<192>(decoder_conv_kernel, conv_attr,
                                                 decoder_attn_kernel<192>, set192, a, B, qf, av, s);
  if (e != cudaSuccess) return e;
  // d2: 64 rows, two output passes; d3: 64 rows, one pass; d4: 128 rows
  if (d2) return launch_back<768, 384, 0, 96, 96, 64, 4>(a, B, av, res1, s);
  if (d3) return launch_back<384, 192, 0, 96, 96, 64, 6>(a, B, av, res1, s);
  return launch_back<192, 96, 1, 96, 96, 64, 8>(a, B, av, res1, s);
}

}  // namespace

// The shared whole-block signature (fused_block.cuh) plus B5's three scratch
// buffers: the fine q (B x (L + 64) x C) and av (B·L x C), both in the
// activation dtype, and res1 (B·L x C fp32), all unused (and null) in the
// fp32 body and the first design.
extern "C" int csts_fused_decoder_block(
    int dtype, const void* x, const void* q, const void* skip, const void* k, const void* v,
    const void* ln1_w, const void* ln1_b, const void* wq, const void* bq, const void* wconv,
    const void* nq_w, const void* nq_b, const void* wproj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wp, const void* bp, void* out, void* qf, void* av, void* res1, long long q_rs,
    int B, int L,
    int C, int Cout, int H, int N, int hd, int Lk, int T, int Hh, int W, int Ts, int Hs, int Ws,
    int st, int sh, int sw, float scale, void* stream) {
  Args a{x,    q,     skip, k,  v,  ln1_w, ln1_b, wq, bq, wconv, nq_w, nq_b, wproj, bproj,
         ln2_w, ln2_b, w1,  b1, w2, b2,    wp,    bp, out, q_rs, L,   C,    Cout,  H,
         N,    hd,    Lk,   T,  Hh, W,     Ts,    Hs, Ws,  st,   sh,  sw,   scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csts::kFloat32) return launch_f32<kDecoder>(a, B, s);
  if (dtype != csts::kBFloat16) return cudaErrorInvalidValue;
  return launch_bf16(a, B, static_cast<bf16*>(qf), static_cast<bf16*>(av),
                     static_cast<float*>(res1), s);
}
