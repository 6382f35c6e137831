// B4: an encoder Q-pool (stage-transition) MViT block: the depthwise 3x3x3
// conv at stride (1,2,2), padding 1, over the fine pre-pool Q -> norm_q ->
// attention against the pooled K/V -> proj summed over heads + the max-pooled
// skip -> LN2 -> MLP (+proj) -> residual.
//
// Replaces csts_tpu/kernels/block.py:_pool_block_kernel (called from
// _fused_pool_impl; pallas_call at :1528). It serves v1, v3, a1 and a2 of the
// flagship. The body is shared with B3 and B5 (fused_block.cuh), which states
// the bound and the design. B4's own part is the Q conv: each coarse token
// reads its 3x3x3 window of fine Q rows (one fine row above and below each
// pair, +-1 frame) straight from the token-major fine Q, taps outside the
// grid skipped (zero padding), in fp32, then the per-head norm_q (eps 1e-5),
// rounded once into shared memory. The fine pooled Q never reaches device
// memory. The skip arrives pre-pooled, so MaxPool's -inf padding stays outside.
#include "fused_block.cuh"

using namespace csts::fb;

static int launch_bf16(const Shape& s, const Args& a, int B, cudaStream_t stream) {
  CSTS_FB_CASE(kPool, 2, 6, 6, 128)     // 192 -> 192 (v1)
  CSTS_FB_CASE(kPool, 2, 6, 12, 128)    // 192 -> 384 (a1)
  CSTS_FB_CASE(kPool, 2, 12, 12, 128)   // 384 -> 384 (v3), 384 -> 768 (a2, two column tiles)
  CSTS_FB_CASE(kPool, 2, 3, 6, 128)     // 96 -> 192
  return launch_widest<kPool, false>(s, a, B, stream);  // any other width (small_cfg's among them)
}

CSTS_FUSED_BLOCK_ENTRY(csts_fused_pool_block, kPool)
