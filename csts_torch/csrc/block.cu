// B3: a whole identity-skip MViT block, given K/V already pooled:
//   LN1 -> Wq -> attention per head -> proj + x -> LN2 -> MLP (+proj) -> residual.
//
// Replaces csts_tpu/kernels/block.py:_block_kernel (the "loop" variant,
// called from _fused_block_impl; pallas_call at :250). It serves the blocks
// with at most two heads and no Q pooling (v0, a0 and v2 of the flagship).
// The body is shared with B4 and B5 (fused_block.cuh), which states the
// bound and the design; here only LN1 and the Q projection are B3's own:
// LN1(x) goes into shared memory, Q = LN1(x)·Wq + bq is one streamed product
// whose result is rounded per head into shared memory, and x itself is the
// residual skip.
//
// B9b and B9c: the same kernel also replaces block.py:_block_hg_kernel (the
// head-grid variant, pallas_call at :434) and block.py:_block_bd_kernel (the
// block-diagonal variant, pallas_call at :554), the JAX package's whole
// block at 3-8 heads, reached there only through fused_block(variant=...)
// and here through csts_torch/tools/ab_block.py (block_route keeps JAX's
// two-head cap). One Hopper kernel, not three, is the choice: the three TPU
// variants compute the same function, held to one bar in
// tests/test_fused_block.py. hg's algebra, res1 = x + Σ_h av_h·Wproj_h, is
// already how the shared body builds res1 (the proj product runs over all
// heads' av at once), with all 8 warps on one head at a time whatever the
// head count; bd's block-diagonal K/V only hands the TPU's 128-wide matrix
// unit one large product, while an m16n8k16 tile already has the shape of
// one head's product, so the off-diagonal zeros would only multiply the
// attention products by the head count. The d768 / 8-head instance (WR 1,
// as B5's d2) takes 230,912 of the 232,448 bytes of shared memory a block
// may have. At v15's L 256 and batch 8 its grid is B·L/32 = 64 blocks on
// 132 SMs.
#include "fused_block.cuh"

using namespace csts::fb;

static int launch_bf16(const Shape& s, const Args& a, int B, cudaStream_t stream) {
  CSTS_FB_CASE(kBlock, 2, 3, 6, 128)   // 96 -> 192, one head (v0, a0)
  CSTS_FB_CASE(kBlock, 2, 3, 3, 128)   // 96 -> 96
  CSTS_FB_CASE(kBlock, 2, 6, 12, 128)  // 192 -> 384, two heads (v2)
  CSTS_FB_CASE(kBlock, 2, 6, 6, 128)   // 192 -> 192
  CSTS_FB_CASE(kBlock, 2, 12, 12, 128) // 384 -> 384 and 384 -> 768, four heads (B9b/c)
  CSTS_FB_CASE(kBlock, 1, 12, 12, 128) // 768 -> 768, eight heads (B9b/c)
  CSTS_FB_CASE(kBlock, 2, 6, 12, 256)  // head dim 192
  return launch_widest<kBlock, true>(s, a, B, stream);  // any other width (small_cfg's among them)
}

CSTS_FUSED_BLOCK_ENTRY(csts_fused_block, kBlock)
