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
#include "fused_block.cuh"

using namespace csts::fb;

static int launch_bf16(const Shape& s, const Args& a, int B, cudaStream_t stream) {
  CSTS_FB_CASE(kBlock, 2, 3, 6, 128)   // 96 -> 192, one head (v0, a0)
  CSTS_FB_CASE(kBlock, 2, 6, 12, 128)  // 192 -> 384, two heads (v2)
  CSTS_FB_CASE(kBlock, 2, 6, 6, 128)   // 192 -> 192
  CSTS_FB_CASE(kBlock, 2, 12, 12, 128)
  CSTS_FB_CASE(kBlock, 2, 6, 12, 256)  // head dim 192
  return kNoInstance;
}

CSTS_FUSED_BLOCK_ENTRY(csts_fused_block, kBlock)
