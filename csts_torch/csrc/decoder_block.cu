// B5: an upsample-Q decoder block: the depthwise transposed 3x3x3 conv
// (padding 1, stride (1,2,2) or (2,1,1), output_padding stride-1) over the
// coarse post-Wq Q -> norm_q -> attention against the pooled K/V -> proj over
// heads + the trilinear skip -> LN2 -> MLP (+proj) -> residual.
//
// Replaces csts_tpu/kernels/block.py:_decoder_kernel (called from
// _fused_decoder_impl; pallas_call at :1222). It serves d2, d3 and d4 (the
// JAX package's decoder blocks 1-3; block 0's 768->768 weights stay on K1+K2).
// The body is shared with B3 and B4 (fused_block.cuh), which states the bound
// and the design. B5's own part is the Q upsample as sub-pixel phases: each
// fine token takes only the taps of its parity from the coarse Q (at stride
// 2, fine 2m takes tap 1 of coarse m, fine 2m+1 taps 0 of m+1 and 2 of m), in
// fp32, then norm_q (eps 1e-5), rounded once into shared memory, so fine Q
// never reaches device memory. The weight is torch's ConvTranspose3d layout,
// reordered tap-major by the wrapper; taps are used as torch numbers them.
// At d2 (dim 768, head dim 192) the block takes 32 tokens so that res1 and
// four heads' worth of Q and av fit in shared memory.
#include "fused_block.cuh"

using namespace csts::fb;

static int launch_bf16(const Shape& s, const Args& a, int B, cudaStream_t stream) {
  CSTS_FB_CASE(kDecoder, 1, 12, 6, 256)   // 768 -> 384, head dim 192 (d2)
  CSTS_FB_CASE(kDecoder, 2, 12, 6, 128)   // 384 -> 192 (d3)
  CSTS_FB_CASE(kDecoder, 2, 6, 3, 128)    // 192 -> 96 (d4)
  CSTS_FB_CASE(kDecoder, 1, 12, 6, 128)
  return kNoInstance;
}

CSTS_FUSED_BLOCK_ENTRY(csts_fused_decoder_block, kDecoder)
