// K2: the second half of an MViT block at eval,
//   out = base + fc2(GELU(fc1(LN2(x)))),  base = proj(LN2(x)) if dim != dim_out else x.
//
// Replaces csts_tpu/kernels/block.py:_mlp_tail_kernel. The body, its bound
// and its design are in mlp_tail.cuh, which B7 (mlp_tail_train.cu) shares;
// this is its TRAIN = false instance. xn2 (M x C) and gbuf (M x H), in the
// activation dtype, are the bf16 body's scratch (LN2's rows and GELU of the
// hidden); the fp32 body reads neither.
#include "mlp_tail.cuh"

extern "C" int csts_mlp_tail(int dtype, const void* x, const void* ln_w, const void* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* wp, const void* bp, void* out, void* xn2, void* gbuf,
                             int M, int C, int H, int Cout, int c_ln, float eps, void* stream) {
  TailArgs a{x, ln_w, ln_b, w1, b1, w2, b2, wp, bp, out, nullptr, nullptr,
             M, C, H, Cout, 0, 1, eps, c_ln};
  return launch_tail<false>(a, dtype, xn2, gbuf, static_cast<cudaStream_t>(stream));
}
