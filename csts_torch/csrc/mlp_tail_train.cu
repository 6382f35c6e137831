// B7: the training MLP tail's forward,
//   out = base + dp[sample] · fc2(GELU(fc1(LN2(x)))),  hid = fc1(LN2(x)) stored,
// base = proj(LN2(x)) if dim != dim_out else x.
//
// Replaces csts_tpu/kernels/block.py:_mlp_tail_train_kernel (pallas_call in
// _mlp_tail_train_impl). The body, its bound and its design are K2's, in
// mlp_tail.cuh; this is its TRAIN = true instance. dp is fp32 per sample
// (stochastic depth's bernoulli(keep)/keep, or ones); hid is written in x's
// dtype for the hand-written backward in csts_torch/kernels/block.py; xn2
// and gbuf are K2's scratch (mlp_tail.cu).
#include "mlp_tail.cuh"

extern "C" int csts_mlp_tail_train(int dtype, const void* x, const void* ln_w, const void* ln_b,
                                   const void* w1, const void* b1, const void* w2, const void* b2,
                                   const void* wp, const void* bp, const void* dp, void* out,
                                   void* hid, void* xn2, void* gbuf, int M, int L, int C, int H,
                                   int Cout, float eps, void* stream) {
  if (L < 1 || M % L) return cudaErrorInvalidValue;
  TailArgs a{x, ln_w, ln_b, w1, b1, w2, b2, wp, bp, out, static_cast<const float*>(dp), hid,
             M, C, H, Cout, 0, L, eps};
  return launch_tail<true>(a, dtype, xn2, gbuf, static_cast<cudaStream_t>(stream));
}
