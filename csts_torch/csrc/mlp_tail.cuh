// The MLP tail of an MViT block, shared by K2 (mlp_tail.cu, serving) and B7
// (mlp_tail_train.cu, training) through the compile-time flag TRAIN:
//   K2:  out = base + fc2(GELU(fc1(LN2(x))))
//   B7:  out = base + dp[sample] · fc2(GELU(fc1(LN2(x)))), and hid = fc1(LN2(x)) stored
// with base = proj(LN2(x)) if dim != dim_out else x.
//
// K2 replaces csts_tpu/kernels/block.py:_mlp_tail_kernel (called from
// _mlp_tail_impl), B7 _mlp_tail_train_kernel (called from
// _mlp_tail_train_impl). As there: LN2 with eps 1e-6 and fp32 statistics, the
// normalised rows rounded once to the activation dtype before the products,
// fc1 + bias and the exact GELU in fp32 (erff, not the TPU kernel's A&S
// polynomial), the hidden rounded to the activation dtype for fc2, fp32
// accumulation throughout, one rounding of the sum. B7 also writes the
// pre-GELU hidden once, rounded to x's dtype, for its hand-written backward
// (csts_torch/kernels/block.py), and scales the MLP branch by the per-sample
// stochastic-depth factor dp before the one rounding.
//
// Bound on the H100: 2·M·(C·H + H·C_out [+ C·C_out]) operations against
// M·(C + C_out) activation bytes plus the weights, i.e. ~2·H·C/(C+C_out)
// operations per byte: 384 (d96 blocks) to 3072 (d768 blocks) per bf16 byte,
// so every K2 site is bound by the tensor cores, not by memory. B7 also
// writes M·H hidden values (H = 4·C), which brings the d96 sites (H·C/(C+H)
// ~ 77 operations per byte) below the card's ridge: B7 there is bound by the
// bytes of the stored hidden.
//
// Design (bf16), split at the hidden: three launches of one C call.
//  * LN2 (tail_ln_kernel) writes the rounded rows xn2 (M x C) once, a warp a
//    row; the products then read them through TMA like any operand.
//  * fc1 (tail_fc1_kernel): xn2·W1ᵀ; the epilogue adds b1 in fp32 and writes
//    G = GELU(h) rounded once (B7 also writes h rounded, which it stores
//    anyway). fc1 runs once per row whatever C_out is.
//  * fc2 (tail_fc2_kernel): G·W2ᵀ over H, then, where dim != dim_out,
//    xn2·Wpᵀ over C into the same accumulators (B7 scales by dp and adds b2
//    between the two); the epilogue adds b2 (K2), bp or x, rounds once.
// Both GEMMs are persistent (one block an SM walking 128-row output tiles,
// BN 64-192 columns picked per call so that the last wave is short), with a
// producer warp that keeps a ring of 4-8 TMA stages (64 reduction columns
// of A and B each, 128-byte swizzle) in flight on mbarriers and two
// consumer warpgroups that run wgmma m64nBNk16 with A and B from shared
// memory, holding at most 96 fp32 accumulators a thread (inside the 168
// registers ptxas gives a 288-thread block). fc2, whose reduction is long,
// splits each tile's rows between the warpgroups; fc1, whose epilogue (an
// exact erff a value) takes as long as its products, gives each warpgroup
// whole tiles in turn, so that one's epilogue overlaps the other's
// products. Each warpgroup stages its rounded output in shared memory and
// copies it out in 16-byte pieces (4-byte stores straight from the
// accumulator layout, and TMA stores of 64-byte-wide boxes, both wrote at
// ~0.7 TB/s). Every weight tile serves 128 rows (the first design's
// mma.sync body served 64, re-read fc1 for each 384-column output tile and
// streamed its weights through two cp.async buffers with a block barrier
// per tile). What the split costs: G is written once and read once (M·H
// bf16, mostly from L2 at M 2048). Ragged rows and widths are TMA's zero
// fill on load and masked stores. (Clusters of two blocks sharing each
// weight tile by TMA multicast measured 2.4x slower, PERF.md.)
//
// fp32 inputs (the exactness check against the plain version) take a simple
// body: the same chunking through shared memory with exact FMA products.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace csts;

struct TailArgs {
  const void *x, *ln_w, *ln_b, *w1, *b1, *w2, *b2, *wp, *bp;
  void* out;
  const float* dp;  // B7: per-sample MLP-branch factor, (M / L,)
  void* hid;        // B7: pre-GELU hidden (M, H) in x's dtype
  int M, C, H, Cout, BN, L;  // L: token rows per sample (B7's dp index is row / L)
  float eps;
  int Cln;  // the width LN2 normalises over: C, or the true width of rows zero-padded to C
};

// LN2 of rows m0 .. m0+BM into Xs (row stride ldx), one warp per row,
// two-pass fp32 statistics; rows past M are zeros.
template <typename T>
__device__ void layer_norm_rows(const TailArgs& a, T* Xs, int ldx, int m0, int BM) {
  const T* x = static_cast<const T*>(a.x);
  const T* ln_w = static_cast<const T*>(a.ln_w);
  const T* ln_b = static_cast<const T*>(a.ln_b);
  const int C = a.C, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += blockDim.x >> 5) {
    const long long row = m0 + r;
    T* xs = Xs + r * ldx;
    if (row < a.M) {
      const T* xr = x + row * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
      const float mean = warp_sum(s) / C;
      float v = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f32(xr[c]) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / C + a.eps);
      for (int c = lane; c < C; c += 32)
        xs[c] = from_f32<T>((to_f32(xr[c]) - mean) * rstd * to_f32(ln_w[c]) + to_f32(ln_b[c]));
    } else {
      for (int c = lane; c < C; c += 32) xs[c] = from_f32<T>(0.f);
    }
  }
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// B7's factor of token row `row` (0 past the last row, which is not stored)
__device__ __forceinline__ float row_dp(const TailArgs& a, long long row) {
  return row < a.M ? a.dp[row / a.L] : 0.f;
}

// ---------------------------------------------------------------------------
// bf16: LN2, then two persistent wgmma GEMMs split at the hidden
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace s9 = csts::sm90;

// Lanes that share a row in ln_body: the power of two that holds its C / 8
// 16-byte pieces, at most 32 (16 at C 96, 32 from C 136 on). A warp takes
// 32 / lanes rows, a 256-thread block eight times that: ln_blocks(M, C)
// blocks cover M rows.
__host__ __device__ inline int ln_lanes(int C) {
  int l = 1;
  while (l < 32 && l * 8 < C) l *= 2;
  return l;
}

inline int ln_blocks(int M, int C) {
  const int rows = 8 * (32 / ln_lanes(C));
  return (M + rows - 1) / rows;
}

// LN2 of every row into xn2 (the rows rounded once), 16-byte pieces,
// two-pass fp32 statistics. Up to 768 columns the row's pieces are loaded
// once into registers (three a lane at most) and the statistics and the
// output come from there; narrow rows share a warp (two rows of 96 columns,
// one a half-warp), so that more rows are in flight. Wider rows take one
// warp a row and read the row three times, from L1 after the first. Rows
// zero-padded from Cln to C columns (a width off 16, padded by the
// wrapper): the statistics are the first Cln columns' (the zeros add
// nothing to the sum, and are left out of the variance), and the padded
// columns, whose weight and bias are zero, come out zero.
// (The body of a 256-thread kernel launched over ln_blocks(M, C) blocks,
// rows of bf16 or, for B3's and B4's res1, fp32.)
template <typename TX>
__device__ __forceinline__ void ln_body(const TX* __restrict__ x, const bf16* __restrict__ w,
                                        const bf16* __restrict__ b, bf16* __restrict__ y, int M,
                                        int C, int Cln, float eps) {
  const int lanes = ln_lanes(C), nc = C >> 3, lane = threadIdx.x & (lanes - 1);
  const long long row = (static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5)) *
                            (32 / lanes) + ((threadIdx.x & 31) / lanes);
  const bool live = row < M;
  const TX* xr = x + (live ? row : 0) * C;
  auto unpack = [](const uint4& u, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  };
  // the 8 values of row piece j, widened to fp32
  auto load8 = [&](int j, float (&f)[8]) {
    if constexpr (sizeof(TX) == 2) {
      unpack(reinterpret_cast<const uint4*>(xr)[j], f);
    } else {
      const float4 lo = reinterpret_cast<const float4*>(xr)[2 * j],
                   hi = reinterpret_cast<const float4*>(xr)[2 * j + 1];
      f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
      f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
    }
  };
  // a sum over the row's lanes (xor offsets below `lanes` stay in the group)
  auto row_sum = [&](float v) {
    for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  // piece j normalised, scaled and shifted, rounded to bf16
  auto store8 = [&](int j, const float (&f)[8], float mean, float rstd) {
    float wf[8], bf[8];
    unpack(reinterpret_cast<const uint4*>(w)[j], wf);
    unpack(reinterpret_cast<const uint4*>(b)[j], bf);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[e] = pack_bf16x2((f[2 * e] - mean) * rstd * wf[2 * e] + bf[2 * e],
                          (f[2 * e + 1] - mean) * rstd * wf[2 * e + 1] + bf[2 * e + 1]);
    reinterpret_cast<uint4*>(y + row * C)[j] = o;
  };
  if (nc <= 3 * lanes) {
    float f[3][8], s = 0.f;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int j = lane + p * lanes;
      if (live && j < nc) {
        load8(j, f[p]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[p][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[p][e];
    }
    const float mean = row_sum(s) / Cln;
    float v = 0.f;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (8 * (lane + p * lanes) + e < Cln) v += (f[p][e] - mean) * (f[p][e] - mean);
    const float rstd = rsqrtf(row_sum(v) / Cln + eps);
    if (!live) return;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      if (lane + p * lanes < nc) store8(lane + p * lanes, f[p], mean, rstd);
    return;
  }
  // rows above 768 columns: lanes is 32, one warp a row
  if (!live) return;
  float f[8], s = 0.f;
  for (int j = lane; j < nc; j += 32) {
    load8(j, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += f[e];
  }
  const float mean = warp_sum(s) / Cln;
  float v = 0.f;
  for (int j = lane; j < nc; j += 32) {
    load8(j, f);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (8 * j + e < Cln) v += (f[e] - mean) * (f[e] - mean);
  }
  const float rstd = rsqrtf(warp_sum(v) / Cln + eps);
  for (int j = lane; j < nc; j += 32) {
    load8(j, f);
    store8(j, f, mean, rstd);
  }
}

template <bool TRAIN>
__global__ void __launch_bounds__(256) tail_ln_kernel(const bf16* __restrict__ x,
                                                      const bf16* __restrict__ w,
                                                      const bf16* __restrict__ b,
                                                      bf16* __restrict__ y, int M, int C,
                                                      int Cln, float eps) {
  ln_body<bf16>(x, w, b, y, M, C, Cln, eps);
}

constexpr int kGemmThreads = 288;  // two consumer warpgroups and a producer warp

// A ring stage holds 64 reduction columns of an A tile (BM rows) and of a B
// tile (BN rows), each one 64-column panel in the 128-byte swizzle (128
// bytes a row). The epilogue stages each warpgroup's output tile (EM rows x
// BN) in the 64-byte swizzle (BN/32 panels of EM rows, which the fragments
// write without bank conflicts) and copies it out in 16-byte pieces; the
// ring takes what is left.
template <int BM, int BN, int EM>
struct GemmPlan {
  static constexpr uint32_t kAPanel = BM * 128;
  static constexpr uint32_t kBPanel = BN * 128;
  static constexpr uint32_t kStage = kAPanel + kBPanel;
  static constexpr uint32_t kEpiWg = EM * BN * 2;
  static constexpr int kFit = static_cast<int>((csts::kMaxSmem - 1024 - 2 * kEpiWg - 256) / kStage);
  static constexpr int ST = kFit > 8 ? 8 : kFit;
  static constexpr size_t kSmem = 1024 + ST * kStage + 2 * kEpiWg + 16 * ST + 16;
  static_assert(ST >= 3 && kSmem <= csts::kMaxSmem, "shared memory");
};

struct GemmArgs {
  int M, N;           // rows, output columns
  int K1, K2;         // reduction of phase 1 (A1·B1ᵀ) and of phase 2 (A2·B2ᵀ; 0: none)
  const bf16* bias;   // b1 (fc1) or b2 (fc2)
  const bf16* bias2;  // bp: the dim-change proj's bias (fc2 with a phase 2)
  const bf16* x;      // the identity base (fc2 without a phase 2), row stride N
  const float* dp;    // B7: per-sample factor of the MLP branch
  int L;              // B7: rows per sample
  const float* x32 = nullptr;  // an fp32 identity base (EPI kBaseF32), row stride N
  const bf16* ln_w = nullptr;  // kLnOut: LN2's weight and bias
  const bf16* ln_b = nullptr;
  bf16* xn = nullptr;          // kLnOut: LN2 of the output rows, rounded (M x N)
  float eps = 0.f;
};

// fc2's epilogue: out = acc + b2 + (bp or the identity base) rounded to bf16,
// the base bf16 (K2, B7: kBaseBf16) or fp32 (kBaseF32: B3's and B4's
// identity blocks, whose base res1 is never rounded); or out = acc + b2 + x
// written in fp32 (kOutF32: B3's and B4's res1 = av·Wprojᵀ + bproj + skip);
// or out = acc + b2 rounded to bf16 (kBiasOnly: B3's q = LN1(x)·Wqᵀ + bq);
// or kOutF32's rows normalised in the epilogue (kLnOut: B3's and B4's res1
// where one output tile holds whole rows, N ≤ BN): xn = LN2(res1) rounded,
// with two-pass fp32 statistics over the row, and res1 itself written in
// fp32 only where `out` is given (an identity block's fc2 base)
enum { kBaseBf16 = 0, kBaseF32 = 1, kOutF32 = 2, kBiasOnly = 3, kLnOut = 4 };

// The shared memory of a GEMM: the ring, the two warpgroups' output tiles,
// the ring's full / empty barriers and two more (fc1's turns)
template <class P>
struct Smem {
  unsigned char *stages, *epi;
  uint64_t *full, *empty, *turn;
  __device__ explicit Smem(unsigned char* raw) {
    stages = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    epi = stages + P::ST * P::kStage;
    full = reinterpret_cast<uint64_t*>(epi + 2 * P::kEpiWg);
    empty = full + P::ST;
    turn = empty + P::ST;
  }
};

// The producer warp's lane 0: for each of the block's tiles in order, its
// stages (phase 1's k1s, then phase 2's k2s), each a panel of A (rows m0 ..
// m0+BM) and one of B (rows n0 .. n0+BN); columns past K are TMA's zeros,
// so the products need no branch.
template <class P, int BM, int BN>
__device__ void produce(const Smem<P>& sm, const CUtensorMap* a1, const CUtensorMap* b1,
                        const CUtensorMap* a2, const CUtensorMap* b2, int tiles, int nn, int k1s,
                        int k2s) {
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / nn * BM, n0 = tile % nn * BN;
    for (int ks = 0; ks < k1s + k2s; ++ks, ++i) {
      const bool ph2 = ks >= k1s;
      const int k0 = (ph2 ? ks - k1s : ks) * 64, s = i % P::ST;
      if (i >= P::ST) s9::bar_wait(&sm.empty[s], ((i / P::ST) & 1) ^ 1);
      unsigned char* st = sm.stages + s * P::kStage;
      s9::bar_expect(&sm.full[s], P::kStage);
      s9::tma_load_2d(st, ph2 ? a2 : a1, &sm.full[s], k0, m0);
      s9::tma_load_2d(st + P::kAPanel, ph2 ? b2 : b1, &sm.full[s], k0, n0);
    }
  }
}

// acc_h [+]= the next nst ring stages' products (stage i on), for the MH
// 64-row slices h of the stage's A tile starting at row arow: all four k16
// steps of a stage in one group (a branch between products makes ptxas
// serialise them, C7520; columns past K are TMA's zeros), one group left in
// flight while the next stage is awaited, a stage freed once the group that
// read it has retired.
template <class P, int BN, int MH>
__device__ __forceinline__ void ring_run(float (&acc)[MH][BN / 2], const Smem<P>& sm,
                                         uint32_t arow, int nst, bool accumulate, int& i) {
#pragma unroll
  for (int h = 0; h < MH; ++h) s9::fence_regs(acc[h]);
  for (int st = 0; st < nst; ++st, ++i) {
    const int s = i % P::ST;
    s9::bar_wait(&sm.full[s], (i / P::ST) & 1);
    s9::wgmma_fence();  // acc is in the previous group: order the next after it
    const unsigned char* a = sm.stages + s * P::kStage + arow;
    const unsigned char* b = sm.stages + s * P::kStage + P::kAPanel;
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        s9::Wgmma<BN, 0>::ss(acc[h], s9::desc_k128(a + h * 64 * 128, ks), s9::desc_k128(b, ks),
                             (accumulate || st > 0 || ks > 0) ? 1 : 0);
    s9::wgmma_commit();
    s9::wgmma_wait<1>();
    if (st > 0) s9::bar_arrive(&sm.empty[(i - 1) % P::ST]);
  }
  s9::wgmma_wait<0>();
  s9::bar_arrive(&sm.empty[(i - 1) % P::ST]);
#pragma unroll
  for (int h = 0; h < MH; ++h) s9::fence_regs(acc[h]);
}

// A warpgroup's epilogue: out_s <- f(h, j, e) for the fragment's (row
// 64h + 16·wl + g + 8e, columns 8j + 2·t4 + {0, 1}) of an EM-row tile, then
// the tile copied to out (rows m.., columns n.., row stride N) in 16-byte
// pieces, rows past M and columns past N left out. The warpgroup waits
// only for itself (named barrier bar), before the tile is written (its last
// copy has read it) and before it is read.
template <int BN, int EM, class F>
__device__ __forceinline__ void stage_out(unsigned char* out_s, int bar, bf16* out, int m, int n,
                                          int M, int N, F f) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) & 3, t4 = lane & 3;
  s9::named_sync(bar, 128);
#pragma unroll
  for (int h = 0; h < EM / 64; ++h)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<__nv_bfloat162*>(
            out_s + s9::swz64(64 * h + wl * 16 + (lane >> 2) + 8 * e, 8 * j + 2 * t4, EM)) =
            f(h, j, e);
  s9::named_sync(bar, 128);
  constexpr int kPieces = BN / 8;  // 16-byte pieces a row
  const int rows = min(EM, M - m);
#pragma unroll 4
  for (int q = threadIdx.x & 127; q < EM * kPieces; q += 128) {
    const int r = q / kPieces, c = 8 * (q - r * kPieces);
    if (r < rows && n + c < N)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(m + r) * N + n + c) =
          *reinterpret_cast<const uint4*>(out_s + s9::swz64(r, c, EM));
  }
}

// fc1 (tail_fc1_kernel): xn2·W1ᵀ over C, h = acc + b1 in fp32, G = GELU(h)
// rounded once (B7 also stores h rounded), persistent over 128 x BN output
// tiles. Its epilogue (an exact erff a value, and B7's second store) takes
// as long as its products or longer at C <= 384, so the two consumer
// warpgroups take whole tiles in turn (ping-pong): warpgroup w runs the
// block's tiles n = w, w + 2, ..., and while one multiplies (both of its
// 64-row halves, BN/2 accumulators each) the other runs its epilogue. (The
// GELU alone is a fifth of K2's and B7's device time: PERF.md.) Two
// mbarriers hand the products over from one to the other, so their
// products never overlap and each epilogue overlaps the other's products.
// (The body of a kGemmThreads kernel whose tensor maps are __grid_constant__.)
template <bool TRAIN, int BN>
__device__ __forceinline__ void fc1_body(const CUtensorMap& amap, const CUtensorMap& bmap,
                                         bf16* gout, bf16* hout, const GemmArgs& g) {
  using P = GemmPlan<128, BN, 128>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<P> sm(smem_raw);
  const int nn = (g.N + BN - 1) / BN, tiles = (g.M + 127) / 128 * nn, ks = (g.K1 + 63) / 64;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::ST; ++s) {
      s9::bar_init(&sm.full[s], 1);
      s9::bar_init(&sm.empty[s], 128);  // one warpgroup reads a stage
    }
    s9::bar_init(&sm.turn[0], 128);
    s9::bar_init(&sm.turn[1], 128);
    s9::bar_init_fence();
  }
  __syncthreads();
  if (warp == 8) {
    if ((threadIdx.x & 31) == 0) produce<P, 128, BN>(sm, &amap, &bmap, &amap, &bmap, tiles, nn, ks, 0);
    return;
  }
  const int wg = warp >> 2, t4 = threadIdx.x & 3;
  unsigned char* out_s = sm.epi + wg * P::kEpiWg;
  float acc[2][BN / 2];
  int k = 0;  // this warpgroup's tiles so far
  for (int n = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles;
       n += 2, tile += 2 * gridDim.x, ++k) {
    const int m0 = tile / nn * 128, n0 = tile % nn * BN;
    // the products' turn: warpgroup 0 first, then each after the other's
    if (wg == 1 || k > 0) s9::bar_wait(&sm.turn[wg], (wg == 1 ? k : k - 1) & 1);
    int i = n * ks;  // the ring's stages of the block's n-th tile
    ring_run<P, BN, 2>(acc, sm, 0, ks, false, i);
    s9::bar_arrive(&sm.turn[wg ^ 1]);
    const int c0 = n0 + 2 * t4;
    auto bias = [&](int j) {
      const int c = c0 + 8 * j;
      return c < g.N ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c))
                     : make_float2(0.f, 0.f);
    };
    stage_out<BN, 128>(out_s, 1 + wg, gout, m0, n0, g.M, g.N, [&](int h, int j, int e) {
      const float2 b = bias(j);
      return __floats2bfloat162_rn(gelu_erf(acc[h][4 * j + 2 * e] + b.x),
                                   gelu_erf(acc[h][4 * j + 2 * e + 1] + b.y));
    });
    if constexpr (TRAIN)
      stage_out<BN, 128>(out_s, 1 + wg, hout, m0, n0, g.M, g.N, [&](int h, int j, int e) {
        const float2 b = bias(j);
        return __floats2bfloat162_rn(acc[h][4 * j + 2 * e] + b.x, acc[h][4 * j + 2 * e + 1] + b.y);
      });
  }
}

template <bool TRAIN, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    tail_fc1_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap, bf16* gout, bf16* hout,
                    GemmArgs g) {
  fc1_body<TRAIN, BN>(amap, bmap, gout, hout, g);
}

// fc2 (tail_fc2_kernel): acc = G·W2ᵀ over H, then with the dim-change proj
// (PROJ) + xn2·Wpᵀ over C into the same accumulators (B7 first sets acc =
// dp·(acc + b2), so the factor scales the MLP branch only); out = acc + b2
// (K2) + bp or x, rounded once. Persistent over 128 x BN output tiles (row-
// tile major, so that the blocks in flight share weight tiles in L2), the
// two consumer warpgroups taking 64 rows each of every tile (cooperative):
// here the reduction is long (H) and the epilogue short, and a 128-row
// tile reads each weight tile for twice the rows of a 64-row one.
// (The body of a kGemmThreads kernel; EPI: what the epilogue adds and
// writes, see kBaseBf16.)
template <bool TRAIN, bool PROJ, int BN, int EPI>
__device__ __forceinline__ void fc2_body(const CUtensorMap& a1map, const CUtensorMap& b1map,
                                         const CUtensorMap& a2map, const CUtensorMap& b2map,
                                         void* out, const GemmArgs& g) {
  using P = GemmPlan<128, BN, 64>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<P> sm(smem_raw);
  const int nn = (g.N + BN - 1) / BN, tiles = (g.M + 127) / 128 * nn;
  const int k1s = (g.K1 + 63) / 64, k2s = (g.K2 + 63) / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::ST; ++s) {
      s9::bar_init(&sm.full[s], 1);
      s9::bar_init(&sm.empty[s], 256);  // both warpgroups read every stage
    }
    s9::bar_init_fence();
  }
  __syncthreads();
  if (warp == 8) {
    if (lane == 0) produce<P, 128, BN>(sm, &a1map, &b1map, &a2map, &b2map, tiles, nn, k1s, k2s);
    return;
  }
  const int wg = warp >> 2, wl = warp & 3, t4 = lane & 3;
  const uint32_t arow = wg * 64 * 128;  // the warpgroup's rows in an A panel
  unsigned char* out_s = sm.epi + wg * P::kEpiWg;
  float acc[1][BN / 2];
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int mw = tile / nn * 128 + wg * 64, n0 = tile % nn * BN;
    const long long r0 = mw + wl * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
    const int c0 = n0 + 2 * t4;
    ring_run<P, BN, 1>(acc, sm, arow, k1s, false, i);
    if constexpr (TRAIN) {
      // acc = dp · (acc + b2): the MLP branch alone, before proj adds to it
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j;
        const float2 bv = c < g.N ? __bfloat1622float2(
                                        *reinterpret_cast<const __nv_bfloat162*>(g.bias + c))
                                  : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long r = r0 + 8 * e;
          const float d = r < g.M ? g.dp[r / g.L] : 0.f;
          acc[0][4 * j + 2 * e] = d * (acc[0][4 * j + 2 * e] + bv.x);
          acc[0][4 * j + 2 * e + 1] = d * (acc[0][4 * j + 2 * e + 1] + bv.y);
        }
      }
    }
    // a compile-time choice: acc live across a branch that holds products
    // makes ptxas serialise them
    if constexpr (PROJ) ring_run<P, BN, 1>(acc, sm, arow, k2s, true, i);
    // b2 (K2; B7 added it before proj), bp or the identity base x; zero past the edge
    auto add = [&](int j, int e) {
      const long long r = r0 + 8 * e;
      const int c = c0 + 8 * j;
      float2 v = make_float2(0.f, 0.f);
      if (r < g.M && c < g.N) {
        if (!TRAIN) v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.bias + c));
        if constexpr (EPI != kBiasOnly) {
          const float2 base =
              EPI == kBaseF32 ? *reinterpret_cast<const float2*>(g.x32 + r * g.N + c)
                              : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                    PROJ ? g.bias2 + c : g.x + r * g.N + c));
          v.x += base.x;
          v.y += base.y;
        }
      }
      return v;
    };
    if constexpr (EPI == kOutF32) {
      // fp32 rows from the fragments, 16 bytes a store: lanes t4 and t4 ^ 1
      // hold columns 4k .. 4k+3 (k = t4 / 2) of rows r0 and r0 + 8 in halves
      // and swap one half, so that the even lane writes the four of row r0
      // and the odd lane those of row r0 + 8, each with its 8-byte bias and
      // skip pieces (N a multiple of 4, the wrapper's widths are of 16)
      const bool odd = t4 & 1;
      const long long r = r0 + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 lo = make_float2(acc[0][4 * j], acc[0][4 * j + 1]),
                     hi = make_float2(acc[0][4 * j + 2], acc[0][4 * j + 3]);
        const float2 send = odd ? lo : hi;
        const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                       __shfl_xor_sync(0xffffffffu, send.y, 1));
        const float4 o = odd ? make_float4(got.x, got.y, hi.x, hi.y)
                             : make_float4(lo.x, lo.y, got.x, got.y);
        const int c = n0 + 8 * j + 4 * (t4 >> 1);
        if (r < g.M && c < g.N) {
          const uint2 bb = *reinterpret_cast<const uint2*>(g.bias + c);
          const uint2 xx = *reinterpret_cast<const uint2*>(g.x + r * g.N + c);
          const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb.x)),
                       b23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb.y)),
                       x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xx.x)),
                       x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xx.y));
          *reinterpret_cast<float4*>(static_cast<float*>(out) + r * g.N + c) =
              make_float4(o.x + (b01.x + x01.x), o.y + (b01.y + x01.y), o.z + (b23.x + x23.x),
                          o.w + (b23.y + x23.y));
        }
      }
    } else if constexpr (EPI == kLnOut) {
      // res1 = acc + bproj + skip in fp32; the tile holds whole rows (n0 is
      // 0, columns past N are zeros), a row's columns over the quad's lanes
      float mean[2], rstd[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 v = add(j, e);
          acc[0][4 * j + 2 * e] += v.x;
          acc[0][4 * j + 2 * e + 1] += v.y;
          sum[e] += acc[0][4 * j + 2 * e] + acc[0][4 * j + 2 * e + 1];
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = sum[e];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        mean[e] = s / g.N;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          if (c0 + 8 * j < g.N) {
            const float d0 = acc[0][4 * j + 2 * e] - mean[e], d1 = acc[0][4 * j + 2 * e + 1] - mean[e];
            q += d0 * d0 + d1 * d1;
          }
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        rstd[e] = rsqrtf(q / g.N + g.eps);
      }
      if (out != nullptr) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long r = r0 + 8 * e;
            const int c = c0 + 8 * j;
            if (r < g.M && c < g.N)
              *reinterpret_cast<float2*>(static_cast<float*>(out) + r * g.N + c) =
                  make_float2(acc[0][4 * j + 2 * e], acc[0][4 * j + 2 * e + 1]);
          }
      }
      stage_out<BN, 64>(out_s, 1 + wg, g.xn, mw, n0, g.M, g.N, [&](int, int j, int e) {
        const int c = c0 + 8 * j;
        float2 w = make_float2(0.f, 0.f), b = w;
        if (c < g.N) {
          w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.ln_w + c));
          b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g.ln_b + c));
        }
        return __floats2bfloat162_rn((acc[0][4 * j + 2 * e] - mean[e]) * rstd[e] * w.x + b.x,
                                     (acc[0][4 * j + 2 * e + 1] - mean[e]) * rstd[e] * w.y + b.y);
      });
    } else {
      stage_out<BN, 64>(out_s, 1 + wg, static_cast<bf16*>(out), mw, n0, g.M, g.N,
                        [&](int, int j, int e) {
                          const float2 v = add(j, e);
                          return __floats2bfloat162_rn(acc[0][4 * j + 2 * e] + v.x,
                                                       acc[0][4 * j + 2 * e + 1] + v.y);
                        });
    }
  }
}

template <bool TRAIN, bool PROJ, int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
    tail_fc2_kernel(const __grid_constant__ CUtensorMap a1map,
                    const __grid_constant__ CUtensorMap b1map,
                    const __grid_constant__ CUtensorMap a2map,
                    const __grid_constant__ CUtensorMap b2map, bf16* out, GemmArgs g) {
  fc2_body<TRAIN, PROJ, BN, kBaseBf16>(a1map, b1map, a2map, b2map, out, g);
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The output tile's width, of `widths`, for N columns over M rows: the one
// whose last wave of 128-row tiles ends first, counting a tile's time as its
// width plus 32 for what every tile costs whatever its width (the ring's
// fill, the epilogue, the A tile read again); the widest on a tie. On 132
// SMs fc2 at M 8192 takes 192 and at M 2048 (v14, v15, a3) 96, so that 128
// tiles fill the card where 64 of 192 would leave half of it idle.
template <int NW>
inline int pick_bn(int M, int N, const int (&widths)[NW]) {
  const int sms = sm_count(), rows = (M + 127) / 128;
  int best = widths[0];
  long long best_cost = -1;
  for (int w : widths) {
    const long long tiles = static_cast<long long>(rows) * ((N + w - 1) / w);
    const long long cost = (tiles + sms - 1) / sms * (w + 32);
    if (best_cost < 0 || cost < best_cost) best = w, best_cost = cost;
  }
  return best;
}

// One attribute set per kernel instance: the dynamic shared memory it needs.
template <class K>
cudaError_t set_smem(K kern, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  done = e == cudaSuccess;
  return e;
}

// a bf16 (rows, K) operand in boxes of 64 columns x box rows, 128-byte swizzle
inline bool map2d(CUtensorMap* m, const void* base, long long rows, long long K, int box) {
  const long long d[2] = {K, rows}, s[1] = {K};
  return s9::make_map(m, base, 2, d, s, box, true);
}

inline int grid_for(int tiles) { return tiles < sm_count() ? tiles : sm_count(); }

template <bool TRAIN, int BN>
cudaError_t launch_fc1(const bf16* xn2, const void* w1, bf16* gbuf, void* hid, const GemmArgs& g,
                       cudaStream_t stream) {
  using P = GemmPlan<128, BN, 128>;
  static bool attr = false;
  cudaError_t e = set_smem(tail_fc1_kernel<TRAIN, BN>, P::kSmem, attr);
  if (e != cudaSuccess) return e;
  CUtensorMap am, bm;
  if (!map2d(&am, xn2, g.M, g.K1, 128) || !map2d(&bm, w1, g.N, g.K1, BN))
    return cudaErrorInvalidValue;
  const int tiles = (g.M + 127) / 128 * ((g.N + BN - 1) / BN);
  tail_fc1_kernel<TRAIN, BN><<<grid_for(tiles), kGemmThreads, P::kSmem, stream>>>(
      am, bm, gbuf, static_cast<bf16*>(hid), g);
  return cudaGetLastError();
}

template <bool TRAIN, bool PROJ, int BN>
cudaError_t launch_fc2(const bf16* gbuf, const void* w2, const bf16* xn2, const void* wp,
                       void* out, const GemmArgs& g, cudaStream_t stream) {
  using P = GemmPlan<128, BN, 64>;
  static bool attr = false;
  cudaError_t e = set_smem(tail_fc2_kernel<TRAIN, PROJ, BN>, P::kSmem, attr);
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
  tail_fc2_kernel<TRAIN, PROJ, BN><<<grid_for(tiles), kGemmThreads, P::kSmem, stream>>>(
      a1, b1, a2, b2, static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

template <bool TRAIN, bool PROJ>
cudaError_t launch_fc2_bn(const bf16* gbuf, const void* w2, const bf16* xn2, const void* wp,
                          void* out, const GemmArgs& g, cudaStream_t stream) {
  static const int widths[4] = {192, 128, 96, 64};
  switch (pick_bn(g.M, g.N, widths)) {
    case 192: return launch_fc2<TRAIN, PROJ, 192>(gbuf, w2, xn2, wp, out, g, stream);
    case 128: return launch_fc2<TRAIN, PROJ, 128>(gbuf, w2, xn2, wp, out, g, stream);
    case 96: return launch_fc2<TRAIN, PROJ, 96>(gbuf, w2, xn2, wp, out, g, stream);
    default: return launch_fc2<TRAIN, PROJ, 64>(gbuf, w2, xn2, wp, out, g, stream);
  }
}

// Three launches: LN2 into xn2 (M x C), fc1 + GELU into G (M x H), fc2
// (+ proj) into out. Widths are multiples of 16 (the wrapper zero-pads
// others to them, Cln the true width): TMA reads whole 16-byte pieces of
// every row, and a reduction that ends inside a panel reads the panel's tail
// as zeros.
template <bool TRAIN>
cudaError_t launch_bf16(const TailArgs& a, bf16* xn2, bf16* gbuf, cudaStream_t stream) {
  if (a.M == 0) return cudaSuccess;
  if (xn2 == nullptr || gbuf == nullptr || a.C % 16 || a.H % 16 || a.Cout % 16 ||
      a.Cln > a.C || a.Cln < 1)
    return cudaErrorInvalidValue;
  tail_ln_kernel<TRAIN><<<ln_blocks(a.M, a.C), 256, 0, stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.ln_w),
      static_cast<const bf16*>(a.ln_b), xn2, a.M, a.C, a.Cln, a.eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // fc1's tiles are 64 columns wide: its ping-pong holds both 64-row halves
  // of a tile a thread, and at 64 (64 accumulators) the GELU epilogue has
  // the registers to overlap its erff chains (96 measured 0-10% slower at
  // every flagship site, PERF.md)
  GemmArgs g1{a.M, a.H, a.C, 0, static_cast<const bf16*>(a.b1), nullptr, nullptr, nullptr, 1};
  e = launch_fc1<TRAIN, 64>(xn2, a.w1, gbuf, a.hid, g1, stream);
  if (e != cudaSuccess) return e;
  GemmArgs g2{a.M, a.Cout, a.H, a.wp != nullptr ? a.C : 0, static_cast<const bf16*>(a.b2),
              static_cast<const bf16*>(a.bp), static_cast<const bf16*>(a.x), a.dp, a.L};
  return a.wp != nullptr
             ? launch_fc2_bn<TRAIN, true>(gbuf, a.w2, xn2, a.wp, a.out, g2, stream)
             : launch_fc2_bn<TRAIN, false>(gbuf, a.w2, xn2, a.wp, a.out, g2, stream);
}

// ---------------------------------------------------------------------------
// fp32: exact FMA body through shared memory
// ---------------------------------------------------------------------------

constexpr int kF32BM = 32;      // token rows per block
constexpr int kF32KC = 64;      // input-width chunk of fc1 / proj
constexpr int kF32HC = 64;      // hidden-width chunk
constexpr int kF32Threads = 256;

inline size_t f32_smem_bytes(int C, int BN) {
  const int pad = kF32Pad;
  const int wrows = BN > kF32HC ? BN : kF32HC;
  return align128(sizeof(float) * kF32BM * (C + pad)) +
         align128(sizeof(float) * wrows * (kF32KC + pad)) +
         align128(sizeof(float) * kF32BM * kF32HC) +
         align128(sizeof(float) * kF32BM * (kF32HC + pad)) +
         align128(sizeof(float) * BN * (kF32HC + pad)) + align128(sizeof(float) * kF32BM * BN);
}

template <bool TRAIN>
__global__ void __launch_bounds__(kF32Threads) mlp_tail_f32_kernel(TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BM = kF32BM;
  const int pad = kF32Pad;
  const int C = a.C, H = a.H, Cout = a.Cout, BN = a.BN;
  const int ldx = C + pad, ldw = kF32KC + pad, ldh = kF32HC + pad;
  const int wrows = BN > kF32HC ? BN : kF32HC;
  unsigned char* p = smem_raw;
  float* Xs = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * ldx));     // LN2(x) rows
  float* Wt = reinterpret_cast<float*>(carve(p, sizeof(float) * wrows * ldw));  // fc1 / proj tile
  float* Hf = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * kF32HC));
  float* Ht = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * ldh));     // GELU chunk
  float* W2t = reinterpret_cast<float*>(carve(p, sizeof(float) * BN * ldh));    // fc2 tile
  float* Oacc = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * BN));

  const float* x = static_cast<const float*>(a.x);
  const float* w1 = static_cast<const float*>(a.w1);
  const float* b1 = static_cast<const float*>(a.b1);
  const float* w2 = static_cast<const float*>(a.w2);
  const float* b2 = static_cast<const float*>(a.b2);
  const float* wp = static_cast<const float*>(a.wp);
  const float* bp = static_cast<const float*>(a.bp);
  float* out = static_cast<float*>(a.out);
  float* hout = static_cast<float*>(a.hid);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bn = min(BN, Cout - n0);
  const bool write_hid = TRAIN && blockIdx.y == 0;

  layer_norm_rows<float>(a, Xs, ldx, m0, BM);
  for (int idx = tid; idx < BM * BN; idx += kF32Threads) Oacc[idx] = 0.f;
  __syncthreads();

  // base = proj(LN2(x)) for the dim-changing blocks (K2 first, B7 last)
  auto proj = [&]() {
    for (int k0 = 0; k0 < C; k0 += kF32KC) {
      const int kc = min(kF32KC, C - k0);
      for (int idx = tid; idx < bn * kc; idx += kF32Threads) {
        const int n = idx / kc, kk = idx - n * kc;
        Wt[n * ldw + kk] = wp[(long long)(n0 + n) * C + k0 + kk];
      }
      __syncthreads();
      smem_gemm<true>(Oacc, BN, Xs + k0, ldx, Wt, ldw, BM, bn, kc, true);
      __syncthreads();
    }
  };
  if (!TRAIN && wp != nullptr) proj();

  for (int h0 = 0; h0 < H; h0 += kF32HC) {
    const int hc = min(kF32HC, H - h0);
    for (int k0 = 0; k0 < C; k0 += kF32KC) {
      const int kc = min(kF32KC, C - k0);
      for (int idx = tid; idx < hc * kc; idx += kF32Threads) {
        const int n = idx / kc, kk = idx - n * kc;
        Wt[n * ldw + kk] = w1[(long long)(h0 + n) * C + k0 + kk];
      }
      __syncthreads();
      smem_gemm<true>(Hf, kF32HC, Xs + k0, ldx, Wt, ldw, BM, hc, kc, k0 > 0);
      __syncthreads();
    }
    for (int idx = tid; idx < BM * hc; idx += kF32Threads) {
      const int r = idx / hc, j = idx - r * hc;
      const float h = Hf[r * kF32HC + j] + b1[h0 + j];
      Ht[r * ldh + j] = gelu_erf(h);
      if (write_hid && m0 + r < a.M) hout[(long long)(m0 + r) * H + h0 + j] = h;
    }
    for (int idx = tid; idx < bn * hc; idx += kF32Threads) {
      const int n = idx / hc, kk = idx - n * hc;
      W2t[n * ldh + kk] = w2[(long long)(n0 + n) * H + h0 + kk];
    }
    __syncthreads();
    smem_gemm<true>(Oacc, BN, Ht, ldh, W2t, ldh, BM, bn, hc, true);
    __syncthreads();
  }

  if (TRAIN) {
    for (int idx = tid; idx < BM * bn; idx += kF32Threads) {
      const int r = idx / bn, j = idx - r * bn;
      Oacc[r * BN + j] = row_dp(a, m0 + r) * (Oacc[r * BN + j] + b2[n0 + j]);
    }
    __syncthreads();
    if (wp != nullptr) proj();
  }

  for (int idx = tid; idx < BM * bn; idx += kF32Threads) {
    const int r = idx / bn, j = idx - r * bn;
    const long long row = m0 + r;
    if (row >= a.M) continue;
    const int col = n0 + j;
    float o = Oacc[r * BN + j] + (TRAIN ? 0.f : b2[col]);
    o += wp != nullptr ? bp[col] : x[row * C + col];
    out[row * Cout + col] = o;
  }
}

template <bool TRAIN>
cudaError_t launch_f32(TailArgs a, cudaStream_t stream) {
  // one column tile when the output is narrow, 128-wide tiles otherwise
  a.BN = a.Cout <= 192 ? a.Cout : 128;
  const size_t smem = f32_smem_bytes(a.C, a.BN);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = mlp_tail_f32_kernel<TRAIN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.M + kF32BM - 1) / kF32BM, (a.Cout + a.BN - 1) / a.BN);
  kern<<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool TRAIN>
int launch_tail(const TailArgs& a, int dtype, void* xn2, void* gbuf, cudaStream_t s) {
  if (dtype == kFloat32) return a.Cln != a.C ? cudaErrorInvalidValue : launch_f32<TRAIN>(a, s);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  return launch_bf16<TRAIN>(a, static_cast<bf16*>(xn2), static_cast<bf16*>(gbuf), s);
}

}  // namespace
