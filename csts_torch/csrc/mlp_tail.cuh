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
// accumulation throughout, one rounding of the sum. K2 never writes the
// hidden tensor; B7 writes the pre-GELU hidden once, rounded to x's dtype, for
// its hand-written backward (csts_torch/kernels/block.py), and scales the MLP
// branch by the per-sample stochastic-depth factor dp before the one rounding.
//
// Bound on the H100: 2·M·(C·H + H·C_out [+ C·C_out]) operations against
// M·(C + C_out) activation bytes plus the weights, i.e. ~2·H·C/(C+C_out)
// operations per byte: 384 (d96 blocks) to 3072 (d768 blocks) per bf16 byte,
// so every K2 site is bound by the tensor cores, not by memory. B7 also
// writes M·H hidden values (H = 4·C), which brings the d96 sites (H·C/(C+H)
// ~ 77 operations per byte) below the card's ridge: B7 there is bound by the
// bytes of the stored hidden, which it writes with 16-byte stores.
//
// Design (bf16): one block of 8 warps takes BM = 64 token rows and BN =
// 32·NT output columns (96, 192 or 384; a C_out of 768 takes two column
// tiles, so fc1 runs twice there and only the first column tile writes the
// hidden). LN2 of its rows goes once into shared memory. The block then walks
// one stream of weight tiles: K2 takes proj's tiles (BN x 64, when dim !=
// dim_out) first, then per hidden chunk of 128 the fc1 tiles (128 x 128) over
// C, a bias + GELU pass that puts the chunk into shared memory as bf16, and
// the fc2 tiles (BN x 64) over the chunk. B7 takes proj's tiles last: the
// output sum then holds the MLP branch alone when the fc2 tiles end, and is
// scaled there by dp before the proj products add into it. B7 stages each
// chunk's pre-GELU values in the GELU buffer, copies them out with 16-byte
// stores, then overwrites the buffer with GELU of the fp32 values still in
// registers (so the forward's GELU is of the unrounded hidden, as the TPU
// kernel's). Tiles are copied with cp.async into two buffers, so the next
// tile loads while the warps multiply the current one; rows past the
// weights' edge are zero-filled, so the product loop runs without bounds
// checks, which slowed it measurably. Products are mma.sync m16n8k16 (bf16
// in, fp32 accumulate) fed by ldmatrix; the (64 x BN) output sum stays in
// registers for the whole hidden width (each warp owns 32 x 8·NT of it). At
// dim 768 the fc weights are 4.5 MB and the hidden width 3072, far above a
// block's 227 KB; the tile stream is what lets one design serve every width.
// Ragged token counts (the fusion blocks' 260 and 8) are masked in the kernel.
//
// fp32 inputs (the exactness check against the plain version) take a simple
// body: the same chunking through shared memory with exact FMA products.
#pragma once

#include "common.cuh"

namespace {

using namespace csts;

struct TailArgs {
  const void *x, *ln_w, *ln_b, *w1, *b1, *w2, *b2, *wp, *bp;
  void* out;
  const float* dp;  // B7: per-sample MLP-branch factor, (M / L,)
  void* hid;        // B7: pre-GELU hidden (M, H) in x's dtype
  int M, C, H, Cout, BN, L;  // L: token rows per sample (B7's dp index is row / L)
  float eps;
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
// bf16: register-tiled mma.sync body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;            // token rows per block
constexpr int kHC = 128;           // hidden chunk
constexpr int kKW1 = 128;          // reduction width of an fc1 tile
constexpr int kKW2 = 64;           // reduction width of an fc2 / proj tile
constexpr int kLd1 = kKW1 + 8;     // row strides of the tiles (elements)
constexpr int kLd2 = kKW2 + 8;
constexpr int kLdG = kHC + 8;      // GELU(hidden) chunk row stride
constexpr int kMmaThreads = 256;   // 8 warps: 2 along rows x 4 along columns

enum { kProj = 0, kFc1 = 1, kFc2 = 2, kDone = 3 };

// position in the block's stream of weight tiles
struct TileIt {
  int kind, h0, k0;
};

// K2: proj, then (fc1, fc2) per hidden chunk. B7: the chunks, then proj.
template <bool TRAIN>
__device__ __forceinline__ void advance(TileIt& s, int C, int H, bool has_proj) {
  if (s.kind == kProj) {
    s.k0 += kKW2;
    if (s.k0 >= C) s = TRAIN ? TileIt{kDone, 0, 0} : TileIt{kFc1, 0, 0};
  } else if (s.kind == kFc1) {
    s.k0 += kKW1;
    if (s.k0 >= C) s.kind = kFc2, s.k0 = 0;
  } else if (s.kind == kFc2) {
    s.k0 += kKW2;
    if (s.k0 >= min(kHC, H - s.h0)) {
      const int h0 = s.h0 + kHC;
      s = h0 < H ? TileIt{kFc1, h0, 0}
                 : (TRAIN && has_proj ? TileIt{kProj, 0, 0} : TileIt{kDone, h0, 0});
    }
  }
}

// Copy one weight tile (rows x kc of global row stride ld) into buf (row
// stride ldb) with cp.async, zero-filling its rows from `valid` to `rows`.
__device__ __forceinline__ void load_tile(bf16* buf, int ldb, const bf16* src, int rows,
                                          int valid, int ld, int kc) {
  const int per_row = kc >> 3;  // 16-byte pieces
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kMmaThreads) {
    const int r = idx / per_row, c8 = idx - r * per_row;
    const bool ok = r < valid;
    cp_async16_zfill(buf + r * ldb + c8 * 8, ok ? src + (long long)r * ld + c8 * 8 : src, ok);
  }
}

// one buffer: an fc1 tile (kHC x kKW1) or an fc2 / proj tile (BN x kKW2)
template <int NT>
__host__ __device__ constexpr int tile_elems() {
  return kHC * kLd1 > 32 * NT * kLd2 ? kHC * kLd1 : 32 * NT * kLd2;
}

template <int NT>
size_t mma_smem_bytes(int C) {
  return align128(sizeof(bf16) * kBM * (C + 8)) + 2 * align128(sizeof(bf16) * tile_elems<NT>()) +
         align128(sizeof(bf16) * kBM * kLdG);
}

template <int NT, bool TRAIN>
__global__ void __launch_bounds__(kMmaThreads, NT > 6 ? 1 : 2) mlp_tail_mma_kernel(TailArgs a) {
  constexpr int BN = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, H = a.H, Cout = a.Cout, ldx = C + 8;
  unsigned char* p = smem_raw;
  bf16* Xs = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBM * ldx));
  bf16* buf[2];
  buf[0] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * tile_elems<NT>()));
  buf[1] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * tile_elems<NT>()));
  bf16* G = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBM * kLdG));

  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* b1 = static_cast<const bf16*>(a.b1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* b2 = static_cast<const bf16*>(a.b2);
  const bf16* wp = static_cast<const bf16*>(a.wp);
  const bf16* bp = static_cast<const bf16*>(a.bp);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp >> 2, wc = warp & 3;  // warp's 32 rows / column slice
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int bn = min(BN, Cout - n0);
  const bool has_proj = wp != nullptr;
  const bool write_hid = TRAIN && blockIdx.y == 0;  // block-uniform

  auto issue = [&](const TileIt& s, bf16* dst) {
    if (s.kind == kProj) {
      load_tile(dst, kLd2, wp + (long long)n0 * C + s.k0, BN, bn, C, min(kKW2, C - s.k0));
    } else if (s.kind == kFc1) {
      load_tile(dst, kLd1, w1 + (long long)s.h0 * C + s.k0, kHC, min(kHC, H - s.h0), C,
                min(kKW1, C - s.k0));
    } else {
      load_tile(dst, kLd2, w2 + (long long)n0 * H + s.h0 + s.k0, BN, bn, H,
                min(kKW2, min(kHC, H - s.h0) - s.k0));
    }
  };

  float acc[2][NT][4] = {};
  // B7: acc = dp · (acc + b2), once the fc2 tiles are done (before proj adds)
  auto scale_mlp = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cl = wc * 8 * NT + j * 8 + 2 * (lane & 3);
        if (cl >= bn) continue;
        const float bias0 = __bfloat162float(b2[n0 + cl]);
        const float bias1 = __bfloat162float(b2[n0 + cl + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float d = row_dp(a, m0 + wr * 32 + i * 16 + (lane >> 2) + half * 8);
          acc[i][j][2 * half] = d * (acc[i][j][2 * half] + bias0);
          acc[i][j][2 * half + 1] = d * (acc[i][j][2 * half + 1] + bias1);
        }
      }
  };

  TileIt cur = has_proj && !TRAIN ? TileIt{kProj, 0, 0} : TileIt{kFc1, 0, 0};
  issue(cur, buf[0]);
  cp_async_commit();
  layer_norm_rows<bf16>(a, Xs, ldx, m0, kBM);

  float hid[2][4][4];
  int cb = 0;
  while (cur.kind != kDone) {
    TileIt nxt = cur;
    advance<TRAIN>(nxt, C, H, has_proj);
    cp_async_wait_all();
    __syncthreads();  // tile `cur` (and Xs / G) visible; buf[cb ^ 1] free
    if (nxt.kind != kDone) issue(nxt, buf[cb ^ 1]);
    cp_async_commit();
    const bf16* B = buf[cb];
    if (cur.kind == kProj) {
      if (TRAIN && cur.k0 == 0) scale_mlp();
      warp_mma_32xN<NT>(acc, Xs + cur.k0, ldx, B, kLd2, min(kKW2, C - cur.k0), wr * 32,
                        wc * 8 * NT, lane);
    } else if (cur.kind == kFc1) {
      const int hc = min(kHC, H - cur.h0);
      if (cur.k0 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) hid[i][j][e] = 0.f;
      }
      warp_mma_32xN<4>(hid, Xs + cur.k0, ldx, B, kLd1, min(kKW1, C - cur.k0), wr * 32, wc * 32,
                       lane);
      if (cur.k0 + kKW1 >= C) {
        // bias (+ exact GELU) in fp32, rounded to bf16 into the chunk buffer G
        auto stage = [&](bool gelu) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = wc * 32 + j * 8 + 2 * (lane & 3);
              if (col < hc) {
                const float bias0 = __bfloat162float(b1[cur.h0 + col]);
                const float bias1 = __bfloat162float(b1[cur.h0 + col + 1]);
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const int row = wr * 32 + i * 16 + (lane >> 2) + half * 8;
                  const float h0v = hid[i][j][2 * half] + bias0;
                  const float h1v = hid[i][j][2 * half + 1] + bias1;
                  *reinterpret_cast<__nv_bfloat162*>(G + row * kLdG + col) =
                      gelu ? __floats2bfloat162_rn(gelu_erf(h0v), gelu_erf(h1v))
                           : __floats2bfloat162_rn(h0v, h1v);
                }
              }
            }
        };
        if (write_hid) {
          // B7: the pre-GELU chunk out to device memory in 16-byte pieces
          stage(false);
          __syncthreads();
          bf16* hout = static_cast<bf16*>(a.hid);
          const int per_row = hc >> 3;
          for (int idx = threadIdx.x; idx < kBM * per_row; idx += kMmaThreads) {
            const int r = idx / per_row, c8 = idx - r * per_row;
            const long long row = m0 + r;
            if (row < a.M)
              *reinterpret_cast<uint4*>(hout + row * H + cur.h0 + c8 * 8) =
                  *reinterpret_cast<const uint4*>(G + r * kLdG + c8 * 8);
          }
          __syncthreads();  // G read out before GELU overwrites it
        }
        stage(true);
      }
    } else {
      const int hc = min(kHC, H - cur.h0);
      warp_mma_32xN<NT>(acc, G + cur.k0, kLdG, B, kLd2, min(kKW2, hc - cur.k0), wr * 32,
                        wc * 8 * NT, lane);
    }
    cur = nxt;
    cb ^= 1;
  }
  if (TRAIN && !has_proj) scale_mlp();

  // K2: out = acc + b2 + (bp or x); B7: out = acc + (bp or x), acc already
  // dp-scaled with b2 in it. One rounding.
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int cl = wc * 8 * NT + j * 8 + 2 * (lane & 3);
      if (cl >= bn) continue;
      const int col = n0 + cl;
      float add0 = 0.f, add1 = 0.f;
      if (!TRAIN) {
        add0 = __bfloat162float(b2[col]);
        add1 = __bfloat162float(b2[col + 1]);
      }
      if (has_proj) {
        add0 += __bfloat162float(bp[col]);
        add1 += __bfloat162float(bp[col + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wr * 32 + i * 16 + (lane >> 2) + half * 8;
        if (row >= a.M) continue;
        float v0 = acc[i][j][2 * half] + add0, v1 = acc[i][j][2 * half + 1] + add1;
        if (!has_proj) {
          v0 += __bfloat162float(x[row * C + col]);
          v1 += __bfloat162float(x[row * C + col + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row * Cout + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <int NT, bool TRAIN>
cudaError_t launch_mma(const TailArgs& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<NT>(a.C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = mlp_tail_mma_kernel<NT, TRAIN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.M + kBM - 1) / kBM, (a.Cout + 32 * NT - 1) / (32 * NT));
  kern<<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
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
int launch_tail(const TailArgs& a, int dtype, cudaStream_t s) {
  if (dtype == kFloat32) return launch_f32<TRAIN>(a, s);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  // the narrowest column tile that holds the output (up to 384 wide)
  if (a.Cout <= 96) return launch_mma<3, TRAIN>(a, s);
  if (a.Cout <= 192) return launch_mma<6, TRAIN>(a, s);
  return launch_mma<12, TRAIN>(a, s);
}

}  // namespace
