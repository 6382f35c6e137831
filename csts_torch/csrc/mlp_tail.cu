// K2: the second half of an MViT block,
//   out = base + fc2(GELU(fc1(LN2(x)))),  base = proj(LN2(x)) if dim != dim_out else x.
//
// Replaces csts_tpu/kernels/block.py:_mlp_tail_kernel (called from
// _mlp_tail_impl). As there: LN2 with eps 1e-6 and fp32 statistics, the
// normalised rows rounded once to the activation dtype before the products,
// fc1 + bias and the exact GELU in fp32 (erff, not the TPU kernel's A&S
// polynomial), the hidden rounded to the activation dtype for fc2, fp32
// accumulation throughout, one rounding of the sum. The hidden tensor never
// reaches device memory.
//
// Bound on the H100: 2·M·(C·H + H·C_out [+ C·C_out]) operations against
// M·(C + C_out) activation bytes plus the weights, i.e. ~2·H·C/(C+C_out)
// operations per byte: 384 (d96 blocks) to 3072 (d768 blocks) per bf16 byte,
// so every site is bound by the tensor cores, not by memory.
//
// Design (bf16, the serving path): one block of 8 warps takes BM = 64 token
// rows and BN = 32·NT output columns (96, 192 or 384; a C_out of 768 takes
// two column tiles, so fc1 runs twice there). LN2 of its rows goes once into
// shared memory. The block then walks one stream of weight tiles: proj's
// tiles (BN x 64, when dim != dim_out), then per hidden chunk of 128 the fc1
// tiles (128 x 128) over C, a bias + GELU pass that puts the chunk into
// shared memory as bf16, and the fc2 tiles (BN x 64) over the chunk. Tiles
// are copied with cp.async into two buffers, so the next tile loads while
// the warps multiply the current one; rows past the weights' edge are
// zero-filled, so the product loop runs without bounds checks, which slowed
// it measurably. Products are mma.sync m16n8k16
// (bf16 in, fp32 accumulate) fed by ldmatrix; the (64 x BN) output sum stays
// in registers for the whole hidden width (each warp owns 32 x 8·NT of it).
// At dim 768 the fc weights are 4.5 MB and the hidden width 3072, far above a
// block's 227 KB; the tile stream is what lets one design serve every width.
// Ragged token counts (the fusion blocks' 260 and 8) are masked in the kernel.
//
// fp32 inputs (the exactness check against the plain version) take a simple
// body: the same chunking through shared memory with exact FMA products.
#include "common.cuh"

using namespace csts;

namespace {

struct TailArgs {
  const void *x, *ln_w, *ln_b, *w1, *b1, *w2, *b2, *wp, *bp;
  void* out;
  int M, C, H, Cout, BN;
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

__device__ __forceinline__ void advance(TileIt& s, int C, int H) {
  if (s.kind == kProj) {
    s.k0 += kKW2;
    if (s.k0 >= C) s = TileIt{kFc1, 0, 0};
  } else if (s.kind == kFc1) {
    s.k0 += kKW1;
    if (s.k0 >= C) s.kind = kFc2, s.k0 = 0;
  } else if (s.kind == kFc2) {
    s.k0 += kKW2;
    if (s.k0 >= min(kHC, H - s.h0)) s = TileIt{s.h0 + kHC < H ? kFc1 : kDone, s.h0 + kHC, 0};
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

template <int NT>
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

  TileIt cur = wp != nullptr ? TileIt{kProj, 0, 0} : TileIt{kFc1, 0, 0};
  issue(cur, buf[0]);
  cp_async_commit();
  layer_norm_rows<bf16>(a, Xs, ldx, m0, kBM);

  float acc[2][NT][4] = {};
  float hid[2][4][4];
  int cb = 0;
  while (cur.kind != kDone) {
    TileIt nxt = cur;
    advance(nxt, C, H);
    cp_async_wait_all();
    __syncthreads();  // tile `cur` (and Xs / G) visible; buf[cb ^ 1] free
    if (nxt.kind != kDone) issue(nxt, buf[cb ^ 1]);
    cp_async_commit();
    const bf16* B = buf[cb];
    if (cur.kind == kProj) {
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
        // bias + exact GELU in fp32, rounded to bf16 into the chunk buffer G
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
                *reinterpret_cast<__nv_bfloat162*>(G + row * kLdG + col) = __floats2bfloat162_rn(
                    gelu_erf(hid[i][j][2 * half] + bias0), gelu_erf(hid[i][j][2 * half + 1] + bias1));
              }
            }
          }
      }
    } else {
      const int hc = min(kHC, H - cur.h0);
      warp_mma_32xN<NT>(acc, G + cur.k0, kLdG, B, kLd2, min(kKW2, hc - cur.k0), wr * 32,
                        wc * 8 * NT, lane);
    }
    cur = nxt;
    cb ^= 1;
  }

  // out = acc + b2 + (bp or x), one rounding
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int cl = wc * 8 * NT + j * 8 + 2 * (lane & 3);
      if (cl >= bn) continue;
      const int col = n0 + cl;
      float add0 = __bfloat162float(b2[col]), add1 = __bfloat162float(b2[col + 1]);
      if (wp != nullptr) {
        add0 += __bfloat162float(bp[col]);
        add1 += __bfloat162float(bp[col + 1]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = m0 + wr * 32 + i * 16 + (lane >> 2) + half * 8;
        if (row >= a.M) continue;
        float v0 = acc[i][j][2 * half] + add0, v1 = acc[i][j][2 * half + 1] + add1;
        if (wp == nullptr) {
          v0 += __bfloat162float(x[row * C + col]);
          v1 += __bfloat162float(x[row * C + col + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + row * Cout + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <int NT>
cudaError_t launch_mma(const TailArgs& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<NT>(a.C);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = mlp_tail_mma_kernel<NT>;
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

size_t f32_smem_bytes(int C, int BN) {
  const int pad = kF32Pad;
  const int wrows = BN > kF32HC ? BN : kF32HC;
  return align128(sizeof(float) * kF32BM * (C + pad)) +
         align128(sizeof(float) * wrows * (kF32KC + pad)) +
         align128(sizeof(float) * kF32BM * kF32HC) +
         align128(sizeof(float) * kF32BM * (kF32HC + pad)) +
         align128(sizeof(float) * BN * (kF32HC + pad)) + align128(sizeof(float) * kF32BM * BN);
}

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

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bn = min(BN, Cout - n0);

  layer_norm_rows<float>(a, Xs, ldx, m0, BM);
  for (int idx = tid; idx < BM * BN; idx += kF32Threads) Oacc[idx] = 0.f;
  __syncthreads();

  // base = proj(LN2(x)) for the dim-changing blocks
  if (wp != nullptr) {
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
  }

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
      Ht[r * ldh + j] = gelu_erf(Hf[r * kF32HC + j] + b1[h0 + j]);
    }
    for (int idx = tid; idx < bn * hc; idx += kF32Threads) {
      const int n = idx / hc, kk = idx - n * hc;
      W2t[n * ldh + kk] = w2[(long long)(n0 + n) * H + h0 + kk];
    }
    __syncthreads();
    smem_gemm<true>(Oacc, BN, Ht, ldh, W2t, ldh, BM, bn, hc, true);
    __syncthreads();
  }

  for (int idx = tid; idx < BM * bn; idx += kF32Threads) {
    const int r = idx / bn, j = idx - r * bn;
    const long long row = m0 + r;
    if (row >= a.M) continue;
    const int col = n0 + j;
    float o = Oacc[r * BN + j] + b2[col];
    o += wp != nullptr ? bp[col] : x[row * C + col];
    out[row * Cout + col] = o;
  }
}

cudaError_t launch_f32(TailArgs a, cudaStream_t stream) {
  // one column tile when the output is narrow, 128-wide tiles otherwise
  a.BN = a.Cout <= 192 ? a.Cout : 128;
  const size_t smem = f32_smem_bytes(a.C, a.BN);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mlp_tail_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.M + kF32BM - 1) / kF32BM, (a.Cout + a.BN - 1) / a.BN);
  mlp_tail_f32_kernel<<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int csts_mlp_tail(int dtype, const void* x, const void* ln_w, const void* ln_b,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* wp, const void* bp, void* out, int M, int C, int H,
                             int Cout, float eps, void* stream) {
  TailArgs a{x, ln_w, ln_b, w1, b1, w2, b2, wp, bp, out, M, C, H, Cout, 0, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_f32(a, s);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  // the narrowest column tile that holds the output (up to 384 wide)
  if (Cout <= 96) return launch_mma<3>(a, s);
  if (Cout <= 192) return launch_mma<6>(a, s);
  return launch_mma<12>(a, s);
}
