// Shared body of the whole-block kernels B3 (block.cu; at 3-8 heads also
// B9b/B9c), B4 (pool_block.cu) and B5 (decoder_block.cu). One thread block of 8 warps takes BM = 32·WR
// output tokens of one clip and runs the whole block on them:
//
//   Q      B3: LN1(x) · Wq + bq
//          B4: depthwise 3x3x3 conv at stride (1,2,2) over the fine Q, norm_q
//          B5: depthwise transposed 3x3x3 conv over the coarse Q, norm_q
//   attention per head against the pooled K/V (online softmax over chunks)
//   res1 = skip + Σ_h av_h · Wproj_h + bproj          (fp32, never rounded)
//   out  = base + fc2(GELU(fc1(LN2(res1))))           base = proj(LN2) or res1
//
// Q, the attention output, res1 and LN2 stay in shared memory and registers;
// only x (or Q), the pooled K/V, the skip and the weights are read, and only
// the output is written. The rounding points are the TPU kernels': LN1 and
// LN2 rounded to the activation dtype before their products, q rounded per
// head (after the conv and norm_q, both in fp32, for B4 and B5), the
// probabilities rounded before P·V (unnormalised, as in K1), av rounded
// before proj, the hidden rounded before fc2, one rounding of the output.
//
// Bound on the H100: every flagship site does 90-300 tensor-core operations
// per byte it must move, so the products bound it; the design keeps them on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix, with the
// weights streamed through two shared-memory tile buffers with cp.async
// (tiles widened along the reduction for narrow outputs) and the K/V chunks
// through a ring of up to four. A block holds ~140-228 KB of shared memory
// and up to 255 registers a thread, so one block (8 warps) runs on an SM:
// each phase's latency shows, which is what keeps the kernels ~15-25x off
// their bound (PERF.md); wgmma, TMA and more warps are later work.
//
// Warp layouts: the products give each warp 32 rows x 8·NT columns (WR warps
// along rows, WC = 8/WR along columns); the attention gives each warp 16
// query rows and a 1/KS share of every 64-key chunk (RW = 2·WR row warps,
// KS = 8/RW key splits), so all 8 warps work on one head at a time whatever
// the head count, and the KS partial softmax states merge through shared
// memory at the end. Ragged edges are masked here: rows past L are zero and
// not stored, keys past Lk get -inf, conv taps outside the grid are skipped.
#pragma once

#include "common.cuh"

namespace csts {
namespace fb {

using bf16 = __nv_bfloat16;

enum { kBlock = 0, kPool = 1, kDecoder = 2 };

constexpr int kThreads = 256;
constexpr int kHC = 128;         // hidden chunk of the MLP
constexpr int kKW1 = 128;        // reduction width of an fc1 tile
// reduction width of an fc2 / tail proj tile (BN rows), or of an attention
// proj / Wq tile (BNP rows): wide tiles for narrow outputs, so that every
// tile step carries enough products to cover the next tile's load
__host__ __device__ constexpr int tile_kw(int rows) {
  return rows <= 192 ? 128 : rows <= 384 ? 64 : 32;
}
constexpr int kLdG = kHC + 8;    // GELU chunk row stride
constexpr int kBK = 64;          // keys per attention chunk
constexpr float kLnEps = 1e-6f;  // LN1 / LN2
constexpr float kQEps = 1e-5f;   // norm_q (torch's default, as the reference)

struct Args {
  const void *x, *q, *skip, *k, *v;
  const void *ln1_w, *ln1_b, *wq, *bq, *wconv, *nq_w, *nq_b, *wproj, *bproj;
  const void *ln2_w, *ln2_b, *w1, *b1, *w2, *b2, *wp, *bp;
  void* out;
  long long q_rs;      // row stride of q, elements
  int L, C, Cout, H, N, hd, Lk;
  int T, Hh, W;        // output grid (B4: coarse, B5: fine)
  int Ts, Hs, Ws;      // grid of q (B4: fine, B5: coarse)
  int st, sh, sw;      // conv strides
  float scale;
};

// --- sizes, shared by the host launch and the device carve ------------------

template <int WR, int NTP, int NT>
struct Plan {
  static constexpr int BM = 32 * WR, WC = 8 / WR, RW = 2 * WR, KS = 8 / RW;
  static constexpr int BN = WC * 8 * NT;    // tail column tile
  static constexpr int BNP = WC * 8 * NTP;  // attention-proj / Wq column tile (covers C)
  static constexpr int KW2 = tile_kw(BN), KWP = tile_kw(BNP);
  static constexpr int NT1 = 16 / WC;       // fc1 n8 tiles per warp (128-wide chunk)
  static constexpr int TILE = (kHC * (kKW1 + 8) > BN * (KW2 + 8))
                                  ? (kHC * (kKW1 + 8) > BNP * (KWP + 8) ? kHC * (kKW1 + 8)
                                                                        : BNP * (KWP + 8))
                                  : (BN * (KW2 + 8) > BNP * (KWP + 8) ? BN * (KW2 + 8)
                                                                      : BNP * (KWP + 8));
  __host__ __device__ static size_t kv_bytes(int hd) { return 4 * align128(sizeof(bf16) * kBK * (hd + 8)); }
  __host__ __device__ static size_t merge_bytes(int hd) {
    return sizeof(float) * RW * (KS - 1) * (16 * hd + 32);
  }
  __host__ __device__ static size_t region_bytes(int C, int hd) {
    size_t r = 2 * align128(sizeof(bf16) * TILE);
    const size_t kv = kv_bytes(hd), mg = merge_bytes(hd), res = sizeof(float) * BM * (C + 4);
    if (kv > r) r = kv;
    if (mg > r) r = mg;
    if (res > r) r = res;
    return align128(r);
  }
  __host__ __device__ static size_t smem_bytes(int C, int hd) {
    return 2 * align128(sizeof(bf16) * BM * (C + 8)) + align128(sizeof(bf16) * BM * kLdG) +
           region_bytes(C, hd);
  }
};

// --- loads ------------------------------------------------------------------

// rows x kc (multiple of 8) bf16 from global (row stride ld) into shared (row
// stride ldb) with cp.async; rows from `valid` on are zero-filled
__device__ __forceinline__ void load_tile(bf16* buf, int ldb, const bf16* src, int rows,
                                          int valid, long long ld, int kc) {
  const int per_row = kc >> 3;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, c8 = idx - r * per_row;
    const bool ok = r < valid;
    cp_async16_zfill(buf + r * ldb + c8 * 8, ok ? src + r * ld + c8 * 8 : src, ok);
  }
}

// LayerNorm of segments: row r's segments seg = 0 .. per_row-1 of `len`
// values (at src + r·lds + seg·len) normalised with fp32 two-pass statistics
// and weight / bias indexed within the segment, into dst (row stride ldd).
// LN1 and LN2 are one segment a row, norm_q one a head. g threads share a
// segment (g a power of two, as many as the block has for the segments), so
// that all 256 threads work; rows from `valid` on are zero. With `wb` (2·len
// floats of shared memory) the weight and bias are read from there, copied
// once, instead of from global memory for every segment.
template <typename TI, typename TO>
__device__ void seg_norm(const TI* __restrict__ src, long long lds, TO* __restrict__ dst, int ldd,
                         int rows, int valid, int per_row, int len, const TO* __restrict__ w,
                         const TO* __restrict__ b, float eps, float* wb = nullptr) {
  if (wb != nullptr) {
    for (int c = threadIdx.x; c < len; c += kThreads) {
      wb[c] = to_f32(w[c]);
      wb[len + c] = to_f32(b[c]);
    }
    __syncthreads();
  }
  // at least 4 threads a segment, consecutive segments on consecutive rows:
  // with row strides of 4 mod 32 words that keeps the shared reads of a warp
  // on distinct banks
  const int items = rows * per_row;
  int g = 32;
  while (g > 4 && g * items > kThreads) g >>= 1;
  for (int base = 0; base < items * g; base += kThreads) {
    const int t = base + threadIdx.x, item = t / g, sub = t & (g - 1);
    const bool on = item < items;
    const int seg = on ? item / rows : 0, r = on ? item - seg * rows : 0;
    const bool live = on && r < valid;
    const TI* s = src + r * lds + seg * len;
    float sum = 0.f;
    if (live)
#pragma unroll 4
      for (int c = sub; c < len; c += g) sum += to_f32(s[c]);
    for (int o = 1; o < g; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / len;
    float var = 0.f;
    if (live)
#pragma unroll 4
      for (int c = sub; c < len; c += g) {
        const float d = to_f32(s[c]) - mean;
        var += d * d;
      }
    for (int o = 1; o < g; o <<= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
    const float rstd = rsqrtf(var / len + eps);
    if (on) {
      TO* d = dst + r * ldd + seg * len;
#pragma unroll 4
      for (int c = sub; c < len; c += g) {
        const float wc = wb != nullptr ? wb[c] : to_f32(w[c]);
        const float bc = wb != nullptr ? wb[len + c] : to_f32(b[c]);
        d[c] = from_f32<TO>(live ? (to_f32(s[c]) - mean) * rstd * wc + bc : 0.f);
      }
    }
  }
}

// source index along one axis of the Q conv for output index o and tap k:
// B4 is a forward conv (stride s, pad 1), B5 a transposed one (stride s,
// pad 1, output_padding s-1): fine 2m takes tap 1 of m, 2m+1 taps 0 of m+1
// and 2 of m at stride 2 — the tap order flips against the forward conv
template <int MODE>
__device__ __forceinline__ bool src_index(int o, int k, int s, int n, int& i) {
  if constexpr (MODE == kPool) {
    i = o * s + k - 1;
    return i >= 0 && i < n;
  } else {
    const int num = o + 1 - k;
    if (num < 0 || num % s) return false;
    i = num / s;
    return i < n;
  }
}

// eight consecutive values (16-byte aligned), loaded raw, converted later
template <typename T>
struct Raw8;
template <>
struct Raw8<bf16> {
  uint4 v;
};
template <>
struct Raw8<float> {
  float4 lo, hi;
};
__device__ __forceinline__ Raw8<bf16> load_raw8(const bf16* p) {
  return Raw8<bf16>{*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ Raw8<float> load_raw8(const float* p) {
  return Raw8<float>{*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ void raw8_to_f32(const Raw8<bf16>& r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void raw8_to_f32(const Raw8<float>& r, float (&v)[8]) {
  v[0] = r.lo.x, v[1] = r.lo.y, v[2] = r.lo.z, v[3] = r.lo.w;
  v[4] = r.hi.x, v[5] = r.hi.y, v[6] = r.hi.z, v[7] = r.hi.w;
}

// Q of rows m0 .. m0+rows for every head: the depthwise (transposed) conv of
// the source Q in fp32 into S (row stride lds), then norm_q per head, rounded
// once into Qs. The conv gives each thread eight channels of one row (one
// 16-byte load a tap; a source frame's nine taps load together) and reads its
// weights from shared memory (Wc, 27·hd floats).
template <int MODE, int HDM, typename T>
__device__ void conv_q(const Args& a, int b, int m0, int rows, float* S, int lds, float* Wc,
                       T* Qs, int ldq, float* wb) {
  const int N = a.N, hd = a.hd, C = a.C;
  const T* qb = static_cast<const T*>(a.q) + (long long)b * a.Ts * a.Hs * a.Ws * a.q_rs;
  const T* wconv = static_cast<const T*>(a.wconv);  // (27, hd), tap-major
  const int hw = a.Hh * a.W;
  for (int i = threadIdx.x; i < 27 * hd; i += kThreads) Wc[i] = to_f32(wconv[i]);
  __syncthreads();
  const int chunks = C >> 3;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c0 = (idx - r * chunks) * 8, d0 = c0 % hd, row = m0 + r;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row < a.L) {
      const int t = row / hw, y = (row - t * hw) / a.W, xx = row - t * hw - y * a.W;
      // source index and validity of each tap along each axis; invalid taps
      // load nothing and add nothing
      int ti[3], yi[3], xi[3];
      bool tv[3], yv[3], xv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        tv[k] = src_index<MODE>(t, k, a.st, a.Ts, ti[k]);
        yv[k] = src_index<MODE>(y, k, a.sh, a.Hs, yi[k]);
        xv[k] = src_index<MODE>(xx, k, a.sw, a.Ws, xi[k]);
      }
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        if (!tv[kt]) continue;
        Raw8<T> raw[9];
#pragma unroll
        for (int j = 0; j < 9; ++j)
          raw[j] = yv[j / 3] && xv[j % 3]
                       ? load_raw8(qb + ((long long)(ti[kt] * a.Hs + yi[j / 3]) * a.Ws +
                                         xi[j % 3]) * a.q_rs + c0)
                       : Raw8<T>{};
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          if (yv[j / 3] && xv[j % 3]) {
            float q[8], w[8];
            raw8_to_f32(raw[j], q);
            // 16-byte shared loads: scalar ones would conflict 8 ways
            raw8_to_f32(load_raw8(Wc + (kt * 9 + j) * hd + d0), w);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = fmaf(w[i], q[i], acc[i]);
          }
        }
      }
    }
    float4* out = reinterpret_cast<float4*>(S + r * lds + c0);
    out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  seg_norm<float, T>(S, lds, Qs, ldq, rows, a.L - m0, N, hd, static_cast<const T*>(a.nq_w),
                     static_cast<const T*>(a.nq_b), kQEps, wb);
}

// --- bf16 products ----------------------------------------------------------

// acc (each warp 32 x 8·NT, the block BM x BN) += A[BM x K] · W[0..BN, 0..K)ᵀ,
// W in nn.Linear layout (row stride ldw, rows from `nvalid` on read as zero),
// streamed in KW-wide tiles through two buffers. Synchronises at its start
// (inputs visible) and its end (buffers free).
template <int WR, int NT, int KW>
__device__ void stream_gemm(float (&acc)[2][NT][4], const bf16* A, int lda, const bf16* W,
                            long long ldw, int nvalid, int K, bf16* buf0, bf16* buf1) {
  constexpr int WC = 8 / WR, BN = WC * 8 * NT, LDT = KW + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WC, wc = warp % WC;
  bf16* buf[2] = {buf0, buf1};
  __syncthreads();
  load_tile(buf[0], LDT, W, BN, nvalid, ldw, min(KW, K));
  cp_async_commit();
  int cb = 0;
  for (int k0 = 0; k0 < K; k0 += KW) {
    cp_async_wait_all();
    __syncthreads();
    if (k0 + KW < K)
      load_tile(buf[cb ^ 1], LDT, W + k0 + KW, BN, nvalid, ldw, min(KW, K - k0 - KW));
    cp_async_commit();
    warp_mma_32xN<NT>(acc, A + k0, lda, buf[cb], LDT, min(KW, K - k0), wr * 32, wc * 8 * NT,
                      lane);
    cb ^= 1;
  }
  __syncthreads();
}

// fragment (i, j, e) of a warp's 32 x 8·NT accumulator: its row and column
__device__ __forceinline__ int frag_row(int wr, int i, int e, int lane) {
  return wr * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
}
template <int NT>
__device__ __forceinline__ int frag_col(int wc, int j, int e, int lane) {
  return wc * 8 * NT + j * 8 + 2 * (lane & 3) + (e & 1);
}

// acc += bias[col] (+ rows[r·ld + col] for rows r < valid) over a warp's
// fragments, columns n0 + the fragment's below `cols`. All loads happen
// before the caller's stores, so they go out together.
template <int NT>
__device__ __forceinline__ void add_pairs(float (&acc)[2][NT][4], const bf16* bias,
                                          const bf16* rows, long long ld, int cols, int n0,
                                          int valid, int wr, int wc, int lane) {
  const int WC8NT = 8 * NT;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = n0 + wc * WC8NT + j * 8 + 2 * (lane & 3);
    if (c >= cols) continue;
    const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + c));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v = bv;
        const int r = frag_row(wr, i, 2 * h, lane);
        if (rows != nullptr && r < valid) {
          const float2 sk = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(rows + (long long)r * ld + c));
          v.x += sk.x;
          v.y += sk.y;
        }
        acc[i][j][2 * h] += v.x;
        acc[i][j][2 * h + 1] += v.y;
      }
  }
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// The MLP tail of one column tile [n0, n0+BN): acc += [proj(Xs)] + fc2(GELU(
// fc1(Xs) + b1)), one stream of weight tiles (proj tiles, then per hidden
// chunk its fc1 tiles and fc2 tiles), as K2 (mlp_tail.cu) walks it.
template <int WR, int NT>
__device__ void tail_tile(float (&acc)[2][NT][4], const Args& a, const bf16* Xs, int ldx, int n0,
                          bf16* G, bf16* buf0, bf16* buf1) {
  constexpr int WC = 8 / WR, BN = WC * 8 * NT, NT1 = 16 / WC;
  constexpr int kKW2 = tile_kw(BN), kLd1 = kKW1 + 8, kLd2 = kKW2 + 8;
  enum { kProj = 0, kFc1 = 1, kFc2 = 2, kDone = 3 };
  const int C = a.C, H = a.H;
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* b1 = static_cast<const bf16*>(a.b1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* wp = static_cast<const bf16*>(a.wp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WC, wc = warp % WC;
  const int bn = min(BN, a.Cout - n0);
  bf16* buf[2] = {buf0, buf1};
  struct It {
    int kind, h0, k0;
  };
  auto advance = [&](It& s) {
    if (s.kind == kProj) {
      s.k0 += kKW2;
      if (s.k0 >= C) s = It{kFc1, 0, 0};
    } else if (s.kind == kFc1) {
      s.k0 += kKW1;
      if (s.k0 >= C) s.kind = kFc2, s.k0 = 0;
    } else if (s.kind == kFc2) {
      s.k0 += kKW2;
      if (s.k0 >= min(kHC, H - s.h0)) s = It{s.h0 + kHC < H ? kFc1 : kDone, s.h0 + kHC, 0};
    }
  };
  auto prefetch = [&](const It& s, bf16* dst) {
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
  It cur = wp != nullptr ? It{kProj, 0, 0} : It{kFc1, 0, 0};
  __syncthreads();
  prefetch(cur, buf[0]);
  cp_async_commit();
  float hid[2][NT1][4];
  int cb = 0;
  while (cur.kind != kDone) {
    It nxt = cur;
    advance(nxt);
    cp_async_wait_all();
    __syncthreads();
    if (nxt.kind != kDone) prefetch(nxt, buf[cb ^ 1]);
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
          for (int j = 0; j < NT1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) hid[i][j][e] = 0.f;
      }
      warp_mma_32xN<NT1>(hid, Xs + cur.k0, ldx, B, kLd1, min(kKW1, C - cur.k0), wr * 32,
                         wc * 8 * NT1, lane);
      if (cur.k0 + kKW1 >= C) {
        // the biases load before any store, so the loads go out together
        float2 bias[NT1];
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          const int col = wc * 8 * NT1 + j * 8 + 2 * (lane & 3);
          bias[j] = col < hc ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                   b1 + cur.h0 + col))
                             : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            const int col = wc * 8 * NT1 + j * 8 + 2 * (lane & 3);
            if (col < hc) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int row = wr * 32 + i * 16 + (lane >> 2) + half * 8;
                *reinterpret_cast<__nv_bfloat162*>(G + row * kLdG + col) =
                    __floats2bfloat162_rn(gelu_erf(hid[i][j][2 * half] + bias[j].x),
                                          gelu_erf(hid[i][j][2 * half + 1] + bias[j].y));
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
  __syncthreads();
}

// rows x hd bf16 K or V rows (contiguous, row stride hd) into shared memory
// (row stride hd + 8), zeros for rows at or past `valid`
__device__ __forceinline__ void load_kv(bf16* dst, const bf16* src, int hd, int valid) {
  const int per_row = hd >> 3, ld = hd + 8;
  for (int idx = threadIdx.x; idx < kBK * per_row; idx += kThreads) {
    const int r = idx / per_row, c8 = idx - r * per_row;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * ld + c8 * 8, ok ? src + (long long)r * hd + c8 * 8 : src, ok);
  }
}

// av of one head for the block's BM rows: softmax(Q_h K_hᵀ · scale) V_h,
// Q_h = Qs[:, qcol .. qcol+hd) (bf16), K_h / V_h (Lk x hd, global), written
// normalised and rounded into AVs[:, qcol .. qcol+hd). `region` holds a ring
// of `stages` K/V chunk buffers (2 to 4, as many as fit: the loads of the
// next chunks are in flight while one is used), then the merge scratch.
// Synchronises at both ends.
template <int WR, int HDM>
__device__ void attention_head(const bf16* Qs, int ldq, int qcol, const bf16* kh, const bf16* vh,
                               int Lk, int hd, float scale, bf16* AVs, unsigned char* region,
                               int stages) {
  constexpr int RW = 2 * WR, KS = 8 / RW, KW = kBK / KS, ST = KW / 8, DT = HDM / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % RW, ks = warp / RW;
  const int g = lane >> 2, t4 = lane & 3;
  const int ld = hd + 8;
  const size_t kvb = align128(sizeof(bf16) * kBK * ld);
  auto slot_k = [&](int i) { return reinterpret_cast<bf16*>(region + (i % stages) * 2 * kvb); };
  auto slot_v = [&](int i) {
    return reinterpret_cast<bf16*>(region + (i % stages) * 2 * kvb + kvb);
  };
  auto prefetch = [&](int i) {  // key chunk i into its ring slot (nothing past Lk)
    if (i * kBK < Lk) {
      load_kv(slot_k(i), kh + (long long)i * kBK * hd, hd, Lk - i * kBK);
      load_kv(slot_v(i), vh + (long long)i * kBK * hd, hd, Lk - i * kBK);
    }
    cp_async_commit();
  };
  __syncthreads();  // Qs written; region free
  for (int i = 0; i < stages - 1; ++i) prefetch(i);

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const bf16* Qw = Qs + rw * 16 * ldq + qcol;
  const int kb0 = ks * KW;

  for (int ci = 0, c0 = 0; c0 < Lk; ++ci, c0 += kBK) {
    cp_async_wait_pending(stages - 2);
    __syncthreads();  // chunk ci visible; the slot of chunk ci-1 free
    prefetch(ci + stages - 1);
    const bf16* K = slot_k(ci);
    const bf16* V = slot_v(ci);

    float s[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int k = 0; k < HDM; k += 16) {
      if (k < hd) {
        uint32_t qa[4];
        ldmatrix_x4(qa, Qw + (lane & 15) * ldq + k + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < ST; np += 2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, K + (kb0 + np * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld + k +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[np], qa, kf[0], kf[1]);
          mma_bf16_16816(s[np + 1], qa, kf[2], kf[3]);
        }
      }
    }

    // online softmax in fp32 (entries 0,1 of a tile are row g, 2,3 row g + 8);
    // a warp may see no valid key in a chunk, so -inf maxima are guarded
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + kb0 + nt * 8 + 2 * t4 + (e & 1);
        const float val = col < Lk ? s[nt][e] * scale : -INFINITY;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = expf(m_run[h] - m_use[h]);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = pe;
        sum[e >> 1] += pe;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_run[h] = l_run[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < ST / 2; ++j) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * j][0], s[2 * j][1]),
                              pack_bf16x2(s[2 * j][2], s[2 * j][3]),
                              pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT; dp += 2) {
        if (dp * 8 < hd) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, V + (kb0 + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                    dp * 8 + (lane >> 4) * 8);
          mma_bf16_16816(o[dp], pa, vf[0], vf[1]);
          mma_bf16_16816(o[dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // K/V buffers free: the merge scratch takes the region

  // merge the KS key splits of each row: warps ks > 0 publish (o, m, l)
  float* scr = reinterpret_cast<float*>(region);
  const int slot = 16 * hd + 32;
  if (ks > 0) {
    float* sl = scr + ((ks - 1) * RW + rw) * slot;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      if (dt * 8 < hd) {
        const int col = dt * 8 + 2 * t4;
        sl[g * hd + col] = o[dt][0];
        sl[g * hd + col + 1] = o[dt][1];
        sl[(g + 8) * hd + col] = o[dt][2];
        sl[(g + 8) * hd + col + 1] = o[dt][3];
      }
    }
    if (t4 == 0) {
      sl[16 * hd + g] = m_run[0];
      sl[16 * hd + g + 8] = m_run[1];
      sl[16 * hd + 16 + g] = l_run[0];
      sl[16 * hd + 16 + g + 8] = l_run[1];
    }
  }
  __syncthreads();
  if (ks == 0) {
    float f[KS][2], mm[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      mm[h] = m_run[h];
#pragma unroll
      for (int j = 1; j < KS; ++j)
        mm[h] = fmaxf(mm[h], scr[((j - 1) * RW + rw) * slot + 16 * hd + r]);
      f[0][h] = expf(m_run[h] - mm[h]);
      float l = l_run[h] * f[0][h];
#pragma unroll
      for (int j = 1; j < KS; ++j) {
        const float* sl = scr + ((j - 1) * RW + rw) * slot;
        f[j][h] = expf(sl[16 * hd + r] - mm[h]);
        l += sl[16 * hd + 16 + r] * f[j][h];
      }
      inv[h] = 1.f / l;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      if (dt * 8 < hd) {
        const int col = dt * 8 + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          float v0 = o[dt][2 * h] * f[0][h], v1 = o[dt][2 * h + 1] * f[0][h];
#pragma unroll
          for (int j = 1; j < KS; ++j) {
            const float* sl = scr + ((j - 1) * RW + rw) * slot;
            v0 += sl[r * hd + col] * f[j][h];
            v1 += sl[r * hd + col + 1] * f[j][h];
          }
          *reinterpret_cast<__nv_bfloat162*>(AVs + (rw * 16 + r) * ldq + qcol + col) =
              __floats2bfloat162_rn(v0 * inv[h], v1 * inv[h]);
        }
      }
    }
  }
  __syncthreads();  // AVs written; scratch free
}

// --- the bf16 kernel --------------------------------------------------------

template <int MODE, int WR, int NTP, int NT, int HDM>
__global__ void __launch_bounds__(kThreads, 1) block_mma_kernel(Args a) {
  using P = Plan<WR, NTP, NT>;
  constexpr int BM = P::BM, WC = P::WC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C, ldc = C + 8, ldr = C + 4;
  unsigned char* p = smem_raw;
  bf16* Qs = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * BM * ldc));   // Q, then LN2
  bf16* AVs = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * BM * ldc));  // LN1, then av
  bf16* G = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * BM * kLdG));
  unsigned char* region = p;  // weight tiles | K/V chunks | merge scratch | res1
  bf16* buf0 = reinterpret_cast<bf16*>(region);
  bf16* buf1 = reinterpret_cast<bf16*>(region + align128(sizeof(bf16) * P::TILE));
  float* R = reinterpret_cast<float*>(region);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WC, wc = warp % WC;
  const int b = blockIdx.y, m0 = blockIdx.x * BM;
  const int valid = min(BM, a.L - m0);
  const long long row0 = (long long)b * a.L + m0;

  // ---- Q ----
  if constexpr (MODE == kBlock) {
    const bf16* x = static_cast<const bf16*>(a.x) + row0 * C;
    seg_norm<bf16, bf16>(x, C, AVs, ldc, BM, valid, 1, C, static_cast<const bf16*>(a.ln1_w),
                         static_cast<const bf16*>(a.ln1_b), kLnEps, reinterpret_cast<float*>(G));
    float acc[2][NTP][4] = {};
    stream_gemm<WR, NTP, P::KWP>(acc, AVs, ldc, static_cast<const bf16*>(a.wq), C, C, C, buf0,
                                 buf1);
    add_pairs<NTP>(acc, static_cast<const bf16*>(a.bq), nullptr, 0, C, 0, C, wr, wc, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTP; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = frag_row(wr, i, e, lane), c = frag_col<NTP>(wc, j, e, lane);
          if (c < C)
            *reinterpret_cast<__nv_bfloat162*>(Qs + r * ldc + c) =
                __floats2bfloat162_rn(acc[i][j][e], acc[i][j][e + 1]);
        }
  } else {
    conv_q<MODE, HDM, bf16>(a, b, m0, BM, R, ldr, reinterpret_cast<float*>(AVs), Qs, ldc,
                            reinterpret_cast<float*>(G));
  }

  // ---- attention, head by head ----
  const long long kv_b = (long long)b * a.N * a.Lk * a.hd;
  const int stages = min(4, static_cast<int>(P::region_bytes(C, a.hd) /
                                             (2 * align128(sizeof(bf16) * kBK * (a.hd + 8)))));
  for (int h = 0; h < a.N; ++h) {
    const long long off = kv_b + (long long)h * a.Lk * a.hd;
    attention_head<WR, HDM>(Qs, ldc, h * a.hd, static_cast<const bf16*>(a.k) + off,
                            static_cast<const bf16*>(a.v) + off, a.Lk, a.hd, a.scale, AVs,
                            region, stages);
  }

  // ---- res1 = skip + av · Wprojᵀ + bproj, fp32 into the region ----
  {
    float acc[2][NTP][4] = {};
    stream_gemm<WR, NTP, P::KWP>(acc, AVs, ldc, static_cast<const bf16*>(a.wproj), C, C, C,
                                 buf0, buf1);
    const bf16* skip = static_cast<const bf16*>(MODE == kBlock ? a.x : a.skip) + row0 * C;
    add_pairs<NTP>(acc, static_cast<const bf16*>(a.bproj), skip, C, C, 0, valid, wr, wc, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NTP; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = frag_row(wr, i, e, lane), c = frag_col<NTP>(wc, j, e, lane);
          if (c < C) *reinterpret_cast<float2*>(R + r * ldr + c) = make_float2(acc[i][j][e], acc[i][j][e + 1]);
        }
  }
  __syncthreads();
  seg_norm<float, bf16>(R, ldr, Qs, ldc, BM, valid, 1, C, static_cast<const bf16*>(a.ln2_w),
                        static_cast<const bf16*>(a.ln2_b), kLnEps, reinterpret_cast<float*>(G));

  // ---- MLP tail, column tile by column tile ----
  const bool identity = a.wp == nullptr;  // base = res1: one tile, NT == NTP (host checks)
  bf16* out = static_cast<bf16*>(a.out) + row0 * a.Cout;
  const bf16* b2 = static_cast<const bf16*>(a.b2);
  const bf16* bp = static_cast<const bf16*>(a.bp);
  for (int n0 = 0; n0 < a.Cout; n0 += P::BN) {
    float acc[2][NT][4] = {};
    if constexpr (NT == NTP) {
      if (identity) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = frag_col<NT>(wc, j, e, lane);
              if (c < C) acc[i][j][e] = R[frag_row(wr, i, e, lane) * ldr + c];
            }
      }
    }
    tail_tile<WR, NT>(acc, a, Qs, ldc, n0, G, buf0, buf1);
    add_pairs<NT>(acc, b2, nullptr, 0, a.Cout, n0, valid, wr, wc, lane);
    if (!identity) add_pairs<NT>(acc, bp, nullptr, 0, a.Cout, n0, valid, wr, wc, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = frag_row(wr, i, e, lane), c = n0 + frag_col<NT>(wc, j, e, lane);
          if (r >= valid || c >= a.Cout) continue;
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * a.Cout + c) =
              __floats2bfloat162_rn(acc[i][j][e], acc[i][j][e + 1]);
        }
  }
}

template <int MODE, int WR, int NTP, int NT, int HDM>
cudaError_t launch_mma(const Args& a, int B, cudaStream_t stream) {
  using P = Plan<WR, NTP, NT>;
  const size_t smem = P::smem_bytes(a.C, a.hd);
  // the Q conv's weight (27·hd fp32) borrows the av buffer during the Q phase
  if (smem > kMaxSmem || 27 * 4 * a.hd > 2 * P::BM * (a.C + 8)) return cudaErrorInvalidValue;
  auto kern = block_mma_kernel<MODE, WR, NTP, NT, HDM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + P::BM - 1) / P::BM, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// --- fp32: exact FMA body, everything through shared memory -----------------
//
// The parity check against the plain version (TF32 off): the same phases on
// kF32BM rows with exact fp32 products (smem_gemm, weights read from global),
// the whole logit row of a head in shared memory.

constexpr int kF32BM = 8;

inline size_t f32_smem_bytes(int C, int Cout, int Lk, int hd) {
  return sizeof(float) * (kF32BM * (3 * (C + 4) + Lk + Cout + 64) + 27 * hd) + 7 * 128;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) block_f32_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BM = kF32BM;
  const int C = a.C, Cout = a.Cout, H = a.H, hd = a.hd, Lk = a.Lk, ldc = C + 4;
  unsigned char* p = smem_raw;
  float* Qf = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * ldc));  // Q, then LN2
  float* Af = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * ldc));  // LN1, then av
  float* R = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * ldc));
  float* S = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * Lk));
  float* O = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * Cout));
  float* Hf = reinterpret_cast<float*>(carve(p, sizeof(float) * BM * 64));
  float* Wc = reinterpret_cast<float*>(carve(p, sizeof(float) * 27 * hd));  // Q conv weight
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, m0 = blockIdx.x * BM;
  const int valid = min(BM, a.L - m0);
  const long long row0 = (long long)b * a.L + m0;
  const float* x = static_cast<const float*>(a.x);

  if constexpr (MODE == kBlock) {
    seg_norm<float, float>(x + row0 * C, C, Af, ldc, BM, valid, 1, C,
                           static_cast<const float*>(a.ln1_w), static_cast<const float*>(a.ln1_b),
                           kLnEps);
    __syncthreads();
    smem_gemm<true>(Qf, ldc, Af, ldc, static_cast<const float*>(a.wq), C, BM, C, C, false);
    __syncthreads();
    const float* bq = static_cast<const float*>(a.bq);
    for (int idx = tid; idx < BM * C; idx += kThreads) Qf[(idx / C) * ldc + idx % C] += bq[idx % C];
  } else {
    conv_q<MODE, 256, float>(a, b, m0, BM, R, ldc, Wc, Qf, ldc, nullptr);
  }
  __syncthreads();

  for (int h = 0; h < a.N; ++h) {
    const long long off = ((long long)b * a.N + h) * Lk * hd;
    const float* kh = static_cast<const float*>(a.k) + off;
    const float* vh = static_cast<const float*>(a.v) + off;
    smem_gemm<true>(S, Lk, Qf + h * hd, ldc, kh, hd, BM, Lk, hd, false);
    __syncthreads();
    for (int r = warp; r < BM; r += kThreads / 32) {
      float mx = -INFINITY;
      for (int c = lane; c < Lk; c += 32) mx = fmaxf(mx, S[r * Lk + c] * a.scale);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int c = lane; c < Lk; c += 32) {
        const float e = expf(S[r * Lk + c] * a.scale - mx);
        S[r * Lk + c] = e;
        sum += e;
      }
      const float inv = 1.f / warp_sum(sum);
      for (int c = lane; c < Lk; c += 32) S[r * Lk + c] *= inv;
    }
    __syncthreads();
    smem_gemm<false>(Af + h * hd, ldc, S, Lk, vh, hd, BM, hd, Lk, false);
    __syncthreads();
  }

  smem_gemm<true>(R, ldc, Af, ldc, static_cast<const float*>(a.wproj), C, BM, C, C, false);
  __syncthreads();
  const float* skip = static_cast<const float*>(MODE == kBlock ? a.x : a.skip) + row0 * C;
  const float* bproj = static_cast<const float*>(a.bproj);
  for (int idx = tid; idx < BM * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    R[r * ldc + c] += bproj[c] + (r < valid ? skip[(long long)r * C + c] : 0.f);
  }
  __syncthreads();
  seg_norm<float, float>(R, ldc, Qf, ldc, BM, valid, 1, C, static_cast<const float*>(a.ln2_w),
                         static_cast<const float*>(a.ln2_b), kLnEps);
  __syncthreads();

  const float* wp = static_cast<const float*>(a.wp);
  if (wp != nullptr) {
    smem_gemm<true>(O, Cout, Qf, ldc, wp, C, BM, Cout, C, false);
  } else {
    for (int idx = tid; idx < BM * Cout; idx += kThreads) O[idx] = R[(idx / Cout) * ldc + idx % Cout];
  }
  const float* w1 = static_cast<const float*>(a.w1);
  const float* b1 = static_cast<const float*>(a.b1);
  for (int h0 = 0; h0 < H; h0 += 64) {
    const int hc = min(64, H - h0);
    __syncthreads();
    smem_gemm<true>(Hf, 64, Qf, ldc, w1 + (long long)h0 * C, C, BM, hc, C, false);
    __syncthreads();
    for (int idx = tid; idx < BM * hc; idx += kThreads) {
      const int r = idx / hc, j = idx % hc;
      Hf[r * 64 + j] = gelu_erf(Hf[r * 64 + j] + b1[h0 + j]);
    }
    __syncthreads();
    smem_gemm<true>(O, Cout, Hf, 64, static_cast<const float*>(a.w2) + h0, H, BM, Cout, hc, true);
  }
  __syncthreads();
  const float* b2 = static_cast<const float*>(a.b2);
  const float* bp = static_cast<const float*>(a.bp);
  float* out = static_cast<float*>(a.out) + row0 * Cout;
  for (int idx = tid; idx < valid * Cout; idx += kThreads) {
    const int c = idx % Cout;
    out[idx] = O[idx] + b2[c] + (bp != nullptr ? bp[c] : 0.f);
  }
}

template <int MODE>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(a.C, a.Cout, a.Lk, a.hd);
  if (smem > kMaxSmem || a.hd > 256) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(block_f32_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.L + kF32BM - 1) / kF32BM, B);
  block_f32_kernel<MODE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Column tile widths for the bf16 body: warps along rows WR (2 for C ≤ 384,
// else 1), and the n8 tiles per warp that cover C (NTP) and min(Cout, 12
// tiles) (NT), each rounded up to 3, 6 or 12.
inline int pick_nt(int cols, int wc) {
  const int need = (cols + 8 * wc - 1) / (8 * wc);
  return need <= 3 ? 3 : need <= 6 ? 6 : need <= 12 ? 12 : 0;
}

// returned when no bf16 instance covers the widths (the wrapper says which)
constexpr int kNoInstance = 100000;

struct Shape {
  int wr, ntp, nt, hdm;
};

inline Shape pick_shape(const Args& a) {
  const int wr = a.C <= 384 ? 2 : 1, wc = 8 / wr;
  return Shape{wr, pick_nt(a.C, wc), pick_nt(a.Cout < 96 * wc ? a.Cout : 96 * wc, wc),
               a.hd <= 128 ? 128 : 256};
}

// One C entry point per library, the same signature for all three: the
// library's `launch_bf16(shape, args, B, stream)` picks its instance.
#define CSTS_FUSED_BLOCK_ENTRY(NAME, MODE)                                                      \
  extern "C" int NAME(                                                                          \
      int dtype, const void* x, const void* q, const void* skip, const void* k, const void* v, \
      const void* ln1_w, const void* ln1_b, const void* wq, const void* bq, const void* wconv, \
      const void* nq_w, const void* nq_b, const void* wproj, const void* bproj,                \
      const void* ln2_w, const void* ln2_b, const void* w1, const void* b1, const void* w2,    \
      const void* b2, const void* wp, const void* bp, void* out, long long q_rs, int B, int L, \
      int C, int Cout, int H, int N, int hd, int Lk, int T, int Hh, int W, int Ts, int Hs,     \
      int Ws, int st, int sh, int sw, float scale, void* stream) {                             \
    csts::fb::Args a{x,     q,     skip,  k,     v,    ln1_w, ln1_b, wq,    bq,   wconv,       \
                     nq_w,  nq_b,  wproj, bproj, ln2_w, ln2_b, w1,   b1,    w2,   b2,          \
                     wp,    bp,    out,   q_rs,  L,    C,     Cout,  H,     N,    hd,          \
                     Lk,    T,     Hh,    W,     Ts,   Hs,    Ws,    st,    sh,   sw,    scale}; \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                        \
    if (dtype == csts::kFloat32) return csts::fb::launch_f32<MODE>(a, B, s);                  \
    if (dtype != csts::kBFloat16) return cudaErrorInvalidValue;                                \
    const csts::fb::Shape sh_ = csts::fb::pick_shape(a);                                       \
    if (wp == nullptr && (sh_.nt != sh_.ntp || Cout != C)) return csts::fb::kNoInstance;       \
    return launch_bf16(sh_, a, B, s);                                                           \
  }

#define CSTS_FB_CASE(MODE, WR, NTP, NT, HDM)                                  \
  if (s.wr == WR && s.ntp == NTP && s.nt == NT && s.hdm == HDM)                \
    return csts::fb::launch_mma<MODE, WR, NTP, NT, HDM>(a, B, stream);

// The widest instance of the shape's row split and head-dim bound: its
// column tiles (384 columns a tile at WR 2, 768 at WR 1) cover every input
// width of the split and, masked, any narrower one and any output width.
// Each library's launch_bf16 ends with it, so every width its wrapper and
// eligibility predicate admit has an instance, chosen before the launch.
// (At WR 1 with head dims above 240, its shared memory holds C ≤ 684 only:
// the route, csts_torch/models/mvit.py whole_block_fits, mirrors these sizes
// and sends such blocks to K1+K2 before any launch.)
// HD256: the library takes head dims above 128 (B4 does not: its predicate
// stops at 128, and the instances it would not use are not compiled).
template <int MODE, bool HD256>
int launch_widest(const Shape& s, const Args& a, int B, cudaStream_t stream) {
  if constexpr (HD256) {
    if (s.hdm != 128)
      return s.wr == 2 ? launch_mma<MODE, 2, 12, 12, 256>(a, B, stream)
                       : launch_mma<MODE, 1, 12, 12, 256>(a, B, stream);
  } else {
    if (s.hdm != 128) return kNoInstance;
  }
  return s.wr == 2 ? launch_mma<MODE, 2, 12, 12, 128>(a, B, stream)
                   : launch_mma<MODE, 1, 12, 12, 128>(a, B, stream);
}

}  // namespace fb
}  // namespace csts
