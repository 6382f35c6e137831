// K1: multiscale attention core, out = softmax(q kᵀ · scale [+ mask]) v.
//
// Replaces csts_tpu/kernels/attention.py:_attn_kernel (called from
// _fused_attention_fwd_impl). Like the TPU kernel, logits and softmax are
// fp32 and the probabilities never reach device memory.
//
// Bound on the H100: per (batch·head) the kernel must read q (Lq·hd), k and v
// (Lk·hd) and write out (Lq·hd), and do 4·Lq·Lk·hd operations. With the
// pooled keys of MViT (Lk 64..1024, Lq up to 32768) that is about Lk
// operations per byte, so the Lk=256 stem blocks sit near the card's ridge
// (~295 bf16 operations per byte) and the Lk=1024 Q-pool blocks are bound by
// the tensor cores.
//
// Design (bf16, the serving path): one block of 4 warps takes 64 query rows
// of one (batch, head), each warp 16 of them, and walks the keys in chunks of
// 64 with an online softmax. A whole fp32 logit row of Lk=1024 for a useful
// query tile does not fit shared memory at hd 192, so the chunking is what
// lets one design serve every site. K and V chunks are copied with cp.async
// into two buffers, so the next chunk loads while the warps work on the
// current one. Both products are mma.sync m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix; the logits, the running row max and sum and
// the (16 x hd) output accumulator stay in each warp's registers, and the
// probabilities pass from the first product's accumulators to the second's
// operands without leaving them. Ragged edges (Lq=8, Lq=Lk=260) are masked in
// the kernel: query rows past Lq load zeros and are not stored, key rows past
// Lk load zeros and get a logit of -inf. The additive fp32 mask (the spatial
// fusion's -1e8 in-frame mask) is added to the fp32 logits and never passes
// through bf16. q, k, v and out are addressed through (batch, head, row)
// strides, so the caller passes head views of the fused qkv projection and
// receives the output already in token-major (B, Lq, heads·hd) order.
//
// In training the caller also passes an fp32 row of log-sum-exp values, one
// per query row (lse = m + log l of the online softmax), which the backward
// kernel B8 (attention_bwd.cu) reads to rebuild the normalised probabilities
// in one pass over the keys; at eval it passes none.
//
// fp32 inputs (the exactness check against the plain version) take a simple
// body: the same online softmax with exact FMA products in shared memory.
#include "common.cuh"

using namespace csts;

namespace {

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  void* out;
  float* lse;  // (B·N, Lq) or null
  int N, Lq, Lk, hd;
  long long qsb, qsn, qsr, ksb, ksn, ksr, vsb, vsn, vsr, osb, osn, osr;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: register-tiled flash body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;       // query rows per block (16 per warp)
constexpr int kBK = 64;       // keys per chunk
constexpr int kThreads = 128;

template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }

template <int HD>
size_t mma_smem_bytes() {
  return align128(sizeof(bf16) * kBQ * mma_ld<HD>()) +
         4 * align128(sizeof(bf16) * kBK * mma_ld<HD>());
}

// rows x HD bf16 rows (global stride rs) into shared memory (stride HD + 8),
// zeros for rows at or past `valid`
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long rs, int rows,
                                          int valid) {
  constexpr int per_row = HD / 8;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, c8 = idx - r * per_row;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * mma_ld<HD>() + c8 * 8, ok ? src + r * rs + c8 * 8 : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) attn_mma_kernel(AttnArgs a) {
  constexpr int LD = mma_ld<HD>(), DT = HD / 8;  // DT: n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  bf16* Qs = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBQ * LD));
  bf16* Ks[2];
  bf16* Vs[2];
  for (int i = 0; i < 2; ++i) {
    Ks[i] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBK * LD));
    Vs[i] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBK * LD));
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row / column pair
  const int b = blockIdx.y / a.N, n = blockIdx.y % a.N;
  const int q0 = blockIdx.x * kBQ;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb + n * a.qsn;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + n * a.ksn;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + n * a.vsn;
  bf16* ob = static_cast<bf16*>(a.out) + b * a.osb + n * a.osn;

  load_rows<HD>(Qs, qb + q0 * a.qsr, a.qsr, kBQ, a.Lq - q0);
  load_rows<HD>(Ks[0], kb, a.ksr, kBK, a.Lk);
  load_rows<HD>(Vs[0], vb, a.vsr, kBK, a.Lk);
  cp_async_commit();

  // this thread's two query rows (g and g + 8 of the warp's 16)
  const int qr[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[DT][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const bf16* Qw = Qs + warp * 16 * LD;

  int cb = 0;
  for (int c0 = 0; c0 < a.Lk; c0 += kBK) {
    cp_async_wait_all();
    __syncthreads();  // chunk c0 (and Q) visible; buffers cb ^ 1 free
    if (c0 + kBK < a.Lk) {
      load_rows<HD>(Ks[cb ^ 1], kb + (c0 + kBK) * a.ksr, a.ksr, kBK, a.Lk - c0 - kBK);
      load_rows<HD>(Vs[cb ^ 1], vb + (c0 + kBK) * a.vsr, a.vsr, kBK, a.Lk - c0 - kBK);
    }
    cp_async_commit();
    const bf16* K = Ks[cb];
    const bf16* V = Vs[cb];

    // S = Q Kᵀ for the warp's 16 rows and the chunk's 64 keys
    float s[kBK / 8][4] = {};
#pragma unroll
    for (int k = 0; k < HD; k += 16) {
      uint32_t qa[4];
      ldmatrix_x4(qa, Qw + (lane & 15) * LD + k + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kBK / 8; np += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, K + (np * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + k +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[np], qa, kf[0], kf[1]);
        mma_bf16_16816(s[np + 1], qa, kf[2], kf[3]);
      }
    }

    // online softmax in fp32; entries 0,1 of a tile are row g, 2,3 row g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + nt * 8 + 2 * t4 + (e & 1), h = e >> 1;
        float val = -INFINITY;
        if (col < a.Lk) {
          val = s[nt][e] * a.scale;
          if (a.mask != nullptr && qr[h] < a.Lq) val += a.mask[(long long)qr[h] * a.Lk + col];
        }
        s[nt][e] = val;
        mx[h] = fmaxf(mx[h], val);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);  // finite: key c0 < Lk is valid
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - m_run[e >> 1]);
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

    // O += P V: the logit accumulators of key tiles 2j, 2j+1 are the A
    // operand of keys 16j .. 16j+15, rounded to bf16
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * j][0], s[2 * j][1]),
                              pack_bf16x2(s[2 * j][2], s[2 * j][3]),
                              pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT; dp += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, V + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 8 +
                                  (lane >> 4) * 8);
        mma_bf16_16816(o[dp], pa, vf[0], vf[1]);
        mma_bf16_16816(o[dp + 1], pa, vf[2], vf[3]);
      }
    }
    cb ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qr[h] >= a.Lq) continue;
    // the four lanes of a quad hold the same row statistics
    if (a.lse != nullptr && t4 == 0)
      a.lse[(long long)blockIdx.y * a.Lq + qr[h]] = m_run[h] + logf(l_run[h]);
    const float inv = 1.f / l_run[h];
    bf16* orow = ob + qr[h] * a.osr;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[dt][2 * h] * inv, o[dt][2 * h + 1] * inv);
  }
}

template <int HD>
cudaError_t launch_mma(const AttnArgs& a, int B, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HD>();
  auto kern = attn_mma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.Lq + kBQ - 1) / kBQ, B * a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: exact FMA body through shared memory
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 32;

size_t f32_smem_bytes(int hd) {
  const int ld = hd + kF32Pad;
  return align128(sizeof(float) * kF32BQ * ld) + 2 * align128(sizeof(float) * kBK * ld) +
         align128(sizeof(float) * kF32BQ * kBK) + align128(sizeof(float) * kF32BQ * kBK) +
         align128(sizeof(float) * kF32BQ * hd) + 2 * align128(sizeof(float) * kF32BQ);
}

__global__ void __launch_bounds__(kThreads) attn_f32_kernel(AttnArgs a) {
  constexpr int BQ = kF32BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hd = a.hd, ld = hd + kF32Pad;
  unsigned char* p = smem_raw;
  float* Qs = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * ld));
  float* Ks = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* Vs = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* S = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * kBK));
  float* P = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * kBK));
  float* O = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * hd));
  float* Mrow = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));
  float* Lrow = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / a.N, n = blockIdx.y % a.N;
  const int q0 = blockIdx.x * BQ;
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + n * a.qsn;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + n * a.ksn;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + n * a.vsn;
  float* ob = static_cast<float*>(a.out) + b * a.osb + n * a.osn;

  for (int idx = tid; idx < BQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = q0 + r;
    Qs[r * ld + d] = row < a.Lq ? qb[row * a.qsr + d] : 0.f;
    O[idx] = 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    Mrow[r] = -INFINITY;
    Lrow[r] = 0.f;
  }

  for (int c0 = 0; c0 < a.Lk; c0 += kBK) {
    __syncthreads();  // previous chunk's P·V has read Ks/Vs/P
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - r * hd, row = c0 + r;
      const bool ok = row < a.Lk;
      Ks[r * ld + d] = ok ? kb[row * a.ksr + d] : 0.f;
      Vs[r * ld + d] = ok ? vb[row * a.vsr + d] : 0.f;
    }
    __syncthreads();
    smem_gemm<true>(S, kBK, Qs, ld, Ks, ld, BQ, kBK, hd, false);
    __syncthreads();
    // online softmax, one warp per query row, two key columns per lane
    for (int r = warp; r < BQ; r += kThreads / 32) {
      const int qi = q0 + r;
      float s[kBK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const int col = lane + 32 * j, kc = c0 + col;
        float val = -INFINITY;
        if (kc < a.Lk) {
          val = S[r * kBK + col] * a.scale;
          if (a.mask != nullptr && qi < a.Lq) val += a.mask[(long long)qi * a.Lk + kc];
        }
        s[j] = val;
        mx = fmaxf(mx, val);
      }
      mx = warp_max(mx);
      const float m_old = Mrow[r];
      const float m_new = fmaxf(m_old, mx);  // finite: column c0 < Lk is valid
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const float pj = expf(s[j] - m_new);
        sum += pj;
        P[r * kBK + lane + 32 * j] = pj;
      }
      sum = warp_sum(sum);
      for (int d = lane; d < hd; d += 32) O[r * hd + d] *= alpha;
      if (lane == 0) {
        Lrow[r] = Lrow[r] * alpha + sum;
        Mrow[r] = m_new;
      }
    }
    __syncthreads();
    smem_gemm<false>(O, hd, P, kBK, Vs, ld, BQ, hd, kBK, true);
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = q0 + r;
    if (row < a.Lq) ob[row * a.osr + d] = O[idx] / Lrow[r];
  }
  if (a.lse != nullptr)
    for (int r = tid; r < BQ; r += kThreads)
      if (q0 + r < a.Lq) a.lse[(long long)blockIdx.y * a.Lq + q0 + r] = Mrow[r] + logf(Lrow[r]);
}

cudaError_t launch_f32(const AttnArgs& a, int B, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(a.hd);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attn_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.Lq + kF32BQ - 1) / kF32BQ, B * a.N);
  attn_f32_kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int csts_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* mask, void* out, void* lse, int B, int N, int Lq,
                                  int Lk,
                                  int hd, long long qsb, long long qsn, long long qsr,
                                  long long ksb, long long ksn, long long ksr, long long vsb,
                                  long long vsn, long long vsr, long long osb, long long osn,
                                  long long osr, float scale, void* stream) {
  AttnArgs a{q,   k,   v,   static_cast<const float*>(mask), out, static_cast<float*>(lse),
             N,   Lq,  Lk,  hd, qsb, qsn, qsr, ksb, ksn, ksr, vsb, vsn, vsr, osb, osn, osr,
             scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_f32(a, B, s);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_mma<64>(a, B, s);
    case 96: return launch_mma<96>(a, B, s);
    case 128: return launch_mma<128>(a, B, s);
    case 192: return launch_mma<192>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
