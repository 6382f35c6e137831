// K1: multiscale attention core, out = softmax(q kᵀ · scale [+ mask]) v.
//
// Replaces csts_tpu/kernels/attention.py:_attn_kernel (called from
// _fused_attention_fwd_impl). Like the TPU kernel, logits and softmax are
// fp32 and the probabilities never reach device memory.
//
// Bound on the H100: per (batch·head) the kernel must read q (Lq·hd), k and v
// (Lk·hd) and write out (Lq·hd), and do 4·Lq·Lk·hd operations. With the
// pooled keys of MViT (Lk 64..1024) that is about Lk/2 operations per byte,
// below the card's ridge (~295 bf16 operations per byte) at every flagship
// site: the bytes bound it, 5-10 µs a launch at batch 8. What kept the first
// design (mma.sync, one 4-warp block per 64 rows, two K/V buffers with
// a block-wide barrier per chunk) at 4-8x that bound was latency, not
// throughput: at Lq 256 / Lk 1024 (v14, a3) its 256 blocks each walked 16 key
// chunks in series on a card that holds ~400 of them, and every launch paid
// ~0.04 ms of host work.
//
// Design (bf16, the serving and training path), redesigned for Hopper:
//  * Products on wgmma. S = Q Kᵀ is m64n64k16 with Q and K read from shared
//    memory; O += P V is m64n{hd}k16 with P from registers (the logit
//    accumulators rounded to bf16 unnormalised, as the TPU kernel and the
//    first design do) and V read MN-major from shared memory. The logits, the
//    row max and sum and the (64 x hd) output stay in registers.
//  * One warpgroup per 64 query rows, two per block where Lq > 64, sharing
//    each K/V tile. A producer warp loads Q and then the 64-key K/V chunks
//    with TMA (tensor maps over the (batch, head, row) strides, so the head
//    views of the fused qkv projection load without a copy) into a ring of
//    three stages, each with a "full" mbarrier (TMA bytes) and an "empty"
//    one (consumer arrivals).
//    No block-wide barrier in the loop: a consumer waits only for the chunk
//    it needs.
//  * Software-pipelined: S of chunk i+1 is issued before P·V of chunk i, so
//    the softmax of chunk i+1 runs while P·V of chunk i is in the tensor
//    cores; the mask of chunk i+1 loads meanwhile.
//  * A block walks several query tiles of one (batch, head) where the grid
//    would take more than one wave (the wrapper picks the count): with two
//    Q buffers (head dims up to 128) the next tile's Q and first K/V chunks
//    load while the current tile computes, and the card runs one wave.
//  * The keys split 1-4 ways where the grid of (batch·head, query tiles)
//    fills less than one wave of the card (the wrapper picks the count).
//    Each split writes its unnormalised fp32 output and (m, l) rows; a
//    second small kernel merges them with the online-softmax algebra and
//    rounds the output once.
//  * exp2 with scale·log2(e) folded into one fused multiply-add; the lse
//    rows (natural log, fp32) for B8 in training.
//  * Head dims 256 and 384 (the bf16 head dims above 192 that the wrapper
//    pads to): the (64 x hd) output accumulator would not fit the
//    registers, so a block takes 128 of the output columns (grid z), one
//    consumer warpgroup a block; each slice computes the logits over the
//    whole head dim (Q and K tiles at hd, V at 128 columns) and the first
//    writes lse. Two ring stages at 384.
//  * The additive mask (the spatial fusion's in-frame mask) is read in its own
//    dtype, bf16 or fp32, two adjacent columns a load, only in the masked
//    instance; widening bf16 to fp32 is exact, so the result is the fp32
//    mask's.
//  * Host: the shared-memory attribute is set once per instance; the three
//    tensor maps come from a table of encoded maps (cuTensorMapEncodeTiled
//    through the runtime's driver entry point, so no -lcuda, only for a new
//    pointer, shape or stride); the wrapper passes its arguments as one
//    int64 array.
// Ragged edges: rows past Lq and keys past Lk load as zeros (TMA's
// out-of-bounds fill); such keys get a logit of -inf, such rows are not
// stored.
//
// The bf16 body is in attention_wg.cuh, which B5 (decoder_block.cu) also
// runs for its attention. fp32 inputs (the exactness check against the plain
// version) take a simple body here, attn_streamed_kernel: the same online
// softmax with exact FMA products in shared memory, the head dim streamed in
// 64-column steps (the logits summed over them, P·V walked in them) and the
// query rows a block takes cut until its output accumulator fits, so that
// it runs at any head dim (the whole-head-dim tiles it held before stopped
// at 280). bf16 head dims above 384, which no wgmma instance holds (whole-
// head-dim Q and K tiles fill a block's shared memory there), take the same
// body with K1's rounding points, chosen by (head dim, dtype) before the
// launch.
#include "attention_wg.cuh"

using namespace csts;
using namespace csts::attn;

namespace {

// The key splits' merge: one warp a row, m = max m_z, l = Σ l_z·2^(m_z - m),
// out = Σ o_z·2^(m_z - m) / l rounded once; lse = (m + log2 l)·ln 2.
__global__ void __launch_bounds__(256) attn_merge_kernel(AttnArgs a, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int hd = a.hd, bn = row / a.Lq, r = row - bn * a.Lq;
  const int b = bn / a.N, n = bn % a.N;
  float m = -INFINITY;
  for (int z = 0; z < a.splits; ++z) m = fmaxf(m, a.ml[2 * (static_cast<long long>(z) * rows + row)]);
  const float m_use = m == -INFINITY ? 0.f : m;
  float f[4], l = 0.f;
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    f[z] = 0.f;
    if (z < a.splits) {
      const float2 st = *reinterpret_cast<const float2*>(a.ml + 2 * (static_cast<long long>(z) * rows + row));
      f[z] = exp2f(st.x - m_use);
      l += st.y * f[z];
    }
  }
  const float inv = 1.f / l;
  bf16* orow = static_cast<bf16*>(a.out) + b * a.osb + n * a.osn + r * a.osr;
  for (int c = 2 * lane; c < hd; c += 64) {
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int z = 0; z < 4; ++z) {
      if (z < a.splits) {
        const float2 w = *reinterpret_cast<const float2*>(
            a.ws + (static_cast<long long>(z) * rows + row) * hd + c);
        acc.x += w.x * f[z];
        acc.y += w.y * f[z];
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
  }
  if (a.lse != nullptr && lane == 0) a.lse[row] = (m + log2f(l)) * kLn2;
}

template <int HD, int NW, bool MASKED, int DV = HD>
__global__ void __launch_bounds__(WgPlan<HD, NW, DV>::kThreads, 1)
    attn_wg_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, AttnArgs a) {
  attn_wg_body<HD, NW, MASKED, DV>(qmap, kmap, vmap, a);
}

template <int HD, int NW, bool MASKED, int DV = HD>
cudaError_t launch_wg(const AttnArgs& a, int B, cudaStream_t stream) {
  static bool attr_set = false;  // once per instance
  cudaError_t e =
      launch_attn<HD, NW, DV>(attn_wg_kernel<HD, NW, MASKED, DV>, attr_set, a, B, stream);
  if (e != cudaSuccess || a.splits == 1) return e;
  const int rows = B * a.N * a.Lq;
  attn_merge_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(a, rows);
  return cudaGetLastError();
}

// two consumer warpgroups a block where Lq > 64, else one
template <int HD>
cudaError_t launch_hd(const AttnArgs& a, int B, cudaStream_t stream) {
  const bool two = a.Lq > 64;
  if (a.mask != nullptr)
    return two ? launch_wg<HD, 2, true>(a, B, stream) : launch_wg<HD, 1, true>(a, B, stream);
  return two ? launch_wg<HD, 2, false>(a, B, stream) : launch_wg<HD, 1, false>(a, B, stream);
}

// head dims above 192: one consumer warpgroup a block, 128 output columns a
// slice (grid z), no key split
template <int HD>
cudaError_t launch_wide(const AttnArgs& a, int B, cudaStream_t stream) {
  if (a.splits != 1) return cudaErrorInvalidValue;
  return a.mask != nullptr ? launch_wg<HD, 1, true, 128>(a, B, stream)
                           : launch_wg<HD, 1, false, 128>(a, B, stream);
}

// ---------------------------------------------------------------------------
// the streamed body: fp32 inputs (the exactness check against the plain
// version) at any head dim, and bf16 head dims above the largest wgmma
// instance (384)
// ---------------------------------------------------------------------------

constexpr int kSC = 64;  // head-dim columns a step
constexpr int kThreads = 128;

// shared memory of a block of bq query rows at head dim hd: a column step of
// Q, K and V, the chunk's logits and probabilities, the output accumulator
// (bq x hd) and the row statistics
size_t streamed_smem_bytes(int hd, int bq) {
  const int ld = kSC + kF32Pad;
  return align128(sizeof(float) * bq * ld) + 2 * align128(sizeof(float) * kBK * ld) +
         2 * align128(sizeof(float) * bq * kBK) + align128(sizeof(float) * bq * hd) +
         2 * align128(sizeof(float) * bq);
}

// query rows a block: 32, halved until the block's tiles fit (32 up to head
// dim ~1350, one row up to ~55000)
int streamed_rows(int hd) {
  int bq = 32;
  while (bq > 1 && streamed_smem_bytes(hd, bq) > kMaxSmem) bq /= 2;
  return bq;
}

// x rounded to T and widened back: the bf16 body's rounding of the
// probabilities before P·V (none in fp32)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

// One block takes bq query rows of one (batch, head). Per 64-key chunk the
// logits S = Σ_d Q[:, d]·K[:, d]ᵀ are summed over 64-column steps of the
// head dim (one exact FMA chain carried across the steps, so S is bit for
// bit that of one unsplit chain, as the whole-head-dim body had it), the online
// softmax runs in fp32, and O += P·V is walked in the same column steps of V
// and O; the output is O / l, rounded once. bf16 inputs are widened exactly
// and take K1's rounding points: fp32 logits and softmax, the probabilities
// rounded unnormalised before P·V (the row sums are of the unrounded ones),
// fp32 accumulation, one rounding of the output.
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_streamed_kernel(AttnArgs a, int bq) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hd = a.hd, ld = kSC + kF32Pad;
  unsigned char* p = smem_raw;
  float* Qs = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * ld));
  float* Ks = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* Vs = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* S = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * kBK));
  float* P = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * kBK));
  float* O = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * hd));
  float* Mrow = reinterpret_cast<float*>(carve(p, sizeof(float) * bq));
  float* Lrow = reinterpret_cast<float*>(carve(p, sizeof(float) * bq));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / a.N, n = blockIdx.y % a.N;
  const int q0 = blockIdx.x * bq;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + n * a.qsn;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + n * a.ksn;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + n * a.vsn;
  T* ob = static_cast<T*>(a.out) + b * a.osb + n * a.osn;

  // rows x dc columns (from column d0) of src (row stride ls, rows from
  // row0, valid below `valid`) into dst (row stride ld), zeros elsewhere
  auto load = [&](float* dst, const T* src, long long ls, int row0, int rows, int valid, int d0,
                  int dc) {
    for (int idx = tid; idx < rows * dc; idx += kThreads) {
      const int r = idx / dc, d = idx - r * dc, row = row0 + r;
      dst[r * ld + d] = row < valid ? to_f32(src[row * ls + d0 + d]) : 0.f;
    }
  };

  for (int idx = tid; idx < bq * hd; idx += kThreads) O[idx] = 0.f;
  for (int r = tid; r < bq; r += kThreads) {
    Mrow[r] = -INFINITY;
    Lrow[r] = 0.f;
  }

  for (int c0 = 0; c0 < a.Lk; c0 += kBK) {
    for (int d0 = 0; d0 < hd; d0 += kSC) {
      const int dc = min(kSC, hd - d0);
      __syncthreads();  // the previous step's product has read Qs and Ks
      load(Qs, qb, a.qsr, q0, bq, a.Lq, d0, dc);
      load(Ks, kb, a.ksr, c0, kBK, a.Lk, d0, dc);
      __syncthreads();
      smem_gemm_chain<true>(S, kBK, Qs, ld, Ks, ld, bq, kBK, dc, d0 == 0);
    }
    __syncthreads();
    // online softmax, one warp per query row, two key columns per lane
    for (int r = warp; r < bq; r += kThreads / 32) {
      const int qi = q0 + r;
      float s[kBK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 32; ++j) {
        const int col = lane + 32 * j, kc = c0 + col;
        float val = -INFINITY;
        if (kc < a.Lk) {
          val = S[r * kBK + col] * a.scale;
          if (a.mask != nullptr && qi < a.Lq) {
            const long long off = (long long)qi * a.Lk + kc;
            val += a.mask_bf16 ? __bfloat162float(static_cast<const bf16*>(a.mask)[off])
                               : static_cast<const float*>(a.mask)[off];
          }
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
        P[r * kBK + lane + 32 * j] = rnd<T>(pj);
      }
      sum = warp_sum(sum);
      for (int d = lane; d < hd; d += 32) O[r * hd + d] *= alpha;
      if (lane == 0) {
        Lrow[r] = Lrow[r] * alpha + sum;
        Mrow[r] = m_new;
      }
    }
    for (int d0 = 0; d0 < hd; d0 += kSC) {
      const int dc = min(kSC, hd - d0);
      __syncthreads();  // the softmax (first step) or the previous step's product is done
      load(Vs, vb, a.vsr, c0, kBK, a.Lk, d0, dc);
      __syncthreads();
      smem_gemm<false>(O + d0, hd, P, kBK, Vs, ld, bq, dc, kBK, true);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < bq * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = q0 + r;
    if (row < a.Lq) ob[row * a.osr + d] = from_f32<T>(O[idx] / Lrow[r]);
  }
  if (a.lse != nullptr)
    for (int r = tid; r < bq; r += kThreads)
      if (q0 + r < a.Lq) a.lse[(long long)blockIdx.y * a.Lq + q0 + r] = Mrow[r] + logf(Lrow[r]);
}

template <typename T>
cudaError_t launch_streamed(const AttnArgs& a, int B, cudaStream_t stream) {
  if (a.splits != 1) return cudaErrorInvalidValue;
  const int bq = streamed_rows(a.hd);
  const size_t smem = streamed_smem_bytes(a.hd, bq);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(attn_streamed_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((a.Lq + bq - 1) / bq, B * a.N);
  attn_streamed_kernel<T><<<grid, kThreads, smem, stream>>>(a, bq);
  return cudaGetLastError();
}

}  // namespace

// One pointer to 29 int64 values, so that the host's call converts three
// arguments, not twenty-nine: dtype, q, k, v, mask, mask_bf16, out, lse, ws,
// ml, splits, tpb, B, N, Lq, Lk, hd, then the (batch, head, row) strides of
// q, k, v and out.
extern "C" int csts_attention_fwd(const long long* p, float scale, void* stream) {
  const auto ptr = [&](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(p[i])); };
  const int dtype = static_cast<int>(p[0]), mask_bf16 = static_cast<int>(p[5]);
  const int splits = static_cast<int>(p[10]), tpb = static_cast<int>(p[11]);
  const int B = static_cast<int>(p[12]), hd = static_cast<int>(p[16]);
  AttnArgs a{ptr(1), ptr(2), ptr(3), ptr(4), mask_bf16, ptr(6), static_cast<float*>(ptr(7)),
             static_cast<float*>(ptr(8)), static_cast<float*>(ptr(9)), static_cast<int>(p[13]),
             static_cast<int>(p[14]), static_cast<int>(p[15]), hd, splits, tpb,
             p[17], p[18], p[19], p[20], p[21], p[22], p[23], p[24], p[25], p[26], p[27], p[28],
             scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return (mask_bf16 || splits != 1) ? cudaErrorInvalidValue : launch_streamed<float>(a, B, s);
  if (dtype != kBFloat16 || splits < 1 || splits > 4 || tpb < 1 || (splits > 1 && tpb > 1))
    return cudaErrorInvalidValue;
  if (hd > 384) return tpb != 1 ? cudaErrorInvalidValue : launch_streamed<bf16>(a, B, s);
  switch (hd) {
    case 64: return launch_hd<64>(a, B, s);
    case 96: return launch_hd<96>(a, B, s);
    case 128: return launch_hd<128>(a, B, s);
    case 192: return launch_hd<192>(a, B, s);
    case 256: return launch_wide<256>(a, B, s);
    case 384: return launch_wide<384>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}
