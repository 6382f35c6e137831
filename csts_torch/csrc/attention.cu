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
// version) take a simple body here: the same online softmax with exact FMA
// products in shared memory.
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
// fp32: exact FMA body through shared memory
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 32;
constexpr int kThreads = 128;

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
          if (a.mask != nullptr && qi < a.Lq)
            val += static_cast<const float*>(a.mask)[(long long)qi * a.Lk + kc];
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
  if (dtype == kFloat32) return (mask_bf16 || splits != 1) ? cudaErrorInvalidValue : launch_f32(a, B, s);
  if (dtype != kBFloat16 || splits < 1 || splits > 4 || tpb < 1 || (splits > 1 && tpb > 1))
    return cudaErrorInvalidValue;
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
