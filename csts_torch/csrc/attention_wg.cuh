// K1's bf16 body (wgmma, a TMA-fed K/V ring, online softmax in registers),
// shared by K1 (attention.cu, which states its design) and B5's attention
// (decoder_block.cu). The caller's kernel passes its __grid_constant__ tensor
// maps; launch_attn encodes them and launches.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace csts {
namespace attn {

namespace s9 = csts::sm90;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* mask;
  int mask_bf16;  // the mask's dtype: bf16 (1) or fp32 (0)
  void* out;
  float* lse;  // (B·N, Lq) or null
  float* ws;   // key splits: (splits, B·N, Lq, hd) fp32 partial outputs
  float* ml;   // key splits: (splits, B·N, Lq, 2) fp32 (max in log2 units, sum)
  int N, Lq, Lk, hd, splits;
  int tpb;  // query tiles a block walks (consecutive, one (batch, head))
  long long qsb, qsn, qsr, ksb, ksn, ksr, vsb, vsn, vsr, osb, osn, osr;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: wgmma body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;      // keys per chunk (one ring stage)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD, int NW, int DV = HD>
struct WgPlan {
  static constexpr int P = HD / s9::kPanel;                       // 32-column panels
  static constexpr int PV = DV / s9::kPanel;                      // those of a V slice
  static constexpr uint32_t kPanelBytes = 64 * s9::kRowBytes;     // one panel of 64 rows
  static constexpr uint32_t kTile = P * kPanelBytes;              // 64 rows x HD
  static constexpr uint32_t kVTile = PV * kPanelBytes;            // 64 rows x DV
  // Q buffers: two where they fit, so that a block's next query tile loads
  // while it works on the current one
  static constexpr int QB = HD <= 128 ? 2 : 1;
  // K/V ring stages: three, two where a head dim above 256 leaves no room
  static constexpr int ST = HD <= 256 ? 3 : 2;
  // the consumer warpgroups and a producer warp (ptxas holds a block of two
  // warpgroups and a warp to 168 registers a thread; setmaxnreg, tried with
  // a whole producer warpgroup, did not raise that budget)
  static constexpr int kThreads = NW * 128 + 32;
  static constexpr size_t kSmem =
      1024 + QB * NW * kTile + ST * (kTile + kVTile) + 8 * (2 * ST + 2 * QB);
  static_assert(HD % DV == 0 && kSmem <= kMaxSmem, "shared memory");
};

// The body of a block: called by a __global__ kernel whose tensor maps are
// __grid_constant__ parameters (TMA reads them in parameter space), launched
// with WgPlan<HD, NW, DV>::kThreads threads and kSmem bytes by launch_attn.
// A block takes a.tpb consecutive query tiles (64·NW rows each) of one
// (batch, head) and, with key splits, one split of the keys; where DV < HD
// (head dims above 192), one slice of DV output columns instead (grid z):
// every slice computes the logits over the whole head dim and reads its
// own columns of V, and the first writes lse.
template <int HD, int NW, bool MASKED, int DV = HD>
__device__ __forceinline__ void attn_wg_body(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                             const CUtensorMap& vmap, const AttnArgs& a) {
  using Pl = WgPlan<HD, NW, DV>;
  constexpr int QB = Pl::QB, kStages = Pl::ST;
  constexpr uint32_t T = Pl::kTile, TV = Pl::kVTile, PB = Pl::kPanelBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Qs = base;               // QB buffers of NW tiles of 64 query rows
  unsigned char* KV = base + QB * NW * T; // stage s: K at KV + s(T + TV), V at + T
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + kStages * (T + TV));
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;      // a Q buffer loaded
  uint64_t* qfree = qfull + QB;           // a Q buffer read by its tile's last product

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bn = blockIdx.y, b = bn / a.N, n = bn % a.N;
  const int rows_tile = 64 * NW;
  const int tile0 = blockIdx.x * a.tpb;
  const int tiles = min(a.tpb, (a.Lq + rows_tile - 1) / rows_tile - tile0);
  const int nchunks = (a.Lk + kBK - 1) / kBK;
  const int per = (nchunks + a.splits - 1) / a.splits;
  const int split = DV < HD ? 0 : blockIdx.z, c0 = DV < HD ? blockIdx.z * DV : 0;
  const int c_begin = split * per, c_end = min(nchunks, c_begin + per);
  const int n_it = c_end - c_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      s9::bar_init(&full[s], 1);
      s9::bar_init(&empty[s], NW * 128);
    }
    for (int j = 0; j < QB; ++j) {
      s9::bar_init(&qfull[j], 1);
      s9::bar_init(&qfree[j], NW * 128);
    }
    s9::bar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NW) {
    // ---- producer: per query tile, its Q, then the split's K/V chunks
    //      through the ring (the ring index runs on across tiles) ----
    if (lane == 0) {
      for (int j = 0, i = 0; j < tiles; ++j) {
        const int qb = j % QB;
        if (j >= QB) s9::bar_wait(&qfree[qb], ((j / QB) - 1) & 1);
        s9::bar_expect(&qfull[qb], NW * T);
        for (int w = 0; w < NW; ++w)
          for (int p = 0; p < Pl::P; ++p)
            s9::tma_load_4d(Qs + (qb * NW + w) * T + p * PB, &qmap, &qfull[qb], p * s9::kPanel,
                            (tile0 + j) * rows_tile + 64 * w, n, b);
        for (int c = c_begin; c < c_end; ++c, ++i) {
          const int s = i % kStages;
          if (i >= kStages) s9::bar_wait(&empty[s], ((i / kStages) - 1) & 1);
          s9::bar_expect(&full[s], T + TV);
          unsigned char* K = KV + s * (T + TV);
          for (int p = 0; p < Pl::P; ++p)
            s9::tma_load_4d(K + p * PB, &kmap, &full[s], p * s9::kPanel, c * kBK, n, b);
          for (int p = 0; p < Pl::PV; ++p)
            s9::tma_load_4d(K + T + p * PB, &vmap, &full[s], c0 + p * s9::kPanel, c * kBK, n, b);
        }
      }
    }
    return;
  }

  // ---- consumers: in each tile, warpgroup wg owns query rows 64·wg .. +64 ----
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // exp2 of (logit·scale) = exp2 of one fma: raw logits times scale·log2(e)
  // (the masked instance folds the mask in first and then works in log2 units)
  const float cl2 = a.scale * kLog2e, sm = MASKED ? 1.f : cl2;
  float o[DV / 2];
  float sc[32];                 // logits, then probabilities, of the chunk in hand
  float mk[MASKED ? 32 : 1];    // its mask values (masked instance)
  uint32_t pa[4][4];            // its probabilities as the A fragments of P·V
  int ring = 0;                 // ring index of the tile's first chunk

  for (int j = 0; j < tiles; ++j) {
    const int qb = j % QB;
    const int r0 = (tile0 + j) * rows_tile + wg * 64 + wl * 16 + g;
    const int qr[2] = {r0, r0 + 8};
    const unsigned char* Qw = Qs + (qb * NW + wg) * T;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    // S = Q Kᵀ of chunk iteration i (64 rows x 64 keys) into sc, asynchronously
    auto issue_s = [&](int i) {
      const unsigned char* K = KV + ((ring + i) % kStages) * (T + TV);
#pragma unroll
      for (int p = 0; p < Pl::P; ++p)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          s9::Wgmma<64, 0>::ss(sc, s9::desc_k(Qw + p * PB, ks), s9::desc_k(K + p * PB, ks),
                               (p | ks) != 0);
      s9::wgmma_commit();
    };
    auto wait_full = [&](int i) {
      s9::bar_wait(&full[(ring + i) % kStages], ((ring + i) / kStages) & 1);
    };
    // the mask of chunk c at this thread's entries (0 past Lq or Lk)
    auto load_mask = [&](int c) {
      if constexpr (MASKED) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = c * kBK + 8 * jj + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m0 = 0.f, m1 = 0.f;
            if (qr[h] < a.Lq) {
              const long long off = static_cast<long long>(qr[h]) * a.Lk + col;
              if (a.mask_bf16) {
                const bf16* mp = static_cast<const bf16*>(a.mask) + off;
                if ((off & 1) == 0 && col + 1 < a.Lk) {
                  const float2 f =
                      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mp));
                  m0 = f.x, m1 = f.y;
                } else {
                  if (col < a.Lk) m0 = __bfloat162float(mp[0]);
                  if (col + 1 < a.Lk) m1 = __bfloat162float(mp[1]);
                }
              } else {
                const float* mp = static_cast<const float*>(a.mask) + off;
                if ((off & 1) == 0 && col + 1 < a.Lk) {
                  const float2 f = *reinterpret_cast<const float2*>(mp);
                  m0 = f.x, m1 = f.y;
                } else {
                  if (col < a.Lk) m0 = mp[0];
                  if (col + 1 < a.Lk) m1 = mp[1];
                }
              }
            }
            mk[4 * jj + 2 * h] = m0 * kLog2e;
            mk[4 * jj + 2 * h + 1] = m1 * kLog2e;
          }
        }
      }
    };

    s9::bar_wait(&qfull[qb], (j / QB) & 1);
    if (n_it > 0) {
      wait_full(0);
      s9::wgmma_fence();
      issue_s(0);
      load_mask(c_begin);
      s9::wgmma_wait<0>();
      s9::fence_regs(sc);
    }
    // Pipelined: while P·V of chunk i runs, S of chunk i+1 has been issued
    // ahead of it and the softmax of i+1 overlaps P·V of i.
    for (int i = 0; i < n_it; ++i) {
      const int c = c_begin + i;
      // online softmax in fp32 (log2 units); sc[4j + e] is row qr[e >> 1],
      // key c·64 + 8j + 2·t4 + (e & 1)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = c * kBK + 8 * jj + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = col + (e & 1) < a.Lk ? sc[4 * jj + e] : -INFINITY;
          if constexpr (MASKED) x = fmaf(x, cl2, mk[4 * jj + e]);
          sc[4 * jj + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h] * sm);
        m_use[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m_run[h] - m_use[h]);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int i2 = 0; i2 < 32; ++i2) {
        const float pe = exp2f(fmaf(sc[i2], sm, -m_use[(i2 >> 1) & 1]));
        sc[i2] = pe;
        sum[(i2 >> 1) & 1] += pe;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + sum[h];
      }
      // P·V of chunk i-1 done: o may be rescaled, pa rewritten, its stage freed
      s9::wgmma_wait<0>();
      s9::fence_regs(o);
      if (i > 0) s9::bar_arrive(&empty[(ring + i - 1) % kStages]);
#pragma unroll
      for (int i2 = 0; i2 < DV / 2; ++i2) o[i2] *= alpha[(i2 >> 1) & 1];
      // keys 16kk .. 16kk+15 are the A fragment of logit tiles 2kk, 2kk+1
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      s9::fence_regs(sc);
      s9::wgmma_fence();
      if (i + 1 < n_it) {
        wait_full(i + 1);
        issue_s(i + 1);
      }
      const unsigned char* V = KV + ((ring + i) % kStages) * (T + TV) + T;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        s9::Wgmma<DV, 1>::rs(o, pa[kk], s9::desc_mn(V, 16 * kk, PB), 1);
      s9::wgmma_commit();
      if (i + 1 < n_it) {
        load_mask(c + 1);
        s9::wgmma_wait<1>();  // S of chunk i+1 (P·V of chunk i may still run)
        s9::fence_regs(sc);
      }
    }
    s9::wgmma_wait<0>();
    s9::fence_regs(o);
    if (n_it > 0) s9::bar_arrive(&empty[(ring + n_it - 1) % kStages]);
    s9::bar_arrive(&qfree[qb]);  // the producer may load the tile after next into it
    ring += n_it;

    // ---- epilogue ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qr[h] >= a.Lq) continue;
      const long long row = static_cast<long long>(bn) * a.Lq + qr[h];
      if (DV == HD && a.splits > 1) {
        // partial state of this key split: unnormalised o, (m, l)
        float* w = a.ws + (static_cast<long long>(blockIdx.z) * gridDim.y * a.Lq * HD) + row * HD;
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj)
          *reinterpret_cast<float2*>(w + 8 * jj + 2 * t4) =
              make_float2(o[4 * jj + 2 * h], o[4 * jj + 2 * h + 1]);
        if (t4 == 0)
          *reinterpret_cast<float2*>(a.ml + 2 * (static_cast<long long>(blockIdx.z) * gridDim.y *
                                                     a.Lq + row)) = make_float2(m_run[h], l_run[h]);
        continue;
      }
      // the four lanes of a quad hold the same row statistics
      if (a.lse != nullptr && t4 == 0 && c0 == 0)
        a.lse[row] = (m_run[h] + log2f(l_run[h])) * kLn2;
      const float inv = 1.f / l_run[h];
      bf16* orow = static_cast<bf16*>(a.out) + b * a.osb + n * a.osn + qr[h] * a.osr + c0;
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + 2 * t4) =
            __floats2bfloat162_rn(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
    }
  }
}

// Encode q's, k's and v's tensor maps and launch `kern` (an instance that
// calls attn_wg_body<HD, NW, ..., DV>) over (query tiles / a.tpb, B·N,
// splits, or HD / DV column slices); `attr_set` is the caller's
// once-per-instance flag for the shared-memory size.
template <int HD, int NW, int DV = HD, typename Kernel>
cudaError_t launch_attn(Kernel kern, bool& attr_set, const AttnArgs& a, int B,
                        cudaStream_t stream) {
  using Pl = WgPlan<HD, NW, DV>;
  if (DV < HD && a.splits != 1) return cudaErrorInvalidValue;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Pl::kSmem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap qm, km, vm;
  const long long qd[4] = {HD, a.Lq, a.N, B}, kd[4] = {HD, a.Lk, a.N, B};
  const long long qs[3] = {a.qsr, a.qsn, a.qsb}, ks[3] = {a.ksr, a.ksn, a.ksb},
                  vs[3] = {a.vsr, a.vsn, a.vsb};
  if (!s9::make_map(&qm, a.q, 4, qd, qs, 64) || !s9::make_map(&km, a.k, 4, kd, ks, kBK) ||
      !s9::make_map(&vm, a.v, 4, kd, vs, kBK))
    return cudaErrorInvalidValue;
  const int qtiles = (a.Lq + 64 * NW - 1) / (64 * NW);
  dim3 grid((qtiles + a.tpb - 1) / a.tpb, B * a.N, DV < HD ? HD / DV : a.splits);
  kern<<<grid, Pl::kThreads, Pl::kSmem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

}  // namespace attn
}  // namespace csts
