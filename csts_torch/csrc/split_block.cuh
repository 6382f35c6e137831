// The split whole block shared by B4 (pool_block.cu) and B5
// (decoder_block.cu), three launches of one C call (decoder_block.cu states
// the design and what it measured):
//  * the Q conv (conv_body: fused_block.cuh's conv_q on a few dozen output
//    tokens a block, several blocks an SM) into a bf16 scratch, q rounded
//    per head after norm_q;
//  * the attention: K1's wgmma body (attention_wg.cuh) with q from that
//    scratch and av written token-major into a second one;
//  * B5's back (tail_body): a persistent grid, one block an SM, walking row
//    tiles: res1 = skip + av·Wprojᵀ + bproj in fp32 into an fp32 scratch,
//    LN2 from it (two-pass fp32 statistics, rounded), then fc1 -> GELU ->
//    fc2 plus the dim-change proj, on wgmma fed by a TMA weight ring. (B4's
//    back is K2's split tail behind a proj GEMM, pool_block.cu: this one's
//    fc1, recomputed for every output pass, measured slower there.)
// The rounding points are the TPU kernels' (fused_block.cuh:12-18). The
// caller's .cu defines the __global__ kernels around the bodies (their names
// tell the profiler which block ran) and the instances.
#pragma once

#include "attention_wg.cuh"
#include "fused_block.cuh"
#include "sm90.cuh"

// phase stamps of csts_torch/tools/b5_phases.py (empty unless it defines
// them): the Q conv's run from stamp 0 to 1, the back's from 10 to 14
#ifndef CSTS_STAMP
#define CSTS_STAMP(k)
#endif

namespace csts {
namespace split {

using namespace csts::fb;
namespace s9 = csts::sm90;

// ---------------------------------------------------------------------------
// the front: the Q conv (+ norm_q) into a bf16 scratch, then attention
// ---------------------------------------------------------------------------

// output tokens a block of the Q conv: 12288 channels' worth (B5: 16 fine
// tokens at d2, 32 at d3, 64 at d4; B4: 64 coarse tokens at v1/a1, 32 at
// v3/a2), so that the block's fp32 tile stays near 48 KB and the tap weights
// it loads first are spread over enough work
__host__ __device__ inline int conv_rows(int C) { return C >= 768 ? 16 : C >= 384 ? 32 : 64; }

__host__ __device__ inline size_t conv_smem_bytes(int C, int hd) {
  return align128(sizeof(float) * conv_rows(C) * (C + 4)) + align128(sizeof(float) * 27 * hd) +
         align128(sizeof(float) * 2 * hd);
}

// fused_block.cuh's conv_q for conv_rows(C) output tokens (MODE kDecoder:
// the transposed conv's sub-pixel phases; kPool: the stride-(1,2,2) conv
// over the fine Q), in fp32, then norm_q, rounded once into q, whose clips
// are `lpad` rows apart (a multiple of the block's rows, so that a partial
// tile's zero rows stay inside its clip). The caller's kernel runs three
// blocks an SM: the conv's 16-byte tap loads are what it waits on. (Staging
// q in shared memory for 16-byte stores, at two blocks an SM, and staging
// the coarse taps in shared memory, one head and a slab of fine rows a
// block, both measured slower for B5.)
template <int MODE>
__device__ __forceinline__ void conv_body(const Args& a, bf16* q, int lpad) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  const int rows = conv_rows(a.C);
  float* S = reinterpret_cast<float*>(carve(p, sizeof(float) * rows * (a.C + 4)));
  float* Wc = reinterpret_cast<float*>(carve(p, sizeof(float) * 27 * a.hd));
  float* wb = reinterpret_cast<float*>(carve(p, sizeof(float) * 2 * a.hd));
  const int b = blockIdx.y, m0 = blockIdx.x * rows;
  CSTS_STAMP(0);
  conv_q<MODE, 128, bf16>(a, b, m0, rows, S, a.C + 4, Wc, q + ((long long)b * lpad + m0) * a.C,
                          a.C, wb);
  CSTS_STAMP(1);
}
// ---------------------------------------------------------------------------
// the back: res1, LN2 and the MLP tail on wgmma, fed by a TMA ring
// ---------------------------------------------------------------------------

struct TailArgs {
  const bf16 *skip, *bproj, *ln2_w, *ln2_b, *b1, *b2, *bp;
  float* res1;  // (rows, C) fp32 scratch
  bf16* out;    // (rows, Cout)
  int rows, H;
};

// C, COUT: widths; MS: the two warpgroups take 64 rows each (1) or share 64
// rows and split the columns (0); NCW, TCW, HCW: columns a warpgroup takes of
// a proj pass, of an output pass and of a hidden chunk; ST: ring stages,
// each 64 columns of the reduction (two 32-column panels) of up to R rows.
// The accumulators a thread holds at once (TCW/2 + HCW/2 = 80 floats) are
// sized for the 168 registers ptxas allows a 288-thread block; wider ones
// spilled and serialised the products (setmaxnreg did not lift that limit).
template <int C, int COUT, int MS, int NCW, int TCW, int HCW, int ST>
struct TailPlan {
  static constexpr int BM = MS ? 128 : 64;
  static constexpr int PW = MS ? NCW : 2 * NCW;   // proj columns a pass
  static constexpr int TW = MS ? TCW : 2 * TCW;   // output columns a pass
  static constexpr int TP = COUT / TW;            // output passes (fc1 runs in each)
  static constexpr int HC = MS ? HCW : 2 * HCW;   // hidden chunk
  static constexpr int R = PW > TW ? (PW > HC ? PW : HC) : (TW > HC ? TW : HC);  // stage rows
  static constexpr uint32_t kPanel = R * s9::kRowBytes, kStage = 2 * kPanel;
  static constexpr uint32_t kA = BM * C * 2, kG = BM * HC * 2;
  static constexpr int kThreads = 288;  // two consumer warpgroups and a producer warp
  static constexpr size_t kSmem = 1024 + kA + 2 * kG + ST * kStage + 8 * (2 * ST + 2);
  static_assert(COUT % TW == 0 && C % PW == 0 && C % 64 == 0 && HC % 64 == 0, "whole tiles");
  static_assert(kSmem <= csts::kMaxSmem, "shared memory");
};

// the ring, as each side walks it: stage i % ST, phase parity (i / ST) & 1;
// a stage holds two panels, panel_bytes apart
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  uint32_t stage_bytes, panel_bytes;
  int st;
  __device__ __forceinline__ int slot(int i) const { return i % st; }
  __device__ __forceinline__ uint32_t parity(int i) const { return (i / st) & 1; }
  __device__ __forceinline__ unsigned char* buf(int i) const { return stages + slot(i) * stage_bytes; }
};

// acc (64 x N, the warpgroup's rows) [+]= A · Bᵀ over `kp` 32-column panels
// (kp even): A's panels at a (stride a_panel bytes, rows offset already
// applied), B the next kp / 2 ring stages from row b_row0. Releases each
// stage once the product that read it has retired (one group left in flight).
template <int N>
__device__ __forceinline__ void ring_gemm(float (&acc)[N / 2], const unsigned char* a,
                                          uint32_t a_panel, int kp, int b_row0, const Ring& ring,
                                          int& i, bool accumulate) {
  s9::fence_regs(acc);
  s9::wgmma_fence();
  for (int p = 0; p < kp; p += 2, ++i) {
    s9::bar_wait(&ring.full[ring.slot(i)], ring.parity(i));
    const unsigned char* b = ring.buf(i) + b_row0 * s9::kRowBytes;
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        s9::Wgmma<N, 0>::ss(acc, s9::desc_k(a + (p + pp) * a_panel, ks),
                            s9::desc_k(b + pp * ring.panel_bytes, ks),
                            (accumulate || p > 0 || pp > 0 || ks > 0) ? 1 : 0);
    s9::wgmma_commit();
    s9::wgmma_wait<1>();
    if (p > 0) s9::bar_arrive(&ring.empty[ring.slot(i - 1)]);
  }
  s9::wgmma_wait<0>();
  s9::bar_arrive(&ring.empty[ring.slot(i - 1)]);
  s9::fence_regs(acc);
}

// The back's body, called by the caller's __global__ kernel (288 threads,
// TailPlan::kSmem bytes) with its __grid_constant__ tensor maps.
template <int C, int COUT, int MS, int NCW, int TCW, int HCW, int ST>
__device__ __forceinline__ void tail_body(const CUtensorMap& avmap, const CUtensorMap& wprojmap,
                                          const CUtensorMap& wpmap, const CUtensorMap& w1map,
                                          const CUtensorMap& w2map, const TailArgs& t) {
  using P = TailPlan<C, COUT, MS, NCW, TCW, HCW, ST>;
  constexpr int BM = P::BM, KC = C / 32, KH = P::HC / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* A = base;                  // av, then LN2(res1): C/32 panels of BM rows
  unsigned char* G = base + P::kA;          // two hidden chunks: HC/32 panels of BM rows each
  unsigned char* stages = G + 2 * P::kG;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + ST * P::kStage);
  uint64_t* empty = full + ST;
  uint64_t* afull = empty + ST;  // av of the row tile landed
  uint64_t* afree = afull + 1;   // LN2's output read by the tile's last fc1
  const Ring ring{stages, full, empty, P::kStage, P::kPanel, ST};
  const int tiles = (t.rows + BM - 1) / BM, H = t.H, nh = H / P::HC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      s9::bar_init(&full[s], 1);
      s9::bar_init(&empty[s], 256);
    }
    s9::bar_init(afull, 1);
    s9::bar_init(afree, 256);
    s9::bar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: per row tile, av, then the weight tiles in the order
    //      the consumers take them ----
    if (lane != 0) return;
    int i = 0, n = 0;
    // rows row0 .. row0+rows of a weight, reduction columns k0 .. k0+64
    auto load = [&](const CUtensorMap* map, int row0, int rows, int k0) {
      const int s = ring.slot(i);
      if (i >= ST) s9::bar_wait(&empty[s], ring.parity(i) ^ 1);
      s9::bar_expect(&full[s], 2 * rows * s9::kRowBytes);
      for (int pp = 0; pp < 2; ++pp)
        for (int r = 0; r < rows; r += 32)
          s9::tma_load_2d(ring.buf(i) + pp * P::kPanel + r * s9::kRowBytes, map, &full[s],
                          k0 + 32 * pp, row0 + r);
      ++i;
    };
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
      if (n > 0) s9::bar_wait(afree, (n - 1) & 1);
      s9::bar_expect(afull, P::kA);
      for (int p = 0; p < KC; ++p)
        for (int r = 0; r < BM; r += 64)
          s9::tma_load_2d(A + p * BM * s9::kRowBytes + r * s9::kRowBytes, &avmap, afull, 32 * p,
                          tile * BM + r);
      for (int c0 = 0; c0 < C; c0 += P::PW)
        for (int k = 0; k < KC; k += 2) load(&wprojmap, c0, P::PW, 32 * k);
      for (int tp = 0; tp < P::TP; ++tp) {
        for (int k = 0; k < KC; k += 2) load(&wpmap, tp * P::TW, P::TW, 32 * k);
        for (int h = 0; h < nh; ++h) {
          for (int k = 0; k < KC; k += 2) load(&w1map, h * P::HC, P::HC, 32 * k);
          for (int k = 0; k < KH; k += 2) load(&w2map, tp * P::TW, P::TW, h * P::HC + 32 * k);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int arow0 = MS ? 64 * wg : 0;          // the warpgroup's first row in the tile
  const uint32_t a_panel = BM * s9::kRowBytes, g_panel = BM * s9::kRowBytes;
  const unsigned char* Aw = A + arow0 * s9::kRowBytes;
  // When the warpgroups own their rows (MS), each waits only for itself
  // between phases, so one can run its GELU or LN2 while the other's
  // products run; when they share the rows, both wait.
  auto sync_rows = [&]() {
    if (MS)
      s9::named_sync(2 + wg, 128);
    else
      s9::named_sync(1, 256);
  };
  int i = 0, n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
    const long long row0 = (long long)tile * BM;
    const int valid = min(BM, t.rows - static_cast<int>(row0));
    // this thread's two rows of the tile (fragment rows g and g + 8)
    const int rr[2] = {arow0 + 16 * wl + g, arow0 + 16 * wl + g + 8};
    CSTS_STAMP(10);
    s9::bar_wait(afull, n & 1);

    // ---- res1 = skip + av · Wprojᵀ + bproj (fp32, to the scratch) ----
    for (int c0 = 0; c0 < C; c0 += P::PW) {
      float acc[NCW / 2];
      ring_gemm<NCW>(acc, Aw, a_panel, KC, MS ? 0 : wg * NCW, ring, i, false);
      const int cw = c0 + (MS ? 0 : wg * NCW);
      // four column tiles at a time, their loads issued before any store
#pragma unroll
      for (int j0 = 0; j0 < NCW / 8; j0 += 4) {
        float2 bv[4], sk[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cw + 8 * (j0 + j) + 2 * t4;
          bv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.bproj + c));
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sk[j][h] = rr[h] < valid ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                           t.skip + (row0 + rr[h]) * C + c))
                                     : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (rr[h] >= valid) continue;
            const int c = cw + 8 * (j0 + j) + 2 * t4, e = 4 * (j0 + j) + 2 * h;
            *reinterpret_cast<float2*>(t.res1 + (row0 + rr[h]) * C + c) = make_float2(
                acc[e] + (bv[j].x + sk[j][h].x), acc[e + 1] + (bv[j].y + sk[j][h].y));
          }
      }
    }
    CSTS_STAMP(11);
    sync_rows();  // res1 written; av read by every proj product

    // ---- LN2: a warp a row, two-pass fp32 statistics, into A (swizzled);
    //      RB rows of a warp load together, so their L2 reads overlap ----
    constexpr int PL = C / 32, RB = 1536 / C;
    const int lw = MS ? wl : warp, nlw = MS ? 4 : 8, lend = MS ? arow0 + 64 : BM;
    for (int r0 = (MS ? arow0 : 0) + lw * RB; r0 < lend; r0 += nlw * RB) {
      float x[RB][PL];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const bool live = r0 + rb < valid;
        const float* src = t.res1 + (row0 + r0 + rb) * C;
#pragma unroll
        for (int k = 0; k < PL; ++k) x[rb][k] = live ? src[lane + 32 * k] : 0.f;
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int r = r0 + rb;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < PL; ++k) sum += x[rb][k];
        const float mean = warp_sum(sum) / C;
        float var = 0.f;
#pragma unroll
        for (int k = 0; k < PL; ++k) {
          const float d = x[rb][k] - mean;
          var += d * d;
        }
        const float rstd = rsqrtf(warp_sum(var) / C + kLnEps);
        const bool live = r < valid;
#pragma unroll
        for (int k = 0; k < PL; ++k) {
          const int c = lane + 32 * k;
          const float y = live ? (x[rb][k] - mean) * rstd * __bfloat162float(t.ln2_w[c]) +
                                     __bfloat162float(t.ln2_b[c])
                               : 0.f;
          *reinterpret_cast<bf16*>(A + s9::swz64(r, c, BM)) = __float2bfloat16(y);
        }
      }
    }
    s9::fence_async_smem();
    sync_rows();
    CSTS_STAMP(12);

    // ---- out = LN2 · Wpᵀ + fc2(GELU(LN2 · W1ᵀ + b1)) + b2 + bp, by passes
    //      of TW output columns ----
    const int hcol = MS ? 0 : wg * HCW;  // the warpgroup's hidden columns in a chunk
    for (int tp = 0; tp < P::TP; ++tp) {
      float acc[TCW / 2];
      ring_gemm<TCW>(acc, Aw, a_panel, KC, MS ? 0 : wg * TCW, ring, i, false);
      for (int h = 0; h < nh; ++h) {
        float hid[HCW / 2];
        ring_gemm<HCW>(hid, Aw, a_panel, KC, hcol, ring, i, false);
        if (tp == P::TP - 1 && h == nh - 1) s9::bar_arrive(afree);  // A may take the next av
        unsigned char* Gb = G + ((tp * nh + h) & 1) * P::kG;
#pragma unroll
        for (int j = 0; j < HCW / 8; ++j) {
          const int c = hcol + 8 * j + 2 * t4;
          const float2 bv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.b1 + h * P::HC + c));
#pragma unroll
          for (int e = 0; e < 2; ++e)
            *reinterpret_cast<__nv_bfloat162*>(Gb + s9::swz64(rr[e], c, BM)) =
                __floats2bfloat162_rn(gelu_erf(hid[4 * j + 2 * e] + bv.x),
                                      gelu_erf(hid[4 * j + 2 * e + 1] + bv.y));
        }
        s9::fence_async_smem();
        sync_rows();  // the chunk's hidden complete (both halves when they share rows)
        ring_gemm<TCW>(acc, Gb + arow0 * s9::kRowBytes, g_panel, KH, MS ? 0 : wg * TCW, ring,
                       i, true);
      }
      CSTS_STAMP(13);
      const int cw = tp * P::TW + (MS ? 0 : wg * TCW);
#pragma unroll
      for (int j0 = 0; j0 < TCW / 8; j0 += 4) {
        float2 b2[4], bp[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cw + 8 * (j0 + j) + 2 * t4;
          b2[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.b2 + c));
          bp[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t.bp + c));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (rr[h] >= valid) continue;
            const int c = cw + 8 * (j0 + j) + 2 * t4, e = 4 * (j0 + j) + 2 * h;
            float v0 = acc[e] + b2[j].x, v1 = acc[e + 1] + b2[j].y;
            v0 += bp[j].x;
            v1 += bp[j].y;
            *reinterpret_cast<__nv_bfloat162*>(t.out + (row0 + rr[h]) * COUT + c) =
                __floats2bfloat162_rn(v0, v1);
          }
      }
      CSTS_STAMP(14);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The attention (`attn`, an instance calling attn_wg_body<HD, 2, false>)
// from q (B clips of q_rows rows of C columns, head h at columns h·hd) into
// av (B·L x C, token-major), the K/V pooled per head; attn_attr: the
// caller's once-per-instance flag for the shared-memory attribute. One wave
// of blocks, each walking its share of the (batch, head)'s query tiles.
template <int HD, typename AttnKernel>
cudaError_t launch_attention(AttnKernel attn, bool& attn_attr, const Args& a, int B,
                             const bf16* q, long long q_rows, bf16* av, cudaStream_t stream) {
  const int qtiles = (a.L + 127) / 128, tpb = (qtiles * B * a.N + sm_count() - 1) / sm_count();
  const long long C = a.C, hd = a.hd, kv = (long long)a.Lk * hd;
  csts::attn::AttnArgs at{q, a.k, a.v, nullptr, 0, av, nullptr, nullptr, nullptr, a.N, a.L,
                          a.Lk, a.hd, 1, tpb, q_rows * C, hd, C, a.N * kv, kv, hd, a.N * kv, kv,
                          hd, a.L * C, hd, C, a.scale};
  return csts::attn::launch_attn<HD, 2>(attn, attn_attr, at, B, stream);
}

// The Q conv (`conv`, an instance calling conv_body<MODE>), then the
// attention (launch_attention) from its scratch qf into av. conv_attr /
// attn_attr: the caller's flags for the shared-memory attribute (the
// largest conv size set so far; once for attn).
template <int HD, typename ConvKernel, typename AttnKernel>
cudaError_t launch_front(ConvKernel conv, size_t& conv_attr, AttnKernel attn, bool& attn_attr,
                         const Args& a, int B, bf16* qf, bf16* av, cudaStream_t stream) {
  const size_t smem = conv_smem_bytes(a.C, a.hd);
  if (smem > conv_attr) {
    cudaError_t e = cudaFuncSetAttribute(conv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    conv_attr = smem;
  }
  const int rows = conv_rows(a.C), lpad = (a.L + rows - 1) / rows * rows;
  conv<<<dim3(lpad / rows, B), kThreads, smem, stream>>>(a, qf, lpad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_attention<HD>(attn, attn_attr, a, B, qf, lpad, av, stream);
}

// The back (`kern`, an instance calling tail_body<C, COUT, ...>) over the
// B·L rows of av, one persistent block an SM.
template <int C, int COUT, int MS, int NCW, int TCW, int HCW, int ST, typename Kernel>
cudaError_t launch_tail(Kernel kern, bool& attr_set, const Args& a, int B, const bf16* av,
                        float* res1, cudaStream_t stream) {
  using P = TailPlan<C, COUT, MS, NCW, TCW, HCW, ST>;
  if (a.H % P::HC || a.wp == nullptr) return static_cast<cudaError_t>(kNoInstance);
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmem));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int rows = B * a.L, H = a.H;
  const long long avd[2] = {C, rows}, wd[2] = {C, C}, wpd[2] = {C, COUT}, w1d[2] = {C, H},
                  w2d[2] = {H, COUT};
  const long long sC[1] = {C}, sH[1] = {H};
  CUtensorMap avm, wprojm, wpm, w1m, w2m;
  if (!s9::make_map(&avm, av, 2, avd, sC, 64) || !s9::make_map(&wprojm, a.wproj, 2, wd, sC, 32) ||
      !s9::make_map(&wpm, a.wp, 2, wpd, sC, 32) || !s9::make_map(&w1m, a.w1, 2, w1d, sC, 32) ||
      !s9::make_map(&w2m, a.w2, 2, w2d, sH, 32))
    return cudaErrorInvalidValue;
  TailArgs t{static_cast<const bf16*>(a.skip), static_cast<const bf16*>(a.bproj),
             static_cast<const bf16*>(a.ln2_w), static_cast<const bf16*>(a.ln2_b),
             static_cast<const bf16*>(a.b1), static_cast<const bf16*>(a.b2),
             static_cast<const bf16*>(a.bp), res1, static_cast<bf16*>(a.out), rows, H};
  const int tiles = (rows + P::BM - 1) / P::BM;
  kern<<<min(tiles, sm_count()), P::kThreads, P::kSmem, stream>>>(avm, wprojm, wpm, w1m, w2m, t);
  return cudaGetLastError();
}

}  // namespace split
}  // namespace csts
