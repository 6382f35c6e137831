// B5: an upsample-Q decoder block: the depthwise transposed 3x3x3 conv
// (padding 1, stride (1,2,2) or (2,1,1), output_padding stride-1) over the
// coarse post-Wq Q -> norm_q -> attention against the pooled K/V -> proj over
// heads + the trilinear skip -> LN2 -> MLP (+proj) -> residual.
//
// Replaces csts_tpu/kernels/block.py:_decoder_kernel (called from
// _fused_decoder_impl; pallas_call at :1222). It serves d2, d3 and d4 (the
// JAX package's decoder blocks 1-3; block 0's 768->768 weights stay on K1+K2).
// The rounding points are the TPU kernel's (fused_block.cuh:12-18): q rounded
// per head after the conv and norm_q (both fp32), the probabilities rounded
// unnormalised before P·V, av rounded before proj, res1 fp32 and never
// rounded, LN2 (two-pass fp32 statistics) rounded before its products, the
// hidden rounded before fc2, one rounding of the output.
//
// Bound on the H100: 90-300 tensor-core operations per byte at every site,
// so the products bound it; proj, fc1, fc2 and the dim-change proj are ~95%
// of them (Lk is 64 at all three sites). The first design
// (fused_block.cuh's whole-block body, one 8-warp block an SM, mma.sync fed
// through two weight buffers with a block-wide barrier per tile, 32 tokens
// a block at d2) reached 46-72 TFLOP/s, and clock stamps in its phases
// (csts_torch/tools/b5_phases.py) gave the Q conv 17-38% of its time, the
// attention 12-15%, proj 10-14%, LN2 2-5% and the MLP tail 32-54%. This
// redesign is three launches of one C call:
//
//  * the Q conv (decoder_conv_kernel): fused_block.cuh's conv_q, unchanged
//    (sub-pixel phases of the transposed conv in fp32, norm_q), on 16-64
//    fine tokens a block, three blocks an SM, into a bf16 scratch: the
//    first design ran it at one 8-warp block an SM, where its gathers
//    waited on L2.
//  * the attention (decoder_attn_kernel): K1's wgmma body (attention_wg.cuh)
//    with q from that scratch, av token-major into a second one.
//  * the back (decoder_tail_kernel): a persistent grid, one block an SM,
//    walking row tiles of 64 (d2, d3) or 128 (d4) tokens: res1 = skip +
//    av·Wprojᵀ + bproj in fp32 into an fp32 scratch that the block reads
//    back at once (from L2), LN2 from it, then fc1 -> GELU -> fc2 plus the
//    dim-change proj. Products on wgmma (m64nNk16, A and B from shared
//    memory, fp32 accumulators in registers). A producer warp streams every
//    weight tile (64 columns of the reduction, up to 192 rows) through a
//    TMA ring of 4-8 stages with full/empty mbarriers, and loads the next
//    row tile's av as soon as the current one's last fc1 has read LN2's
//    output; the consumer warpgroups wait only on the tile they need, so
//    one row tile's epilogue overlaps the next tile's loads. At d2 each
//    weight tile serves 64 rows, twice the first design's 32; at d4 128.
//    res1 goes to global memory because 64 rows x 768 fp32 (192 KB) beside
//    av/LN2 (96 KB) exceed shared memory. At d2 and d3 the two warpgroups
//    share the 64 rows and split the columns (each hidden chunk exchanged
//    through shared memory); at d4 each owns 64 of 128 rows and they wait
//    only for themselves between phases. The accumulators are sized to the
//    168 registers ptxas gives a 288-thread block (96 columns a warpgroup,
//    d2 in two output passes, fc1 recomputed in each): wider ones spilled
//    and ptxas serialised the wgmma; setmaxnreg did not lift the limit.
// The fine Q, the probabilities, the hidden and LN2 never reach device
// memory; q, av and res1 do, once each (~0.03-0.06 ms of HBM time a site).
// Widths outside these instances (other (C, Cout) pairs, head dims other than
// 96 and 192, no dim-change proj) keep the first design's body: its
// instances, and its widest instance of each row split for any other width.
#include "attention_wg.cuh"
#include "fused_block.cuh"
#include "sm90.cuh"

// phase stamps of csts_torch/tools/b5_phases.py (empty unless it defines
// them): the Q conv's run from stamp 0 to 1, the back's from 10 to 14
#ifndef CSTS_STAMP
#define CSTS_STAMP(k)
#endif

using namespace csts;
using namespace csts::fb;
namespace s9 = csts::sm90;

namespace {

// ---------------------------------------------------------------------------
// the front: the Q conv (+ norm_q) into a bf16 scratch, then attention
// ---------------------------------------------------------------------------

// fine tokens a block of the Q conv: 12288 channels' worth (16 at d2, 32 at
// d3, 64 at d4), so that the block's fp32 tile stays near 48 KB and the tap
// weights it loads first are spread over enough work
__host__ __device__ inline int conv_rows(int C) { return C >= 768 ? 16 : C >= 384 ? 32 : 64; }

__host__ __device__ inline size_t conv_smem_bytes(int C, int hd) {
  return align128(sizeof(float) * conv_rows(C) * (C + 4)) + align128(sizeof(float) * 27 * hd) +
         align128(sizeof(float) * 2 * hd);
}

// fused_block.cuh's conv_q for conv_rows(C) fine tokens: the transposed
// conv's sub-pixel phases in fp32, norm_q, rounded once into q, whose clips
// are `lpad` rows apart (a multiple of the block's rows, so that a partial
// tile's zero rows stay inside its clip). Three blocks an SM: the conv's
// 16-byte tap loads are what it waits on. (Staging q in shared memory for
// 16-byte stores, at two blocks an SM, and staging the coarse taps in shared
// memory, one head and a slab of fine rows a block, both measured slower.)
__global__ void __launch_bounds__(kThreads, 3) decoder_conv_kernel(Args a, bf16* q, int lpad) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  const int rows = conv_rows(a.C);
  float* S = reinterpret_cast<float*>(carve(p, sizeof(float) * rows * (a.C + 4)));
  float* Wc = reinterpret_cast<float*>(carve(p, sizeof(float) * 27 * a.hd));
  float* wb = reinterpret_cast<float*>(carve(p, sizeof(float) * 2 * a.hd));
  const int b = blockIdx.y, m0 = blockIdx.x * rows;
  CSTS_STAMP(0);
  conv_q<kDecoder, 128, bf16>(a, b, m0, rows, S, a.C + 4, Wc,
                              q + ((long long)b * lpad + m0) * a.C, a.C, wb);
  CSTS_STAMP(1);
}

// attention per head against the pooled K/V: K1's wgmma body
// (attention_wg.cuh), q from the conv's scratch, av token-major into its own
template <int HD>
__global__ void __launch_bounds__(csts::attn::WgPlan<HD, 2>::kThreads, 1)
    decoder_attn_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, csts::attn::AttnArgs a) {
  csts::attn::attn_wg_body<HD, 2, false>(qmap, kmap, vmap, a);
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

template <int C, int COUT, int MS, int NCW, int TCW, int HCW, int ST>
__global__ void __launch_bounds__(288, 1)
    decoder_tail_kernel(const __grid_constant__ CUtensorMap avmap,
                        const __grid_constant__ CUtensorMap wprojmap,
                        const __grid_constant__ CUtensorMap wpmap,
                        const __grid_constant__ CUtensorMap w1map,
                        const __grid_constant__ CUtensorMap w2map, TailArgs t) {
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

cudaError_t launch_front(const Args& a, int B, bf16* qf, bf16* av, cudaStream_t stream) {
  const size_t smem = conv_smem_bytes(a.C, a.hd);
  static size_t attr = 0;  // the largest size set so far
  if (smem > attr) {
    cudaError_t e = cudaFuncSetAttribute(decoder_conv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr = smem;
  }
  const int rows = conv_rows(a.C), lpad = (a.L + rows - 1) / rows * rows;
  decoder_conv_kernel<<<dim3(lpad / rows, B), kThreads, smem, stream>>>(a, qf, lpad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // one wave of blocks, each walking its share of the (batch, head)'s query tiles
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int qtiles = (a.L + 127) / 128, tpb = (qtiles * B * a.N + sms - 1) / sms;
  const long long C = a.C, hd = a.hd, kv = (long long)a.Lk * hd;
  csts::attn::AttnArgs at{qf, a.k, a.v, nullptr, 0, av, nullptr, nullptr, nullptr, a.N, a.L,
                          a.Lk, a.hd, 1, tpb, lpad * C, hd, C, a.N * kv, kv, hd, a.N * kv, kv,
                          hd, a.L * C, hd, C, a.scale};
  if (a.hd == 96) {
    static bool set96 = false;
    return csts::attn::launch_attn<96, 2>(decoder_attn_kernel<96>, set96, at, B, stream);
  }
  static bool set192 = false;
  return csts::attn::launch_attn<192, 2>(decoder_attn_kernel<192>, set192, at, B, stream);
}

template <int C, int COUT, int MS, int NCW, int TCW, int HCW, int ST>
cudaError_t launch_tail(const Args& a, int B, const bf16* av, float* res1, cudaStream_t stream) {
  using P = TailPlan<C, COUT, MS, NCW, TCW, HCW, ST>;
  if (a.H % P::HC) return static_cast<cudaError_t>(kNoInstance);
  auto kern = decoder_tail_kernel<C, COUT, MS, NCW, TCW, HCW, ST>;
  static bool attr_set = false;  // once per instance
  static int sms = 0;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmem));
    if (e != cudaSuccess) return e;
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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
  kern<<<min(tiles, sms), P::kThreads, P::kSmem, stream>>>(avm, wprojm, wpm, w1m, w2m, t);
  return cudaGetLastError();
}

// Widths the redesign has no instance for take the first design's body
// (fused_block.cuh's block_mma_kernel, one launch), with the instances it
// had and, for any other width, the widest instance of its row split.
int launch_first_design(const Args& a, int B, cudaStream_t stream) {
  const Shape s = pick_shape(a);
  if (a.wp == nullptr && (s.nt != s.ntp || a.Cout != a.C)) return kNoInstance;
  CSTS_FB_CASE(kDecoder, 1, 12, 6, 256)   // 768 -> 384, head dim 192
  CSTS_FB_CASE(kDecoder, 2, 12, 6, 128)   // 384 -> 192
  CSTS_FB_CASE(kDecoder, 2, 6, 3, 128)    // 192 -> 96
  CSTS_FB_CASE(kDecoder, 1, 12, 6, 128)   // 768 -> 384, head dim up to 128
  return launch_widest<kDecoder, true>(s, a, B, stream);  // any other width (small_cfg's among them)
}

// Three launches: the Q conv, the attention (head dims 96 and 192: d3, d4
// and d2), the back (its instances: (C, Cout) of d2, d3 and d4, H a multiple
// of the hidden chunk); any other widths go to the first design.
int launch_bf16(const Args& a, int B, bf16* qf, bf16* av, float* res1, cudaStream_t s) {
  const bool d2 = a.C == 768 && a.Cout == 384, d3 = a.C == 384 && a.Cout == 192,
             d4 = a.C == 192 && a.Cout == 96;
  if (a.wp == nullptr || (a.hd != 96 && a.hd != 192) || !(d2 || d3 || d4) ||
      a.H % (d4 ? 64 : 128))
    return launch_first_design(a, B, s);
  cudaError_t e = launch_front(a, B, qf, av, s);
  if (e != cudaSuccess) return e;
  // d2: 64 rows, two output passes; d3: 64 rows, one pass; d4: 128 rows
  if (d2) return launch_tail<768, 384, 0, 96, 96, 64, 4>(a, B, av, res1, s);
  if (d3) return launch_tail<384, 192, 0, 96, 96, 64, 6>(a, B, av, res1, s);
  return launch_tail<192, 96, 1, 96, 96, 64, 8>(a, B, av, res1, s);
}

}  // namespace

// The shared whole-block signature (fused_block.cuh) plus B5's three scratch
// buffers: the fine q (B x (L + 64) x C) and av (B·L x C), both in the
// activation dtype, and res1 (B·L x C fp32), all unused by the fp32 body.
extern "C" int csts_fused_decoder_block(
    int dtype, const void* x, const void* q, const void* skip, const void* k, const void* v,
    const void* ln1_w, const void* ln1_b, const void* wq, const void* bq, const void* wconv,
    const void* nq_w, const void* nq_b, const void* wproj, const void* bproj, const void* ln2_w,
    const void* ln2_b, const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wp, const void* bp, void* out, void* qf, void* av, void* res1, long long q_rs,
    int B, int L,
    int C, int Cout, int H, int N, int hd, int Lk, int T, int Hh, int W, int Ts, int Hs, int Ws,
    int st, int sh, int sw, float scale, void* stream) {
  Args a{x,    q,     skip, k,  v,  ln1_w, ln1_b, wq, bq, wconv, nq_w, nq_b, wproj, bproj,
         ln2_w, ln2_b, w1,  b1, w2, b2,    wp,    bp, out, q_rs, L,   C,    Cout,  H,
         N,    hd,    Lk,   T,  Hh, W,     Ts,    Hs, Ws,  st,   sh,  sw,   scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csts::kFloat32) return launch_f32<kDecoder>(a, B, s);
  if (dtype != csts::kBFloat16 || qf == nullptr || av == nullptr || res1 == nullptr)
    return cudaErrorInvalidValue;
  return launch_bf16(a, B, static_cast<bf16*>(qf), static_cast<bf16*>(av),
                     static_cast<float*>(res1), s);
}
