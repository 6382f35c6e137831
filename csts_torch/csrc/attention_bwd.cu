// B8: the backward of the multiscale attention core (K1). Given q, k, v,
// K1's output o, its per-row log-sum-exp lse and the incoming gradient g:
//   delta = rowsum(g·o),  p = exp(q kᵀ · scale − lse) (= softmax, fp32 logits),
//   dl = p·(g vᵀ − delta),  dq = dl k · scale,  dk = dlᵀ q · scale,  dv = pᵀ g.
//
// Replaces csts_tpu/kernels/attention.py:_flash_bwd_kernel (pallas_call in
// _flash_bwd_impl). As there, the probabilities are rebuilt on chip from q
// and k and never reach device memory; delta and the softmax stay fp32. The
// tensor-core products take p and dl rounded to bf16 (the TPU kernel keeps
// them fp32 and multiplies in fp32); the plain version rounds at the same
// points.
//
// Bound on the H100: five products of 2·Lq·Lk·hd operations per (batch·head)
// (q kᵀ, g vᵀ, dq, dk, dv) against reading q, o, g, dq (Lq·hd each) and k,
// v, dk, dv (Lk·hd each): about 2.5·Lk operations per byte in bf16, so the
// Lk 64 decoder sites (160 per byte) are bound by bytes and the Lk 256 and
// 1024 encoder sites by the tensor cores.
//
// Design (bf16), for Hopper. The TPU kernel walks q tiles in order and
// accumulates dk and dv in place across them; blocks of a GPU grid run in
// parallel, so that order cannot carry over. Two passes and, where the
// queries are chunked, a reduction, in stream order:
//  1. dq (dq_wg_kernel): a block of one warpgroup takes 64 query rows of one
//     (batch, head), K1's layout: q and g stay in shared memory, the key
//     chunks of k and v stream through a TMA ring. S = q kᵀ and dP = g vᵀ
//     are wgmma m64n64k16 with both operands in shared memory; p = exp2(S·
//     scale·log2 e − lse·log2 e) with lse from K1 (one pass over the keys)
//     and dl = p·(dP − delta) stay in registers; dq += dl k is wgmma with dl
//     rounded to bf16 as the register operand and k read MN-major. The pass
//     also writes delta (and lse, padded to whole tiles) for pass 2. dq is
//     not built from per-key-tile partials: at the flagship's Lk of 64-1024
//     an fp32 partial per key tile costs more memory time than recomputing
//     S and dP here.
//  2. dk, dv (dkdv_wg_kernel): a block takes 64 keys, k and v resident, and
//     walks the query tiles of its chunk through the ring (q, g and their 64
//     lse and delta values, the last two by bulk copy): Sᵀ = k qᵀ and dPᵀ =
//     v gᵀ on wgmma, pᵀ and dlᵀ in registers, then dv += pᵀ g and dk += dlᵀ
//     q with pᵀ and dlᵀ as register operands, as K1 passes P. Chunking the
//     queries gives the short-key sites enough blocks (d4: Lk 64, Lq 32768).
//  3. With more than one chunk, the fp32 partial dk and dv of each chunk go
//     to a workspace and a third launch sums them in chunk order.
// The result does not depend on which block ran first (no atomics): the
// same inputs give bit-equal dq, dk and dv.
//  * One warpgroup a block, and no producer warp: thread 0 issues the TMA
//    loads of a stage once the warpgroup's products have read it. ptxas then
//    gives a thread up to 255 registers (a block of two warpgroups and a warp
//    gets 168), and two blocks share an SM where their shared memory fits
//    (head dims 64-128), so one block's softmax overlaps the other's
//    products.
//  * The accumulators a thread holds are the output columns it owns: up to
//    192 dq columns (96 registers) beside S and dP (64), and 96 dk and 96 dv
//    columns. Wider head dims split the output columns over blocks (grid z),
//    each recomputing S and dP over the whole head dim and reading its own
//    columns of the operands: dq in 128-column blocks above 192, dk/dv in
//    64- or 96-column blocks from 128 on. That is what takes head dims 256
//    and 384 (the largest instance: k, v and one 384-column stage of q and g
//    fill the shared memory).
// Ragged edges: rows past Lq and keys past Lk load as zeros (TMA's
// out-of-bounds fill); keys past Lk get p = 0 in the dq pass and are not
// stored by the dk/dv pass; rows past Lq have lse = +inf (p = 0) and delta =
// 0. q, k, v, o, g and dq are addressed through (batch, head, row) strides
// with unit columns (16-byte aligned, the wrapper checks).
//
// fp32 inputs (the exactness check against the plain version) take simple
// bodies with the same passes and exact FMA products in shared memory
// (dq_streamed_kernel, dkdv_streamed_kernel): the head dim streamed in
// 64-column steps (S and dP summed over them, the products into dq, dk and
// dv walked in them) and the rows a block takes cut until its accumulators
// fit, so that they run at any head dim (the whole-head-dim tiles they held
// before stopped at ~224). bf16 head dims above 384, which no wgmma instance
// holds, take the same bodies with B8's rounding points (p and dl rounded to
// bf16 before the products, one rounding of each output), chosen by (head
// dim, dtype) before the launch.
#include "common.cuh"
#include "sm90.cuh"

using namespace csts;

namespace {

struct BwdArgs {
  const void *q, *k, *v, *o, *g;
  const float* lse;  // (B·N, Lq), K1's
  // written by the dq pass: (B·N, Lq) for the fp32 bodies; the bf16 body
  // pads the rows of lse_pad and delta to whole query tiles ((B·N, Lq_pad),
  // +inf and 0 past Lq), so that the dk/dv pass copies 64 of each at once
  float* delta;
  float* lse_pad;
  void* dq;          // (B, N, Lq, hd) through strides
  void *dk, *dv;     // (B·N, Lk, hd) contiguous
  float* ws;         // (chunks, 2, B·N, Lk, hd) fp32 partials; null with one chunk
  int BNh, N, Lq, Lk, hd, Lq_pad;
  long long qsb, qsn, qsr, ksb, ksn, ksr, vsb, vsn, vsr, osb, osn, osr, gsb, gsn, gsr;
  long long dqsb, dqsn, dqsr;
  int tiles_per_chunk, chunks;  // of the dk/dv pass
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* head(const void* base, int bn, int N, long long sb,
                                         long long sn) {
  return static_cast<const T*>(base) + (bn / N) * sb + (bn % N) * sn;
}

// write the chunk's dk (scaled) and dv at key `key`, columns d, d + 1
template <typename T>
__device__ __forceinline__ void store_dkdv(const BwdArgs& a, int chunk, int bn, int key, int d,
                                           float dk0, float dk1, float dv0, float dv1) {
  const long long off = ((long long)bn * a.Lk + key) * a.hd + d;
  if (a.chunks == 1) {
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    dk[off] = from_f32<T>(dk0 * a.scale);
    dk[off + 1] = from_f32<T>(dk1 * a.scale);
    dv[off] = from_f32<T>(dv0);
    dv[off + 1] = from_f32<T>(dv1);
  } else {
    const long long plane = (long long)a.BNh * a.Lk * a.hd;
    float* wk = a.ws + 2 * chunk * plane + off;
    wk[0] = dk0 * a.scale;
    wk[1] = dk1 * a.scale;
    wk[plane] = dv0;
    wk[plane + 1] = dv1;
  }
}

// dk, dv = the sum of the chunks' partials, in chunk order
template <typename T>
__global__ void reduce_kernel(BwdArgs a) {
  const long long plane = (long long)a.BNh * a.Lk * a.hd;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < 2 * plane;
       idx += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < a.chunks; ++c) s += a.ws[2 * c * plane + idx];
    T* dst = static_cast<T*>(idx < plane ? a.dk : a.dv);
    dst[idx < plane ? idx : idx - plane] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma bodies fed by TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace s9 = csts::sm90;

constexpr int kBQ = 64;  // query rows of a tile
constexpr int kBK = 64;  // keys of a chunk / of a dk-dv block
constexpr int kWgThreads = 128;  // one warpgroup a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kPB = 64 * s9::kRowBytes;  // one 32-column panel of a 64-row tile
// shared memory a block may take so that two blocks share an SM
constexpr uint32_t kHalfSm = 112 * 1024;

// ring stages that fit beside `resident` bytes: up to 4, as many as leave
// room for a second block on the SM where at least two do, else as many as
// one block may hold (at least one)
__host__ __device__ constexpr int ring_stages(uint32_t resident, uint32_t stage) {
  const uint32_t room = (resident + 2 * stage + 2048 <= kHalfSm ? kHalfSm
                                                                : static_cast<uint32_t>(kMaxSmem)) -
                        2048 - resident;
  return room / stage > 4 ? 4 : static_cast<int>(room / stage);
}

template <int HD>
struct BwdPlan {
  static constexpr int P = HD / s9::kPanel;  // 32-column panels of a row
  static constexpr uint32_t kT = P * kPB;    // a 64-row tile, all HD columns
  // the output columns a block holds in registers (a 64 x D fp32 accumulator
  // is D/2 registers a thread): the dq pass's one accumulator up to 192
  // columns, the dk/dv pass's two up to 96 each; wider head dims split the
  // columns over blocks (grid z), each recomputing S and dP
  static constexpr int DQ = HD <= 192 ? HD : 128;
  static constexpr int DKV = HD == 64 || HD == 96 ? HD : HD == 192 || HD == 384 ? 96 : 64;
  static constexpr int SQ = HD / DQ, SKV = HD / DKV;
  // dq pass: q and g resident, a stage holds a key chunk of k and of v
  static constexpr int NSQ = ring_stages(2 * kT, 2 * kT);
  static constexpr size_t kSmemQ = 1024 + 2 * kT + NSQ * 2 * kT + 8 * (NSQ + 1);
  // dk/dv pass: k and v resident, a stage holds a query tile of q and of g
  // and its 64 lse and 64 delta values
  static constexpr int NSKV = ring_stages(2 * kT, 2 * kT + 512);
  static constexpr size_t kSmemKV = 1024 + 2 * kT + NSKV * (2 * kT + 512) + 8 * (NSKV + 1);
  static_assert(HD % s9::kPanel == 0 && HD % DQ == 0 && HD % DKV == 0, "head dim");
  static_assert(NSQ >= 1 && NSKV >= 1 && kSmemQ <= kMaxSmem && kSmemKV <= kMaxSmem, "smem");
};

// S (64 x 64 fp32) = A · Bᵀ over HD, A and B 64-row tiles in shared memory
// (K-major panels), issued asynchronously (the caller commits)
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[32], const unsigned char* A,
                                        const unsigned char* B) {
#pragma unroll
  for (int p = 0; p < HD / s9::kPanel; ++p)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      s9::Wgmma<64, 0>::ss(s, s9::desc_k(A + p * kPB, ks), s9::desc_k(B + p * kPB, ks),
                           (p | ks) != 0);
}

// the 64 x 64 accumulator tile rounded to bf16 as the four k16 A fragments
// of an rs product (keys or query rows 16kk .. 16kk+15 are its columns)
__device__ __forceinline__ void to_frags(const float (&s)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[kk][e] = pack_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// acc (64 x D) += F · B[:, c0 .. c0+D), F the fragments of a 64 x 64 tile
// and B a 64-row tile whose rows are the contraction (MN-major)
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2], const uint32_t (&f)[4][4],
                                          const unsigned char* B, int c0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    s9::Wgmma<D, 1>::rs(acc, f[kk], s9::desc_mn(B + (c0 / s9::kPanel) * kPB, 16 * kk, kPB), 1);
}

// The dq pass: a block takes 64 query rows of one (batch, head) and DQ of
// their dq columns (blockIdx.z), computes delta = rowsum(g·o) for its rows
// (the first column block also writes lse and delta padded to whole tiles
// for the dk/dv pass: +inf and 0 past Lq), then walks the key chunks: S = q
// kᵀ and dP = g vᵀ on wgmma, p = exp(S·scale − lse) and dl = p·(dP − delta)
// in registers, dq += dl k with dl as the register operand.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wg_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                 BwdArgs a) {
  using Pl = BwdPlan<HD>;
  constexpr int D = Pl::DQ, NS = Pl::NSQ;
  constexpr uint32_t T = Pl::kT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Qs = base;
  unsigned char* Gs = base + T;
  unsigned char* ring = base + 2 * T;  // stage s: k at ring + 2sT, v at + T
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * 2 * T);
  uint64_t* qbar = full + NS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
  const int bn = blockIdx.y, b = bn / a.N, n = bn % a.N, q0 = blockIdx.x * kBQ;
  const int c0 = blockIdx.z * D;
  const int nchunks = (a.Lk + kBK - 1) / kBK;

  auto load_chunk = [&](int c) {
    const int s = c % NS;
    s9::bar_expect(&full[s], 2 * T);
    unsigned char* K = ring + 2 * s * T;
    for (int p = 0; p < Pl::P; ++p) {
      s9::tma_load_4d(K + p * kPB, &kmap, &full[s], p * s9::kPanel, c * kBK, n, b);
      s9::tma_load_4d(K + T + p * kPB, &vmap, &full[s], p * s9::kPanel, c * kBK, n, b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) s9::bar_init(&full[s], 1);
    s9::bar_init(qbar, 1);
    s9::bar_init_fence();
  }
  __syncthreads();  // the barriers initialised before anyone waits on them
  if (tid == 0) {
    s9::bar_expect(qbar, 2 * T);
    for (int p = 0; p < Pl::P; ++p) {
      s9::tma_load_4d(Qs + p * kPB, &qmap, qbar, p * s9::kPanel, q0, n, b);
      s9::tma_load_4d(Gs + p * kPB, &gmap, qbar, p * s9::kPanel, q0, n, b);
    }
    for (int c = 0; c < NS && c < nchunks; ++c) load_chunk(c);
  }

  // delta and lse of this thread's two rows (the four lanes of a quad share
  // a row and split its columns), while the loads are in flight
  const int qr[2] = {q0 + 16 * warp + g4, q0 + 16 * warp + g4 + 8};
  const bf16* gb = head<bf16>(a.g, bn, a.N, a.gsb, a.gsn);
  const bf16* ob = head<bf16>(a.o, bn, a.N, a.osb, a.osn);
  float delta[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
    if (qr[h] < a.Lq) {
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) {
        const int col = 32 * j + 8 * t4;
        const uint4 gu = *reinterpret_cast<const uint4*>(gb + qr[h] * a.gsr + col);
        const uint4 ou = *reinterpret_cast<const uint4*>(ob + qr[h] * a.osr + col);
        const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gu);
        const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ou);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(gh[e]), of = __bfloat1622float2(oh[e]);
          s = fmaf(gf.x, of.x, fmaf(gf.y, of.y, s));
        }
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    delta[h] = s;
    const float l = qr[h] < a.Lq ? a.lse[(long long)bn * a.Lq + qr[h]] : INFINITY;
    lse2[h] = l * kLog2e;
    if (blockIdx.z == 0 && t4 == 0) {
      const long long i = (long long)bn * a.Lq_pad + qr[h];
      a.lse_pad[i] = l;
      a.delta[i] = qr[h] < a.Lq ? s : 0.f;
    }
  }
  const float cl2 = a.scale * kLog2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t fr[4][4];
  // S and dP of chunk c into sc and dp, asynchronously (one commit group)
  auto issue_sdp = [&](int c) {
    const int s = c % NS;
    s9::bar_wait(&full[s], (c / NS) & 1);
    const unsigned char* K = ring + 2 * s * T;
    s9::wgmma_fence();
    issue_s<HD>(sc, Qs, K);
    issue_s<HD>(dp, Gs, K + T);
    s9::wgmma_commit();
  };
  // dl of chunk c from its S and dP (sc[4j + e] is row qr[e >> 1], key
  // c·64 + 8j + 2·t4 + (e & 1)), rounded into the fragments once dq's
  // product of the chunk before has retired (`retired`)
  auto make_dl = [&](int c, auto retired) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c * kBK + 8 * jj + 2 * t4 + (e & 1), h = e >> 1;
        const float pe = key < a.Lk ? exp2f(fmaf(sc[4 * jj + e], cl2, -lse2[h])) : 0.f;
        sc[4 * jj + e] = pe * (dp[4 * jj + e] - delta[h]);
      }
    retired();
    to_frags(sc, fr);
    s9::fence_regs(sc);
  };
  auto issue_dq = [&](int c) {
    s9::wgmma_fence();
    issue_acc<D>(acc, fr, ring + 2 * (c % NS) * T, c0);
    s9::wgmma_commit();
  };
  // dq's products so far retired; then chunk c's stage takes chunk c + NS
  auto reload = [&](int c) {
    s9::wgmma_wait<0>();
    s9::fence_regs(acc);
    __syncthreads();  // every warp's products have read the stage
    if (tid == 0 && c + NS < nchunks) load_chunk(c + NS);
  };
  s9::bar_wait(qbar, 0);
  if constexpr (NS >= 2) {
    // Software-pipelined: S and dP of chunk c+1 are issued ahead of dq's
    // product of chunk c, so the exponentials of chunk c+1 run while that
    // product is in the tensor cores. The last chunk is peeled off, so that
    // no product is issued under a branch (ptxas would serialise them, C7520).
    issue_sdp(0);
    s9::wgmma_wait<0>();
    s9::fence_regs(sc);
    s9::fence_regs(dp);
    for (int c = 0; c + 1 < nchunks; ++c) {
      make_dl(c, [&] {
        if (c > 0) reload(c - 1);
      });
      issue_sdp(c + 1);
      issue_dq(c);
      s9::wgmma_wait<1>();  // S and dP of chunk c+1 (dq's product of chunk c may still run)
      s9::fence_regs(sc);
      s9::fence_regs(dp);
    }
    make_dl(nchunks - 1, [&] {
      if (nchunks > 1) reload(nchunks - 2);
    });
    issue_dq(nchunks - 1);
  } else {
    // one stage (head dim 384): chunk by chunk
    for (int c = 0; c < nchunks; ++c) {
      issue_sdp(c);
      s9::wgmma_wait<0>();
      s9::fence_regs(sc);
      s9::fence_regs(dp);
      make_dl(c, [] {});
      issue_dq(c);
      reload(c);
    }
  }
  s9::wgmma_wait<0>();
  s9::fence_regs(acc);

  bf16* dqb = static_cast<bf16*>(a.dq) + (bn / a.N) * a.dqsb + (bn % a.N) * a.dqsn;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qr[h] >= a.Lq) continue;
    bf16* row = dqb + qr[h] * a.dqsr + c0;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * jj + 2 * t4) = __floats2bfloat162_rn(
          acc[4 * jj + 2 * h] * a.scale, acc[4 * jj + 2 * h + 1] * a.scale);
  }
}

// The dk/dv pass: a block takes 64 keys of one (batch, head), DKV of their
// dk and dv columns and one chunk of the query tiles (grid (key tiles,
// chunks, B·N x column blocks)), with k and v resident, and walks the query
// tiles: Sᵀ = k qᵀ and dPᵀ = v gᵀ on wgmma, pᵀ = exp(Sᵀ·scale − lse) and
// dlᵀ = pᵀ·(dPᵀ − delta) in registers (lse and delta per query row from the
// stage), dv += pᵀ g and dk += dlᵀ q with pᵀ and dlᵀ as register operands.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkdv_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, BwdArgs a) {
  using Pl = BwdPlan<HD>;
  constexpr int D = Pl::DKV, NS = Pl::NSKV;
  constexpr uint32_t T = Pl::kT, ST = 2 * T;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Ks = base;
  unsigned char* Vs = base + T;
  unsigned char* ring = base + 2 * T;  // stage s: q at ring + s·ST, g at + T
  float* lsd = reinterpret_cast<float*>(ring + NS * ST);  // stage s: lse at 128s, delta at + 64
  uint64_t* full = reinterpret_cast<uint64_t*>(lsd + 128 * NS);
  uint64_t* kbar = full + NS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBK, chunk = blockIdx.y;
  const int bn = blockIdx.z / Pl::SKV, c0 = (blockIdx.z % Pl::SKV) * D;
  const int b = bn / a.N, n = bn % a.N;
  const int tiles = (a.Lq + kBQ - 1) / kBQ;
  const int t_begin = chunk * a.tiles_per_chunk;
  const int n_it = min(tiles, t_begin + a.tiles_per_chunk) - t_begin;

  auto load_tile = [&](int i) {
    const int s = i % NS, r0 = (t_begin + i) * kBQ;
    unsigned char* st = ring + s * ST;
    s9::bar_expect(&full[s], 2 * T + 512);
    for (int p = 0; p < Pl::P; ++p) {
      s9::tma_load_4d(st + p * kPB, &qmap, &full[s], p * s9::kPanel, r0, n, b);
      s9::tma_load_4d(st + T + p * kPB, &gmap, &full[s], p * s9::kPanel, r0, n, b);
    }
    const long long row = (long long)bn * a.Lq_pad + r0;
    s9::bulk_load(lsd + 128 * s, a.lse_pad + row, 256, &full[s]);
    s9::bulk_load(lsd + 128 * s + 64, a.delta + row, 256, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) s9::bar_init(&full[s], 1);
    s9::bar_init(kbar, 1);
    s9::bar_init_fence();
  }
  __syncthreads();  // the barriers initialised before anyone waits on them
  if (tid == 0) {
    s9::bar_expect(kbar, 2 * T);
    for (int p = 0; p < Pl::P; ++p) {
      s9::tma_load_4d(Ks + p * kPB, &kmap, kbar, p * s9::kPanel, k0, n, b);
      s9::tma_load_4d(Vs + p * kPB, &vmap, kbar, p * s9::kPanel, k0, n, b);
    }
    for (int i = 0; i < NS && i < n_it; ++i) load_tile(i);
  }
  const float cl2 = a.scale * kLog2e;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float st_[32], dpt[32];
  uint32_t pf[4][4], df[4][4];
  // Sᵀ and dPᵀ of query tile i into st_ and dpt, asynchronously
  auto issue_sdp = [&](int i) {
    const int s = i % NS;
    s9::bar_wait(&full[s], (i / NS) & 1);
    const unsigned char* Qt = ring + s * ST;
    s9::wgmma_fence();
    issue_s<HD>(st_, Ks, Qt);
    issue_s<HD>(dpt, Vs, Qt + T);
    s9::wgmma_commit();
  };
  // pᵀ and dlᵀ of tile i (st_[4j + e] is key k0 + 16·warp + g4 + 8·(e >> 1),
  // query row 8j + 2·t4 + (e & 1) of the tile; rows past Lq have lse +inf,
  // so p = 0, and delta 0), rounded into the fragments once the products of
  // the tile before have retired (`retired`)
  auto make_p = [&](int i, auto retired) {
    const float* L = lsd + 128 * (i % NS);
    const float* Dl = L + 64;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * jj + 2 * t4 + (e & 1);
        const float pe = exp2f(fmaf(st_[4 * jj + e], cl2, -L[r] * kLog2e));
        dpt[4 * jj + e] = pe * (dpt[4 * jj + e] - Dl[r]);
        st_[4 * jj + e] = pe;
      }
    retired();
    to_frags(st_, pf);
    to_frags(dpt, df);
    s9::fence_regs(st_);
    s9::fence_regs(dpt);
  };
  auto issue_dkdv = [&](int i) {
    const unsigned char* Qt = ring + (i % NS) * ST;
    s9::wgmma_fence();
    issue_acc<D>(dv, pf, Qt + T, c0);
    issue_acc<D>(dk, df, Qt, c0);
    s9::wgmma_commit();
  };
  // the products so far retired; then tile i's stage takes tile i + NS
  auto reload = [&](int i) {
    s9::wgmma_wait<0>();
    s9::fence_regs(dv);
    s9::fence_regs(dk);
    __syncthreads();  // every warp's products have read the stage
    if (tid == 0 && i + NS < n_it) load_tile(i + NS);
  };
  // every chunk has at least one tile
  s9::bar_wait(kbar, 0);
  if constexpr (NS >= 2) {
    // pipelined as the dq pass: Sᵀ and dPᵀ of tile i+1 ahead of the dk and
    // dv products of tile i, the last tile peeled off
    issue_sdp(0);
    s9::wgmma_wait<0>();
    s9::fence_regs(st_);
    s9::fence_regs(dpt);
    for (int i = 0; i + 1 < n_it; ++i) {
      make_p(i, [&] {
        if (i > 0) reload(i - 1);
      });
      issue_sdp(i + 1);
      issue_dkdv(i);
      s9::wgmma_wait<1>();
      s9::fence_regs(st_);
      s9::fence_regs(dpt);
    }
    make_p(n_it - 1, [&] {
      if (n_it > 1) reload(n_it - 2);
    });
    issue_dkdv(n_it - 1);
  } else {
    // one stage (head dim 384): tile by tile
    for (int i = 0; i < n_it; ++i) {
      issue_sdp(i);
      s9::wgmma_wait<0>();
      s9::fence_regs(st_);
      s9::fence_regs(dpt);
      make_p(i, [] {});
      issue_dkdv(i);
      reload(i);
    }
  }
  s9::wgmma_wait<0>();
  s9::fence_regs(dv);
  s9::fence_regs(dk);

  // keys past Lk (zero rows of k and v) are not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + g4 + 8 * h;
    if (key >= a.Lk) continue;
    const long long off = ((long long)bn * a.Lk + key) * a.hd + c0;
    if (a.chunks == 1) {
      bf16* dkr = static_cast<bf16*>(a.dk) + off;
      bf16* dvr = static_cast<bf16*>(a.dv) + off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int c = 8 * jj + 2 * t4, e = 4 * jj + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(dkr + c) =
            __floats2bfloat162_rn(dk[e] * a.scale, dk[e + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + c) = __floats2bfloat162_rn(dv[e], dv[e + 1]);
      }
    } else {
      const long long plane = (long long)a.BNh * a.Lk * a.hd;
      float* wk = a.ws + 2 * chunk * plane + off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int c = 8 * jj + 2 * t4, e = 4 * jj + 2 * h;
        *reinterpret_cast<float2*>(wk + c) = make_float2(dk[e] * a.scale, dk[e + 1] * a.scale);
        *reinterpret_cast<float2*>(wk + plane + c) = make_float2(dv[e], dv[e + 1]);
      }
    }
  }
}

// Encode the four tensor maps, then the dq pass, the dk/dv pass and, with
// more than one query chunk, the reduction, in stream order.
template <int HD>
cudaError_t launch_wg(BwdArgs a, int max_chunks, int B, cudaStream_t stream) {
  using Pl = BwdPlan<HD>;
  auto kq = dq_wg_kernel<HD>;
  auto kkv = dkdv_wg_kernel<HD>;
  static bool attr_set = false;  // once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Pl::kSmemQ));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Pl::kSmemKV));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  CUtensorMap qm, gm, km, vm;
  const long long qd[4] = {HD, a.Lq, a.N, B}, kd[4] = {HD, a.Lk, a.N, B};
  const long long qs[3] = {a.qsr, a.qsn, a.qsb}, gs[3] = {a.gsr, a.gsn, a.gsb},
                  ks[3] = {a.ksr, a.ksn, a.ksb}, vs[3] = {a.vsr, a.vsn, a.vsb};
  if (!s9::make_map(&qm, a.q, 4, qd, qs, kBQ) || !s9::make_map(&gm, a.g, 4, qd, gs, kBQ) ||
      !s9::make_map(&km, a.k, 4, kd, ks, kBK) || !s9::make_map(&vm, a.v, 4, kd, vs, kBK))
    return cudaErrorInvalidValue;
  const int tiles = (a.Lq + kBQ - 1) / kBQ;
  a.tiles_per_chunk = (tiles + max_chunks - 1) / max_chunks;
  a.chunks = (tiles + a.tiles_per_chunk - 1) / a.tiles_per_chunk;
  if (a.chunks > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  kq<<<dim3(tiles, a.BNh, Pl::SQ), kWgThreads, Pl::kSmemQ, stream>>>(qm, gm, km, vm, a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kkv<<<dim3((a.Lk + kBK - 1) / kBK, a.chunks, a.BNh * Pl::SKV), kWgThreads, Pl::kSmemKV,
        stream>>>(qm, gm, km, vm, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.chunks > 1) reduce_kernel<bf16><<<264, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the streamed bodies: fp32 inputs (the exactness check against the plain
// version) at any head dim, and bf16 head dims above the largest wgmma
// instance (384)
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kF32BQ = 32;  // query rows of a dk/dv pass tile
constexpr int kSC = 64;     // head-dim columns a step

// x rounded to T and widened back: the bf16 bodies' rounding of p and dl
// before their products (none in fp32)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

// rows x dc columns (from column d0) of src (row stride ls, rows from row0,
// valid below `valid`) into dst (row stride kSC + kF32Pad), zeros elsewhere
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* src, long long ls, int row0,
                                          int rows, int valid, int d0, int dc) {
  for (int idx = threadIdx.x; idx < rows * dc; idx += kThreads) {
    const int r = idx / dc, d = idx - r * dc, row = row0 + r;
    dst[r * (kSC + kF32Pad) + d] = row < valid ? to_f32(src[row * ls + d0 + d]) : 0.f;
  }
}

// the dq pass's shared memory at bq query rows: a column step of q, g, k and
// v, S and dP of a key chunk, the dq accumulator (bq x hd), lse and delta
size_t dq_streamed_smem_bytes(int hd, int bq) {
  const int ld = kSC + kF32Pad;
  return 2 * align128(sizeof(float) * bq * ld) + 2 * align128(sizeof(float) * kBK * ld) +
         2 * align128(sizeof(float) * bq * kBK) + align128(sizeof(float) * bq * hd) +
         2 * align128(sizeof(float) * bq);
}

// the dk/dv pass's at bk keys: a column step of k, v, q and g, Sᵀ and dPᵀ of
// a query tile, the dk and dv accumulators (bk x hd each), lse and delta
size_t dkdv_streamed_smem_bytes(int hd, int bk) {
  const int ld = kSC + kF32Pad;
  return 2 * align128(sizeof(float) * bk * ld) + 2 * align128(sizeof(float) * kF32BQ * ld) +
         2 * align128(sizeof(float) * bk * kF32BQ) + 2 * align128(sizeof(float) * bk * hd) +
         2 * align128(sizeof(float) * kF32BQ);
}

// rows a block of either pass takes: 32, halved until its tiles fit
template <class F>
int streamed_rows(int hd, F smem) {
  int rows = 32;
  while (rows > 1 && smem(hd, rows) > kMaxSmem) rows /= 2;
  return rows;
}

// The dq pass: bq query rows of one (batch, head). delta = rowsum(g·o) and
// lse per row; per 64-key chunk, S = q kᵀ and dP = g vᵀ summed over 64-column
// steps of the head dim (one exact FMA chain carried across the steps, bit
// for bit the unsplit sum), p = exp(S·scale − lse), dl = p·(dP − delta) rounded
// to T, dq += dl k walked in the same column steps; dq·scale rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads) dq_streamed_kernel(BwdArgs a, int bq) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hd = a.hd, ld = kSC + kF32Pad;
  unsigned char* p = smem_raw;
  float* Qs = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * ld));
  float* Gs = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * ld));
  float* Ks = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* Vs = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* S = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * kBK));
  float* dP = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * kBK));
  float* dQ = reinterpret_cast<float*>(carve(p, sizeof(float) * bq * hd));
  float* Lrow = reinterpret_cast<float*>(carve(p, sizeof(float) * bq));
  float* Drow = reinterpret_cast<float*>(carve(p, sizeof(float) * bq));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bn = blockIdx.y, q0 = blockIdx.x * bq;
  const T* qb = head<T>(a.q, bn, a.N, a.qsb, a.qsn);
  const T* kb = head<T>(a.k, bn, a.N, a.ksb, a.ksn);
  const T* vb = head<T>(a.v, bn, a.N, a.vsb, a.vsn);
  const T* ob = head<T>(a.o, bn, a.N, a.osb, a.osn);
  const T* gb = head<T>(a.g, bn, a.N, a.gsb, a.gsn);

  for (int idx = tid; idx < bq * hd; idx += kThreads) dQ[idx] = 0.f;
  for (int r = warp; r < bq; r += kThreads / 32) {
    const int row = q0 + r;
    float s = 0.f;
    if (row < a.Lq)
      for (int d = lane; d < hd; d += 32)
        s += to_f32(gb[row * a.gsr + d]) * to_f32(ob[row * a.osr + d]);
    s = warp_sum(s);
    if (lane == 0) {
      Drow[r] = s;
      Lrow[r] = row < a.Lq ? a.lse[(long long)bn * a.Lq + row] : 0.f;
      if (row < a.Lq) a.delta[(long long)bn * a.Lq + row] = s;
    }
  }

  for (int c0 = 0; c0 < a.Lk; c0 += kBK) {
    for (int d0 = 0; d0 < hd; d0 += kSC) {
      const int dc = min(kSC, hd - d0);
      __syncthreads();  // the previous step's products have read the four tiles
      load_cols(Qs, qb, a.qsr, q0, bq, a.Lq, d0, dc);
      load_cols(Gs, gb, a.gsr, q0, bq, a.Lq, d0, dc);
      load_cols(Ks, kb, a.ksr, c0, kBK, a.Lk, d0, dc);
      load_cols(Vs, vb, a.vsr, c0, kBK, a.Lk, d0, dc);
      __syncthreads();
      smem_gemm_chain<true>(S, kBK, Qs, ld, Ks, ld, bq, kBK, dc, d0 == 0);
      smem_gemm_chain<true>(dP, kBK, Gs, ld, Vs, ld, bq, kBK, dc, d0 == 0);
    }
    __syncthreads();
    for (int idx = tid; idx < bq * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx - r * kBK;
      const float pe = c0 + c < a.Lk ? expf(S[idx] * a.scale - Lrow[r]) : 0.f;
      S[idx] = rnd<T>(pe * (dP[idx] - Drow[r]));
    }
    for (int d0 = 0; d0 < hd; d0 += kSC) {
      const int dc = min(kSC, hd - d0);
      __syncthreads();  // dl written (first step), the previous step's product done
      load_cols(Ks, kb, a.ksr, c0, kBK, a.Lk, d0, dc);
      __syncthreads();
      smem_gemm<false>(dQ + d0, hd, S, kBK, Ks, ld, bq, dc, kBK, true);
    }
  }
  __syncthreads();
  T* dqb = static_cast<T*>(a.dq) + (bn / a.N) * a.dqsb + (bn % a.N) * a.dqsn;
  for (int idx = tid; idx < bq * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = q0 + r;
    if (row < a.Lq) dqb[row * a.dqsr + d] = from_f32<T>(dQ[idx] * a.scale);
  }
}

// The dk/dv pass: bk keys of one (batch, head) over the query tiles of its
// chunk. Per 32-row tile, Sᵀ = k qᵀ and dPᵀ = v gᵀ summed over 64-column steps
// of the head dim (the chain carried across them), pᵀ = exp(Sᵀ·scale − lse) and dlᵀ = pᵀ·(dPᵀ − delta), each
// rounded to T, then dv += pᵀ g and dk += dlᵀ q walked in the same column
// steps; dk·scale and dv rounded once (or the chunk's fp32 partials).
template <typename T>
__global__ void __launch_bounds__(kThreads) dkdv_streamed_kernel(BwdArgs a, int bk) {
  constexpr int BQ = kF32BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hd = a.hd, ld = kSC + kF32Pad;
  unsigned char* p = smem_raw;
  float* Ks = reinterpret_cast<float*>(carve(p, sizeof(float) * bk * ld));
  float* Vs = reinterpret_cast<float*>(carve(p, sizeof(float) * bk * ld));
  float* Qs = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * ld));
  float* Gs = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * ld));
  float* St = reinterpret_cast<float*>(carve(p, sizeof(float) * bk * BQ));
  float* dPt = reinterpret_cast<float*>(carve(p, sizeof(float) * bk * BQ));
  float* dK = reinterpret_cast<float*>(carve(p, sizeof(float) * bk * hd));
  float* dV = reinterpret_cast<float*>(carve(p, sizeof(float) * bk * hd));
  float* L = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));
  float* D = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * bk, chunk = blockIdx.y, bn = blockIdx.z;
  const int tiles = (a.Lq + BQ - 1) / BQ;
  const int t_begin = chunk * a.tiles_per_chunk;
  const int t_end = min(tiles, t_begin + a.tiles_per_chunk);
  const T* qb = head<T>(a.q, bn, a.N, a.qsb, a.qsn);
  const T* kb = head<T>(a.k, bn, a.N, a.ksb, a.ksn);
  const T* vb = head<T>(a.v, bn, a.N, a.vsb, a.vsn);
  const T* gb = head<T>(a.g, bn, a.N, a.gsb, a.gsn);

  for (int idx = tid; idx < bk * hd; idx += kThreads) {
    dK[idx] = 0.f;
    dV[idx] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int r0 = t * BQ;
    for (int d0 = 0; d0 < hd; d0 += kSC) {
      const int dc = min(kSC, hd - d0);
      __syncthreads();  // the previous step's (or tile's) products have read the tiles
      if (d0 == 0)
        for (int i = tid; i < BQ; i += kThreads) {
          const bool ok = r0 + i < a.Lq;
          L[i] = ok ? a.lse[(long long)bn * a.Lq + r0 + i] : INFINITY;
          D[i] = ok ? a.delta[(long long)bn * a.Lq + r0 + i] : 0.f;
        }
      load_cols(Ks, kb, a.ksr, k0, bk, a.Lk, d0, dc);
      load_cols(Vs, vb, a.vsr, k0, bk, a.Lk, d0, dc);
      load_cols(Qs, qb, a.qsr, r0, BQ, a.Lq, d0, dc);
      load_cols(Gs, gb, a.gsr, r0, BQ, a.Lq, d0, dc);
      __syncthreads();
      smem_gemm_chain<true>(St, BQ, Ks, ld, Qs, ld, bk, BQ, dc, d0 == 0);
      smem_gemm_chain<true>(dPt, BQ, Vs, ld, Gs, ld, bk, BQ, dc, d0 == 0);
    }
    __syncthreads();
    for (int idx = tid; idx < bk * BQ; idx += kThreads) {
      const int c = idx % BQ;
      const float pe = expf(St[idx] * a.scale - L[c]);
      dPt[idx] = rnd<T>(pe * (dPt[idx] - D[c]));
      St[idx] = rnd<T>(pe);
    }
    for (int d0 = 0; d0 < hd; d0 += kSC) {
      const int dc = min(kSC, hd - d0);
      __syncthreads();  // pᵀ and dlᵀ written (first step), the previous step's products done
      load_cols(Qs, qb, a.qsr, r0, BQ, a.Lq, d0, dc);
      load_cols(Gs, gb, a.gsr, r0, BQ, a.Lq, d0, dc);
      __syncthreads();
      smem_gemm<false>(dV + d0, hd, St, BQ, Gs, ld, bk, dc, BQ, true);
      smem_gemm<false>(dK + d0, hd, dPt, BQ, Qs, ld, bk, dc, BQ, true);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < bk * (hd / 2); idx += kThreads) {
    const int r = idx / (hd / 2), d = 2 * (idx - r * (hd / 2)), key = k0 + r;
    if (key < a.Lk)
      store_dkdv<T>(a, chunk, bn, key, d, dK[r * hd + d], dK[r * hd + d + 1], dV[r * hd + d],
                    dV[r * hd + d + 1]);
  }
}

template <typename T>
cudaError_t launch_streamed(BwdArgs a, int max_chunks, cudaStream_t stream) {
  if (a.hd % 2) return cudaErrorInvalidValue;
  const int bq = streamed_rows(a.hd, dq_streamed_smem_bytes);
  const int bk = streamed_rows(a.hd, dkdv_streamed_smem_bytes);
  const size_t smem_q = dq_streamed_smem_bytes(a.hd, bq);
  const size_t smem_kv = dkdv_streamed_smem_bytes(a.hd, bk);
  if (smem_q > kMaxSmem || smem_kv > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(dq_streamed_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_q));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkdv_streamed_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_kv));
  if (e != cudaSuccess) return e;
  const int tiles = (a.Lq + kF32BQ - 1) / kF32BQ;
  a.tiles_per_chunk = (tiles + max_chunks - 1) / max_chunks;
  a.chunks = (tiles + a.tiles_per_chunk - 1) / a.tiles_per_chunk;
  if (a.chunks > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  dq_streamed_kernel<T><<<dim3((a.Lq + bq - 1) / bq, a.BNh), kThreads, smem_q, stream>>>(a, bq);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv_streamed_kernel<T><<<dim3((a.Lk + bk - 1) / bk, a.chunks, a.BNh), kThreads, smem_kv,
                            stream>>>(a, bk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.chunks > 1) reduce_kernel<T><<<264, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// max_chunks bounds the query chunks of the dk/dv pass; ws holds that many
// (2, B·N, Lk, hd) fp32 planes (null when max_chunks is 1); delta and
// lse_pad hold B·N·Lq_pad floats (Lq_pad: Lq rounded up to 64)
extern "C" int csts_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* o, const void* g, const void* lse, void* delta,
                                  void* lse_pad, void* dq, void* dk, void* dv, void* ws,
                                  int max_chunks, int B, int N, int Lq, int Lk, int hd,
                                  long long qsb, long long qsn, long long qsr, long long ksb,
                                  long long ksn, long long ksr, long long vsb, long long vsn,
                                  long long vsr, long long osb, long long osn, long long osr,
                                  long long gsb, long long gsn, long long gsr, long long dqsb,
                                  long long dqsn, long long dqsr, float scale, void* stream) {
  if (max_chunks < 1 || Lq < 1 || Lk < 1) return cudaErrorInvalidValue;
  BwdArgs a{q,   k,   v,   o,   g,   static_cast<const float*>(lse), static_cast<float*>(delta),
            static_cast<float*>(lse_pad), dq, dk, dv, static_cast<float*>(ws), B * N, N, Lq,
            Lk, hd, (Lq + kBQ - 1) / kBQ * kBQ,
            qsb, qsn, qsr, ksb, ksn, ksr, vsb, vsn, vsr, osb, osn, osr, gsb, gsn, gsr,
            dqsb, dqsn, dqsr, 1, 1, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_streamed<float>(a, max_chunks, s);
  if (dtype != kBFloat16 || lse_pad == nullptr) return cudaErrorInvalidValue;
  if (hd > 384) return launch_streamed<bf16>(a, max_chunks, s);
  switch (hd) {
    case 64: return launch_wg<64>(a, max_chunks, B, s);
    case 96: return launch_wg<96>(a, max_chunks, B, s);
    case 128: return launch_wg<128>(a, max_chunks, B, s);
    case 192: return launch_wg<192>(a, max_chunks, B, s);
    case 256: return launch_wg<256>(a, max_chunks, B, s);
    case 384: return launch_wg<384>(a, max_chunks, B, s);
    default: return cudaErrorInvalidValue;
  }
}
