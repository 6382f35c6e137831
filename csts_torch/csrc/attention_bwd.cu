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
// Design. The TPU kernel walks q tiles in order and accumulates dk and dv in
// place across them; blocks of a GPU grid run in parallel, so that order
// cannot carry over. Here three launches in stream order:
//  1. dq: one block of 4 warps per 64 query rows of one (batch, head), the
//     layout of K1's forward. It writes delta for its rows, then walks the
//     keys in chunks of 64 (cp.async double buffer): S = q kᵀ and dP = g vᵀ
//     in registers, p = exp(S·scale − lse) with lse from K1 (one pass over
//     the keys, where recomputing the row statistics would take a second
//     q kᵀ), dl = p·(dP − delta), dq += dl k with dl passed from the
//     accumulators to the operands without leaving registers. dq goes out
//     once, scaled, through (batch, head, row) strides.
//  2. dk, dv: one block per 64 keys, per chunk of query tiles and per
//     (batch, head) (and per half of the head dim at hd 128 and 192, which
//     keeps the two accumulators in registers). Each warp owns 16 keys and
//     computes the transposed products Sᵀ = k qᵀ and dPᵀ = v gᵀ for each
//     query tile of its chunk, so pᵀ and dlᵀ are already the operands of
//     dv += pᵀ g and dk += dlᵀ q. Chunking the queries gives the short-key
//     sites enough blocks (d4: Lk 64, Lq 32768) for the 132 SMs.
//  3. With more than one chunk, the fp32 partial dk and dv of each chunk go
//     to a workspace and a third launch sums them in chunk order: the result
//     does not depend on which block ran first (no atomics).
// Ragged edges are masked in the kernels: rows past Lq load zeros and get
// lse = +inf (p = 0), keys past Lk load zeros and get p = 0 in the dq pass
// and are not stored in the dk/dv pass, so a chunk that is mostly past Lk
// (the temporal fusion's Lk 8) computes no −∞ − −∞. q, k, v, o, g and dq are
// addressed through (batch, head, row) strides with unit columns.
//
// fp32 inputs (the exactness check against the plain version) take simple
// bodies with the same three passes and exact FMA products in shared memory.
#include "common.cuh"

using namespace csts;

namespace {

struct BwdArgs {
  const void *q, *k, *v, *o, *g;
  const float* lse;  // (B·N, Lq), K1's
  float* delta;      // (B·N, Lq), written by the dq pass
  void* dq;          // (B, N, Lq, hd) through strides
  void *dk, *dv;     // (B·N, Lk, hd) contiguous
  float* ws;         // (chunks, 2, B·N, Lk, hd) fp32 partials; null with one chunk
  int BNh, N, Lq, Lk, hd;
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
// bf16: register-tiled bodies
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows per tile (16 per warp in the dq pass)
constexpr int kBK = 64;  // keys per chunk / per dk-dv block (16 per warp)
constexpr int kThreads = 128;

template <int HD>
__host__ __device__ constexpr int mma_ld() { return HD + 8; }

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

// acc[0..8) (16 rows x 64 columns) += A[16 rows, 0..HD) · B[64 rows, 0..HD)ᵀ,
// both bf16 row-major in shared memory (stride LD), A rows at Aw
template <int HD>
__device__ __forceinline__ void rows_x_rowsT(float (&acc)[kBK / 8][4], const bf16* Aw,
                                             const bf16* B, int lane) {
  constexpr int LD = mma_ld<HD>();
#pragma unroll
  for (int k = 0; k < HD; k += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, Aw + (lane & 15) * LD + k + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kBK / 8; np += 2) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, B + (np * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + k +
                           ((lane >> 3) & 1) * 8);
      mma_bf16_16816(acc[np], af, bfr[0], bfr[1]);
      mma_bf16_16816(acc[np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc[0..NT) (16 rows x 8·NT columns from column d0) += P · B[0..64, d0 ..),
// P the 16 x 64 accumulator tile rounded to bf16, B bf16 row-major in shared
// memory (stride LD) with its rows as the contraction
template <int HD, int NT>
__device__ __forceinline__ void acc_x_rows(float (&acc)[NT][4], float (&pm)[kBK / 8][4],
                                           const bf16* B, int d0, int lane) {
  constexpr int LD = mma_ld<HD>();
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16x2(pm[2 * j][0], pm[2 * j][1]),
                            pack_bf16x2(pm[2 * j][2], pm[2 * j][3]),
                            pack_bf16x2(pm[2 * j + 1][0], pm[2 * j + 1][1]),
                            pack_bf16x2(pm[2 * j + 1][2], pm[2 * j + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NT; dp += 2) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, B + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + d0 +
                                 dp * 8 + (lane >> 4) * 8);
      mma_bf16_16816(acc[dp], pa, bfr[0], bfr[1]);
      mma_bf16_16816(acc[dp + 1], pa, bfr[2], bfr[3]);
    }
  }
}

template <int HD>
size_t dq_smem_bytes() {
  return 2 * align128(sizeof(bf16) * kBQ * mma_ld<HD>()) +
         4 * align128(sizeof(bf16) * kBK * mma_ld<HD>());
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(BwdArgs a) {
  constexpr int LD = mma_ld<HD>(), DT = HD / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  bf16* Qs = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBQ * LD));
  bf16* Gs = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBQ * LD));
  bf16* Ks[2];
  bf16* Vs[2];
  for (int i = 0; i < 2; ++i) {
    Ks[i] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBK * LD));
    Vs[i] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBK * LD));
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int bn = blockIdx.y, q0 = blockIdx.x * kBQ;
  const bf16* qb = head<bf16>(a.q, bn, a.N, a.qsb, a.qsn);
  const bf16* kb = head<bf16>(a.k, bn, a.N, a.ksb, a.ksn);
  const bf16* vb = head<bf16>(a.v, bn, a.N, a.vsb, a.vsn);
  const bf16* ob = head<bf16>(a.o, bn, a.N, a.osb, a.osn);
  const bf16* gb = head<bf16>(a.g, bn, a.N, a.gsb, a.gsn);

  load_rows<HD>(Qs, qb + q0 * a.qsr, a.qsr, kBQ, a.Lq - q0);
  load_rows<HD>(Gs, gb + q0 * a.gsr, a.gsr, kBQ, a.Lq - q0);
  load_rows<HD>(Ks[0], kb, a.ksr, kBK, a.Lk);
  load_rows<HD>(Vs[0], vb, a.vsr, kBK, a.Lk);
  cp_async_commit();

  // delta of the warp's 16 rows (to device memory for the dk/dv pass) and
  // this thread's two rows' delta and lse
  const int qr[2] = {q0 + warp * 16 + g4, q0 + warp * 16 + g4 + 8};
  float delta_row[2] = {0.f, 0.f}, lse_row[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    float s = 0.f;
    if (row < a.Lq)
      for (int d = lane; d < HD; d += 32)
        s += __bfloat162float(gb[row * a.gsr + d]) * __bfloat162float(ob[row * a.osr + d]);
    s = warp_sum(s);
    if (row < a.Lq && lane == 0) a.delta[(long long)bn * a.Lq + row] = s;
    if (r == g4) delta_row[0] = s;
    if (r == g4 + 8) delta_row[1] = s;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (qr[h] < a.Lq) lse_row[h] = a.lse[(long long)bn * a.Lq + qr[h]];

  float dqa[DT][4] = {};
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* Gw = Gs + warp * 16 * LD;
  int cb = 0;
  for (int c0 = 0; c0 < a.Lk; c0 += kBK) {
    cp_async_wait_all();
    __syncthreads();  // chunk c0 (and Q, G) visible; buffers cb ^ 1 free
    if (c0 + kBK < a.Lk) {
      load_rows<HD>(Ks[cb ^ 1], kb + (c0 + kBK) * a.ksr, a.ksr, kBK, a.Lk - c0 - kBK);
      load_rows<HD>(Vs[cb ^ 1], vb + (c0 + kBK) * a.vsr, a.vsr, kBK, a.Lk - c0 - kBK);
    }
    cp_async_commit();

    float s[kBK / 8][4] = {}, dpv[kBK / 8][4] = {};
    rows_x_rowsT<HD>(s, Qw, Ks[cb], lane);
    rows_x_rowsT<HD>(dpv, Gw, Vs[cb], lane);
    // dl = p·(dP − delta) in fp32; entries 0,1 of a tile are row g4, 2,3 row g4 + 8
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + nt * 8 + 2 * t4 + (e & 1), h = e >> 1;
        const float pe = col < a.Lk ? expf(s[nt][e] * a.scale - lse_row[h]) : 0.f;
        s[nt][e] = pe * (dpv[nt][e] - delta_row[h]);
      }
    acc_x_rows<HD, DT>(dqa, s, Ks[cb], 0, lane);
    cb ^= 1;
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + (bn / a.N) * a.dqsb + (bn % a.N) * a.dqsn;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qr[h] >= a.Lq) continue;
    bf16* row = dqb + qr[h] * a.dqsr;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + 2 * t4) =
          __floats2bfloat162_rn(dqa[dt][2 * h] * a.scale, dqa[dt][2 * h + 1] * a.scale);
  }
}

template <int HD>
size_t dkdv_smem_bytes() {
  return 2 * align128(sizeof(bf16) * kBK * mma_ld<HD>()) +
         4 * align128(sizeof(bf16) * kBQ * mma_ld<HD>()) + 4 * align128(sizeof(float) * kBQ);
}

// DO: the head-dim columns of dk and dv one block computes (HD / DO blocks
// split the head dim; the two transposed products cover all of HD in each)
template <int HD, int DO>
__global__ void __launch_bounds__(kThreads) dkdv_mma_kernel(BwdArgs a) {
  constexpr int LD = mma_ld<HD>(), OT = DO / 8, SPLIT = HD / DO;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  bf16* Ks = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBK * LD));
  bf16* Vs = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBK * LD));
  bf16* Qs[2];
  bf16* Gs[2];
  float* Ls[2];
  float* Ds[2];
  for (int i = 0; i < 2; ++i) {
    Qs[i] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBQ * LD));
    Gs[i] = reinterpret_cast<bf16*>(carve(p, sizeof(bf16) * kBQ * LD));
  }
  for (int i = 0; i < 2; ++i) {
    Ls[i] = reinterpret_cast<float*>(carve(p, sizeof(float) * kBQ));
    Ds[i] = reinterpret_cast<float*>(carve(p, sizeof(float) * kBQ));
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBK, chunk = blockIdx.y;
  const int bn = blockIdx.z / SPLIT, d0 = (blockIdx.z % SPLIT) * DO;
  const int tiles = (a.Lq + kBQ - 1) / kBQ;
  const int t_begin = chunk * a.tiles_per_chunk;
  const int t_end = min(tiles, t_begin + a.tiles_per_chunk);
  const bf16* qb = head<bf16>(a.q, bn, a.N, a.qsb, a.qsn);
  const bf16* kb = head<bf16>(a.k, bn, a.N, a.ksb, a.ksn);
  const bf16* vb = head<bf16>(a.v, bn, a.N, a.vsb, a.vsn);
  const bf16* gb = head<bf16>(a.g, bn, a.N, a.gsb, a.gsn);
  const float* lse = a.lse + (long long)bn * a.Lq;
  const float* delta = a.delta + (long long)bn * a.Lq;

  auto load_tile = [&](int t, int buf) {
    const int r0 = t * kBQ;
    load_rows<HD>(Qs[buf], qb + r0 * a.qsr, a.qsr, kBQ, a.Lq - r0);
    load_rows<HD>(Gs[buf], gb + r0 * a.gsr, a.gsr, kBQ, a.Lq - r0);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      const bool ok = r0 + i < a.Lq;
      Ls[buf][i] = ok ? lse[r0 + i] : INFINITY;  // p = 0 past Lq
      Ds[buf][i] = ok ? delta[r0 + i] : 0.f;
    }
  };
  load_rows<HD>(Ks, kb + k0 * a.ksr, a.ksr, kBK, a.Lk - k0);
  load_rows<HD>(Vs, vb + k0 * a.vsr, a.vsr, kBK, a.Lk - k0);
  load_tile(t_begin, 0);
  cp_async_commit();

  float dka[OT][4] = {}, dva[OT][4] = {};
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  int cb = 0;
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t visible; buffers cb ^ 1 free
    if (t + 1 < t_end) load_tile(t + 1, cb ^ 1);
    cp_async_commit();

    // rows: the warp's 16 keys; columns: the tile's 64 query rows
    float st[kBQ / 8][4] = {}, dpt[kBQ / 8][4] = {};
    rows_x_rowsT<HD>(st, Kw, Qs[cb], lane);
    rows_x_rowsT<HD>(dpt, Vw, Gs[cb], lane);
    const float* L = Ls[cb];
    const float* D = Ds[cb];
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const float pe = expf(st[nt][e] * a.scale - L[c]);
        dpt[nt][e] = pe * (dpt[nt][e] - D[c]);
        st[nt][e] = pe;
      }
    acc_x_rows<HD, OT>(dva, st, Gs[cb], d0, lane);
    acc_x_rows<HD, OT>(dka, dpt, Qs[cb], d0, lane);
    cb ^= 1;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g4 + 8 * h;
    if (key >= a.Lk) continue;
#pragma unroll
    for (int dt = 0; dt < OT; ++dt)
      store_dkdv<bf16>(a, chunk, bn, key, d0 + dt * 8 + 2 * t4, dka[dt][2 * h],
                       dka[dt][2 * h + 1], dva[dt][2 * h], dva[dt][2 * h + 1]);
  }
}

template <int HD, int DO>
cudaError_t launch_mma(BwdArgs a, int max_chunks, cudaStream_t stream) {
  const size_t smem_q = dq_smem_bytes<HD>(), smem_kv = dkdv_smem_bytes<HD>();
  auto kq = dq_mma_kernel<HD>;
  auto kkv = dkdv_mma_kernel<HD, DO>;
  cudaError_t e = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_q));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_kv));
  if (e != cudaSuccess) return e;
  const int tiles = (a.Lq + kBQ - 1) / kBQ;
  a.tiles_per_chunk = (tiles + max_chunks - 1) / max_chunks;
  a.chunks = (tiles + a.tiles_per_chunk - 1) / a.tiles_per_chunk;
  if (a.chunks > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  kq<<<dim3(tiles, a.BNh), kThreads, smem_q, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  kkv<<<dim3((a.Lk + kBK - 1) / kBK, a.chunks, a.BNh * (HD / DO)), kThreads, smem_kv, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.chunks > 1) reduce_kernel<bf16><<<264, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: exact FMA bodies through shared memory
// ---------------------------------------------------------------------------

constexpr int kF32BQ = 32;  // query rows per tile
constexpr int kF32BK = 32;  // keys per dk/dv block (the dq pass walks chunks of kBK)

size_t dq_f32_smem_bytes(int hd) {
  const int ld = hd + kF32Pad;
  return 2 * align128(sizeof(float) * kF32BQ * ld) + 2 * align128(sizeof(float) * kBK * ld) +
         2 * align128(sizeof(float) * kF32BQ * kBK) + align128(sizeof(float) * kF32BQ * hd) +
         2 * align128(sizeof(float) * kF32BQ);
}

__global__ void __launch_bounds__(kThreads) dq_f32_kernel(BwdArgs a) {
  constexpr int BQ = kF32BQ;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hd = a.hd, ld = hd + kF32Pad;
  unsigned char* p = smem_raw;
  float* Qs = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * ld));
  float* Gs = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * ld));
  float* Ks = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* Vs = reinterpret_cast<float*>(carve(p, sizeof(float) * kBK * ld));
  float* S = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * kBK));
  float* dP = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * kBK));
  float* dQ = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * hd));
  float* Lrow = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));
  float* Drow = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bn = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* qb = head<float>(a.q, bn, a.N, a.qsb, a.qsn);
  const float* kb = head<float>(a.k, bn, a.N, a.ksb, a.ksn);
  const float* vb = head<float>(a.v, bn, a.N, a.vsb, a.vsn);
  const float* ob = head<float>(a.o, bn, a.N, a.osb, a.osn);
  const float* gb = head<float>(a.g, bn, a.N, a.gsb, a.gsn);

  for (int idx = tid; idx < BQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = q0 + r;
    const bool ok = row < a.Lq;
    Qs[r * ld + d] = ok ? qb[row * a.qsr + d] : 0.f;
    Gs[r * ld + d] = ok ? gb[row * a.gsr + d] : 0.f;
    dQ[idx] = 0.f;
  }
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int row = q0 + r;
    float s = 0.f;
    if (row < a.Lq)
      for (int d = lane; d < hd; d += 32) s += gb[row * a.gsr + d] * ob[row * a.osr + d];
    s = warp_sum(s);
    if (lane == 0) {
      Drow[r] = s;
      Lrow[r] = row < a.Lq ? a.lse[(long long)bn * a.Lq + row] : 0.f;
      if (row < a.Lq) a.delta[(long long)bn * a.Lq + row] = s;
    }
  }

  for (int c0 = 0; c0 < a.Lk; c0 += kBK) {
    __syncthreads();  // the previous chunk's dQ product has read Ks and S
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - r * hd, row = c0 + r;
      const bool ok = row < a.Lk;
      Ks[r * ld + d] = ok ? kb[row * a.ksr + d] : 0.f;
      Vs[r * ld + d] = ok ? vb[row * a.vsr + d] : 0.f;
    }
    __syncthreads();
    smem_gemm<true>(S, kBK, Qs, ld, Ks, ld, BQ, kBK, hd, false);
    smem_gemm<true>(dP, kBK, Gs, ld, Vs, ld, BQ, kBK, hd, false);
    __syncthreads();
    for (int idx = tid; idx < BQ * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx - r * kBK;
      const float pe = c0 + c < a.Lk ? expf(S[idx] * a.scale - Lrow[r]) : 0.f;
      S[idx] = pe * (dP[idx] - Drow[r]);
    }
    __syncthreads();
    smem_gemm<false>(dQ, hd, S, kBK, Ks, ld, BQ, hd, kBK, true);
  }
  __syncthreads();
  float* dqb = static_cast<float*>(a.dq) + (bn / a.N) * a.dqsb + (bn % a.N) * a.dqsn;
  for (int idx = tid; idx < BQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = q0 + r;
    if (row < a.Lq) dqb[row * a.dqsr + d] = dQ[idx] * a.scale;
  }
}

size_t dkdv_f32_smem_bytes(int hd) {
  const int ld = hd + kF32Pad;
  return 2 * align128(sizeof(float) * kF32BK * ld) + 2 * align128(sizeof(float) * kF32BQ * ld) +
         2 * align128(sizeof(float) * kF32BK * kF32BQ) + 2 * align128(sizeof(float) * kF32BK * hd) +
         2 * align128(sizeof(float) * kF32BQ);
}

__global__ void __launch_bounds__(kThreads) dkdv_f32_kernel(BwdArgs a) {
  constexpr int BQ = kF32BQ, BK = kF32BK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hd = a.hd, ld = hd + kF32Pad;
  unsigned char* p = smem_raw;
  float* Ks = reinterpret_cast<float*>(carve(p, sizeof(float) * BK * ld));
  float* Vs = reinterpret_cast<float*>(carve(p, sizeof(float) * BK * ld));
  float* Qs = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * ld));
  float* Gs = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ * ld));
  float* St = reinterpret_cast<float*>(carve(p, sizeof(float) * BK * BQ));
  float* dPt = reinterpret_cast<float*>(carve(p, sizeof(float) * BK * BQ));
  float* dK = reinterpret_cast<float*>(carve(p, sizeof(float) * BK * hd));
  float* dV = reinterpret_cast<float*>(carve(p, sizeof(float) * BK * hd));
  float* L = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));
  float* D = reinterpret_cast<float*>(carve(p, sizeof(float) * BQ));

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK, chunk = blockIdx.y, bn = blockIdx.z;
  const int tiles = (a.Lq + BQ - 1) / BQ;
  const int t_begin = chunk * a.tiles_per_chunk;
  const int t_end = min(tiles, t_begin + a.tiles_per_chunk);
  const float* qb = head<float>(a.q, bn, a.N, a.qsb, a.qsn);
  const float* kb = head<float>(a.k, bn, a.N, a.ksb, a.ksn);
  const float* vb = head<float>(a.v, bn, a.N, a.vsb, a.vsn);
  const float* gb = head<float>(a.g, bn, a.N, a.gsb, a.gsn);

  for (int idx = tid; idx < BK * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd, row = k0 + r;
    const bool ok = row < a.Lk;
    Ks[r * ld + d] = ok ? kb[row * a.ksr + d] : 0.f;
    Vs[r * ld + d] = ok ? vb[row * a.vsr + d] : 0.f;
    dK[idx] = 0.f;
    dV[idx] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int r0 = t * BQ;
    __syncthreads();  // the previous tile's products have read Qs, Gs, St, dPt
    for (int idx = tid; idx < BQ * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - r * hd, row = r0 + r;
      const bool ok = row < a.Lq;
      Qs[r * ld + d] = ok ? qb[row * a.qsr + d] : 0.f;
      Gs[r * ld + d] = ok ? gb[row * a.gsr + d] : 0.f;
    }
    for (int i = tid; i < BQ; i += kThreads) {
      const bool ok = r0 + i < a.Lq;
      L[i] = ok ? a.lse[(long long)bn * a.Lq + r0 + i] : INFINITY;
      D[i] = ok ? a.delta[(long long)bn * a.Lq + r0 + i] : 0.f;
    }
    __syncthreads();
    smem_gemm<true>(St, BQ, Ks, ld, Qs, ld, BK, BQ, hd, false);
    smem_gemm<true>(dPt, BQ, Vs, ld, Gs, ld, BK, BQ, hd, false);
    __syncthreads();
    for (int idx = tid; idx < BK * BQ; idx += kThreads) {
      const int c = idx % BQ;
      const float pe = expf(St[idx] * a.scale - L[c]);
      dPt[idx] = pe * (dPt[idx] - D[c]);
      St[idx] = pe;
    }
    __syncthreads();
    smem_gemm<false>(dV, hd, St, BQ, Gs, ld, BK, hd, BQ, true);
    smem_gemm<false>(dK, hd, dPt, BQ, Qs, ld, BK, hd, BQ, true);
  }
  __syncthreads();
  for (int idx = tid; idx < BK * (hd / 2); idx += kThreads) {
    const int r = idx / (hd / 2), d = 2 * (idx - r * (hd / 2)), key = k0 + r;
    if (key < a.Lk)
      store_dkdv<float>(a, chunk, bn, key, d, dK[r * hd + d], dK[r * hd + d + 1], dV[r * hd + d],
                        dV[r * hd + d + 1]);
  }
}

cudaError_t launch_f32(BwdArgs a, int max_chunks, cudaStream_t stream) {
  const size_t smem_q = dq_f32_smem_bytes(a.hd), smem_kv = dkdv_f32_smem_bytes(a.hd);
  if (smem_q > kMaxSmem || smem_kv > kMaxSmem || a.hd % 2) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_q));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_kv));
  if (e != cudaSuccess) return e;
  const int tiles = (a.Lq + kF32BQ - 1) / kF32BQ;
  a.tiles_per_chunk = (tiles + max_chunks - 1) / max_chunks;
  a.chunks = (tiles + a.tiles_per_chunk - 1) / a.tiles_per_chunk;
  if (a.chunks > 1 && a.ws == nullptr) return cudaErrorInvalidValue;
  dq_f32_kernel<<<dim3(tiles, a.BNh), kThreads, smem_q, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv_f32_kernel<<<dim3((a.Lk + kF32BK - 1) / kF32BK, a.chunks, a.BNh), kThreads, smem_kv,
                    stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (a.chunks > 1) reduce_kernel<float><<<264, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// max_chunks bounds the query chunks of the dk/dv pass; ws holds that many
// (2, B·N, Lk, hd) fp32 planes (null when max_chunks is 1)
extern "C" int csts_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* o, const void* g, const void* lse, void* delta,
                                  void* dq, void* dk, void* dv, void* ws, int max_chunks, int B,
                                  int N, int Lq, int Lk, int hd, long long qsb, long long qsn,
                                  long long qsr, long long ksb, long long ksn, long long ksr,
                                  long long vsb, long long vsn, long long vsr, long long osb,
                                  long long osn, long long osr, long long gsb, long long gsn,
                                  long long gsr, long long dqsb, long long dqsn, long long dqsr,
                                  float scale, void* stream) {
  if (max_chunks < 1 || Lq < 1 || Lk < 1) return cudaErrorInvalidValue;
  BwdArgs a{q,   k,   v,   o,   g,   static_cast<const float*>(lse), static_cast<float*>(delta),
            dq,  dk,  dv,  static_cast<float*>(ws), B * N, N, Lq, Lk, hd,
            qsb, qsn, qsr, ksb, ksn, ksr, vsb, vsn, vsr, osb, osn, osr, gsb, gsn, gsr,
            dqsb, dqsn, dqsr, 1, 1, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_f32(a, max_chunks, s);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_mma<64, 64>(a, max_chunks, s);
    case 96: return launch_mma<96, 96>(a, max_chunks, s);
    case 128: return launch_mma<128, 64>(a, max_chunks, s);
    case 192: return launch_mma<192, 96>(a, max_chunks, s);
    default: return cudaErrorInvalidValue;
  }
}
