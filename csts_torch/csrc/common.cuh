// Shared helpers for the csts_torch kernels: dtype conversion, warp
// reductions, shared-memory carving, the register-tiled bf16 building blocks
// (ldmatrix, mma.sync m16n8k16 with fp32 accumulation, cp.async) and one
// block-wide exact-fp32 matrix product over shared-memory tiles, which the
// fp32 bodies use so that an fp32 call is exact fp32 (no TF32), as the parity
// checks against the plain PyTorch versions need.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace csts {

// dtype codes passed from Python
enum { kFloat32 = 0, kBFloat16 = 1 };

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr size_t kMaxSmem = 232448;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Row padding of the fp32 bodies' shared-memory tiles, in elements: 1 makes
// the FMA product's column-strided reads conflict-free. (The bf16 bodies pad
// rows by 8 elements, which keeps ldmatrix rows 16-byte aligned and spreads
// eight consecutive rows over distinct banks.)
constexpr int kF32Pad = 1;

__host__ __device__ constexpr size_t align128(size_t bytes) {
  return (bytes + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ unsigned char* carve(unsigned char*& p, size_t bytes) {
  unsigned char* r = p;
  p += align128(bytes);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// --- register-tiled bf16 products: ldmatrix, mma.sync m16n8k16, cp.async ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row-major fragment) * b (16x8, column fragment), fp32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
// As cp_async16, but writes 16 zero bytes (and reads nothing) when !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// wait until at most n (0..2) committed groups are still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One warp: acc[2][NT] (m16 x n8 tiles) += A[row0 .. row0+32, 0..K) * Bt[col0 .. col0+8·NT, 0..K)ᵀ
// A and Bt are bf16 row-major in shared memory (Bt is the weight in nn.Linear
// layout, rows = output columns). K is a multiple of 16 and row strides keep
// 16-byte rows. Straight-line code: every product runs, so rows of Bt past
// the weight's edge must hold zeros (the loads zero-fill them).
template <int NT>
__device__ __forceinline__ void warp_mma_32xN(float (&acc)[2][NT][4], const __nv_bfloat16* A,
                                              int lda, const __nv_bfloat16* Bt, int ldb, int K,
                                              int row0, int col0, int lane) {
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], A + (row0 + mt * 16 + (lane & 15)) * lda + k + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT; np += 2) {
      const int n = col0 + np * 8;
      if (np + 1 < NT) {
        uint32_t b[4];
        ldmatrix_x4(b, Bt + (n + (lane & 7) + ((lane >> 4) << 3)) * ldb + k +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][np], a[mt], b[0], b[1]);
          mma_bf16_16816(acc[mt][np + 1], a[mt], b[2], b[3]);
        }
      } else {
        uint32_t b[2];
        ldmatrix_x2(b, Bt + (n + (lane & 7)) * ldb + k + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][np], a[mt], b[0], b[1]);
      }
    }
  }
}

// C[M x N] (fp32, row-major, ldc) = (accumulate ? C : 0) + A[M x K] * B[K x N]
// in exact fp32 FMA, any M, N, K. A is row-major (lda). With B_COL,
// B[k][n] = B[n * ldb + k]; otherwise B[k][n] = B[k * ldb + n]. Every thread
// of the block calls it; the caller synchronises before (inputs written) and
// after (C read).
template <bool B_COL>
__device__ void smem_gemm(float* C, int ldc, const float* A, int lda, const float* B,
                          int ldb, int M, int N, int K, bool accumulate) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int i = idx / N, j = idx - (idx / N) * N;
    const float* a = A + i * lda;
    float s = 0.f;
    if constexpr (B_COL) {
      const float* b = B + j * ldb;
      for (int k = 0; k < K; ++k) s = fmaf(a[k], b[k], s);
    } else {
      for (int k = 0; k < K; ++k) s = fmaf(a[k], B[k * ldb + j], s);
    }
    C[i * ldc + j] = accumulate ? C[i * ldc + j] + s : s;
  }
}

// C[M x N] = A[M x K] * B (as smem_gemm) continued from C where `first` is
// false: each element's fused multiply-add chain starts from C's value (0
// where first), so that a reduction cut into steps (the streamed attention
// bodies' 64-column steps of the head dim) runs the very chain of one
// unsplit reduction, bit for bit.
template <bool B_COL>
__device__ void smem_gemm_chain(float* C, int ldc, const float* A, int lda, const float* B,
                                int ldb, int M, int N, int K, bool first) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int i = idx / N, j = idx - (idx / N) * N;
    const float* a = A + i * lda;
    float s = first ? 0.f : C[i * ldc + j];
    if constexpr (B_COL) {
      const float* b = B + j * ldb;
      for (int k = 0; k < K; ++k) s = fmaf(a[k], b[k], s);
    } else {
      for (int k = 0; k < K; ++k) s = fmaf(a[k], B[k * ldb + j], s);
    }
    C[i * ldc + j] = s;
  }
}

}  // namespace csts
