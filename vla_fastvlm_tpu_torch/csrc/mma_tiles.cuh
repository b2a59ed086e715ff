// Warp-level 16x8x16 tile products for the port's kernels (sm_90a).
//
// One warp computes D (16 x 8, fp32) += A (16 x 16) . B (16 x 8) with the
// register layout of PTX `mma.sync.aligned.m16n8k16.row.col` (lane = 4 * g + t):
//   A: a[0] = (row g,     k 2t, 2t+1)   a[1] = (row g + 8, k 2t, 2t+1)
//      a[2] = (row g,     k 2t+8, +9)   a[3] = (row g + 8, k 2t+8, +9)
//   B: b[0] = (k 2t, 2t+1,   col g)     b[1] = (k 2t+8, 2t+9, col g)
//   D: d[0], d[1] = (row g, col 2t, 2t+1)   d[2], d[3] = (row g + 8, col 2t, 2t+1)
// Each register holds a pair of consecutive elements: two bf16 packed in 32
// bits, or a float2 for the fp32 instance.
//
// bf16 runs on the tensor cores (mma.sync, operands from shared memory through
// ldmatrix). fp32 takes the same fragments and reproduces the product with
// warp shuffles and CUDA-core FMAs, so both instances share one code path and
// the fp32 one checks the algorithm at full fp32 precision.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma_tiles {

using bf16 = __nv_bfloat16;

template <typename T> struct Pair;
template <> struct Pair<bf16> { using type = uint32_t; };
template <> struct Pair<float> { using type = float2; };
template <typename T> using pair_t = typename Pair<T>::type;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// Pack two floats into one fragment register (bf16: rounded, low half first).
template <typename T> __device__ __forceinline__ pair_t<T> pack(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack<bf16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ float2 pack<float>(float lo, float hi) { return make_float2(lo, hi); }

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 unpack(float2 v) { return v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- D += A . B --------------------------------------------------------------

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], const float2 (&a)[4], float2 b0, float2 b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int src = (kk & 7) >> 1;  // the t of the lanes holding element kk
    const bool hi = kk >= 8, odd = kk & 1;
    const float2 ar0 = hi ? a[2] : a[0], ar1 = hi ? a[3] : a[1], br = hi ? b1 : b0;
    const float a_g = __shfl_sync(0xffffffffu, odd ? ar0.y : ar0.x, g * 4 + src);
    const float a_g8 = __shfl_sync(0xffffffffu, odd ? ar1.y : ar1.x, g * 4 + src);
    const float bv = odd ? br.y : br.x;
    const float b_c0 = __shfl_sync(0xffffffffu, bv, (2 * t) * 4 + src);
    const float b_c1 = __shfl_sync(0xffffffffu, bv, (2 * t + 1) * 4 + src);
    d[0] = fmaf(a_g, b_c0, d[0]);
    d[1] = fmaf(a_g, b_c1, d[1]);
    d[2] = fmaf(a_g8, b_c0, d[2]);
    d[3] = fmaf(a_g8, b_c1, d[3]);
  }
}

// ---- operand loads from shared memory ------------------------------------------
// Row strides are in elements; every row must start 16-byte aligned (bf16: a
// multiple of 8 elements), and a stride of 8 elements past a multiple of 64
// keeps ldmatrix free of bank conflicts.

// A fragment of the 16 x 16 tile at `a` (row-major [m][k]).
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* a, int lda) {
  const int lane = threadIdx.x & 31;
  const bf16* p = a + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void load_a(float2 (&r)[4], const float* a, int lda) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  r[0] = *reinterpret_cast<const float2*>(a + g * lda + 2 * t);
  r[1] = *reinterpret_cast<const float2*>(a + (g + 8) * lda + 2 * t);
  r[2] = *reinterpret_cast<const float2*>(a + g * lda + 2 * t + 8);
  r[3] = *reinterpret_cast<const float2*>(a + (g + 8) * lda + 2 * t + 8);
}

// B fragments of two adjacent 8-column tiles, 16 deep, from `b` stored [k][n]
// (row k holds the columns): b[0], b[1] for columns 0-7, b[2], b[3] for 8-15.
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const bf16* p = b + ((lane & 7) + (mi & 1) * 8) * ldb + (mi >> 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void load_b_kn(float2 (&r)[4], const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* col = b + j * 8 + g;
    r[2 * j] = make_float2(col[(2 * t) * ldb], col[(2 * t + 1) * ldb]);
    r[2 * j + 1] = make_float2(col[(2 * t + 8) * ldb], col[(2 * t + 9) * ldb]);
  }
}

// The same two tiles from `b` stored [n][k] (row n holds the depth).
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const bf16* b, int ldb) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  const bf16* p = b + ((lane & 7) + (mi >> 1) * 8) * ldb + (mi & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void load_b_nk(float2 (&r)[4], const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* row = b + (j * 8 + g) * ldb;
    r[2 * j] = *reinterpret_cast<const float2*>(row + 2 * t);
    r[2 * j + 1] = *reinterpret_cast<const float2*>(row + 2 * t + 8);
  }
}

// acc[j] += A (16 x 16 at a) . B (16 x 8 NJ at b, stored [k][n]); NJ even.
template <int NJ, typename T>
__device__ __forceinline__ void mma_k16_kn(float (&acc)[NJ][4], const T* a, int lda, const T* b, int ldb) {
  pair_t<T> af[4];
  load_a(af, a, lda);
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    pair_t<T> bf[4];
    load_b_kn(bf, b + j * 8, ldb);
    mma(acc[j], af, bf[0], bf[1]);
    mma(acc[j + 1], af, bf[2], bf[3]);
  }
}

// ---- asynchronous global -> shared copies ----------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// 16 bytes when `valid`, else 16 zero bytes (nothing is read from src).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma_tiles
