// Warpgroup tensor-core products (wgmma) for the port's kernels (sm_90a).
//
// One warpgroup (4 warps, 128 threads) computes D (64 x N, fp32, registers)
// += A (64 x 16, bf16) . B (16 x N, bf16) with
// `wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16`, both operands read
// from shared memory through 64-bit descriptors.
//
// Operand layout: the 128-byte swizzle. A tile of R rows whose rows hold
// bf16 values along the contiguous dimension is kept in column blocks of 64
// values: block b holds columns [64 b, 64 b + 64) of every row, R rows of
// 128 bytes, and the 16-byte chunk j of row r lies at chunk j ^ (r % 8) of
// its row (sw128_offset). Every block starts 1024-byte aligned.
// - A (M x K) is K-major: rows are the 64 output rows, columns the depth.
//   The descriptor of k-step k0 starts at block k0 / 64, byte 2 (k0 % 64) of
//   row 0; 8-row groups are 1024 bytes apart (SBO).
// - B (K x N) is MN-major: rows are the depth, columns the outputs, as the
//   weights lie in device memory; the instruction's transpose flag is set.
//   k-step k0 starts at row k0 of the first N-block; 8-row groups of K are
//   1024 bytes apart (SBO), N-blocks R x 128 bytes (LBO). A warpgroup's N
//   columns start on a block boundary, or lie within one block.
// The hardware applies the XOR to the address bits, so an offset inside a
// block (a k-step of A, half a block of B) needs no other change.
//
// D's registers follow mma.sync's m16n8 tiles along N: thread 4 g + t of
// warp w of the warpgroup holds, for each 8-column tile j,
//   d[j][0, 1] = (row 16 w + g, cols 8 j + 2 t, + 1)
//   d[j][2, 3] = (row 16 w + g + 8, the same cols).
//
// Ordering: a thread's shared-memory writes (st.shared, or cp.async after
// its wait) reach wgmma, which reads through the async proxy, only after
// fence_async_smem() by the writing thread and then a barrier. Registers
// that a wgmma writes are read only after wait<0>(); a buffer that a wgmma
// reads is overwritten only after wait<0>() by the warpgroups that read it
// and a barrier.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace wgmma_tiles {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a bf16 tile of `rows` rows in the
// 128-byte swizzle layout above.
__host__ __device__ __forceinline__ uint32_t sw128_offset(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// Descriptor of an operand at `p` in the 128-byte swizzle layout; offsets in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // layout type: 128-byte swizzle; base offset 0
  return d;
}

// The descriptor `d` advanced by `bytes` (a multiple of 16) along its operand.
__device__ __forceinline__ uint64_t advance(uint64_t d, uint32_t bytes) { return d + (bytes >> 4); }

// Before the first wgmma that reads or writes registers touched since.
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's earlier shared-memory writes visible to the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulator across a wgmma
// sequence (its registers are written asynchronously).
template <int NJ> __device__ __forceinline__ void fence_operand(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x N) = A . B + (accumulate ? d : 0), A K-major, B MN-major
// (transposed); d[j] is the thread's part of 8-column tile j.
template <int N>
__device__ __forceinline__ void mma_async(float (&d)[N / 8][4], uint64_t a, uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void mma_async<32>(float (&d)[4][4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_async<48>(float (&d)[6][4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23},"
      " %24, %25, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_async<64>(float (&d)[8][4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void mma_async<192>(float (&d)[24][4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

}  // namespace wgmma_tiles
