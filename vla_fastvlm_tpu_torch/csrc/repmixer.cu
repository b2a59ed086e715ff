// Fused FastViTHD RepMixer block, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vla_fastvlm_tpu/ops/pallas/repmixer.py
// (repmixer_block -> _repmixer_block_pallas -> _block_kernel). On NHWC
// (B, H, W, C) input, with the JAX argument order and shapes:
//   t3  = dw3x3(x) + b3                      SAME zero padding, rounded to dtype
//   t7  = dw7x7(t3) + b7                     SAME zero padding AROUND t3, rounded
//   h   = gelu_tanh(round(t7 . w1 + b1))     rounded, hidden dim in chunks
//   y   = round(h . w2 + b2) * gamma         rounded
//   out = t3 + y                             rounded
// The dtype materialization points are those of the Pallas kernel
// (repmixer.py:120, :131, :146, :152, :155). The zero padding applies to t3
// itself: positions of the t3 ring outside the image are 0, so the dw3 bias
// never leaks into the border.
//
// Bound on this card: at the FastViTHD stage shapes (batch 128, 256 px) the
// two pointwise products are ~77 GFLOP a launch against ~50-200 MB of x and
// out, so the least time is set by operations (~0.08 ms). What holds the
// kernel far above it is on chip:
// - The weight stream. Every block stages all of w1 and w2 from L2, so a
//   launch moves 2 C 4C 2 bytes per block: ~1.2 GB at 64-pixel tiles, at
//   every width, 6x to 24x its traffic through HBM. With the products on
//   wgmma the per-hidden-chunk part of a launch runs near the rate L2 gives.
// - The depthwise pair (58 taps a pixel and channel on CUDA cores, the
//   haloed input tiles, two barriers a channel chunk) and the epilogue: the
//   part of a launch that does not grow with F, 46-72% of it with the
//   products on wgmma (more at narrow widths, which run more blocks). The
//   products do not overlap it.
// - Before wgmma, shared-memory reads in the products: with mma.sync each
//   warp read its own B fragments by ldmatrix for 16 rows, about 11-15
//   operations a shared byte, which caps the tensor cores at 35-50%.
// The design keeps every intermediate on chip: t3, t7, the hidden activation
// and the fp32 accumulator never reach device memory, and x is read and out
// written once.
//
// Design: one block of 8 warps (two warpgroups) per (tile, image); the tile
// is TH x 8 pixels, TH = 8 (64 pixels) or 16 (128, at C = 192: Plan).
// 1. Depthwise pair on CUDA cores, 32 channels at a time: the haloed
//    (TH + 8) x 16 input tile arrives by cp.async (the next chunk's while
//    this one is computed), the (TH + 6) x 14 dw3 ring is computed (masked to
//    0 outside the image, rounded), then dw7 for the tile: each thread owns
//    one channel of one pixel column, holds the channel's taps in registers
//    and sweeps the ring's rows once with the column's TH sums in registers.
//    t7 (pixels x C) and the centre of t3 stay in shared memory.
// 2. fc1 -> GELU -> fc2 over hidden chunks of FC. bf16: on wgmma
//    (wgmma_tiles.cuh), both operands read from shared memory in the
//    128-byte swizzle layout, which cp.async (weights) and the threads (t7,
//    t3, h) write with the XOR computed by hand. A warpgroup reads each
//    weight row once for 64 pixel rows (mma.sync read it once per 16), about
//    4x fewer shared-memory bytes an operation. At 64 pixels the two
//    warpgroups split each product's columns (fc1 m64n32k16, fc2
//    m64n{C/2}k16, with w2 kept as two halves that each start on a swizzle
//    block); at 128 pixels each owns 64 rows and all columns (m64n64k16,
//    m64n{C}k16), and each weight byte serves twice the pixels. fp32: the
//    same loop on mma.sync m16n8k16 tiles (mma_tiles.cuh), warp w owning
//    rows 16 (w % 4) and half of the columns. The fp32 y tile lives in
//    registers for the whole loop. Weight chunks are staged with cp.async:
//    the w2 chunk loads while fc1 runs and the next w1 chunk while fc2 runs.
// 3. Epilogue from the registers: + b2, round, x gamma, round, + t3, store.
//
// Plan per instance (Plan below): FC = 64 hidden units per chunk, with the
// centre of t3 kept in shared memory for the residual. The fp32 instance at
// C = 384 would need 430 KB that way; it takes FC = 32 and parks the t3
// centre in `out` itself (each block writes and later reads back only its own
// pixels, after a barrier), which brings it to 217 KB. The bf16 instance
// takes 76, 163 and 200 KB at C = 96, 192 and 384: two blocks an SM at
// C = 96, one at the others.

#include "mma_tiles.cuh"
#include "wgmma_tiles.cuh"

#include <cmath>
#include <cstddef>

using namespace mma_tiles;
namespace wg = wgmma_tiles;

namespace {

constexpr int TW = 8;                     // output pixels per tile row (tile rows: Plan::TH)
constexpr int HALO = 4;                   // dw3 (1) + dw7 (3)
constexpr int IN_W = TW + 2 * HALO;       // 16
constexpr int RING_W = TW + 6;            // dw3 output incl. the dw7 halo: 14
constexpr int CC = 32;                    // channels per depthwise chunk
constexpr int THREADS = 256;
constexpr int PAD = 8;                    // row padding (elements) against bank conflicts
static_assert(THREADS / CC == TW, "dw7 gives each warp one pixel column");

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// tanh-approximate GELU (Flax's nn.gelu default). The bf16 instance uses the
// hardware tanh (max relative error ~2^-11, below bf16's 2^-8 rounding of h);
// the fp32 instance keeps tanhf so it checks the algorithm at fp32 precision.
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <typename T>
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = k0 * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + (sizeof(T) == 2 ? fast_tanh(u) : tanhf(u)));
}

// Hidden units per fc chunk, whether the t3 centre stays in shared memory,
// whether the products run on wgmma (the bf16 instance) with the tiles in its
// 128-byte swizzle layout or on the m16n8 tiles of mma_tiles.cuh, and the
// tile: TH rows of TW pixels. 128 pixels (TH 16) give each warpgroup 64 rows
// and all of a product's columns, and halve the weight bytes a pixel costs;
// 64 pixels split the columns between the two warpgroups (SPLIT 2). Only
// C = 192 takes 128 pixels: at C = 96 the larger tile fits one block to an
// SM instead of two and measured slower, and at C = 384 its t7, t3 centre
// and weight chunks would not fit in shared memory.
template <typename T, int C>
struct Plan {
  static constexpr bool WIDE_FP32 = sizeof(T) == 4 && C >= 384;
  static constexpr int FC = WIDE_FP32 ? 32 : 64;
  static constexpr bool T3_SMEM = !WIDE_FP32;
  static constexpr bool WG = sizeof(T) == 2;
  static constexpr int TH = WG && C == 192 ? 16 : 8;
  static constexpr int PIX = TH * TW;
  static constexpr int SPLIT = PIX == 64 ? 2 : 1;
  // Blocks an SM should hold: the y tile of C = 384, or of a 128-pixel
  // tile, takes more registers than two blocks may have; narrower 64-pixel
  // blocks fit two to an SM, which hides the cp.async latencies of one
  // behind the other's work.
  static constexpr int MIN_BLOCKS = C >= 384 || PIX == 128 ? 1 : 2;
  static_assert(!WG || FC == 64, "wgmma tiles: one 128-byte row per hidden chunk");
  static_assert(WG || PIX == 64, "the m16n8 products take 64-pixel tiles");
};

// Columns of one warpgroup's half of a w2 chunk in the wgmma layout: C / 2,
// rounded up to whole 64-column blocks so that each half starts on one.
__host__ __device__ constexpr int w2_half_cols(int c) { return (c / 2 + 63) / 64 * 64; }
// Columns of a whole w2 chunk in the wgmma layout.
__host__ __device__ constexpr int w2_cols(int c, int split) {
  return split == 2 ? 2 * w2_half_cols(c) : (c + 63) / 64 * 64;
}

// Shared-memory layout, shared by the host planner and the kernel. With
// wgmma, t7, the t3 centre and h are tiles of one row per pixel and the w1 /
// w2 chunks C- / FC-row tiles in the 128-byte swizzle layout
// (wgmma_tiles.cuh), every one 1024-byte aligned; otherwise rows are padded
// by PAD elements.
struct Layout {
  size_t t7, t3c, xs, ring, w1s, w2s, hs, total;
  __host__ __device__ Layout(int esz, int c, int fc, bool t3_smem, bool wg, int th) {
    const int pix = th * TW;
    const size_t tsz = wg ? (size_t)((c + 63) / 64) * pix * 128 : align128((size_t)pix * (c + PAD) * esz);
    t7 = 0;
    t3c = tsz;  // unused without t3_smem
    const size_t uni = (t3_smem ? 2 : 1) * tsz;  // phase 1 (depthwise) and phase 2 (fc) share the rest
    xs = uni;                    // two input tiles: the chunk in use and the next
    ring = xs + 2 * align128((size_t)(th + 2 * HALO) * IN_W * CC * esz);
    const size_t phase1 = ring + align128((size_t)(th + 6) * RING_W * CC * esz);
    w1s = uni;
    if (wg) {
      w2s = w1s + (size_t)c * 128;
      hs = w2s + (size_t)w2_cols(c, pix == 64 ? 2 : 1) * fc * 2;
    } else {
      w2s = w1s + align128((size_t)c * (fc + PAD) * esz);
      hs = w2s + align128((size_t)fc * (c + PAD) * esz);
    }
    const size_t phase2 = hs + (wg ? (size_t)pix * 128 : align128((size_t)pix * (fc + PAD) * esz));
    total = phase1 > phase2 ? phase1 : phase2;
  }
};

template <typename T, int C>
__host__ __device__ Layout plan_layout() {
  using P = Plan<T, C>;
  return Layout(sizeof(T), C, P::FC, P::T3_SMEM, P::WG, P::TH);
}

// Element (r, c) of a PIX-row activation tile (t7, the t3 centre, h): in the
// wgmma layout, or row-major with row stride ld.
template <bool WG, int PIX, typename T>
__device__ __forceinline__ T* tile_at(T* base, int r, int c, int ld) {
  if constexpr (WG) return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(base) + wg::sw128_offset(r, c, PIX));
  return base + r * ld + c;
}

// Start copying the haloed (TH + 8) x 16 input tile of channels
// [c0, c0 + CC) into dst (pixel-major, CC wide); pixels outside the image
// are zero-filled.
template <typename T, int C, int TH>
__device__ __forceinline__ void stage_input(T* dst, const T* xi, int H, int W, int oy, int ox, int c0) {
  constexpr int VEC = 16 / sizeof(T), PER_PIX = CC / VEC;
  for (int i = threadIdx.x; i < (TH + 2 * HALO) * IN_W * PER_PIX; i += THREADS) {
    const int p = i / PER_PIX, c = (i % PER_PIX) * VEC;
    const int gy = oy - HALO + p / IN_W, gx = ox - HALO + p % IN_W;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* src = inside ? xi + ((size_t)gy * W + gx) * C + c0 + c : xi;
    cp_async16_zfill(dst + p * CC + c, src, inside);
  }
}

// Stage w1[:, f0 : f0 + FC] (C rows of FC) into dst: with wgmma one
// 128-byte swizzled row per input channel, else row stride FC + PAD.
template <typename T, int C, int FC, bool WG>
__device__ __forceinline__ void stage_w1(T* dst, const T* w1, int F, int f0) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = FC / VEC;
  for (int i = threadIdx.x; i < C * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    T* to = WG ? reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(dst) + wg::sw128_offset(r, c, C))
               : dst + r * (FC + PAD) + c;
    cp_async16(to, w1 + (size_t)r * F + f0 + c);
  }
}

// Stage w2[f0 : f0 + FC, :] (FC rows of C) into dst: with wgmma swizzled,
// with SPLIT 2 as two halves of w2_half_cols(C) columns, one per warpgroup;
// else row stride C + PAD.
template <typename T, int C, int FC, bool WG, int SPLIT>
__device__ __forceinline__ void stage_w2(T* dst, const T* w2, int f0) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = C / VEC;
  for (int i = threadIdx.x; i < FC * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    T* to;
    if constexpr (WG) {
      const int pc = SPLIT == 2 ? c / (C / 2) * w2_half_cols(C) + c % (C / 2) : c;
      to = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(dst) + wg::sw128_offset(r, pc, FC));
    } else {
      to = dst + r * (C + PAD) + c;
    }
    cp_async16(to, w2 + (size_t)(f0 + r) * C + c);
  }
}

// fc1 on wgmma: acc (64 x FC / SPLIT: warpgroup wgi's rows of t7 and its
// share of the chunk's columns) = t7 (PIX x C) . w1 chunk.
template <int C, int FC, int PIX, int SPLIT>
__device__ __forceinline__ void fc1_wgmma(float (&acc)[FC / SPLIT / 8][4], const void* t7, const void* w1s,
                                          int wgi) {
  const unsigned char* a0 = static_cast<const unsigned char*>(t7) + (SPLIT == 1 ? wgi * 64 * 128 : 0);
  const unsigned char* b0 = static_cast<const unsigned char*>(w1s) + (SPLIT == 2 ? wgi * FC : 0);  // FC / 2 columns
  const uint64_t a = wg::desc(a0, 16, 1024);
  const uint64_t b = wg::desc(b0, C * 128, 1024);
  wg::fence_operand(acc);
  wg::fence();
#pragma unroll
  for (int k0 = 0; k0 < C; k0 += 16)
    wg::mma_async<FC / SPLIT>(acc, wg::advance(a, (k0 / 64) * PIX * 128 + (k0 % 64) * 2),
                              wg::advance(b, k0 * 128), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_operand(acc);
}

// fc2 on wgmma: acc (64 x C / SPLIT, warpgroup wgi's part of y) += h (its
// rows of the PIX x FC chunk) . w2 chunk.
template <int C, int FC, int SPLIT>
__device__ __forceinline__ void fc2_wgmma(float (&acc)[C / SPLIT / 8][4], const void* hs, const void* w2s,
                                          int wgi) {
  const unsigned char* a0 = static_cast<const unsigned char*>(hs) + (SPLIT == 1 ? wgi * 64 * 128 : 0);
  const unsigned char* b0 = static_cast<const unsigned char*>(w2s) + (SPLIT == 2 ? wgi * w2_half_cols(C) * FC * 2 : 0);
  const uint64_t a = wg::desc(a0, 16, 1024);
  const uint64_t b = wg::desc(b0, FC * 128, 1024);
  wg::fence_operand(acc);
  wg::fence();
#pragma unroll
  for (int k0 = 0; k0 < FC; k0 += 16)
    wg::mma_async<C / SPLIT>(acc, wg::advance(a, k0 * 2), wg::advance(b, k0 * 128), 1);
  wg::commit();
  wg::wait<0>();
  wg::fence_operand(acc);
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, Plan<T, C>::MIN_BLOCKS)
repmixer_kernel(const T* __restrict__ x, const T* __restrict__ w3, const T* __restrict__ b3,
                const T* __restrict__ w7, const T* __restrict__ b7, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
                const T* __restrict__ gamma, T* __restrict__ out, int H, int W, int F,
                int tiles_w) {
  constexpr int FC = Plan<T, C>::FC;
  constexpr bool T3_SMEM = Plan<T, C>::T3_SMEM;
  constexpr bool WG = Plan<T, C>::WG;
  constexpr int TH = Plan<T, C>::TH, PIX = Plan<T, C>::PIX, SPLIT = Plan<T, C>::SPLIT;
  constexpr int IN_H = TH + 2 * HALO, RING_H = TH + 6;
  constexpr int LDT = C + PAD;      // t7 / t3c / w2s row stride (without wgmma)
  constexpr int LDH = FC + PAD;     // w1s / hs row stride (without wgmma)
  constexpr int NJ1 = FC / SPLIT / 8;  // 8-column tiles of a hidden chunk per warp
  constexpr int NJ2 = C / SPLIT / 8;   // 8-column tiles of y per warp
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout L = plan_layout<T, C>();
  T* t7 = reinterpret_cast<T*>(smem + L.t7);
  T* t3c = reinterpret_cast<T*>(smem + L.t3c);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  T* hs = reinterpret_cast<T*>(smem + L.hs);

  const int oy = (blockIdx.x / tiles_w) * TH;
  const int ox = (blockIdx.x % tiles_w) * TW;
  const size_t img = (size_t)blockIdx.y * H * W * C;
  const T* xi = x + img;
  T* oi = out + img;
  const int ch = threadIdx.x % CC;  // a thread's channel within the chunk, fixed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // ---- phase 1: depthwise pair, one chunk of CC channels at a time ---------
  // The next chunk's input tile loads while this one is computed.
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  constexpr int XS = IN_H * IN_W * CC;
  stage_input<T, C, TH>(xs, xi, H, W, oy, ox, 0);
  cp_async_commit();
  for (int c0 = 0; c0 < C; c0 += CC) {
    const T* xc = xs + ((c0 / CC) & 1) * XS;
    if (c0 + CC < C) {
      stage_input<T, C, TH>(xs + (((c0 / CC) + 1) & 1) * XS, xi, H, W, oy, ox, c0 + CC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    float k3[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) k3[j] = to_f(w3[j * C + c0 + ch]);
    const float bias3 = to_f(b3[c0 + ch]);
    __syncthreads();
    // t3 over the ring; ring row ry <-> image row oy - 3 + ry
    for (int i = threadIdx.x; i < RING_H * RING_W * CC; i += THREADS) {
      const int p = i / CC;
      const int ry = p / RING_W, rx = p % RING_W;
      const int gy = oy - 3 + ry, gx = ox - 3 + rx;
      float val = 0.0f;  // dw7's SAME zero padding around t3
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = fmaf(k3[dy * 3 + dx], to_f(xc[((ry + dy) * IN_W + rx + dx) * CC + ch]), acc);
        val = acc + bias3;
      }
      ring[i] = from_f<T>(val);  // t3 rounded to dtype
    }
    float k7[49];
#pragma unroll
    for (int j = 0; j < 49; ++j) k7[j] = to_f(w7[j * C + c0 + ch]);
    const float bias7 = to_f(b7[c0 + ch]);
    __syncthreads();
    // dw7: this thread's channel at output column px = warp, all TH rows,
    // sweeping the ring's rows once with the TH sums in registers.
    {
      const int px = warp;
      float acc[TH];
#pragma unroll
      for (int py = 0; py < TH; ++py) acc[py] = bias7;
#pragma unroll
      for (int ry = 0; ry < RING_H; ++ry) {
        float row[7];
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) row[dx] = to_f(ring[(ry * RING_W + px + dx) * CC + ch]);
#pragma unroll
        for (int py = 0; py < TH; ++py) {
          const int dy = ry - py;
          if (dy >= 0 && dy < 7) {
#pragma unroll
            for (int dx = 0; dx < 7; ++dx) acc[py] = fmaf(k7[dy * 7 + dx], row[dx], acc[py]);
          }
        }
        if (ry >= 3 && ry < 3 + TH) {
          const T t3 = ring[(ry * RING_W + px + 3) * CC + ch];
          if (T3_SMEM) {
            *tile_at<WG, PIX>(t3c, (ry - 3) * TW + px, c0 + ch, LDT) = t3;
          } else if (oy + ry - 3 < H && ox + px < W) {
            oi[((size_t)(oy + ry - 3) * W + ox + px) * C + c0 + ch] = t3;
          }
        }
      }
#pragma unroll
      for (int py = 0; py < TH; ++py) *tile_at<WG, PIX>(t7, py * TW + px, c0 + ch, LDT) = from_f<T>(acc[py]);
    }
  }
  __syncthreads();  // phase 2 reuses the input tiles' and ring's memory; t3 in out is visible

  // ---- phase 2: fc1 -> GELU -> fc2 over hidden chunks, y in registers ------
  // Warpgroup wgi = warp / 4 owns 64 pixel rows and, with SPLIT 2 (64-pixel
  // tiles), half of each product's columns; warp w of it 16 of the rows. With
  // wgmma the warpgroup issues the 64-row products, with the same register
  // layout as the m16n8 tiles of the other instance.
  const int wgi = warp >> 2;
  const int m0 = (SPLIT == 1 ? 64 * wgi : 0) + (warp & 3) * 16;  // this warp's 16 pixel rows
  const int n1 = SPLIT == 2 ? wgi * (FC / 2) : 0;  // its first column of a hidden chunk
  const int n2 = SPLIT == 2 ? wgi * (C / 2) : 0;   // its first column of y
  float y[NJ2][4];
#pragma unroll
  for (int j = 0; j < NJ2; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.0f;

  stage_w1<T, C, FC, WG>(w1s, w1, F, 0);
  cp_async_commit();
  for (int f0 = 0; f0 < F; f0 += FC) {
    stage_w2<T, C, FC, WG, SPLIT>(w2s, w2, f0);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's w1 has landed
    if constexpr (WG) wg::fence_async_smem();
    __syncthreads();

    float hacc[NJ1][4];
#pragma unroll
    for (int j = 0; j < NJ1; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.0f;
    if constexpr (WG) {
      fc1_wgmma<C, FC, PIX, SPLIT>(hacc, t7, w1s, wgi);
    } else {
#pragma unroll 4
      for (int k0 = 0; k0 < C; k0 += 16)
        mma_k16_kn<NJ1>(hacc, t7 + m0 * LDT + k0, LDT, w1s + k0 * LDH + n1, LDH);
    }
#pragma unroll
    for (int j = 0; j < NJ1; ++j) {
      const int col = n1 + j * 8 + 2 * t;
      const float bb0 = to_f(b1[f0 + col]), bb1 = to_f(b1[f0 + col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float h0 = gelu_tanh<T>(round_to<T>(hacc[j][2 * half] + bb0));
        const float h1 = gelu_tanh<T>(round_to<T>(hacc[j][2 * half + 1] + bb1));
        *reinterpret_cast<pair_t<T>*>(tile_at<WG, PIX>(hs, m0 + g + 8 * half, col, LDH)) = pack<T>(h0, h1);
      }
    }
    if constexpr (WG) wg::fence_async_smem();
    __syncthreads();  // hs complete; every warp is done reading w1s

    if (f0 + FC < F) {
      stage_w1<T, C, FC, WG>(w1s, w1, F, f0 + FC);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's w2 has landed
    } else {
      cp_async_wait<0>();
    }
    if constexpr (WG) wg::fence_async_smem();
    __syncthreads();
    if constexpr (WG) {
      fc2_wgmma<C, FC, SPLIT>(y, hs, w2s, wgi);
    } else {
#pragma unroll
      for (int k0 = 0; k0 < FC; k0 += 16)
        mma_k16_kn<NJ2>(y, hs + m0 * LDH + k0, LDH, w2s + k0 * LDT + n2, LDT);
    }
    __syncthreads();  // before the next chunk overwrites w2s and hs
  }

  // ---- epilogue: + b2, round, x gamma, round, + t3, store ------------------
#pragma unroll
  for (int j = 0; j < NJ2; ++j) {
    const int col = n2 + j * 8 + 2 * t;
    const float bb0 = to_f(b2[col]), bb1 = to_f(b2[col + 1]);
    const float g0 = to_f(gamma[col]), g1 = to_f(gamma[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + g + 8 * half;
      const int gy = oy + p / TW, gx = ox + p % TW;
      if (gy < H && gx < W) {
        const T* t3 = T3_SMEM ? tile_at<WG, PIX>(t3c, p, col, LDT) : oi + ((size_t)gy * W + gx) * C + col;
        const float2 r = unpack(*reinterpret_cast<const pair_t<T>*>(t3));
        const float v0 = r.x + round_to<T>(round_to<T>(y[j][2 * half] + bb0) * g0);
        const float v1 = r.y + round_to<T>(round_to<T>(y[j][2 * half + 1] + bb1) * g1);
        *reinterpret_cast<pair_t<T>*>(oi + ((size_t)gy * W + gx) * C + col) = pack<T>(v0, v1);
      }
    }
  }
}

template <typename T, int C>
int launch(const void* x, const void* w3, const void* b3, const void* w7, const void* b7,
           const void* w1, const void* b1, const void* w2, const void* b2, const void* gamma,
           void* out, int B, int H, int W, int F, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = plan_layout<T, C>().total;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(repmixer_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + Plan<T, C>::TH - 1) / Plan<T, C>::TH, tiles_w = (W + TW - 1) / TW;
  dim3 grid(tiles_h * tiles_w, B);
  repmixer_kernel<T, C><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w3), static_cast<const T*>(b3),
      static_cast<const T*>(w7), static_cast<const T*>(b7), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(gamma), static_cast<T*>(out), H, W, F, tiles_w);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w3, const void* b3, const void* w7, const void* b7,
             const void* w1, const void* b1, const void* w2, const void* b2, const void* gamma,
             void* out, int B, int H, int W, int C, int F, cudaStream_t st) {
  switch (C) {
    case 96: return launch<T, 96>(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma, out, B, H, W, F, st);
    case 192: return launch<T, 192>(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma, out, B, H, W, F, st);
    case 384: return launch<T, 384>(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma, out, B, H, W, F, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
long long smem_bytes(int C) {
  switch (C) {
    case 96: return (long long)plan_layout<T, 96>().total;
    case 192: return (long long)plan_layout<T, 192>().total;
    case 384: return (long long)plan_layout<T, 384>().total;
    default: return 0;
  }
}

}  // namespace

// Shared memory one block needs, in bytes (0 for an unknown dtype or width),
// so the caller can reject a shape before launching.
extern "C" long long repmixer_smem_bytes(int C, int dtype) {
  if (dtype == 1) return smem_bytes<bf16>(C);
  if (dtype == 0) return smem_bytes<float>(C);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. w3: (3, 3, C), w7: (7, 7, C), w1: (C, F),
// w2: (F, C). C is one of the FastViTHD RepMixer widths 96, 192, 384.
// Returns a cudaError_t value (0 = launched).
extern "C" int repmixer_block_fwd(const void* x, const void* w3, const void* b3, const void* w7,
                                  const void* b7, const void* w1, const void* b1, const void* w2,
                                  const void* b2, const void* gamma, void* out, int B, int H,
                                  int W, int C, int F, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || F <= 0 || F % 64 != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<bf16>(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma, out, B, H, W, C, F, st);
  if (dtype == 0) return dispatch<float>(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma, out, B, H, W, C, F, st);
  return (int)cudaErrorInvalidValue;
}
