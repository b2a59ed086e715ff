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
// two pointwise products are ~77 GFLOP a block against ~100-200 MB moved, so
// the block is bound by operations; the 58 depthwise taps per pixel and
// channel run on CUDA cores. The design keeps every intermediate on chip: t3,
// t7, the hidden activation and the fp32 accumulator never reach device
// memory, and x is read and out written once.
//
// Design: one block of 8 warps per (8x8 pixel tile, image).
// 1. Depthwise pair on CUDA cores, 32 channels at a time: the 16x16 haloed
//    input tile arrives by cp.async (the next chunk's while this one is
//    computed), the 14x14 dw3 ring is computed (masked to 0 outside the
//    image, rounded), then dw7 for the 8x8 tile: each thread owns one channel
//    of one pixel column, holds the channel's taps in registers and sweeps
//    the ring's rows once with the column's 8 sums in registers. t7
//    (64 px x C) and the centre of t3 stay in shared memory.
// 2. fc1 -> GELU -> fc2 over hidden chunks of 64 on the tensor cores
//    (mma.sync m16n8k16, operands through ldmatrix). The fp32 y tile (64 x C)
//    lives in registers for the whole loop: warp w owns rows 16 (w % 4) and
//    half of the columns. Weight chunks are staged in shared memory with
//    cp.async: the w2 chunk loads while fc1 runs and the next w1 chunk while
//    fc2 runs.
// 3. Epilogue from the registers: + b2, round, x gamma, round, + t3, store.
// The fp32 instance runs the same code with CUDA-core products (mma_tiles.cuh)
// and fits shared memory up to C = 192.

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>

using namespace mma_tiles;

namespace {

constexpr int TILE = 8;                   // output pixels per side
constexpr int PIX = TILE * TILE;          // 64 pixels (GEMM rows) per block
constexpr int HALO = 4;                   // dw3 (1) + dw7 (3)
constexpr int IN_SIDE = TILE + 2 * HALO;  // 16
constexpr int RING = TILE + 6;            // dw3 output incl. the dw7 halo: 14
constexpr int CC = 32;                    // channels per depthwise chunk
constexpr int FC = 64;                    // hidden units per fc chunk
constexpr int THREADS = 256;
constexpr int PAD = 8;                    // row padding (elements) against bank conflicts
static_assert(THREADS / CC == TILE, "dw7 gives each warp one pixel column");

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

// Shared-memory layout, shared by the host planner and the kernel.
struct Layout {
  size_t t7, t3c, xs, ring, w1s, w2s, hs, total;
  __host__ __device__ Layout(int esz, int c) {
    const size_t tsz = align128((size_t)PIX * (c + PAD) * esz);
    t7 = 0;
    t3c = tsz;
    const size_t uni = 2 * tsz;  // phase 1 (depthwise) and phase 2 (fc) share the rest
    xs = uni;                    // two input tiles: the chunk in use and the next
    ring = xs + 2 * align128((size_t)IN_SIDE * IN_SIDE * CC * esz);
    const size_t phase1 = ring + align128((size_t)RING * RING * CC * esz);
    w1s = uni;
    w2s = w1s + align128((size_t)c * (FC + PAD) * esz);
    hs = w2s + align128((size_t)FC * (c + PAD) * esz);
    const size_t phase2 = hs + align128((size_t)PIX * (FC + PAD) * esz);
    total = phase1 > phase2 ? phase1 : phase2;
  }
};

// Start copying the haloed 16x16 input tile of channels [c0, c0 + CC) into
// dst (pixel-major, CC wide); pixels outside the image are zero-filled.
template <typename T, int C>
__device__ __forceinline__ void stage_input(T* dst, const T* xi, int H, int W, int oy, int ox, int c0) {
  constexpr int VEC = 16 / sizeof(T), PER_PIX = CC / VEC;
  for (int i = threadIdx.x; i < IN_SIDE * IN_SIDE * PER_PIX; i += THREADS) {
    const int p = i / PER_PIX, c = (i % PER_PIX) * VEC;
    const int gy = oy - HALO + p / IN_SIDE, gx = ox - HALO + p % IN_SIDE;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* src = inside ? xi + ((size_t)gy * W + gx) * C + c0 + c : xi;
    cp_async16_zfill(dst + p * CC + c, src, inside);
  }
}

// Stage w1[:, f0 : f0 + FC] (C rows of FC) into dst with row stride FC + PAD.
template <typename T, int C>
__device__ __forceinline__ void stage_w1(T* dst, const T* w1, int F, int f0) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = FC / VEC;
  for (int i = threadIdx.x; i < C * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    cp_async16(dst + r * (FC + PAD) + c, w1 + (size_t)r * F + f0 + c);
  }
}

// Stage w2[f0 : f0 + FC, :] (FC rows of C) into dst with row stride C + PAD.
template <typename T, int C>
__device__ __forceinline__ void stage_w2(T* dst, const T* w2, int f0) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = C / VEC;
  for (int i = threadIdx.x; i < FC * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    cp_async16(dst + r * (C + PAD) + c, w2 + (size_t)(f0 + r) * C + c);
  }
}

// Blocks an SM should hold: the y tile of C = 384 takes every register a
// thread may have; narrower blocks fit two to an SM, which hides the cp.async
// latencies of one behind the other's work.
template <int C> constexpr int min_blocks() { return C >= 384 ? 1 : 2; }

template <typename T, int C>
__global__ void __launch_bounds__(THREADS, min_blocks<C>())
repmixer_kernel(const T* __restrict__ x, const T* __restrict__ w3, const T* __restrict__ b3,
                const T* __restrict__ w7, const T* __restrict__ b7, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
                const T* __restrict__ gamma, T* __restrict__ out, int H, int W, int F,
                int tiles_w) {
  constexpr int LDT = C + PAD;      // t7 / t3c / w2s row stride
  constexpr int LDH = FC + PAD;     // w1s / hs row stride
  constexpr int NJ2 = C / 16;       // 8-column tiles of y per warp (half of C)
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(sizeof(T), C);
  T* t7 = reinterpret_cast<T*>(smem + L.t7);
  T* t3c = reinterpret_cast<T*>(smem + L.t3c);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  T* hs = reinterpret_cast<T*>(smem + L.hs);

  const int oy = (blockIdx.x / tiles_w) * TILE;
  const int ox = (blockIdx.x % tiles_w) * TILE;
  const size_t img = (size_t)blockIdx.y * H * W * C;
  const T* xi = x + img;
  const int ch = threadIdx.x % CC;  // a thread's channel within the chunk, fixed
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // ---- phase 1: depthwise pair, one chunk of CC channels at a time ---------
  // The next chunk's input tile loads while this one is computed.
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  constexpr int XS = IN_SIDE * IN_SIDE * CC;
  stage_input<T, C>(xs, xi, H, W, oy, ox, 0);
  cp_async_commit();
  for (int c0 = 0; c0 < C; c0 += CC) {
    const T* xc = xs + ((c0 / CC) & 1) * XS;
    if (c0 + CC < C) {
      stage_input<T, C>(xs + (((c0 / CC) + 1) & 1) * XS, xi, H, W, oy, ox, c0 + CC);
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
    for (int i = threadIdx.x; i < RING * RING * CC; i += THREADS) {
      const int p = i / CC;
      const int ry = p / RING, rx = p % RING;
      const int gy = oy - 3 + ry, gx = ox - 3 + rx;
      float val = 0.0f;  // dw7's SAME zero padding around t3
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = fmaf(k3[dy * 3 + dx], to_f(xc[((ry + dy) * IN_SIDE + rx + dx) * CC + ch]), acc);
        val = acc + bias3;
      }
      ring[i] = from_f<T>(val);  // t3 rounded to dtype
    }
    float k7[49];
#pragma unroll
    for (int j = 0; j < 49; ++j) k7[j] = to_f(w7[j * C + c0 + ch]);
    const float bias7 = to_f(b7[c0 + ch]);
    __syncthreads();
    // dw7: this thread's channel at output column px = warp, all 8 rows,
    // sweeping the ring's rows once with the 8 sums in registers.
    {
      const int px = warp;
      float acc[TILE];
#pragma unroll
      for (int py = 0; py < TILE; ++py) acc[py] = bias7;
#pragma unroll
      for (int ry = 0; ry < RING; ++ry) {
        float row[7];
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) row[dx] = to_f(ring[(ry * RING + px + dx) * CC + ch]);
#pragma unroll
        for (int py = 0; py < TILE; ++py) {
          const int dy = ry - py;
          if (dy >= 0 && dy < 7) {
#pragma unroll
            for (int dx = 0; dx < 7; ++dx) acc[py] = fmaf(k7[dy * 7 + dx], row[dx], acc[py]);
          }
        }
        if (ry >= 3 && ry < 3 + TILE) t3c[((ry - 3) * TILE + px) * LDT + c0 + ch] = ring[(ry * RING + px + 3) * CC + ch];
      }
#pragma unroll
      for (int py = 0; py < TILE; ++py) t7[(py * TILE + px) * LDT + c0 + ch] = from_f<T>(acc[py]);
    }
  }
  __syncthreads();  // phase 2 reuses the input tiles' and ring's memory

  // ---- phase 2: fc1 -> GELU -> fc2 over hidden chunks, y in registers ------
  const int m0 = (warp & 3) * 16;        // this warp's 16 pixel rows
  const int n1 = (warp >> 2) * (FC / 2);  // its 32 columns of a hidden chunk
  const int n2 = (warp >> 2) * (C / 2);   // its C / 2 columns of y
  float y[NJ2][4];
#pragma unroll
  for (int j = 0; j < NJ2; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.0f;

  stage_w1<T, C>(w1s, w1, F, 0);
  cp_async_commit();
  for (int f0 = 0; f0 < F; f0 += FC) {
    stage_w2<T, C>(w2s, w2, f0);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's w1 has landed
    __syncthreads();

    float hacc[FC / 16][4];
#pragma unroll
    for (int j = 0; j < FC / 16; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.0f;
#pragma unroll 4
    for (int k0 = 0; k0 < C; k0 += 16)
      mma_k16_kn<FC / 16>(hacc, t7 + m0 * LDT + k0, LDT, w1s + k0 * LDH + n1, LDH);
#pragma unroll
    for (int j = 0; j < FC / 16; ++j) {
      const int col = n1 + j * 8 + 2 * t;
      const float bb0 = to_f(b1[f0 + col]), bb1 = to_f(b1[f0 + col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float h0 = gelu_tanh<T>(round_to<T>(hacc[j][2 * half] + bb0));
        const float h1 = gelu_tanh<T>(round_to<T>(hacc[j][2 * half + 1] + bb1));
        *reinterpret_cast<pair_t<T>*>(hs + (m0 + g + 8 * half) * LDH + col) = pack<T>(h0, h1);
      }
    }
    __syncthreads();  // hs complete; every warp is done reading w1s

    if (f0 + FC < F) {
      stage_w1<T, C>(w1s, w1, F, f0 + FC);
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's w2 has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < FC; k0 += 16)
      mma_k16_kn<NJ2>(y, hs + m0 * LDH + k0, LDH, w2s + k0 * LDT + n2, LDT);
    __syncthreads();  // before the next chunk overwrites w2s and hs
  }

  // ---- epilogue: + b2, round, x gamma, round, + t3, store ------------------
  T* oi = out + img;
#pragma unroll
  for (int j = 0; j < NJ2; ++j) {
    const int col = n2 + j * 8 + 2 * t;
    const float bb0 = to_f(b2[col]), bb1 = to_f(b2[col + 1]);
    const float g0 = to_f(gamma[col]), g1 = to_f(gamma[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + g + 8 * half;
      const int gy = oy + p / TILE, gx = ox + p % TILE;
      if (gy < H && gx < W) {
        const float2 r = unpack(*reinterpret_cast<const pair_t<T>*>(t3c + p * LDT + col));
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
  const size_t smem = Layout(sizeof(T), C).total;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(repmixer_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + TILE - 1) / TILE, tiles_w = (W + TILE - 1) / TILE;
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

}  // namespace

// Shared memory one block needs, in bytes (0 for an unknown dtype), so the
// caller can reject a shape before launching.
extern "C" long long repmixer_smem_bytes(int C, int dtype) {
  if (dtype == 1) return (long long)Layout(sizeof(bf16), C).total;
  if (dtype == 0) return (long long)Layout(sizeof(float), C).total;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. w3: (3, 3, C), w7: (7, 7, C), w1: (C, F),
// w2: (F, C). C is one of the FastViTHD RepMixer widths 96, 192, 384.
// Returns a cudaError_t value (0 = launched).
extern "C" int repmixer_block_fwd(const void* x, const void* w3, const void* b3, const void* w7,
                                  const void* b7, const void* w1, const void* b1, const void* w2,
                                  const void* b2, const void* gamma, void* out, int B, int H,
                                  int W, int C, int F, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || F <= 0 || F % FC != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<bf16>(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma, out, B, H, W, C, F, st);
  if (dtype == 0) return dispatch<float>(x, w3, b3, w7, b7, w1, b1, w2, b2, gamma, out, B, H, W, C, F, st);
  return (int)cudaErrorInvalidValue;
}
