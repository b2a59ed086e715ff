// Paged-KV attention over a speculative verify window (W > 1 new tokens per
// slot), forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vla_fastvlm_tpu/ops/pallas/paged_attention.py
// at W > 1 (paged_attention_window -> _paged_attn_kernel / _paged_attn_kernel_int8
// -> _attend_last_page, window branch). Same function:
//   q (B, W, N, D) x pools (P_total, K, page, D) through tables (B, P_slot)
//   -> out (B, W, N, D), query head h reading KV head h / (N / K);
//   - per KV head the W * rep query rows are window-major: row i = w * rep + r
//     is query head kvh * rep + r at window position w;
//   - stored position s of slot b (logical s = p * page + i lives at
//     pool[tables[b, p], kv, i]) is valid where mask[b, s] != 0; masked
//     logits are -1e30 (finite);
//   - the window's k_new / v_new (B, W, K, D) join the softmax as W extra
//     columns, column j valid for row i iff j <= i / rep (slot-causal), so the
//     pools are only read and the kernel never depends on the window's
//     scatter; the server's invariant is that mask marks only positions below
//     the window, so rejected rows of an earlier round, still in the pages
//     past the cursor, are masked and never count;
//   - fp32 logits and softmax; every probability (stored and window columns)
//     is rounded to the value dtype before P.V, as the TPU kernel does at
//     W > 1 (`(eb / denom).astype(v_new.dtype)`); fp32 accumulation;
//   - int8 pools: pages convert int8 -> float exactly; the per-(position, KV
//     head) K scales multiply the scores and the V scales the probabilities
//     before rounding. The scale windows (B, K, S_max) are gathered outside
//     the kernel, and k_new / v_new arrive dequant-roundtripped.
//
// As in the W = 1 kernel (paged_attention.cu) the window is walked in tiles
// with an online softmax instead of staged whole, so probabilities are
// rounded relative to the running maximum and normalized at the end; the
// function is the same, summation order and the rounding points of P differ
// by a per-row factor.
//
// Bound on this card: bytes. A verify reads every valid page of every slot
// once per layer; at the 7B verify shape (16 slots + 1, 28 heads over 4 KV
// heads, D = 128, W = 5, windows of 24 pages of 16) that is ~13 MB against
// ~0.2 GFLOP a launch. Design: the W = 1 kernel's grid and walk (one block per
// (slot, KV head), 64 stored positions a tile, pages with no valid position
// not read, tiles with none skipped), but a block now carries W * rep query
// rows (35 at k = 4 for both 0.5B and 7B), too many for one position per
// lane. So each warp owns 16 of them as an mma.sync m16n8k16 tile, with the
// FlashAttention-2 register layout of flash_attention.cu: Q fragments, logits,
// probabilities and the output accumulator stay in registers, K/V of the tile
// are staged in shared memory once and read by every warp. A block has
// ceil(W * rep / 16) warps (3 at 35 rows); the window's W rows are the walk's
// last tile, 16 columns wide. Nothing is pipelined and S is not split across
// blocks; both are later work. The fp32 instance runs the same code with
// CUDA-core products (mma_tiles.cuh).

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

using namespace mma_tiles;

namespace {

constexpr int TP = 64;        // stored positions per tile (whole pages)
constexpr int WIN = 16;       // window columns of the last tile (W <= WIN)
constexpr int PAD = 8;        // row padding (elements) against bank conflicts
constexpr int MAX_WARPS = 5;  // 16-row tiles per block: W * rep <= 80
constexpr float MASKED = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout, shared by the host launcher and the kernel.
struct Layout {
  size_t ks, vs, mk, sc, total;
  __host__ __device__ Layout(int esz, int d) {
    ks = 0;
    vs = align128((size_t)TP * (d + PAD) * esz);
    mk = vs + align128((size_t)TP * (d + PAD) * esz);
    sc = mk + align128((size_t)2 * TP * sizeof(int));         // mask, then page ids of the tile
    total = sc + align128((size_t)2 * TP * sizeof(float));     // K scales, V scales (int8 pools)
  }
};

// Eight consecutive int8 pool elements (8-byte aligned) as floats.
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(int8_t)((u.x >> (8 * i)) & 0xff);
    f[4 + i] = (float)(int8_t)((u.y >> (8 * i)) & 0xff);
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  u.x = pack<bf16>(f[0], f[1]);
  u.y = pack<bf16>(f[2], f[3]);
  u.z = pack<bf16>(f[4], f[5]);
  u.w = pack<bf16>(f[6], f[7]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// Eight elements of a pool (or window) row into shared memory as T; zeros
// where not valid (nothing is read). int8 converts exactly.
template <typename T, typename P>
__device__ __forceinline__ void stage8(T* dst, const P* src, bool valid) {
  if constexpr (sizeof(P) == sizeof(T)) {
    constexpr int N16 = 8 * sizeof(T) / 16;  // 16-byte words: 1 for bf16, 2 for fp32
#pragma unroll
    for (int i = 0; i < N16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = valid ? reinterpret_cast<const uint4*>(src)[i] : make_uint4(0u, 0u, 0u, 0u);
  } else {
    float f[8];
    if (valid) {
      load8(src, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.0f;
    }
    store8(dst, f);
  }
}

// One warp's 16 query rows of one (slot, KV head): block rows row_lo = row0 + g
// and row_hi = row0 + g + 8 of this thread.
template <typename T, int D>
struct WinTile {
  pair_t<T> qa[D / 16][4];
  float o[D / 8][4];
  float m_run[2], l_run[2];
  int row_lo, row_hi;

  __device__ __forceinline__ static const T* row_ptr(const T* base, int b, int kvh, int r, int W, int N, int rep) {
    const int w = r / rep, h = kvh * rep + r % rep;
    return base + (((size_t)b * W + w) * N + h) * D;
  }

  __device__ __forceinline__ void load(const T* q, int b, int kvh, int row0, int R, int W, int N, int rep) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    row_lo = row0 + g;
    row_hi = row0 + g + 8;
    const pair_t<T> zero = pack<T>(0.0f, 0.0f);
    const T* qlo = row_lo < R ? row_ptr(q, b, kvh, row_lo, W, N, rep) : nullptr;
    const T* qhi = row_hi < R ? row_ptr(q, b, kvh, row_hi, W, N, rep) : nullptr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = qlo ? *reinterpret_cast<const pair_t<T>*>(qlo + c) : zero;
      qa[kk][1] = qhi ? *reinterpret_cast<const pair_t<T>*>(qhi + c) : zero;
      qa[kk][2] = qlo ? *reinterpret_cast<const pair_t<T>*>(qlo + c + 8) : zero;
      qa[kk][3] = qhi ? *reinterpret_cast<const pair_t<T>*>(qhi + c + 8) : zero;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.0f;
  }

  // Columns 0 .. nk - 1 of a tile staged at ks / vs (NKT * 8 columns at most;
  // the rest take no part). Stored tiles: column valid where mk is set, int8
  // scales from kss / vss. The window tile (WINDOW): column j valid for block
  // row i iff j <= i / rep.
  template <int NKT, bool WINDOW, bool INT8>
  __device__ __forceinline__ void attend(const T* ks, const T* vs, int nk, const int* mk, const float* kss,
                                         const float* vss, int rep, float scale) {
    constexpr int LD = D + PAD;
    const int lane = threadIdx.x & 31, t = lane & 3;
    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NKT; j += 2) {
        if (j * 8 >= nk) break;  // tiles wholly past nk stay out below
        pair_t<T> bf[4];
        load_b_nk(bf, ks + j * 8 * LD + kk * 16, LD);
        mma(s[j], qa[kk], bf[0], bf[1]);
        mma(s[j + 1], qa[kk], bf[2], bf[3]);
      }
    }
    // mask, scale, online softmax; element e of tile j: row (e < 2 ? lo : hi), column 2t + e % 2
    float bmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t + (e & 1);
        float x = -INFINITY;  // columns past nk take no part at all
        if (key < nk) {
          if (WINDOW) {
            x = key <= (e < 2 ? row_lo : row_hi) / rep ? s[j][e] * scale : MASKED;
          } else {
            float v = s[j][e] * scale;
            if (INT8) v *= kss[key];
            x = mk[key] != 0 ? v : MASKED;
          }
        }
        s[j][e] = x;
        bmax[e >> 1] = fmaxf(bmax[e >> 1], x);
      }
    }
    float alpha[2], bsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 1));
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 2));
      const float m_new = fmaxf(m_run[r], bmax[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);
        bsum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bsum[r] += __shfl_xor_sync(0xffffffffu, bsum[r], 1);
      bsum[r] += __shfl_xor_sync(0xffffffffu, bsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + bsum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // P (times the V scales of int8 pages, rounded to the value dtype) . V, 16 columns a step
#pragma unroll
    for (int kk = 0; kk < NKT / 2; ++kk) {
      if (kk * 16 >= nk) break;  // their probabilities are 0
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 2 * kk + h;
          p[h][e] = (INT8 && !WINDOW) ? s[j][e] * vss[j * 8 + 2 * t + (e & 1)] : s[j][e];
        }
      pair_t<T> pa[4];
      pa[0] = pack<T>(p[0][0], p[0][1]);
      pa[1] = pack<T>(p[0][2], p[0][3]);
      pa[2] = pack<T>(p[1][0], p[1][1]);
      pa[3] = pack<T>(p[1][2], p[1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        pair_t<T> bf[4];
        load_b_kn(bf, vs + kk * 16 * LD + j * 8, LD);
        mma(o[j], pa, bf[0], bf[1]);
        mma(o[j + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // out = o / l for this thread's two rows (those below R)
  __device__ __forceinline__ void store(T* out, int b, int kvh, int R, int W, int N, int rep) const {
    const int t = (threadIdx.x & 31) & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row_lo : row_hi;
      if (row >= R) continue;
      const float inv = 1.0f / l_run[r];
      T* dst = const_cast<T*>(row_ptr(out, b, kvh, row, W, N, rep));
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<pair_t<T>*>(dst + j * 8 + 2 * t) = pack<T>(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
};

// T: query / output / value dtype; P: pool element (T, or int8_t with scales).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_window_kernel(const T* __restrict__ q, const P* __restrict__ pool_k, const P* __restrict__ pool_v,
                    const int* __restrict__ tables, const int* __restrict__ mask,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const float* __restrict__ kscale, const float* __restrict__ vscale,
                    T* __restrict__ out, int W, int N, int KH, int page, int P_slot, float scale) {
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int LD = D + PAD;
  constexpr int CPR = D / 8;  // 8-element chunks per staged row
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(sizeof(T), D);
  T* ks = reinterpret_cast<T*>(smem + L.ks);
  T* vs = reinterpret_cast<T*>(smem + L.vs);
  int* mk = reinterpret_cast<int*>(smem + L.mk);
  int* pid = mk + TP;  // physical page of each page of the tile, -1 when not read
  float* kss = reinterpret_cast<float*>(smem + L.sc);
  float* vss = kss + TP;

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int rep = N / KH, R = W * rep, S = P_slot * page;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int* table = tables + (size_t)b * P_slot;
  const int* mrow = mask + (size_t)b * S;

  // One warp per 16 block rows: blockDim.x = 32 * ceil(R / 16).
  WinTile<T, D> tile;
  tile.load(q, b, kvh, (tid >> 5) * 16, R, W, N, rep);

  const int pages_per_tile = page < TP ? TP / page : 1;
  for (int t0 = 0; t0 < S; t0 += TP) {
    const int n_pos = min(TP, S - t0);
    // 1. mask of the tile; which of its pages hold a valid position
    for (int i = tid; i < TP; i += nthreads) mk[i] = i < n_pos ? mrow[t0 + i] : 0;
    __syncthreads();
    int any = 0;
    for (int pp = tid; pp < pages_per_tile; pp += nthreads) {
      const int first = pp * page;
      int valid_page = 0;
      for (int i = first; i < first + page && i < n_pos; ++i) valid_page |= mk[i] != 0;
      pid[pp] = valid_page ? table[(t0 + first) / page] : -1;
      any |= valid_page;
    }
    if (!__syncthreads_or(any)) continue;  // nothing valid in this tile

    // 2. stage the valid pages' K/V rows as T (zeros for the others) and the scales
    for (int i = tid; i < TP * CPR; i += nthreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int pg = pid[r / page];
      const bool valid = r < n_pos && pg >= 0;
      const size_t off = valid ? (((size_t)pg * KH + kvh) * page + r % page) * D + c : 0;
      stage8<T, P>(ks + r * LD + c, pool_k + off, valid);
      stage8<T, P>(vs + r * LD + c, pool_v + off, valid);
    }
    if (INT8) {
      const size_t base = ((size_t)b * KH + kvh) * S + t0;
      for (int i = tid; i < TP; i += nthreads) {
        kss[i] = i < n_pos ? kscale[base + i] : 0.0f;
        vss[i] = i < n_pos ? vscale[base + i] : 0.0f;
      }
    }
    __syncthreads();
    tile.template attend<TP / 8, false, INT8>(ks, vs, n_pos, mk, kss, vss, rep, scale);
    __syncthreads();  // before the next tile overwrites the staged pages and the mask
  }

  // 3. the window's W rows as the last tile, slot-causal
  for (int i = tid; i < WIN * CPR; i += nthreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool valid = r < W;
    const size_t off = valid ? (((size_t)b * W + r) * KH + kvh) * D + c : 0;
    stage8<T, T>(ks + r * LD + c, k_new + off, valid);
    stage8<T, T>(vs + r * LD + c, v_new + off, valid);
  }
  __syncthreads();
  tile.template attend<WIN / 8, true, false>(ks, vs, W, nullptr, nullptr, nullptr, rep, scale);
  tile.store(out, b, kvh, R, W, N, rep);
}

template <typename T, typename P, int D>
int launch(const void* q, const void* pk, const void* pv, const void* tables, const void* mask,
           const void* kn, const void* vn, const void* ksc, const void* vsc, void* out, int B, int W, int N,
           int KH, int page, int P_slot, float scale, cudaStream_t stream) {
  const int warps = (W * (N / KH) + 15) / 16;
  if (warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = Layout(sizeof(T), D).total;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_window_kernel<T, P, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KH);
  paged_window_kernel<T, P, D><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk), static_cast<const P*>(pv),
      static_cast<const int*>(tables), static_cast<const int*>(mask), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<T*>(out), W, N, KH, page, P_slot, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int by_dim(const void* q, const void* pk, const void* pv, const void* tables, const void* mask,
           const void* kn, const void* vn, const void* ksc, const void* vsc, void* out, int B, int W, int N,
           int KH, int D, int page, int P_slot, float scale, cudaStream_t st) {
  if (D == 64) return launch<T, P, 64>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, B, W, N, KH, page, P_slot, scale, st);
  if (D == 128) return launch<T, P, 128>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, B, W, N, KH, page, P_slot, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, out; and the pools unless
// int8_pool, when the pools are int8 and kscale / vscale are (B, K, P_slot *
// page) float32 windows). W: 1 .. 16 window positions with W * N / K <= 80
// query rows per KV head. page: a power of two up to 64. Returns a cudaError_t
// value (0 = launched).
extern "C" int paged_window_fwd(const void* q, const void* pool_k, const void* pool_v,
                                const void* tables, const void* mask, const void* k_new,
                                const void* v_new, const void* kscale, const void* vscale,
                                void* out, int B, int W, int N, int KH, int D, int page, int P_slot,
                                float scale, int dtype, int int8_pool, void* stream) {
  if (B <= 0 || W <= 0 || W > WIN || KH <= 0 || N % KH != 0 || P_slot <= 0 || KH > 65535 || page <= 0 ||
      page > TP || (page & (page - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && !int8_pool)
    return by_dim<bf16, bf16>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, W, N, KH, D, page, P_slot, scale, st);
  if (dtype == 1 && int8_pool)
    return by_dim<bf16, int8_t>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, W, N, KH, D, page, P_slot, scale, st);
  if (dtype == 0 && !int8_pool)
    return by_dim<float, float>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, W, N, KH, D, page, P_slot, scale, st);
  if (dtype == 0 && int8_pool)
    return by_dim<float, int8_t>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, W, N, KH, D, page, P_slot, scale, st);
  return (int)cudaErrorInvalidValue;
}
