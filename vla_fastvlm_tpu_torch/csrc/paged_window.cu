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
//     before rounding. The kernel reads the scales through the page table
//     from the (P_total, K, page) float32 scale pools; k_new / v_new arrive
//     dequant-roundtripped.
//
// As in the W = 1 kernel (paged_attention.cu) the stored window is split
// across blocks and merged in the same launch (paged_split.cuh): each split
// runs an online softmax over its tiles and rounds its probabilities
// relative to its own running maximum, and the window's W columns are one
// more part, rounded relative to their own maximum; the parts are merged in
// a fixed order and normalised at the end. The function is the same;
// summation order and the rounding points of P differ by a per-row factor.
//
// Bound on this card: bytes. A verify reads every valid page of every slot
// once per layer; at the 7B verify shape (16 slots + 1, 28 heads over 4 KV
// heads, D = 128, W = 5, windows of 23 pages of 16) that is ~13 MB against
// ~0.2 GFLOP a launch, ~3.4 us at 3.35 TB/s. The one-block-per-(slot, KV
// head) design sat at 14x that: 68 blocks, each walking 6 tiles with
// synchronous loads. Design: a (B, K, splits + 1) grid, splits from the
// shapes and the blocks an SM holds of the instance
// (ops/kernels/paged_attention.py::split_plan, the occupancy from
// paged_window_blocks_per_sm: at the 7B verify shape 3 parts of 2 tiles in
// bf16, whose 181 registers fit 2 blocks an SM, and 6 of one tile over int8
// pools, 168 registers and 4 blocks an SM); a
// block carries the KV head's W * rep query rows (35 at k = 4 for both 0.5B
// and 7B), ceil(W * rep / 16) warps, each owning 16 of them as an mma.sync
// m16n8k16 tile with the FlashAttention-2 register layout of
// flash_attention.cu: Q fragments, logits, probabilities and the output
// accumulator stay in registers. A split block reads its tile's mask and
// page ids in one round trip and the valid pages' K / V rows by cp.async in
// the next (int8 pages land raw and convert exactly to the query dtype in
// shared memory), and every warp reads the staged tile. Block z == splits
// stages the window's W rows (a 16-column tile) and attends them
// slot-causally. The merge stages the parts' o in shared memory by cp.async
// (paged_split.cuh), so a 7-part merge of 35 x 128 rows costs two or three round
// trips. The fp32 instance runs the same code with CUDA-core products
// (mma_tiles.cuh).

#include "paged_split.cuh"

#include <algorithm>

using namespace mma_tiles;
using namespace paged_split;

namespace {

constexpr int WIN = 16;       // window columns of the new-column part (W <= WIN)
constexpr int PAD = 8;        // row padding (elements) against bank conflicts
constexpr int MAX_WARPS = 5;  // 16-row tiles per block: W * rep <= 80

// Shared-memory layout, shared by the host launcher and the kernel: the tile
// the warps read, as T (ks, vs at the start; cp.async fills it directly for
// pools of the query dtype), for int8 pools the raw rows that convert into
// it, and the tile's mask, page ids and scales. The merge reuses the start.
struct Layout {
  size_t raw_k, raw_v, meta, total;
  int ld;  // bytes a staged row
  __host__ __device__ Layout(int esz, int d, bool int8) {
    const size_t tile = align128((size_t)TP * (d + PAD) * esz);
    ld = int8 ? d + 16 : (d + PAD) * esz;
    const size_t raw = int8 ? align128((size_t)TP * ld) : 0;
    raw_k = 2 * tile;
    raw_v = raw_k + raw;
    meta = raw_v + raw;
    total = meta + TileSmem::meta_bytes();
  }
};

// Eight consecutive int8 pool elements (8-byte aligned) as floats.
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  int8x4_to_float(u.x, f);
  int8x4_to_float(u.y, f + 4);
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

  // This warp's part: o, and (m, l) of each of its rows below R.
  __device__ __forceinline__ void write_part(float* po, float* pml, int R) const {
    const int t = (threadIdx.x & 31) & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row_lo : row_hi;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(po + (size_t)row * D + j * 8 + 2 * t) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (t == 0) {
        pml[2 * row] = m_run[r];
        pml[2 * row + 1] = l_run[r];
      }
    }
  }
};

// T: query / output / value dtype; P: pool element (T, or int8_t with scales).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_window_kernel(const T* __restrict__ q, const P* __restrict__ pool_k, const P* __restrict__ pool_v,
                    const int* __restrict__ tables, const int* __restrict__ mask,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const float* __restrict__ ksc_pool, const float* __restrict__ vsc_pool,
                    T* __restrict__ out, float* __restrict__ ws_o, float* __restrict__ ws_ml,
                    int* __restrict__ counters, int W, int N, int KH, int page, int P_slot, int splits,
                    int gs, float scale) {
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int LD = D + PAD;
  constexpr int CH = D * (int)sizeof(T) / 16;  // 16-byte chunks of a T row
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(sizeof(T), D, INT8);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + TP * LD;

  const int b = blockIdx.x, kvh = blockIdx.y, z = blockIdx.z;
  const int rep = N / KH, R = W * rep, S = P_slot * page, bk = b * KH + kvh;
  const Parts ws{ws_o, ws_ml, splits + 1, R};
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // One warp per 16 block rows: blockDim.x = 32 * ceil(R / 16).
  WinTile<T, D> tile;
  tile.load(q, b, kvh, (tid >> 5) * 16, R, W, N, rep);

  if (z == splits) {
    // The window's W rows as their own part, slot-causal.
    for (int i = tid; i < WIN * CH; i += nthreads) {
      const int r = i / CH, c = i % CH;
      const bool valid = r < W;
      const size_t off = valid ? (((size_t)b * W + r) * KH + kvh) * D : 0;
      cp_async16_zfill(reinterpret_cast<unsigned char*>(ks + r * LD) + c * 16,
                       reinterpret_cast<const unsigned char*>(k_new + off) + c * 16, valid);
      cp_async16_zfill(reinterpret_cast<unsigned char*>(vs + r * LD) + c * 16,
                       reinterpret_cast<const unsigned char*>(v_new + off) + c * 16, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile.template attend<WIN / 8, true, false>(ks, vs, W, nullptr, nullptr, nullptr, rep, scale);
  } else {
    int* meta = reinterpret_cast<int*>(smem + L.meta);
    const TileSmem sm{INT8 ? smem + L.raw_k : smem, INT8 ? smem + L.raw_v : reinterpret_cast<unsigned char*>(vs),
                      L.ld, meta, meta + TP, reinterpret_cast<float*>(meta + 2 * TP),
                      reinterpret_cast<float*>(meta + 3 * TP)};
    const int* table = tables + (size_t)b * P_slot;
    const int* mrow = mask + (size_t)b * S;
    int s0, s1;
    split_range(S, splits, z, s0, s1);
    walk<P, D>(sm, pool_k, pool_v, ksc_pool, vsc_pool, table, mrow, S, s0, s1, KH, kvh, page, [&](int n_pos) {
      if (INT8) {  // raw int8 rows -> T rows, exact
        for (int i = tid; i < TP * (D / 8); i += nthreads) {
          const int r = i / (D / 8), c = (i % (D / 8)) * 8;
          float f[8];
          load8(reinterpret_cast<const int8_t*>(sm.k + r * sm.ld) + c, f);
          store8(ks + r * LD + c, f);
          load8(reinterpret_cast<const int8_t*>(sm.v + r * sm.ld) + c, f);
          store8(vs + r * LD + c, f);
        }
        __syncthreads();
      }
      tile.template attend<TP / 8, false, INT8>(ks, vs, n_pos, sm.mk, sm.kss, sm.vss, rep, scale);
    });
  }

  tile.write_part(ws.o_of(bk, z, D), ws.ml_of(bk, z), R);
  if (!last_ticket(counters + bk, splits + 1)) return;
  merge_parts<T, D, D / 8>(ws, bk, out, b, kvh, W, N, rep, gs, smem);
}

// Launch one call, or with `blocks` set only report the blocks an SM holds
// (split_plan's wave on the host).
template <typename T, typename P, int D>
int launch(const void* q, const void* pk, const void* pv, const void* tables, const void* mask, const void* kn,
           const void* vn, const void* ksc, const void* vsc, void* out, void* ws_o, void* ws_ml, void* counters,
           int B, int W, int N, int KH, int page, int P_slot, int splits, float scale, int dev,
           cudaStream_t stream, int* blocks) {
  static InstanceState st = {};
  const auto kernel = paged_window_kernel<T, P, D>;
  const int R = W * (N / KH), warps = (R + 15) / 16, parts = splits + 1;
  if (warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const size_t walk = Layout(sizeof(T), D, sizeof(P) == 1).total;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(kernel, st, dev, warps, 32 * warps, walk, &per_sm);
  if (err != cudaSuccess || blocks != nullptr) {
    if (blocks != nullptr) *blocks = per_sm;
    return (int)err;
  }
  const int gs = stage_parts(parts, R, D, per_sm, dev);
  const size_t smem = std::max(walk, merge_smem(parts, R, D, gs));
  err = allow_smem(kernel, st, dev, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KH, parts);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk), static_cast<const P*>(pv),
      static_cast<const int*>(tables), static_cast<const int*>(mask), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<T*>(out), static_cast<float*>(ws_o), static_cast<float*>(ws_ml), static_cast<int*>(counters),
      W, N, KH, page, P_slot, splits, gs, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int by_dim(const void* q, const void* pk, const void* pv, const void* tables, const void* mask, const void* kn,
           const void* vn, const void* ksc, const void* vsc, void* out, void* ws_o, void* ws_ml, void* counters,
           int B, int W, int N, int KH, int D, int page, int P_slot, int splits, float scale, int dev,
           cudaStream_t st, int* blocks) {
  if (D == 64)
    return launch<T, P, 64>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, ws_o, ws_ml, counters, B, W, N, KH,
                            page, P_slot, splits, scale, dev, st, blocks);
  if (D == 128)
    return launch<T, P, 128>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, ws_o, ws_ml, counters, B, W, N, KH,
                             page, P_slot, splits, scale, dev, st, blocks);
  return (int)cudaErrorInvalidValue;
}

template <typename... A>
int by_dtype(int dtype, int int8_pool, A... a) {
  if (dtype == 1 && !int8_pool) return by_dim<bf16, bf16>(a...);
  if (dtype == 1 && int8_pool) return by_dim<bf16, int8_t>(a...);
  if (dtype == 0 && !int8_pool) return by_dim<float, float>(a...);
  if (dtype == 0 && int8_pool) return by_dim<float, int8_t>(a...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, out; and the pools unless
// int8_pool, when the pools are int8 and kscale / vscale are their
// (P_total, K, page) float32 scale pools). W: 1 .. 16 window positions with
// W * N / K <= 80 query rows per KV head. page: a power of two up to 64.
// splits: 1 .. MAX_SPLITS parts of the stored window. ws_o / ws_ml: float32
// workspaces of B * K * (splits + 1) * W * (N / K) * D and * 2 elements;
// counters: B * K int32, zero before the first launch and left zero by every
// launch. device: the CUDA device of the tensors. Returns a cudaError_t value
// (0 = launched).
extern "C" int paged_window_fwd(const void* q, const void* pool_k, const void* pool_v, const void* tables,
                                const void* mask, const void* k_new, const void* v_new, const void* kscale,
                                const void* vscale, void* out, void* ws_o, void* ws_ml, void* counters, int B, int W,
                                int N, int KH, int D, int page, int P_slot, int splits, float scale, int dtype,
                                int int8_pool, int device, void* stream) {
  if (B <= 0 || W <= 0 || W > WIN || KH <= 0 || N % KH != 0 || P_slot <= 0 || KH > 65535 || page <= 0 ||
      page > TP || (page & (page - 1)) != 0 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  return by_dtype(dtype, int8_pool, q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, ws_o, ws_ml,
                  counters, B, W, N, KH, D, page, P_slot, splits, scale, device, static_cast<cudaStream_t>(stream),
                  static_cast<int*>(nullptr));
}

// The blocks of one SM the instance for (W, N, K, D, dtype, int8_pool) holds
// on `device`, written to *blocks. Returns a cudaError_t value.
extern "C" int paged_window_blocks_per_sm(int W, int N, int KH, int D, int dtype, int int8_pool, int device,
                                          int* blocks) {
  if (W <= 0 || W > WIN || KH <= 0 || N % KH != 0 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  const void* none = nullptr;
  return by_dtype(dtype, int8_pool, none, none, none, none, none, none, none, none, none, (void*)nullptr,
                  (void*)nullptr, (void*)nullptr, (void*)nullptr, 1, W, N, KH, D, TP, 1, 1, 1.0f, device,
                  (cudaStream_t)nullptr, blocks);
}
