// Paged-KV decode attention (one new token per slot), forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vla_fastvlm_tpu/ops/pallas/paged_attention.py
// at W = 1 (paged_attention_decode -> paged_attention_window ->
// _paged_attn_kernel / _paged_attn_kernel_int8 -> _attend_last_page). Same function:
//   q (B, N, D) x pools (P_total, K, page, D) through tables (B, P_slot)
//   -> out (B, N, D), query head h reading KV head h / (N / K);
//   - stored position s of slot b (logical s = p * page + i lives at
//     pool[tables[b, p], kv, i]) is valid where mask[b, s] != 0; masked
//     logits are -1e30 (finite);
//   - the current token's k_new / v_new (B, K, D) join the softmax as one
//     extra column that is always valid, so the pools are only read;
//   - fp32 logits and softmax; stored-column probabilities are rounded to the
//     value dtype before P.V (the pool's dtype, or the query dtype for int8
//     pools); the new column's share stays fp32;
//   - int8 pools: pages convert int8 -> float exactly; the per-(position, KV
//     head) K scales multiply the scores and the V scales the probabilities.
//     The scale windows (B, K, S_max) are gathered outside the kernel, as in
//     the Pallas launcher, and k_new / v_new arrive dequant-roundtripped.
//
// The TPU kernel stages a slot's whole window and runs one softmax; this one
// walks the window in tiles with an online softmax, so the probabilities are
// rounded relative to the running maximum and normalized at the end. The
// function is the same; summation order and the rounding points of P differ
// by a per-row factor.
//
// Bound on this card: bytes. A decode tick reads every valid page of every
// slot once per layer and does 4 * D FLOP per (query row, position): at the
// serving shape (64 slots, 14 heads over 2 KV heads, D = 64, windows of 24
// pages of 16) that is about 10 MB against 0.04 GFLOP a launch, ~3 us at
// 3.35 TB/s. Design: one block of 4 warps per (slot, KV head), 128 blocks at
// that shape against 132 SMs. The block reads its own page ids from the table
// (the TPU's scalar prefetch) and walks the window 64 positions at a time:
// the tile's K/V pages are staged in shared memory (a page whose mask is all
// 0 is not read, a tile with no valid position is skipped), each warp takes
// query rows warp, warp + 4, ... of the KV head's rep rows with one position
// per lane for Q.K and one slice of D per lane for P.V. Nothing is pipelined
// and S is not split across blocks; both are later work.

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

using namespace mma_tiles;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TP = 64;           // window positions per tile (whole pages)
constexpr int ROW_PAD = 16;      // bytes of padding per staged row against bank conflicts
constexpr float MASKED = -1e30f;

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Eight consecutive pool elements (16-byte aligned for bf16/fp32, 8 for int8) as floats.
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = unpack(w[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(int8_t)((u.x >> (8 * i)) & 0xff);
    f[4 + i] = (float)(int8_t)((u.y >> (8 * i)) & 0xff);
  }
}

__device__ __forceinline__ float elem(const bf16* p, int i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float elem(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float elem(const int8_t* p, int i) { return (float)p[i]; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout, shared by the host launcher and the kernel.
struct Layout {
  size_t ks, vs, qs, ps, mk, sc, total;
  int ld;  // staged row stride in bytes
  __host__ __device__ Layout(int pool_esz, int d, int rep, int rpw) {
    ld = d * pool_esz + ROW_PAD;
    ks = 0;
    vs = align16((size_t)TP * ld);
    qs = vs + align16((size_t)TP * ld);
    ps = qs + align16((size_t)rep * d * sizeof(float));
    mk = ps + align16((size_t)WARPS * rpw * TP * sizeof(float));
    sc = mk + align16((size_t)2 * TP * sizeof(int));          // mask, then page ids of the tile
    total = sc + align16((size_t)2 * TP * sizeof(float));      // K scales, V scales (int8 pools)
  }
};

// T: query / output / value dtype; P: pool element (T, or int8_t with scales).
// RPW: query rows per warp (rep <= 4 * RPW; instantiated for rep <= 8, which
// covers the 0.5B / 1.5B / 7B decoders' 7, 6 and 7).
template <typename T, typename P, int D, int RPW>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pool_k, const P* __restrict__ pool_v,
                    const int* __restrict__ tables, const int* __restrict__ mask,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const float* __restrict__ kscale, const float* __restrict__ vscale,
                    T* __restrict__ out, int N, int KH, int page, int P_slot, float scale) {
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int rep = N / KH;
  const int S = P_slot * page;
  const Layout L(sizeof(P), D, rep, RPW);
  unsigned char* ks = smem + L.ks;
  unsigned char* vs = smem + L.vs;
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  int* mk = reinterpret_cast<int*>(smem + L.mk);
  int* pid = mk + TP;  // physical page of each page of the tile, -1 when not read
  float* kss = reinterpret_cast<float*>(smem + L.sc);
  float* vss = kss + TP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* table = tables + (size_t)b * P_slot;
  const int* mrow = mask + (size_t)b * S;

  // This KV head's rep query rows, as floats.
  const T* qb = q + ((size_t)b * N + (size_t)kvh * rep) * D;
  for (int i = tid; i < rep * D; i += THREADS) qs[i] = to_f(qb[i]);

  float m_run[RPW], l_run[RPW], o[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[i][e] = 0.0f;
  }

  const int pages_per_tile = page < TP ? TP / page : 1;
  constexpr int CHUNK = 16 / sizeof(P) < 8 ? 16 / sizeof(P) : 8;  // elements per staging copy
  const int chunks_per_row = D / CHUNK;
  float* my_ps = ps + (size_t)warp * RPW * TP;

  for (int t0 = 0; t0 < S; t0 += TP) {
    const int n_pos = min(TP, S - t0);
    // 1. mask of the tile; which of its pages hold a valid position
    for (int i = tid; i < TP; i += THREADS) mk[i] = i < n_pos ? mrow[t0 + i] : 0;
    __syncthreads();
    int valid_page = 0;
    if (tid < pages_per_tile) {
      const int first = tid * page;
      for (int i = first; i < first + page && i < n_pos; ++i) valid_page |= mk[i] != 0;
      pid[tid] = valid_page ? table[(t0 + first) / page] : -1;
    }
    if (!__syncthreads_or(valid_page)) continue;  // nothing valid in this tile

    // 2. stage the valid pages' K/V rows (zeros for the others) and the scales
    for (int i = tid; i < TP * chunks_per_row; i += THREADS) {
      const int r = i / chunks_per_row, c = (i % chunks_per_row) * CHUNK;
      const int pg = pid[r / page];
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (r < n_pos && pg >= 0) {
        const size_t off = (((size_t)pg * KH + kvh) * page + (t0 + r) % page) * D + c;
        if (CHUNK * sizeof(P) == 16) {
          kv = *reinterpret_cast<const uint4*>(pool_k + off);
          vv = *reinterpret_cast<const uint4*>(pool_v + off);
        } else {  // int8: 8 bytes
          const uint2 k2 = *reinterpret_cast<const uint2*>(pool_k + off);
          const uint2 v2 = *reinterpret_cast<const uint2*>(pool_v + off);
          kv = make_uint4(k2.x, k2.y, 0u, 0u);
          vv = make_uint4(v2.x, v2.y, 0u, 0u);
        }
      }
      unsigned char* kd = ks + (size_t)r * L.ld + c * sizeof(P);
      unsigned char* vd = vs + (size_t)r * L.ld + c * sizeof(P);
      if (CHUNK * sizeof(P) == 16) {
        *reinterpret_cast<uint4*>(kd) = kv;
        *reinterpret_cast<uint4*>(vd) = vv;
      } else {
        *reinterpret_cast<uint2*>(kd) = make_uint2(kv.x, kv.y);
        *reinterpret_cast<uint2*>(vd) = make_uint2(vv.x, vv.y);
      }
    }
    if (INT8) {
      const size_t base = ((size_t)b * KH + kvh) * S + t0;
      for (int i = tid; i < TP; i += THREADS) {
        kss[i] = i < n_pos ? kscale[base + i] : 0.0f;
        vss[i] = i < n_pos ? vscale[base + i] : 0.0f;
      }
    }
    __syncthreads();

    // 3. logits of this warp's rows at positions lane and lane + 32
    float acc[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kf[2][8];
      load8(reinterpret_cast<const P*>(ks + (size_t)lane * L.ld) + d0, kf[0]);
      load8(reinterpret_cast<const P*>(ks + (size_t)(lane + 32) * L.ld) + d0, kf[1]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i;
        if (r >= rep) break;
        const float4 qa = *reinterpret_cast<const float4*>(qs + r * D + d0);
        const float4 qb4 = *reinterpret_cast<const float4*>(qs + r * D + d0 + 4);
        const float qf[8] = {qa.x, qa.y, qa.z, qa.w, qb4.x, qb4.y, qb4.z, qb4.w};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][j] = fmaf(qf[e], kf[j][e], acc[i][j]);
      }
    }

    // 4. online softmax per row; rounded probabilities to shared memory
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      if (r >= rep) break;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = lane + 32 * j;
        float v = acc[i][j] * scale;
        if (INT8) v *= kss[s];
        x[j] = s < n_pos ? (mk[s] != 0 ? v : MASKED) : -INFINITY;
      }
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(x[0], x[1])));
      const float alpha = expf(m_run[i] - m_new);
      float p[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) p[j] = expf(x[j] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p[0] + p[1]);
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = lane + 32 * j;
        const float pv = INT8 ? p[j] * vss[s] : p[j];
        my_ps[i * TP + s] = round_to<T>(pv);
      }
    }
    __syncwarp();

    // 5. P.V: lane owns columns lane * DPL .. + DPL
    for (int s = 0; s < n_pos; ++s) {
      const P* vrow = reinterpret_cast<const P*>(vs + (size_t)s * L.ld) + lane * DPL;
      float vf[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vf[e] = elem(vrow, e);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (warp + WARPS * i >= rep) break;
        const float pv = my_ps[i * TP + s];
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[i][e] = fmaf(pv, vf[e], o[i][e]);
      }
    }
    __syncthreads();  // before the next tile overwrites the staged pages and the mask
  }

  // 6. the new token's column, then normalize and store
  const size_t nb = ((size_t)b * KH + kvh) * D + lane * DPL;
  float kn[DPL], vn[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    kn[e] = to_f(k_new[nb + e]);
    vn[e] = to_f(v_new[nb + e]);
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    if (r >= rep) break;
    float part = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) part = fmaf(qs[r * D + lane * DPL + e], kn[e], part);
    const float l_new = warp_sum(part) * scale;
    const float m_fin = fmaxf(m_run[i], l_new);
    const float alpha = expf(m_run[i] - m_fin);
    const float p_new = expf(l_new - m_fin);
    const float inv = 1.0f / (l_run[i] * alpha + p_new);
    T* dst = out + ((size_t)b * N + (size_t)kvh * rep + r) * D + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) dst[e] = from_f<T>(o[i][e] * alpha * inv + (p_new * inv) * vn[e]);
  }
}

template <typename T, typename P, int D, int RPW>
int launch(const void* q, const void* pk, const void* pv, const void* tables, const void* mask,
           const void* kn, const void* vn, const void* ksc, const void* vsc, void* out, int B, int N,
           int KH, int page, int P_slot, float scale, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = Layout(sizeof(P), D, N / KH, RPW).total;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T, P, D, RPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KH);
  paged_decode_kernel<T, P, D, RPW><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk), static_cast<const P*>(pv),
      static_cast<const int*>(tables), static_cast<const int*>(mask), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<T*>(out), N, KH, page, P_slot, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int D>
int by_rep(const void* q, const void* pk, const void* pv, const void* tables, const void* mask,
           const void* kn, const void* vn, const void* ksc, const void* vsc, void* out, int B, int N,
           int KH, int page, int P_slot, float scale, cudaStream_t st) {
  const int rep = N / KH;
  if (rep <= WARPS) return launch<T, P, D, 1>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, B, N, KH, page, P_slot, scale, st);
  if (rep <= 2 * WARPS) return launch<T, P, D, 2>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, B, N, KH, page, P_slot, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename P>
int by_dim(const void* q, const void* pk, const void* pv, const void* tables, const void* mask,
           const void* kn, const void* vn, const void* ksc, const void* vsc, void* out, int B, int N,
           int KH, int D, int page, int P_slot, float scale, cudaStream_t st) {
  if (D == 64) return by_rep<T, P, 64>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, B, N, KH, page, P_slot, scale, st);
  if (D == 128) return by_rep<T, P, 128>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, B, N, KH, page, P_slot, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_new, v_new, out; and the pools unless
// int8_pool, when the pools are int8 and kscale / vscale are (B, K, P_slot *
// page) float32 windows). page: a power of two up to 64. Returns a cudaError_t
// value (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                                   const void* tables, const void* mask, const void* k_new,
                                   const void* v_new, const void* kscale, const void* vscale,
                                   void* out, int B, int N, int KH, int D, int page, int P_slot,
                                   float scale, int dtype, int int8_pool, void* stream) {
  if (B <= 0 || KH <= 0 || N % KH != 0 || P_slot <= 0 || KH > 65535 || page <= 0 || page > TP ||
      (page & (page - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && !int8_pool)
    return by_dim<bf16, bf16>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, N, KH, D, page, P_slot, scale, st);
  if (dtype == 1 && int8_pool)
    return by_dim<bf16, int8_t>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, N, KH, D, page, P_slot, scale, st);
  if (dtype == 0 && !int8_pool)
    return by_dim<float, float>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, N, KH, D, page, P_slot, scale, st);
  if (dtype == 0 && int8_pool)
    return by_dim<float, int8_t>(q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, B, N, KH, D, page, P_slot, scale, st);
  return (int)cudaErrorInvalidValue;
}
