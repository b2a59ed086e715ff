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
//     The kernel reads the scales through the page table from the
//     (P_total, K, page) float32 scale pools; k_new / v_new arrive
//     dequant-roundtripped.
//
// The TPU kernel stages a slot's whole window and runs one softmax. Here the
// stored window is split across blocks (paged_split.cuh): each split runs an
// online softmax over its tiles and rounds its probabilities relative to its
// own running maximum; the parts are merged in a fixed order and normalised
// at the end. The function is the same; summation order and the rounding
// points of P differ by a per-row factor.
//
// Bound on this card: bytes. A decode tick reads every valid page of every
// slot once per layer and does 4 * D FLOP per (query row, position): at the
// serving shape (64 slots, 14 heads over 2 KV heads, D = 64, windows of 24
// pages of 16) about 10 MB against 0.04 GFLOP a launch, ~3.2 us at
// 3.35 TB/s. What held the one-block-per-(slot, KV head) design at 13x that
// bound was a serial chain, not bandwidth: 128 blocks on 132 SMs, each
// walking 6 tiles one after another with synchronous loads. Design: a
// (B, K, splits + 1) grid, splits from the shapes and the blocks an SM holds
// of the instance (ops/kernels/paged_attention.py::split_plan, the
// occupancy from paged_attention_blocks_per_sm: 3 parts of 2 tiles at the
// 0.5B serving shape, 6 of one tile with the 7B heads); a block reads its
// tile's mask and page ids in one round trip (the query rows' cp.async in
// flight beside it) and the valid pages' K / V rows by cp.async in the next
// (a page with no valid position is not read, a tile with none is skipped).
// Warp w owns 16 of the tile's positions: for Q.K each lane takes one
// position and half of D for every query row of the KV head, the halves
// summed by a shuffle, so a K row converts once; the block's running maximum
// comes from the warps' maxima through shared memory; for P.V each lane owns
// D / 32 columns over the warp's 16 positions, and the warps' sums meet in
// shared memory at the end of the split. The arithmetic runs on CUDA cores
// and is what a block mostly waits on once its pages have landed (the
// instructions, not the bytes). Block z == splits writes the new column's
// part (m = q.k_new * scale, l = 1, o = v_new in fp32); the block with the
// last ticket merges the parts.

#include "paged_split.cuh"

#include <algorithm>

using namespace mma_tiles;
using namespace paged_split;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

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
  int8x4_to_float(u.x, f);
  int8x4_to_float(u.y, f + 4);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// DPL consecutive pool elements (D / 32 per lane: 2 or 4) as floats.
template <int DPL>
__device__ __forceinline__ void load_cols(const bf16* p, float (&f)[DPL]) {
  if constexpr (DPL == 2) {
    const float2 v = unpack(*reinterpret_cast<const uint32_t*>(p));
    f[0] = v.x;
    f[1] = v.y;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = unpack(u.x), b = unpack(u.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
}
template <int DPL>
__device__ __forceinline__ void load_cols(const float* p, float (&f)[DPL]) {
#pragma unroll
  for (int e = 0; e < DPL; ++e) f[e] = p[e];
}
template <int DPL>
__device__ __forceinline__ void load_cols(const int8_t* p, float (&f)[DPL]) {
  if constexpr (DPL == 4) {
    int8x4_to_float(*reinterpret_cast<const uint32_t*>(p), f);
  } else {
#pragma unroll
    for (int e = 0; e < DPL; ++e) f[e] = (float)p[e];
  }
}

// Shared-memory layout, shared by the host launcher and the kernel: the
// staged tile (K, V rows of the pool dtype), the query rows raw and as
// floats, each warp's rounded probabilities, each warp's tile maxima, and
// the tile's mask, page ids and scales. The split's closing sum across warps
// and the merge reuse the start (the tile is no longer needed then).
struct Layout {
  size_t ks, vs, qraw, qf, pw, red, meta, total;
  int ld;  // staged row stride in bytes
  __host__ __device__ Layout(int esz, int pool_esz, int d, int rep, int rep_max) {
    ld = d * pool_esz + 16;
    ks = 0;
    vs = align128((size_t)TP * ld);
    qraw = vs + align128((size_t)TP * ld);
    qf = qraw + align128((size_t)rep * d * esz);
    pw = qf + align128((size_t)rep * d * sizeof(float));
    red = pw + align128((size_t)WARPS * rep_max * 16 * sizeof(float));
    meta = red + align128((size_t)WARPS * rep_max * sizeof(float));
    total = meta + TileSmem::meta_bytes();
  }
};

// T: query / output / value dtype; P: pool element (T, or int8_t with scales).
// REP: query rows a KV head, at most (instantiated for 4 and 8; 8 covers the
// 0.5B / 1.5B / 7B decoders' 7, 6 and 7).
template <typename T, typename P, int D, int REP>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pool_k, const P* __restrict__ pool_v,
                    const int* __restrict__ tables, const int* __restrict__ mask,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const float* __restrict__ ksc_pool, const float* __restrict__ vsc_pool,
                    T* __restrict__ out, float* __restrict__ ws_o, float* __restrict__ ws_ml,
                    int* __restrict__ counters, int N, int KH, int page, int P_slot, int splits, int gs,
                    float scale) {
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int DPL = D / 32;  // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, z = blockIdx.z;
  const int rep = N / KH, S = P_slot * page, bk = b * KH + kvh;
  const Parts ws{ws_o, ws_ml, splits + 1, rep};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + ((size_t)b * N + (size_t)kvh * rep) * D;
  float* po = ws.o_of(bk, z, D);
  float* pml = ws.ml_of(bk, z);

  if (z == splits) {
    // The new token's column as its own part: its share stays fp32.
    const size_t nb = ((size_t)b * KH + kvh) * D + lane * DPL;
    float kn[DPL], vn[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      kn[e] = to_f(k_new[nb + e]);
      vn[e] = to_f(v_new[nb + e]);
    }
    for (int r = warp; r < rep; r += WARPS) {
      float part = 0.0f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) part = fmaf(to_f(qb[r * D + lane * DPL + e]), kn[e], part);
      const float l_new = warp_sum(part) * scale;
#pragma unroll
      for (int e = 0; e < DPL; ++e) po[r * D + lane * DPL + e] = vn[e];
      if (lane == 0) {
        pml[2 * r] = l_new;
        pml[2 * r + 1] = 1.0f;
      }
    }
  } else {
    const Layout L(sizeof(T), sizeof(P), D, rep, REP);
    T* qraw = reinterpret_cast<T*>(smem + L.qraw);
    float* qf = reinterpret_cast<float*>(smem + L.qf);
    float* pw = reinterpret_cast<float*>(smem + L.pw) + warp * REP * 16;
    float* red = reinterpret_cast<float*>(smem + L.red);
    int* meta = reinterpret_cast<int*>(smem + L.meta);
    const TileSmem sm{smem + L.ks, smem + L.vs, L.ld, meta, meta + TP,
                      reinterpret_cast<float*>(meta + 2 * TP), reinterpret_cast<float*>(meta + 3 * TP)};
    const int* table = tables + (size_t)b * P_slot;
    const int* mrow = mask + (size_t)b * S;

    // This KV head's rep query rows, by cp.async in flight beside the first tile's mask.
    for (int i = tid; i < rep * D * (int)sizeof(T) / 16; i += THREADS)
      cp_async16(reinterpret_cast<unsigned char*>(qraw) + i * 16, reinterpret_cast<const unsigned char*>(qb) + i * 16);
    cp_async_commit();

    // Warp w owns tile positions 16 w .. 16 w + 15: lane (pl, half) takes
    // position 16 w + pl and half of D for Q.K, and D / 32 columns for P.V.
    // The running maximum is the block's (every thread holds it); l and o
    // are this warp's, summed across warps at the end.
    const int pl = lane & 15, half = lane >> 4, s = 16 * warp + pl;
    float m_run[REP], l_run[REP], o[REP][DPL];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      m_run[r] = -INFINITY;
      l_run[r] = 0.0f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[r][e] = 0.0f;
    }

    bool q_ready = false;
    int s0, s1;
    split_range(S, splits, z, s0, s1);
    walk<P, D>(sm, pool_k, pool_v, ksc_pool, vsc_pool, table, mrow, S, s0, s1, KH, kvh, page, [&](int n_pos) {
      if (!q_ready) {  // the query rows as floats, once
        for (int i = tid; i < rep * D; i += THREADS) qf[i] = to_f(qraw[i]);
        __syncthreads();
        q_ready = true;
      }

      // Q.K over this lane's half of D, then the halves summed
      float x[REP];  // Q.K, then the logits
#pragma unroll
      for (int r = 0; r < REP; ++r) x[r] = 0.0f;
      const P* krow = reinterpret_cast<const P*>(sm.k + (size_t)s * L.ld) + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        float kf[8];
        load8(krow + c, kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          if (r >= rep) break;
          float qv[8];
          load8(qf + r * D + half * (D / 2) + c, qv);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[r] = fmaf(qv[e], kf[e], x[r]);
        }
      }
      const bool in_tile = s < n_pos, valid = in_tile && sm.mk[s] != 0;
      const float kscl = INT8 && in_tile ? sm.kss[s] : 1.0f;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float dot = x[r] + __shfl_xor_sync(0xffffffffu, x[r], 16);
        x[r] = in_tile ? (valid ? dot * scale * kscl : MASKED) : -INFINITY;
        float mx = x[r];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        if (lane == 0 && r < rep) red[warp * REP + r] = mx;
      }
      __syncthreads();

      // online softmax: the block's tile maximum, rounded probabilities of this warp's positions
      const float vscl = INT8 && in_tile ? sm.vss[s] : 0.0f;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r >= rep) break;
        float m_new = m_run[r];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) m_new = fmaxf(m_new, red[w * REP + r]);
        const float alpha = expf(m_run[r] - m_new);
        m_run[r] = m_new;
        const float p = expf(x[r] - m_new);
        l_run[r] = l_run[r] * alpha + (half == 0 ? p : 0.0f);
#pragma unroll
        for (int e = 0; e < DPL; ++e) o[r][e] *= alpha;
        if (half == 0) pw[r * 16 + pl] = round_to<T>(INT8 ? p * vscl : p);
      }
      __syncwarp();

      // P.V over this warp's 16 positions: lane owns columns lane * DPL .. + DPL
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        float2 p2[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r)
          if (r < rep) p2[r] = *reinterpret_cast<const float2*>(pw + r * 16 + j);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const P* vrow = reinterpret_cast<const P*>(sm.v + (size_t)(16 * warp + j + jj) * L.ld) + lane * DPL;
          float vf[DPL];
          load_cols<DPL>(vrow, vf);
#pragma unroll
          for (int r = 0; r < REP; ++r) {
            if (r >= rep) break;
            const float pv = jj == 0 ? p2[r].x : p2[r].y;
#pragma unroll
            for (int e = 0; e < DPL; ++e) o[r][e] = fmaf(pv, vf[e], o[r][e]);
          }
        }
      }
    });
    cp_async_wait<0>();  // the query rows, when no tile was staged

    // this split's part (neutral when no tile held a valid position): the
    // warps' l and o summed in warp order through shared memory (the tile's)
    float* red_o = reinterpret_cast<float*>(smem);
    float* red_l = red_o + WARPS * REP * D;
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
#pragma unroll
      for (int e = 0; e < DPL; ++e) red_o[(warp * REP + r) * D + lane * DPL + e] = o[r][e];
      const float l = warp_sum(l_run[r]);
      if (lane == 0) red_l[warp * REP + r] = l;
    }
    __syncthreads();
    for (int i = tid; i < rep * D; i += THREADS) {
      const int r = i / D;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red_o[(w * REP + r) * D + i % D];
      po[i] = sum;
    }
    // Every thread holds each row's m; thread r writes row r's (m, l).
#pragma unroll
    for (int r = 0; r < REP; ++r)
      if (tid == r && r < rep) {
        float l = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) l += red_l[w * REP + r];
        pml[2 * r] = m_run[r];
        pml[2 * r + 1] = l;
      }
  }

  if (!last_ticket(counters + bk, splits + 1)) return;
  merge_parts<T, D, (D + 63) / 64>(ws, bk, out, b, kvh, 1, N, rep, gs, smem);
}

// Launch one call, or with `blocks` set only report the blocks an SM holds
// (split_plan's wave on the host).
template <typename T, typename P, int D, int REP>
int launch(const void* q, const void* pk, const void* pv, const void* tables, const void* mask, const void* kn,
           const void* vn, const void* ksc, const void* vsc, void* out, void* ws_o, void* ws_ml, void* counters,
           int B, int N, int KH, int page, int P_slot, int splits, float scale, int dev, cudaStream_t stream,
           int* blocks) {
  static InstanceState st = {};
  const auto kernel = paged_decode_kernel<T, P, D, REP>;
  const int rep = N / KH, parts = splits + 1;
  const size_t walk = Layout(sizeof(T), sizeof(P), D, rep, REP).total;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(kernel, st, dev, rep, THREADS, walk, &per_sm);
  if (err != cudaSuccess || blocks != nullptr) {
    if (blocks != nullptr) *blocks = per_sm;
    return (int)err;
  }
  const int gs = stage_parts(parts, rep, D, per_sm, dev);
  const size_t smem = std::max(walk, merge_smem(parts, rep, D, gs));
  err = allow_smem(kernel, st, dev, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KH, parts);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pk), static_cast<const P*>(pv),
      static_cast<const int*>(tables), static_cast<const int*>(mask), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<T*>(out), static_cast<float*>(ws_o), static_cast<float*>(ws_ml), static_cast<int*>(counters),
      N, KH, page, P_slot, splits, gs, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename P, int D>
int by_rep(const void* q, const void* pk, const void* pv, const void* tables, const void* mask, const void* kn,
           const void* vn, const void* ksc, const void* vsc, void* out, void* ws_o, void* ws_ml, void* counters,
           int B, int N, int KH, int page, int P_slot, int splits, float scale, int dev, cudaStream_t st,
           int* blocks) {
  const int rep = N / KH;
  if (rep <= 4)
    return launch<T, P, D, 4>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, ws_o, ws_ml, counters, B, N, KH,
                              page, P_slot, splits, scale, dev, st, blocks);
  if (rep <= 8)
    return launch<T, P, D, 8>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, ws_o, ws_ml, counters, B, N, KH,
                              page, P_slot, splits, scale, dev, st, blocks);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename P>
int by_dim(const void* q, const void* pk, const void* pv, const void* tables, const void* mask, const void* kn,
           const void* vn, const void* ksc, const void* vsc, void* out, void* ws_o, void* ws_ml, void* counters,
           int B, int N, int KH, int D, int page, int P_slot, int splits, float scale, int dev, cudaStream_t st,
           int* blocks) {
  if (D == 64)
    return by_rep<T, P, 64>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, ws_o, ws_ml, counters, B, N, KH, page,
                            P_slot, splits, scale, dev, st, blocks);
  if (D == 128)
    return by_rep<T, P, 128>(q, pk, pv, tables, mask, kn, vn, ksc, vsc, out, ws_o, ws_ml, counters, B, N, KH, page,
                             P_slot, splits, scale, dev, st, blocks);
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
// (P_total, K, page) float32 scale pools). page: a power of two up to 64.
// splits: 1 .. MAX_SPLITS parts of the stored window. ws_o / ws_ml: float32
// workspaces of B * K * (splits + 1) * (N / K) * D and * 2 elements;
// counters: B * K int32, zero before the first launch and left zero by every
// launch. device: the CUDA device of the tensors. Returns a cudaError_t value
// (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* pool_k, const void* pool_v, const void* tables,
                                   const void* mask, const void* k_new, const void* v_new, const void* kscale,
                                   const void* vscale, void* out, void* ws_o, void* ws_ml, void* counters, int B,
                                   int N, int KH, int D, int page, int P_slot, int splits, float scale, int dtype,
                                   int int8_pool, int device, void* stream) {
  if (B <= 0 || KH <= 0 || N % KH != 0 || P_slot <= 0 || KH > 65535 || page <= 0 || page > TP ||
      (page & (page - 1)) != 0 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  return by_dtype(dtype, int8_pool, q, pool_k, pool_v, tables, mask, k_new, v_new, kscale, vscale, out, ws_o, ws_ml,
                  counters, B, N, KH, D, page, P_slot, splits, scale, device, static_cast<cudaStream_t>(stream),
                  static_cast<int*>(nullptr));
}

// The blocks of one SM the instance for (N, K, D, dtype, int8_pool) holds on
// `device`, written to *blocks. Returns a cudaError_t value.
extern "C" int paged_attention_blocks_per_sm(int N, int KH, int D, int dtype, int int8_pool, int device,
                                             int* blocks) {
  if (KH <= 0 || N % KH != 0 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  const void* none = nullptr;
  return by_dtype(dtype, int8_pool, none, none, none, none, none, none, none, none, none, (void*)nullptr,
                  (void*)nullptr, (void*)nullptr, (void*)nullptr, 1, N, KH, D, TP, 1, 1, 1.0f, device,
                  (cudaStream_t)nullptr, blocks);
}
