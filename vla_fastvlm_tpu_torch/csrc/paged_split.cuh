// The split walk and in-launch merge shared by the two paged-attention kernels
// (paged_attention.cu at W = 1, paged_window.cu at W > 1), sm_90a.
//
// Both kernels run on a (B, K, splits + 1) grid. Block (b, kvh, z < splits)
// walks its share of slot b's stored window: tiles of TP = 64 positions,
// ceil(tiles / splits) of them a split, the first split starting at 0
// (split_range; the host's ops/kernels/paged_attention.py::split_plan picks
// `splits` from the shapes and the blocks an SM holds of the instance, which
// blocks_per_sm reads from the occupancy calculator once per device and
// stage_parts keeps through the merge). Block z == splits attends the new
// column(s), k_new / v_new, so they form one more partial. Each block writes
// its fp32 partial for the KV head's R query rows -- the maximum m of its
// logits, the sum l of exp(logit - m) and the unnormalised o = sum of
// round(p) . V -- to a workspace, then takes a ticket on the (slot, KV head)
// counter. The block that takes the last ticket merges all parts in part
// order (deterministic whatever order the blocks ran in), normalises,
// stores, and sets the counter back to 0, so the counters need no launch to
// zero them and a CUDA graph can replay the kernel.
//
// A split whose positions are all masked reads no page and writes the
// neutral part m = -inf, l = 0, o = 0. The merge takes M as the maximum over
// all parts, the new columns' part included, which is finite (a new column
// is always valid for its row), so a neutral part gets weight exp(-inf) = 0;
// masked logits (-1e30, finite) inside a tile that holds a valid position
// get exp(-1e30 - m) = 0 in their own part.

#pragma once

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace paged_split {

using namespace mma_tiles;

constexpr int TP = 64;           // window positions a tile (whole pages)
constexpr int MAX_SPLITS = 32;   // stored-window parts a (slot, KV head); one more for the new columns
constexpr float MASKED = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Positions [s0, s1) of split z: ceil(tiles / splits) whole tiles a split.
__device__ __forceinline__ void split_range(int S, int splits, int z, int& s0, int& s1) {
  const int tiles = (S + TP - 1) / TP;
  const int per = (tiles + splits - 1) / splits;
  s0 = min(S, z * per * TP);
  s1 = min(S, (z + 1) * per * TP);
}

// One staged tile in shared memory: K and V rows of the pool dtype, `ld`
// bytes apart (a multiple of 16); the tile's mask, its pages' physical ids
// (-1 for a page with no valid position: not read, its rows zero) and, for
// int8 pools, the positions' K and V scales (0 where not read).
struct TileSmem {
  unsigned char* k;
  unsigned char* v;
  int ld;
  int* mk;     // TP
  int* pid;    // TP (pages a tile <= TP)
  float* kss;  // TP
  float* vss;  // TP

  // Bytes of the mask, page ids and scales after the K / V rows.
  __host__ __device__ static constexpr size_t meta_bytes() { return 4 * TP * sizeof(int); }
};

// Stage positions [t0, t0 + n) of a slot's window for KV head kvh:
// one round trip for the mask and the tile's table entries, then the valid
// pages' K / V rows by cp.async (committed as one group, not waited for) and
// the int8 scales through the page table. Returns false, block-uniformly and
// with nothing staged, when no position of the tile is valid.
template <typename P, int D>
__device__ __forceinline__ bool stage_tile(const TileSmem& sm, const P* __restrict__ pool_k,
                                           const P* __restrict__ pool_v, const float* __restrict__ ksc_pool,
                                           const float* __restrict__ vsc_pool, const int* __restrict__ table,
                                           const int* __restrict__ mrow, int t0, int n, int KH, int kvh,
                                           int page) {
  constexpr bool INT8 = sizeof(P) == 1;
  constexpr int CH = D * (int)sizeof(P) / 16;  // 16-byte chunks a row
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ppt = TP / page;  // page <= TP, both powers of two; t0 and n are multiples of page
  for (int i = tid; i < TP; i += nthreads) sm.mk[i] = i < n ? mrow[t0 + i] : 0;
  for (int pp = tid; pp < ppt; pp += nthreads) sm.pid[pp] = pp * page < n ? table[t0 / page + pp] : -1;
  __syncthreads();
  int any = 0;
  for (int pp = tid; pp < ppt; pp += nthreads) {
    int valid = 0;
    for (int i = pp * page; i < (pp + 1) * page && i < n; ++i) valid |= sm.mk[i] != 0;
    if (!valid) sm.pid[pp] = -1;
    any |= valid;
  }
  if (!__syncthreads_or(any)) return false;
  for (int i = tid; i < TP * CH; i += nthreads) {
    const int r = i / CH, c = i % CH;
    const int pg = r < n ? sm.pid[r / page] : -1;
    const size_t off = pg >= 0 ? (((size_t)pg * KH + kvh) * page + r % page) * D : 0;
    cp_async16_zfill(sm.k + r * sm.ld + c * 16, reinterpret_cast<const unsigned char*>(pool_k + off) + c * 16,
                     pg >= 0);
    cp_async16_zfill(sm.v + r * sm.ld + c * 16, reinterpret_cast<const unsigned char*>(pool_v + off) + c * 16,
                     pg >= 0);
  }
  cp_async_commit();
  if (INT8) {
    for (int i = tid; i < TP; i += nthreads) {
      const int pg = i < n ? sm.pid[i / page] : -1;
      const size_t off = ((size_t)pg * KH + kvh) * page + i % page;
      sm.kss[i] = pg >= 0 ? ksc_pool[off] : 0.0f;
      sm.vss[i] = pg >= 0 ? vsc_pool[off] : 0.0f;
    }
  }
  return true;
}

// Four int8 values packed in a word, as floats, exactly: each byte, biased
// to unsigned, becomes the low mantissa byte of 2^23 + u, and 2^23 + 128 is
// taken off (a byte permute and an add each, instead of an int-to-float
// convert, which the SM issues at a quarter of the rate).
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | k)) - 8388736.0f;
}

// Walk positions [s0, s1) of a slot's window for KV head kvh a tile at a
// time: stage it, skip it when no position is valid, wait for its pages and
// call compute(tile, n_pos) between barriers. Earlier cp.async groups (the
// query rows) complete before the first compute.
template <typename P, int D, typename Compute>
__device__ __forceinline__ void walk(const TileSmem& sm, const P* __restrict__ pool_k, const P* __restrict__ pool_v,
                                     const float* __restrict__ ksc_pool, const float* __restrict__ vsc_pool,
                                     const int* __restrict__ table, const int* __restrict__ mrow, int S, int s0,
                                     int s1, int KH, int kvh, int page, Compute&& compute) {
  for (int t0 = s0; t0 < s1; t0 += TP) {
    const int n_pos = min(TP, S - t0);
    if (!stage_tile<P, D>(sm, pool_k, pool_v, ksc_pool, vsc_pool, table, mrow, t0, n_pos, KH, kvh, page))
      continue;  // nothing valid in this tile
    cp_async_wait<0>();
    __syncthreads();
    compute(n_pos);
    __syncthreads();  // before the next tile overwrites the staged pages and the mask
  }
}

// The fp32 parts of every (slot, KV head): o (parts, R, D), then (m, l) (parts, R, 2).
struct Parts {
  float* o;
  float* ml;
  int parts, R;

  __device__ __forceinline__ float* o_of(int bk, int p, int D) const {
    return o + ((size_t)bk * parts + p) * R * D;
  }
  __device__ __forceinline__ float* ml_of(int bk, int p) const { return ml + ((size_t)bk * parts + p) * R * 2; }
};

// After each thread has written its share of a part: take a ticket on the
// (slot, KV head) counter. True, block-uniformly, in the block that takes
// the last one, which also sets the counter back to 0 (every part has taken
// its ticket by then).
__device__ __forceinline__ bool last_ticket(int* counter, int parts) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // cumulative: the block's part, ordered by the barrier, is visible before the ticket
    const int ticket = atomicAdd(counter, 1);
    last = ticket == parts - 1;
    if (last) {
      *counter = 0;
      __threadfence();  // the other parts' writes are read after their tickets
    }
  }
  __syncthreads();
  return last;
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <>
__device__ __forceinline__ void store4<bf16>(bf16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack<bf16>(v.x, v.y), pack<bf16>(v.z, v.w));
}

// Shared memory of the merge: each part's (m -> weight) and l, each row's
// 1 / L and output offset, then a stage for the parts' o, `gs` parts at a
// time (stage_parts picks gs on the host).
constexpr size_t MERGE_STAGE_BYTES = 72 * 1024;

__host__ __device__ inline size_t merge_bytes(int parts, int R) {
  return align128((size_t)(2 * parts + 2) * R * sizeof(float));
}
__host__ __device__ inline size_t merge_smem(int parts, int R, int D, int gs) {
  return merge_bytes(parts, R) + (size_t)gs * R * D * sizeof(float);
}

// The last block of (slot b, KV head kvh): merge its parts in part order and
// store out = O / L for the KV head's R = W * rep rows (row i = w * rep + r is
// query head kvh * rep + r at window position w; out is (B, W, N, D)).
// `sm` holds merge_smem(parts, R, D, gs) bytes. E: 4-column chunks a thread,
// at least ceil(R * D / 4 / blockDim.x). The first batch of gs parts' o is in
// flight by cp.async beside the one round trip for every (m, l); each
// further batch takes one more.
template <typename T, int D, int E>
__device__ __forceinline__ void merge_parts(const Parts& ws, int bk, T* __restrict__ out, int b, int kvh, int W,
                                            int N, int rep, int gs, unsigned char* sm) {
  constexpr int C4 = D / 4;
  const int tid = threadIdx.x, nthreads = blockDim.x, R = ws.R, parts = ws.parts, PR = parts * R;
  float* wm = reinterpret_cast<float*>(sm);  // (parts, R): m, then the part's weight
  float* wl = wm + PR;                       // (parts, R): l
  float* winv = wl + PR;                     // (R,): 1 / L
  int* rowoff = reinterpret_cast<int*>(winv + R);  // (R,): offset of the row in out
  float4* stage = reinterpret_cast<float4*>(sm + merge_bytes(parts, R));
  auto issue = [&](int p0) {
    const int chunks = min(gs, parts - p0) * R * C4;
    const float4* src = reinterpret_cast<const float4*>(ws.o_of(bk, p0, D));
    for (int i = tid; i < chunks; i += nthreads) cp_async16(stage + i, src + i);
    cp_async_commit();
  };
  // every part's (m, l) (issued first: the weights wait on them), the first
  // batch of o, then each row's maximum, weights and 1 / L
  const float2* ml = reinterpret_cast<const float2*>(ws.ml_of(bk, 0));
  for (int base = 0; base < PR; base += 4 * nthreads) {
    float2 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = base + tid + k * nthreads;
      if (idx < PR) v[k] = __ldcg(ml + idx);
    }
    if (base == 0) issue(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = base + tid + k * nthreads;
      if (idx < PR) {
        wm[idx] = v[k].x;
        wl[idx] = v[k].y;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < R; r += nthreads) {
    float m_max = -INFINITY;
    for (int p = 0; p < parts; ++p) m_max = fmaxf(m_max, wm[p * R + r]);
    float l = 0.0f;
    for (int p = 0; p < parts; ++p) {
      const float w = expf(wm[p * R + r] - m_max);
      wm[p * R + r] = w;
      l = fmaf(w, wl[p * R + r], l);
    }
    winv[r] = 1.0f / l;
    rowoff[r] = ((b * W + r / rep) * N + kvh * rep + r % rep) * D;
  }
  // O, parts in order
  float4 acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int p0 = 0; p0 < parts; p0 += gs) {
    cp_async_wait<0>();
    __syncthreads();  // the batch is staged (and, the first time, the weights are set)
    const int n = min(gs, parts - p0);
    for (int g = 0; g < n; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = tid + e * nthreads;
        if (i < R * C4) {
          const float4 v = stage[g * R * C4 + i];
          const float w = wm[(p0 + g) * R + i / C4];
          acc[e].x = fmaf(w, v.x, acc[e].x);
          acc[e].y = fmaf(w, v.y, acc[e].y);
          acc[e].z = fmaf(w, v.z, acc[e].z);
          acc[e].w = fmaf(w, v.w, acc[e].w);
        }
      }
    }
    if (p0 + gs < parts) {
      __syncthreads();  // every thread is done with the stage
      issue(p0 + gs);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = tid + e * nthreads;
    if (i < R * C4) {
      const int r = i / C4, c = (i % C4) * 4;
      const float inv = winv[r];
      T* dst = out + rowoff[r] + c;
      store4<T>(dst, make_float4(acc[e].x * inv, acc[e].y * inv, acc[e].z * inv, acc[e].w * inv));
    }
  }
}

// Host side. Per device: the shared memory a block may opt in to, an SM's
// shared memory and what the runtime reserves a block, read once.
constexpr int MAX_DEVICES = 64;

struct DeviceSmem {
  int optin, per_sm, reserved;
};

inline const DeviceSmem* device_smem(int dev) {
  static DeviceSmem cached[MAX_DEVICES] = {};
  if (dev < 0 || dev >= MAX_DEVICES) return nullptr;
  DeviceSmem& c = cached[dev];
  if (c.optin == 0) {
    cudaDeviceGetAttribute(&c.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&c.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return &c;
}

// Per kernel instance and device: the dynamic shared memory the instance was
// last allowed (a launch calls cudaFuncSetAttribute only when it needs more),
// and the blocks an SM holds for each launch variant (the decode kernel's
// query rows a KV head, the window kernel's warps).
constexpr int MAX_VARIANTS = 16;

struct InstanceState {
  size_t allowed[MAX_DEVICES];
  int blocks[MAX_DEVICES][MAX_VARIANTS];
};

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, InstanceState& st, int dev, size_t bytes) {
  const DeviceSmem* ds = device_smem(dev);
  if (ds == nullptr || bytes > (size_t)ds->optin) return cudaErrorInvalidValue;
  if (st.allowed[dev] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) st.allowed[dev] = bytes;
  return err;
}

// Blocks of `kernel` an SM holds at `threads` threads and `walk` bytes of
// dynamic shared memory (the split walk's), as the runtime's occupancy
// calculator reports from the instance's registers and shared memory; read
// once per device and variant.
template <typename Kernel>
inline cudaError_t blocks_per_sm(Kernel kernel, InstanceState& st, int dev, int variant, int threads, size_t walk,
                                 int* blocks) {
  if (dev < 0 || dev >= MAX_DEVICES || variant < 0 || variant >= MAX_VARIANTS) return cudaErrorInvalidValue;
  int& cached = st.blocks[dev][variant];
  if (cached == 0) {
    cudaError_t err = allow_smem(kernel, st, dev, walk);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, walk);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    cached = n;
  }
  *blocks = cached;
  return cudaSuccess;
}

// Parts of o the merge stages at a time: as many as fit, beside the merge's
// weights, in each of `blocks` blocks' share of an SM's shared memory (so
// the merge's stage never lowers the occupancy the walk has), at most
// MERGE_STAGE_BYTES' worth, at least one.
inline int stage_parts(int parts, int R, int D, int blocks, int dev) {
  const DeviceSmem* ds = device_smem(dev);
  long long budget = (long long)ds->per_sm / blocks - ds->reserved - (long long)merge_bytes(parts, R);
  if (budget > (long long)MERGE_STAGE_BYTES) budget = MERGE_STAGE_BYTES;
  const long long fit = budget / ((long long)R * D * sizeof(float));
  return fit < 1 ? 1 : fit < parts ? (int)fit : parts;
}

}  // namespace paged_split
