// Masked GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vla_fastvlm_tpu/ops/pallas/flash_attention.py
// (flash_attention -> _flash_attention_forward -> _attn_kernel). Same function:
//   q (B, T, N, D) x k, v (B, S, K, D) -> out (B, T, N, D)
//   - GQA: query head h reads KV head h / (N / K);
//   - key-padding mask (B, S) int32 plus optional causal by absolute position;
//     masked logits are -1e30 (finite), so a row with no allowed key comes out
//     as the uniform average of V over all S keys, exactly as the plain
//     version gives it;
//   - fp32 logits and softmax; probabilities cast to the value dtype before
//     P.V, with fp32 accumulation.
//
// Bound on this card: at the decoder's prefill shapes (T = S = 80, D = 64 or
// 128, 7 query heads a KV head) the work is a few GFLOP against tens of MB of
// q and out, so it is bound by bytes: q read once, out written once, K and V
// of a (batch, KV head) read by a few blocks (mostly from L2), the (T, S)
// logits never written. The design cuts a block's chain of memory round
// trips to one load and one store, and its arithmetic to the keys a row can
// see; what is left waiting is the arithmetic (mma.sync, mask, exp: PERF.md
// gives the measured split):
//
// - Packed rows. The rows a (batch row, KV head) computes are its (query
//   position, query head) pairs, position-major: row r is position r / rep,
//   head kvh * rep + r % rep, for rep = N / K. In (B, T, N, D) a position's
//   rep heads lie next to each other, so a run of rows is a run of
//   contiguous slabs. A block takes `tiles` 16-row tiles of that sequence
//   and `warps` warps that run them in turn (`flash_plan` in
//   ops/kernels/flash_attention.py): every tile holds real rows, and K / V
//   are staged once per block for every head that reads them.
// - One round trip in. At its start a block issues its Q rows, K and V (rows
//   rounded up to 16 keys, not to a softmax block; zero past S) as 16-byte
//   cp.async copies and reads the mask beside them, then waits once. The A
//   operands come from shared memory by ldmatrix.
// - One round trip out. A warp writes its tile's output into the tile's own Q
//   rows of shared memory and copies them out as 16-byte rows.
// - Keys skipped whole 16 at a time, in the products and in the softmax:
//   past S; before the batch row's first allowed key and from its last one
//   on; and under causal masking past the tile's last position. Such keys are
//   masked for every row of the tile, and with a finite maximum their weight
//   is exactly 0. A tile holding a row with no allowed key at or before its
//   position (a fully padded batch row, the first positions under left
//   padding) visits all S keys instead, so those rows average V over all S.
//
// Each warp keeps its tile's logits, probabilities and output accumulator in
// registers (mma.sync m16n8k16 with the FlashAttention-2 register layout: the
// logits' accumulator fragments become the P.V A operand) and walks its keys
// in softmax blocks of KB keys with an online softmax in base 2.
//
// Two instances of that walk:
// - resident (K and V of one (batch, KV head) fit a block's shared memory:
//   up to ~700 keys at bf16 / D = 64): all keys staged once, each warp walks
//   its own key range; a warp may run several tiles in turn;
// - streamed (any S): K / V arrive KB_STREAMED keys at a time into a double
//   buffer by cp.async, the next block's keys loading while this one is
//   computed, over the union of the block's tiles' ranges; one tile a warp.
// The fp32 instance runs the same code with CUDA-core products (mma_tiles.cuh).

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>

using namespace mma_tiles;

namespace {

constexpr int MAX_WARPS = 8;
constexpr int MAX_THREADS = MAX_WARPS * 32;
constexpr int KB = 32;  // keys per softmax block of the resident instance
constexpr int KB_STREAMED = 64;  // of the streamed instance: keys per stage
constexpr int KS = 16;  // keys per step: products, mask and exp skip whole steps
constexpr int PAD = 8;  // row padding (elements) against bank conflicts
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory: the block's rows (Q in, out back), K and V of kv_rows keys in
// `stages` buffers, their mask, and each warp's first and last allowed key.
struct Layout {
  size_t kv, k, v, mk, span, total;  // kv: bytes of one stage's K (or V)
  __host__ __device__ Layout(int esz, int d, int rows, int kv_rows, int stages) {
    kv = align128((size_t)kv_rows * (d + PAD) * esz);
    k = align128((size_t)rows * (d + PAD) * esz);
    v = k + stages * kv;
    mk = v + stages * kv;
    span = mk + align128((size_t)stages * kv_rows * sizeof(int));
    total = span + 2 * MAX_WARPS * sizeof(int);
  }
};

// The packed rows of one block: rows row0 .. row0 + rows - 1 of the
// (position, query head) sequence of KV head kvh in batch row b.
struct Rows {
  int row0, rows, rep, kvh, b, T, N;

  __device__ __forceinline__ int position(int r) const { return (row0 + r) / rep; }
};

// Walks rows r, r + step, r + 2 step, ... of a block, keeping each one's
// position and head without a division a row.
struct RowCursor {
  int pos, head, dpos, dhead;
  __device__ __forceinline__ RowCursor(const Rows& R, int r, int step) {
    pos = (R.row0 + r) / R.rep;
    head = R.row0 + r - pos * R.rep;
    dpos = step / R.rep;
    dhead = step - dpos * R.rep;
  }
  __device__ __forceinline__ void next(int rep) {
    pos += dpos;
    head += dhead;
    if (head >= rep) {
      head -= rep;
      ++pos;
    }
  }
  // Element offset of the row's D values in (B, T, N, D).
  __device__ __forceinline__ size_t offset(const Rows& R, int d) const {
    return (((size_t)R.b * R.T + pos) * R.N + R.kvh * R.rep + head) * d;
  }
};

// Start copying the block's n_rows Q rows (rows past the real ones zero).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* qs, const T* q, const Rows& R, int n_rows) {
  constexpr int LD = D + PAD, VEC = 16 / sizeof(T), CPR = D / VEC;
  const int step = blockDim.x / CPR, c = (threadIdx.x % CPR) * VEC;
  RowCursor at(R, threadIdx.x / CPR, step);
  for (int r = threadIdx.x / CPR; r < n_rows; r += step, at.next(R.rep)) {
    const bool valid = r < R.rows;
    cp_async16_zfill(qs + r * LD + c, q + (valid ? at.offset(R, D) + c : 0), valid);
  }
}

// Start copying keys kb0 .. kb0 + n - 1 of (batch b, KV head kvh) (rows past
// S zero).
template <typename T, int D>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* k, const T* v, int b, int kvh, int kb0, int n,
                                         int S, int KH) {
  constexpr int LD = D + PAD, VEC = 16 / sizeof(T), CPR = D / VEC;
  for (int i = threadIdx.x; i < n * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    const bool valid = kb0 + r < S;
    const size_t off = valid ? (((size_t)b * S + kb0 + r) * KH + kvh) * D + c : 0;
    cp_async16_zfill(ks + r * LD + c, k + off, valid);
    cp_async16_zfill(vs + r * LD + c, v + off, valid);
  }
}

// Mask entries [i0, i0 + n) of batch row b into mk (0 past S) when mk is
// given; when span is, each warp's first allowed key and last allowed key + 1
// of those it read into span[warp] and span[MAX_WARPS + warp] (S and 0 when
// none).
__device__ __forceinline__ void read_mask(int* mk, int* span, const int* mask, int b, int i0, int n, int S) {
  int first = S, last = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int key = i0 + i;
    const int m = key < S ? mask[(size_t)b * S + key] : 0;
    if (mk != nullptr) mk[i] = m;
    if (m > 0) {
      first = min(first, key);
      last = key + 1;
    }
  }
  if (span == nullptr) return;
  first = __reduce_min_sync(0xffffffffu, first);
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) {
    span[threadIdx.x >> 5] = first;
    span[MAX_WARPS + (threadIdx.x >> 5)] = last;
  }
}

// After a barrier: the batch row's first allowed key and last allowed key + 1.
__device__ __forceinline__ void allowed_span(const int* span, int S, int& first, int& last) {
  first = S;
  last = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    first = min(first, span[w]);
    last = max(last, span[MAX_WARPS + w]);
  }
}

// Keys [lo, hi) that rows at positions p_lo .. p_hi must visit. When every
// row has an allowed key at or before its position, the keys before the
// first allowed one, after the last allowed one and (causal) past p_hi are
// masked for every row and weigh exactly 0: they are skipped (lo rounded down
// to a step). Otherwise some row has none and must average V over all S keys.
__device__ __forceinline__ void key_range(int first, int last, int p_lo, int p_hi, int S, int causal, int& lo,
                                          int& hi) {
  if (first < S && (!causal || first <= p_lo)) {
    lo = first & ~(KS - 1);
    hi = causal ? min(last, p_hi + 1) : last;
  } else {
    lo = 0;
    hi = S;
  }
}

// One warp's 16-row tile: its first row is at position p_first, rows g and
// g + 8 of this thread at pos[0] and pos[1].
template <typename T, int D, int KB>
struct Tile {
  float o[D / 8][4];
  float m_run[2], l_run[2];
  int pos[2], p_first;

  __device__ __forceinline__ void init(int first, int pos_lo, int pos_hi) {
    p_first = first;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.0f;
    pos[0] = pos_lo;
    pos[1] = pos_hi;
  }

  // Keys kb0 .. kb0 + KB - 1 that lie in [lo, hi) (at least one step of
  // them): qs points at the tile's first Q row, ks / vs / mk at key kb0's row.
  __device__ __forceinline__ void attend(const T* qs, const T* ks, const T* vs, const int* mk, int kb0, int lo,
                                         int hi, int S, int causal, float scale2) {
    constexpr int LD = D + PAD;
    constexpr int ND = D / 8, NS = KB / KS;
    const int lane = threadIdx.x & 31, t = lane & 3;
    bool live[NS];
#pragma unroll
    for (int st = 0; st < NS; ++st) live[st] = kb0 + st * KS >= lo && kb0 + st * KS < hi;
    // logits of 16 rows x KB keys
    float s[KB / 8][4];
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      pair_t<T> qa[4];
      load_a(qa, qs + kk * 16, LD);
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        if (!live[st]) continue;
        pair_t<T> bf[4];
        load_b_nk(bf, ks + st * KS * LD + kk * 16, LD);
        mma(s[2 * st], qa, bf[0], bf[1]);
        mma(s[2 * st + 1], qa, bf[2], bf[3]);
      }
    }
    // The keys the mask allows, a bit a key: word[h] bit i is key kb0 + 32 h + i.
    unsigned word[KB / 32];
#pragma unroll
    for (int h = 0; h < KB / 32; ++h) {
      const int key = kb0 + h * 32 + lane;
      word[h] = __ballot_sync(0xffffffffu, key < S && mk[key - kb0] > 0);
    }
    // mask, scale (base 2), online softmax; element e of tile j: row g + 8 (e / 2), key 2t + e % 2.
    // A step whose keys the mask allows and (causal) every row may see needs no test a key.
    float bmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      if (!live[st]) continue;
      const int k0 = kb0 + st * KS;
      const unsigned bits = (word[st >> 1] >> (st & 1) * 16) & 0xffffu;
      const bool whole = bits == 0xffffu && (!causal || k0 + KS - 1 <= p_first);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float(&sj)[4] = s[2 * st + jj];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sj[e] * scale2;
          if (!whole) {
            const int at = jj * 8 + 2 * t + (e & 1), key = k0 + at;
            if (!(bits >> at & 1u) || (causal && key > pos[e >> 1])) x = MASKED;
            if (key >= S) x = -INFINITY;  // keys past S take no part at all
          }
          sj[e] = x;
          bmax[e >> 1] = fmaxf(bmax[e >> 1], x);
        }
      }
    }
    float alpha[2], bsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 1));
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 2));
      const float m_new = fmaxf(m_run[r], bmax[r]);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      if (!live[j / 2]) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m_run[e >> 1]);
        bsum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bsum[r] += __shfl_xor_sync(0xffffffffu, bsum[r], 1);
      bsum[r] += __shfl_xor_sync(0xffffffffu, bsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + bsum[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // P (cast to the value dtype) . V, one step of 16 keys at a time
#pragma unroll
    for (int st = 0; st < NS; ++st) {
      if (!live[st]) continue;
      pair_t<T> pa[4];
      pa[0] = pack<T>(s[2 * st][0], s[2 * st][1]);
      pa[1] = pack<T>(s[2 * st][2], s[2 * st][3]);
      pa[2] = pack<T>(s[2 * st + 1][0], s[2 * st + 1][1]);
      pa[3] = pack<T>(s[2 * st + 1][2], s[2 * st + 1][3]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        pair_t<T> bf[4];
        load_b_kn(bf, vs + st * KS * LD + j * 8, LD);
        mma(o[j], pa, bf[0], bf[1]);
        mma(o[j + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // out = o / l into the tile's 16 rows at qs (its Q rows, no longer read).
  __device__ __forceinline__ void put(T* qs) const {
    constexpr int LD = D + PAD;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.0f / l_run[r];
      T* row = qs + (g + 8 * r) * LD;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<pair_t<T>*>(row + j * 8 + 2 * t) = pack<T>(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
};

// Copy the real rows of the warp's tile at block row r0 from shared memory
// (qs: its first row) to out as 16-byte pieces.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* out, const T* qs, const Rows& R, int r0) {
  constexpr int LD = D + PAD, VEC = 16 / sizeof(T), CPR = D / VEC, STEP = 32 / CPR;
  const int n = min(16, R.rows - r0), lane = threadIdx.x & 31, c = (lane % CPR) * VEC;
  RowCursor at(R, r0 + lane / CPR, STEP);
  for (int r = lane / CPR; r < n; r += STEP, at.next(R.rep))
    *reinterpret_cast<uint4*>(out + at.offset(R, D) + c) = *reinterpret_cast<const uint4*>(qs + r * LD + c);
}

__device__ __forceinline__ Rows block_rows(int tiles, int T_len, int N, int KH) {
  const int rep = N / KH, row0 = blockIdx.x * tiles * 16;
  return Rows{row0, min(tiles * 16, T_len * rep - row0), rep, (int)blockIdx.y, (int)blockIdx.z, T_len, N};
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ mask, T* __restrict__ out, int T_len, int S, int N, int KH, int tiles,
                 int causal, float scale2) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int s16 = round_up(S, KS);
  const Layout L(sizeof(T), D, tiles * 16, s16, 1);
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  int* mk = reinterpret_cast<int*>(smem + L.mk);
  int* span = reinterpret_cast<int*>(smem + L.span);
  const Rows R = block_rows(tiles, T_len, N, KH);

  // One round trip: Q rows, K and V by cp.async, the mask by loads beside them.
  stage_rows<T, D>(qs, q, R, tiles * 16);
  stage_kv<T, D>(ks, vs, k, v, R.b, R.kvh, 0, s16, S, KH);
  cp_async_commit();
  read_mask(mk, span, mask, R.b, 0, s16, S);
  cp_async_wait<0>();
  __syncthreads();
  int first, last;
  allowed_span(span, S, first, last);

  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5, g = (threadIdx.x & 31) >> 2;
  for (int tile = warp; tile < tiles && tile * 16 < R.rows; tile += warps) {
    const int r0 = tile * 16;
    T* qt = qs + r0 * LD;
    int lo, hi;
    key_range(first, last, R.position(r0), R.position(min(r0 + 15, R.rows - 1)), S, causal, lo, hi);
    Tile<T, D, KB> w;
    w.init(R.position(r0), R.position(r0 + g), R.position(r0 + g + 8));
    for (int kb0 = lo; kb0 < hi; kb0 += KB)
      w.attend(qt, ks + kb0 * LD, vs + kb0 * LD, mk + kb0, kb0, lo, hi, S, causal, scale2);
    __syncwarp();
    w.put(qt);
    __syncwarp();
    store_tile<T, D>(out, qt, R, r0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_THREADS)
flash_fwd_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const int* __restrict__ mask, T* __restrict__ out, int T_len, int S, int N, int KH,
                          int tiles, int causal, float scale2) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(sizeof(T), D, tiles * 16, KB_STREAMED, 2);
  T* qs = reinterpret_cast<T*>(smem);
  int* span = reinterpret_cast<int*>(smem + L.span);
  T* ks[2];
  T* vs[2];
  int* mk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ks[i] = reinterpret_cast<T*>(smem + L.k + i * L.kv);
    vs[i] = reinterpret_cast<T*>(smem + L.v + i * L.kv);
    mk[i] = reinterpret_cast<int*>(smem + L.mk) + i * KB_STREAMED;
  }
  const Rows R = block_rows(tiles, T_len, N, KH);

  // Q in flight while the whole mask row gives the allowed span.
  stage_rows<T, D>(qs, q, R, tiles * 16);
  read_mask(nullptr, span, mask, R.b, 0, S, S);
  __syncthreads();
  int first, last, b_lo, b_hi;
  allowed_span(span, S, first, last);
  key_range(first, last, R.position(0), R.position(R.rows - 1), S, causal, b_lo, b_hi);

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int r0 = warp * 16;
  const bool own = r0 < R.rows;  // the launch gives every tile a warp
  int lo = 0, hi = 0;
  Tile<T, D, KB_STREAMED> w;
  if (own) {
    key_range(first, last, R.position(r0), R.position(min(r0 + 15, R.rows - 1)), S, causal, lo, hi);
    w.init(R.position(r0), R.position(r0 + g), R.position(r0 + g + 8));
  }
  const int kb_first = b_lo / KB_STREAMED * KB_STREAMED;
  stage_kv<T, D>(ks[0], vs[0], k, v, R.b, R.kvh, kb_first, KB_STREAMED, S, KH);
  cp_async_commit();
  read_mask(mk[0], nullptr, mask, R.b, kb_first, KB_STREAMED, S);
  for (int kb0 = kb_first, it = 0; kb0 < b_hi; kb0 += KB_STREAMED, ++it) {
    const int cur = it & 1;
    if (kb0 + KB_STREAMED < b_hi) {
      stage_kv<T, D>(ks[cur ^ 1], vs[cur ^ 1], k, v, R.b, R.kvh, kb0 + KB_STREAMED, KB_STREAMED, S, KH);
      cp_async_commit();
      read_mask(mk[cur ^ 1], nullptr, mask, R.b, kb0 + KB_STREAMED, KB_STREAMED, S);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (own && kb0 + KB_STREAMED > lo && kb0 < hi)
      w.attend(qs + r0 * LD, ks[cur], vs[cur], mk[cur], kb0, lo, hi, S, causal, scale2);
    __syncthreads();  // before the next stage overwrites this buffer
  }
  if (own) {
    __syncwarp();
    w.put(qs + r0 * LD);
    __syncwarp();
    store_tile<T, D>(out, qs + r0 * LD, R, r0);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The instance a launch takes and its shared memory: the resident one unless
// asked for the streamed one or K / V do not fit.
template <typename T, int D>
void pick(int S, int tiles, int streamed, int max_smem, void (**kernel)(const T*, const T*, const T*, const int*, T*,
                                                                        int, int, int, int, int, int, float),
          size_t* smem) {
  const size_t resident = Layout(sizeof(T), D, tiles * 16, round_up(S, KS), 1).total;
  if (!streamed && resident <= (size_t)max_smem) {
    *kernel = flash_fwd_kernel<T, D>;
    *smem = resident;
  } else {
    *kernel = flash_fwd_streamed_kernel<T, D>;
    *smem = Layout(sizeof(T), D, tiles * 16, KB_STREAMED, 2).total;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int T_len, int S,
           int N, int KH, int causal, float scale, int tiles, int warps, int streamed, int* blocks_per_sm,
           cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  void (*kernel)(const T*, const T*, const T*, const int*, T*, int, int, int, int, int, int, float);
  size_t smem;
  pick<T, D>(S, tiles, streamed, max_smem, &kernel, &smem);
  // The streamed instance holds one tile a warp across its key blocks.
  if (kernel != flash_fwd_kernel<T, D>) warps = tiles;
  if (smem > (size_t)max_smem || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, warps * 32, smem);
  const long rows = (long)T_len * (N / KH);
  dim3 grid((unsigned)((rows + tiles * 16 - 1) / (tiles * 16)), KH, B);
  kernel<<<grid, warps * 32, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<const int*>(mask),
                                             static_cast<T*>(out), T_len, S, N, KH, tiles, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int T_len, int S,
             int N, int KH, int D, int causal, float scale, int dtype, int tiles, int warps, int streamed,
             int* blocks_per_sm, cudaStream_t st) {
  if (KH <= 0 || N % KH != 0 || B <= 0 || T_len <= 0 || S <= 0 || B > 65535 || KH > 65535 || tiles < 1 ||
      warps < 1 || warps > MAX_WARPS || (long)T_len * (N / KH) > (1L << 30))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, tiles, warps, streamed,
                             blocks_per_sm, st);
  if (dtype == 1 && D == 128)
    return launch<bf16, 128>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, tiles, warps, streamed,
                             blocks_per_sm, st);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, tiles, warps, streamed,
                             blocks_per_sm, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, tiles, warps, streamed,
                             blocks_per_sm, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tiles: 16-row tiles of packed (position,
// query head) rows a block takes; warps: the resident instance's warps a
// block (1 .. 8; the streamed instance runs one a tile, so at most 8 tiles).
// streamed: 0 = the resident instance where K / V
// of one head fit a block's shared memory, else the streamed one; 1 = the
// streamed instance at any S. Returns a cudaError_t value (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
                                   int T_len, int S, int N, int KH, int D, int causal, float scale, int dtype,
                                   int tiles, int warps, int streamed, void* stream) {
  return dispatch(q, k, v, mask, out, B, T_len, S, N, KH, D, causal, scale, dtype, tiles, warps, streamed, nullptr,
                  static_cast<cudaStream_t>(stream));
}

// Blocks of the instance that a launch with these arguments takes that one SM
// holds at once (the CUDA occupancy calculator: registers, threads, shared
// memory), into *blocks. Launches nothing.
extern "C" int flash_attention_blocks_per_sm(int T_len, int S, int N, int KH, int D, int dtype, int tiles,
                                             int warps, int streamed, int* blocks) {
  *blocks = 0;
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, 1, T_len, S, N, KH, D, 0, 1.0f, dtype, tiles, warps,
                  streamed, blocks, nullptr);
}
