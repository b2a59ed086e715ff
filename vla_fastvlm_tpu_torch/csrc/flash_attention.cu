// Masked GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vla_fastvlm_tpu/ops/pallas/flash_attention.py
// (flash_attention -> _flash_attention_forward -> _attn_kernel). Same function:
//   q (B, T, N, D) x k, v (B, S, K, D) -> out (B, T, N, D)
//   - GQA: query head h reads KV head h / (N / K);
//   - key-padding mask (B, S) int32 plus optional causal by absolute position;
//     masked logits are -1e30 (finite), so a fully masked row comes out as the
//     uniform average over V, exactly as the plain version gives it;
//   - fp32 logits and softmax; probabilities cast to the value dtype before
//     P.V, with fp32 accumulation.
//
// Bound on this card: at the decoder's prefill shapes (T = S = 80, D = 64)
// the work is ~3 GFLOP against ~42 MB moved, so it is bound by bytes. The
// design reads q once, writes out once, never writes the (T, S) logits, and
// loads each (batch, KV head)'s K and V into shared memory once per block of
// Q_ROWS = 16 query rows, where all rep = N / K query heads of that KV head
// reuse them (the TPU kernel's GQA index map, done as explicit reuse): at
// T = 80 that is 5 loads per (batch, KV head). Blocks of 64 rows (2 loads)
// ran slower on the H100: too few blocks to hide the unpipelined K/V load.
//
// Design, like the Pallas kernel: K and V of one (batch, KV head) stay
// resident in shared memory (S up to a few hundred keys). One block of 4 warps
// per (Q_ROWS query rows, KV head, batch row). Its work is 16-row tiles, one
// per (query head of that KV head, 16 of the Q_ROWS rows), spread over the 4
// warps; rows past T are not tiled. Each warp keeps its tile's Q fragments,
// logits, probabilities and output accumulator in registers (mma.sync m16n8k16 with
// the FlashAttention-2 register layout: the logits' accumulator fragments
// become the P.V A operand), walks S in blocks of 64 keys with an online
// softmax, and writes its 16 output rows once. Every key below S is visited
// (no causal block skipping), so fully masked rows average over all S keys;
// 16-key steps wholly past S are skipped. The fp32 instance runs the same
// code with CUDA-core products (mma_tiles.cuh).

#include "mma_tiles.cuh"

#include <cmath>
#include <cstddef>

using namespace mma_tiles;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int Q_ROWS = 16;  // query rows per block, of every head of one KV head
constexpr int KB = 64;  // keys per softmax block (8 tiles of 8)
constexpr int PAD = 8;  // row padding (elements) against bank conflicts
constexpr float MASKED = -1e30f;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Layout {
  size_t k, v, mk, total;
  __host__ __device__ Layout(int esz, int d, int s) {
    const int sp = round_up(s, KB);
    k = 0;
    v = align128((size_t)sp * (d + PAD) * esz);
    mk = v + align128((size_t)sp * (d + PAD) * esz);
    total = mk + align128((size_t)sp * sizeof(int));
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ mask, T* __restrict__ out, int T_len, int S, int N,
                 int KH, int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int ND = D / 8;  // 8-column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(sizeof(T), D, S);
  T* ks = reinterpret_cast<T*>(smem + L.k);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  int* mk = reinterpret_cast<int*>(smem + L.mk);

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rep = N / KH;
  const int sp = round_up(S, KB);

  // K, V and the mask of this (batch, KV head): zero rows past S.
  constexpr int VEC = 16 / sizeof(T), PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < sp * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (r < S) {
      const size_t off = (((size_t)b * S + r) * KH + kvh) * D + c;
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(ks + r * LD + c) = kv;
    *reinterpret_cast<uint4*>(vs + r * LD + c) = vv;
  }
  for (int i = threadIdx.x; i < sp; i += THREADS) mk[i] = i < S ? mask[(size_t)b * S + i] : 0;
  __syncthreads();

  // This block's Q_ROWS query rows of all rep heads: n_sub 16-row tiles of each
  // head, spread over the warps, all reading the K/V loaded above.
  const int warp = threadIdx.x >> 5;
  const int q_base = blockIdx.x * Q_ROWS;
  const int n_sub = min(Q_ROWS / 16, (T_len - q_base + 15) / 16);
  for (int tile = warp; tile < rep * n_sub; tile += WARPS) {
    const int h = kvh * rep + tile / n_sub;
    const int q0 = q_base + (tile % n_sub) * 16;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row_lo = q0 + g, row_hi = q0 + g + 8;  // query positions of this thread

    // Q fragments straight from device memory; rows past T are zero.
    pair_t<T> qa[D / 16][4];
    {
      const T* qlo = q + (((size_t)b * T_len + row_lo) * N + h) * D;
      const T* qhi = q + (((size_t)b * T_len + row_hi) * N + h) * D;
      const pair_t<T> zero = pack<T>(0.0f, 0.0f);
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qa[kk][0] = row_lo < T_len ? *reinterpret_cast<const pair_t<T>*>(qlo + c) : zero;
        qa[kk][1] = row_hi < T_len ? *reinterpret_cast<const pair_t<T>*>(qhi + c) : zero;
        qa[kk][2] = row_lo < T_len ? *reinterpret_cast<const pair_t<T>*>(qlo + c + 8) : zero;
        qa[kk][3] = row_hi < T_len ? *reinterpret_cast<const pair_t<T>*>(qhi + c + 8) : zero;
      }
    }

    float o[ND][4];
    #pragma unroll
    for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

    for (int kb0 = 0; kb0 < S; kb0 += KB) {
      // logits of 16 rows x 64 keys
      float s[KB / 8][4];
      #pragma unroll
      for (int j = 0; j < KB / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        #pragma unroll
        for (int j = 0; j < KB / 8; j += 2) {
          if (kb0 + j * 8 >= S) break;  // tiles wholly past S stay masked out below
          pair_t<T> bf[4];
          load_b_nk(bf, ks + (kb0 + j * 8) * LD + kk * 16, LD);
          mma(s[j], qa[kk], bf[0], bf[1]);
          mma(s[j + 1], qa[kk], bf[2], bf[3]);
        }
      }
      // mask, scale, online softmax; element e of tile j: row g + 8 (e / 2), key 2t + e % 2
      float bmax[2] = {-INFINITY, -INFINITY};
      #pragma unroll
      for (int j = 0; j < KB / 8; ++j) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb0 + j * 8 + 2 * t + (e & 1);
          const int qpos = e < 2 ? row_lo : row_hi;
          float x = -INFINITY;  // keys past S take no part at all
          if (key < S) {
            const bool ok = mk[key] != 0 && (!causal || key <= qpos);
            x = ok ? s[j][e] * scale : MASKED;
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
      for (int j = 0; j < KB / 8; ++j)
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
      for (int j = 0; j < ND; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // P (cast to the value dtype) . V, 16 keys per step
      #pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        if (kb0 + kk * 16 >= S) break;  // their probabilities are 0
        pair_t<T> pa[4];
        pa[0] = pack<T>(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack<T>(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        #pragma unroll
        for (int j = 0; j < ND; j += 2) {
          pair_t<T> bf[4];
          load_b_kn(bf, vs + (kb0 + kk * 16) * LD + j * 8, LD);
          mma(o[j], pa, bf[0], bf[1]);
          mma(o[j + 1], pa, bf[2], bf[3]);
        }
      }
    }

    // out = o / l for the two rows of this thread
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row_lo : row_hi;
      if (row >= T_len) continue;
      const float inv = 1.0f / l_run[r];
      T* dst = out + (((size_t)b * T_len + row) * N + h) * D;
      #pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<pair_t<T>*>(dst + j * 8 + 2 * t) = pack<T>(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           int B, int T_len, int S, int N, int KH, int causal, float scale, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = Layout(sizeof(T), D, S).total;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + Q_ROWS - 1) / Q_ROWS, KH, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(out), T_len, S, N, KH, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs for S keys, in bytes (0 for an unknown dtype).
extern "C" long long flash_attention_smem_bytes(int S, int D, int dtype) {
  if (dtype == 1) return (long long)Layout(sizeof(bf16), D, S).total;
  if (dtype == 0) return (long long)Layout(sizeof(float), D, S).total;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, int B, int T_len, int S, int N, int KH, int D,
                                   int causal, float scale, int dtype, void* stream) {
  if (KH <= 0 || N % KH != 0 || B <= 0 || T_len <= 0 || S <= 0 || B > 65535 || KH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch<bf16, 64>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, st);
  if (dtype == 1 && D == 128) return launch<bf16, 128>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, st);
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(q, k, v, mask, out, B, T_len, S, N, KH, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
