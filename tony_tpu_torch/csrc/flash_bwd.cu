// FlashAttention-2 backward for Hopper (sm_90a): two passes from the saved
// per-row log-sum-exp, one for dq (B2) and one for dk/dv (B3), with no
// atomics, so the gradients are deterministic.
//
// Replaces: tony_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (launched by _flash_attention_pallas_bwd). Same
// contract: s = (Q K^T) * scale in fp32 (the scale applied after the
// product); p = exp(s - lse) rebuilt from the forward's lse; dp = dO V^T;
// ds = p * (dp - delta), where delta = rowsum(dO * O) - g_lse comes in
// precomputed in fp32 [B, H, t_q]. B2 rounds ds to K's dtype before ds.K;
// B3 rounds p to dO's dtype before p^T.dO and ds to Q's dtype before
// ds^T.Q. All sums are fp32; dq and dk carry the scale; outputs are in the
// input dtype. Key/query tile pairs wholly above the causal diagonal are
// skipped, and only pairs that straddle it or hold tail rows or tail keys
// pay for masking. Query rows sit at the end of the keys (row i has position
// t_k - t_q + i), so a fully masked row (causal, t_q > t_k) gets p = 0 and
// zero gradients.
//
// Bound on this card: at the training shape (B = 8, H = 16, T = 2048,
// D = 64, bf16, causal) B2 does three products over the T(T+1)/2 visible
// pairs of each head (~1.03e11 FLOP) and B3 four (~1.38e11 FLOP) against
// ~70 MB of traffic each, so the published peaks bound them by operations
// (~0.10 and ~0.14 ms at 989 TFLOP/s). Like B1, this first version does the
// products with fp32 FMAs from shared memory rather than on the tensor
// cores, so it is bound by its own FMA issue instead (67 TFLOP/s of fp32 is
// the ceiling of that design). mma/wgmma tiles are later work.
//
// Design: 256 threads per block, 64-row tiles staged in shared memory as
// fp32 with rows padded by one float (the column walks are then free of bank
// conflicts). Each tile pair first computes the 64x64 score and dp tiles in
// the score layout (a 4x4 block per thread, both products in one pass over
// D), turns them into p and ds in registers, and writes what the second
// product needs to shared memory. The second product runs in a row layout:
// four consecutive lanes own one output row, each a quarter of its D
// columns, in registers across the whole loop.
// - B2: one block per (batch*head, 64-row query tile), looping over key
//   tiles; dq[r] += sum_j ds[r][j] K[j].
// - B3: one block per (batch*KV head, 64-row key tile), looping over the
//   H / H_kv query heads that share the KV head and over query tiles;
//   dv[r] += sum_i p[i][r] dO[i] and dk[r] += sum_i ds[i][r] Q[i]. Summing
//   the group inside the block is what autodiff of the JAX route's repeated
//   K/V computes, without atomics or a second reduction pass.
// Inputs are read through batch/seq/head strides with a contiguous last
// dimension.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per tile
constexpr int kBlockN = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kLdS = kBlockN + 1;  // padded row stride of the p / ds tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, t_q]
  const float* delta;  // [B, H, t_q]
  void* dq;
  void* dk;
  void* dv;
  // element strides (batch, sequence, head) of q, k, v, dO and the outputs
  int64_t q_s[3], k_s[3], v_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  int n_heads;
  int n_kv_heads;
  int group;  // query heads per KV head
  int t_q;
  int t_k;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void store_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
// Rounding to the operand dtype before a product (the TPU kernels cast p
// and ds for the MXU); the identity for fp32 inputs.
__device__ __forceinline__ float round_like(float v, float) { return v; }
__device__ __forceinline__ float round_like(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage rows [row0, row0 + 64) of one head into shared memory as fp32 with a
// padded row stride of D + 1; rows at or past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  constexpr int kTotal = 64 * kVecPerRow;
  for (int i = threadIdx.x; i < kTotal; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* out = dst + r * (D + 1) + c;
    const int row = row0 + r;
    if (row < n_rows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (int64_t)row * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = 0.f;
    }
  }
}

// lse and delta of query rows [q0, q0 + 64) of head `bh`; zero past t_q.
__device__ __forceinline__ void load_rows(float* s_lse, float* s_delta,
                                          const Params& p, int bh, int q0) {
  if (threadIdx.x < kBlockM) {
    const int row = q0 + threadIdx.x;
    const bool in = row < p.t_q;
    const int64_t at = (int64_t)bh * p.t_q + row;
    s_lse[threadIdx.x] = in ? p.lse[at] : 0.f;
    s_delta[threadIdx.x] = in ? p.delta[at] : 0.f;
  }
}

// The two score-layout products of one tile pair, s = Q.K^T and
// dp = dO.V^T, in one pass over D; thread (ty, tx) holds query rows
// ty + 16a and keys tx + 16c.
template <int D>
__device__ __forceinline__ void score_tiles(const float* q_tile,
                                            const float* do_tile,
                                            const float* k_tile,
                                            const float* v_tile, int ty,
                                            int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[a][c] = 0.f;
      dp[a][c] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = q_tile[(ty + 16 * a) * kLd + d];
      ov[a] = do_tile[(ty + 16 * a) * kLd + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = k_tile[(tx + 16 * c) * kLd + d];
      vv[c] = v_tile[(tx + 16 * c) * kLd + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(ov[a], vv[c], dp[a][c]);
      }
  }
}

// p = exp(s * scale - lse) at (query row q0 + row, key k0 + col), 0 where
// the pair is masked. `needs_mask` is false for tiles wholly inside the
// visible, in-range region.
__device__ __forceinline__ float masked_p(float s, float lse, bool needs_mask,
                                          const Params& p, int q0, int row,
                                          int k0, int col) {
  if (needs_mask) {
    const int q_row = q0 + row;
    const int k_pos = k0 + col;
    if (k_pos >= p.t_k || q_row >= p.t_q ||
        (p.causal && p.t_k - p.t_q + q_row < k_pos))
      return 0.f;
  }
  return expf(s * p.scale - lse);
}

__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int k0) {
  return (k0 + kBlockN > p.t_k) || (q0 + kBlockM > p.t_q) ||
         (p.causal && k0 + kBlockN - 1 > p.t_k - p.t_q + q0);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * kBlockM + 2 * kBlockN) * (D + 1) +
                          kBlockM * kLdS + 2 * kBlockM);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * kBlockM + 2 * kBlockN) * (D + 1) +
                          2 * kBlockM * kLdS + 2 * kBlockM);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 4;  // output columns owned by each thread
  extern __shared__ float smem[];
  float* s_q = smem;                    // [64][D + 1]
  float* s_do = s_q + kBlockM * kLd;    // [64][D + 1]
  float* s_k = s_do + kBlockM * kLd;    // [64][D + 1]
  float* s_v = s_k + kBlockN * kLd;     // [64][D + 1]
  float* s_ds = s_v + kBlockN * kLd;    // [64][65]: ds, rounded to K's dtype
  float* s_lse = s_ds + kBlockM * kLdS; // [64]
  float* s_delta = s_lse + kBlockM;     // [64]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh % p.n_heads;
  const int hk = h / p.group;
  const int q0 = blockIdx.y * kBlockM;
  const int q_off = p.t_k - p.t_q;

  const T* q_base = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const T* do_base =
      static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[2];
  const T* k_base = static_cast<const T*>(p.k) + b * p.k_s[0] + hk * p.k_s[2];
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_s[0] + hk * p.v_s[2];

  load_tile<T, D>(s_q, q_base, p.q_s[1], q0, p.t_q);
  load_tile<T, D>(s_do, do_base, p.do_s[1], q0, p.t_q);
  load_rows(s_lse, s_delta, p, bh, q0);

  const int ty = tid >> 4;  // score layout
  const int tx = tid & 15;
  const int r = tid >> 2;   // row layout: four lanes per query row
  const int c4 = tid & 3;

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;

  int n_tiles = (p.t_k + kBlockN - 1) / kBlockN;
  if (p.causal) {
    // A key tile is live while its first key is at or before the position
    // of this query tile's last row.
    const int last = q_off + q0 + kBlockM - 1;
    const int live = last < 0 ? 0 : last / kBlockN + 1;
    n_tiles = min(n_tiles, live);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockN;
    __syncthreads();  // the previous tile's reads of K and ds are done
    load_tile<T, D>(s_k, k_base, p.k_s[1], k0, p.t_k);
    load_tile<T, D>(s_v, v_base, p.v_s[1], k0, p.t_k);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<D>(s_q, s_do, s_k, s_v, ty, tx, s, dp);
    const bool needs_mask = tile_needs_mask(p, q0, k0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = ty + 16 * a;
      const float lse = s_lse[row];
      const float delta = s_delta[row];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const float pv = masked_p(s[a][c], lse, needs_mask, p, q0, row, k0,
                                  col);
        s_ds[row * kLdS + col] = round_like(pv * (dp[a][c] - delta), T());
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      const float dsj = s_ds[r * kLdS + j];
      const float* k_row = s_k + j * kLd + c4;
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] = fmaf(dsj, k_row[4 * k], acc[k]);
    }
  }

  const int q_row = q0 + r;
  if (q_row < p.t_q) {
    T* dq_row = static_cast<T*>(p.dq) + b * p.dq_s[0] + h * p.dq_s[2] +
                (int64_t)q_row * p.dq_s[1];
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      store_float(acc[k] * p.scale, dq_row + c4 + 4 * k);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 4;
  extern __shared__ float smem[];
  float* s_k = smem;                    // [64][D + 1]
  float* s_v = s_k + kBlockN * kLd;     // [64][D + 1]
  float* s_q = s_v + kBlockN * kLd;     // [64][D + 1]
  float* s_do = s_q + kBlockM * kLd;    // [64][D + 1]
  float* s_p = s_do + kBlockM * kLd;    // [64 q][65]: p, rounded to dO's dtype
  float* s_ds = s_p + kBlockM * kLdS;   // [64 q][65]: ds, rounded to Q's dtype
  float* s_lse = s_ds + kBlockM * kLdS; // [64]
  float* s_delta = s_lse + kBlockM;     // [64]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.n_kv_heads;
  const int hk = blockIdx.x % p.n_kv_heads;
  const int k0 = blockIdx.y * kBlockN;
  const int q_off = p.t_k - p.t_q;

  const T* k_base = static_cast<const T*>(p.k) + b * p.k_s[0] + hk * p.k_s[2];
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_s[0] + hk * p.v_s[2];
  load_tile<T, D>(s_k, k_base, p.k_s[1], k0, p.t_k);
  load_tile<T, D>(s_v, v_base, p.v_s[1], k0, p.t_k);

  const int ty = tid >> 4;  // score layout: query rows ty + 16a, keys tx + 16c
  const int tx = tid & 15;
  const int r = tid >> 2;   // row layout: four lanes per key row
  const int c4 = tid & 3;

  float acc_dk[kCols], acc_dv[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    acc_dk[k] = 0.f;
    acc_dv[k] = 0.f;
  }

  const int n_q_tiles = (p.t_q + kBlockM - 1) / kBlockM;
  int first = 0;
  if (p.causal) {
    // A query tile is live once its last row's position reaches this key
    // tile's first key: q_off + q0 + 63 >= k0.
    const int need = k0 - q_off - (kBlockM - 1);
    first = need <= 0 ? 0 : (need + kBlockM - 1) / kBlockM;
  }

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const int bh = b * p.n_heads + h;
    const T* q_base = static_cast<const T*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
    const T* do_base =
        static_cast<const T*>(p.dout) + b * p.do_s[0] + h * p.do_s[2];
    for (int qt = first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBlockM;
      __syncthreads();  // the previous tile's reads of Q, dO, p, ds are done
      load_tile<T, D>(s_q, q_base, p.q_s[1], q0, p.t_q);
      load_tile<T, D>(s_do, do_base, p.do_s[1], q0, p.t_q);
      load_rows(s_lse, s_delta, p, bh, q0);
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<D>(s_q, s_do, s_k, s_v, ty, tx, s, dp);
      const bool needs_mask = tile_needs_mask(p, q0, k0);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = ty + 16 * a;
        const float lse = s_lse[row];
        const float delta = s_delta[row];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float pv = masked_p(s[a][c], lse, needs_mask, p, q0, row, k0,
                                    col);
          s_p[row * kLdS + col] = round_like(pv, T());
          s_ds[row * kLdS + col] = round_like(pv * (dp[a][c] - delta), T());
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < kBlockM; ++i) {
        const float pi = s_p[i * kLdS + r];
        const float dsi = s_ds[i * kLdS + r];
        const float* do_row = s_do + i * kLd + c4;
        const float* q_row = s_q + i * kLd + c4;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          acc_dv[k] = fmaf(pi, do_row[4 * k], acc_dv[k]);
          acc_dk[k] = fmaf(dsi, q_row[4 * k], acc_dk[k]);
        }
      }
    }
  }

  const int k_row = k0 + r;
  if (k_row < p.t_k) {
    T* dk_row = static_cast<T*>(p.dk) + b * p.dk_s[0] + hk * p.dk_s[2] +
                (int64_t)k_row * p.dk_s[1];
    T* dv_row = static_cast<T*>(p.dv) + b * p.dv_s[0] + hk * p.dv_s[2] +
                (int64_t)k_row * p.dv_s[1];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      store_float(acc_dk[k] * p.scale, dk_row + c4 + 4 * k);
      store_float(acc_dv[k], dv_row + c4 + 4 * k);
    }
  }
}

// The shared-memory attribute belongs to the current device, so it is set on
// every launch (a cheap host call) rather than once per process.
template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const Params& p, dim3 grid,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int n_heads, int n_kv_heads, int t_q, int t_k, float scale,
                   int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.n_heads = n_heads;
  p.n_kv_heads = n_kv_heads;
  p.group = n_heads / n_kv_heads;
  p.t_q = t_q;
  p.t_k = t_k;
  p.scale = scale;
  p.causal = causal;
  return p;
}

void copy3(int64_t* dst, const int64_t* src) {
  dst[0] = src[0];
  dst[1] = src[1];
  dst[2] = src[2];
}

}  // namespace

// Shapes: q/dO/dq [B, t_q, H, D], k/v [B, t_k, H_kv, D]; lse and delta
// [B, H, t_q] f32, contiguous. `strides` holds the (batch, seq, head)
// element strides of q, k, v, dO, dq in that order (15 values); the last
// dimension is contiguous. dtype codes: 0 = float32, 1 = bfloat16; head_dim
// 64 or 128. Returns a cudaError_t value (0 on success); asynchronous on
// `stream`.
extern "C" int tony_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const int64_t* strides, int batch,
                                 int n_heads, int n_kv_heads, int t_q, int t_k,
                                 int head_dim, float scale, int causal,
                                 int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, n_heads, n_kv_heads, t_q,
                         t_k, scale, causal);
  p.dq = dq;
  copy3(p.q_s, strides);
  copy3(p.k_s, strides + 3);
  copy3(p.v_s, strides + 6);
  copy3(p.do_s, strides + 9);
  copy3(p.dq_s, strides + 12);
  const dim3 grid(batch * n_heads, (t_q + kBlockM - 1) / kBlockM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_bwd_dq_kernel<float, 64>, dq_smem_bytes<64>(), p,
                  grid, s);
  if (dtype == 0 && head_dim == 128)
    return launch(flash_bwd_dq_kernel<float, 128>, dq_smem_bytes<128>(), p,
                  grid, s);
  if (dtype == 1 && head_dim == 64)
    return launch(flash_bwd_dq_kernel<__nv_bfloat16, 64>, dq_smem_bytes<64>(),
                  p, grid, s);
  if (dtype == 1 && head_dim == 128)
    return launch(flash_bwd_dq_kernel<__nv_bfloat16, 128>,
                  dq_smem_bytes<128>(), p, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As tony_flash_bwd_dq, writing dk and dv [B, t_k, H_kv, D]; `strides`
// holds those of q, k, v, dO, dk, dv (18 values).
extern "C" int tony_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  const int64_t* strides, int batch,
                                  int n_heads, int n_kv_heads, int t_q,
                                  int t_k, int head_dim, float scale,
                                  int causal, int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, n_heads, n_kv_heads, t_q,
                         t_k, scale, causal);
  p.dk = dk;
  p.dv = dv;
  copy3(p.q_s, strides);
  copy3(p.k_s, strides + 3);
  copy3(p.v_s, strides + 6);
  copy3(p.do_s, strides + 9);
  copy3(p.dk_s, strides + 12);
  copy3(p.dv_s, strides + 15);
  const dim3 grid(batch * n_kv_heads, (t_k + kBlockN - 1) / kBlockN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_bwd_dkv_kernel<float, 64>, dkv_smem_bytes<64>(), p,
                  grid, s);
  if (dtype == 0 && head_dim == 128)
    return launch(flash_bwd_dkv_kernel<float, 128>, dkv_smem_bytes<128>(), p,
                  grid, s);
  if (dtype == 1 && head_dim == 64)
    return launch(flash_bwd_dkv_kernel<__nv_bfloat16, 64>,
                  dkv_smem_bytes<64>(), p, grid, s);
  if (dtype == 1 && head_dim == 128)
    return launch(flash_bwd_dkv_kernel<__nv_bfloat16, 128>,
                  dkv_smem_bytes<128>(), p, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
