// FlashAttention-2 forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V
// with an online softmax over key tiles, plus the per-row log-sum-exp.
//
// Replaces: tony_tpu/ops/attention.py::_flash_fwd_kernel (launched by
// _flash_attention_pallas). Same contract: the scale is applied after QK^T in
// fp32; P is rounded to V's dtype before P.V and accumulated in fp32; key
// tiles wholly above the causal diagonal are skipped and only tiles that
// straddle the diagonal or the key tail pay for masking; when t_q != t_k the
// queries sit at the end of the keys (query row i has position
// t_k - t_q + i). A fully masked row yields O = 0 and lse = log(1e-30).
//
// Bound on this card: at the serving prefill shape (B*H = 8*16, T = 128,
// D = 64, causal) the work is ~0.27 GFLOP against ~5 MB of q/k/v/o traffic,
// so the published peaks bound it by bytes (~1.6 us); a kernel of this
// design is bound by its own instruction issue instead. This first version
// does the two products with fp32 FMAs from shared memory, not with the
// tensor cores: that keeps the arithmetic identical to the fp32 reference
// and the kernel simple. wgmma/TMA tiles are later work.
//
// Design: one block of 256 threads per (batch*head, 64-row query tile). The
// query tile and each 64-row K/V tile are staged in shared memory as fp32
// (rows padded by one float so the column walks of QK^T are free of bank
// conflicts); the score tile goes through shared memory too, because the
// thread layout that computes it (a 4x4 block of scores per thread) differs
// from the one that owns a row for the softmax and for P.V (four threads per
// row, each holding a quarter of the row's D outputs in registers). GQA is
// resolved by indexing: query head h reads KV head h / (H / H_kv), so K/V
// are never repeated. Inputs are read through explicit batch/seq/head
// strides with a contiguous last dimension, so the q/k/v views of a fused
// projection go in without a copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = kNegInf * 0.5f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, t_q]
  int64_t q_sb, q_st, q_sh;  // element strides: batch, sequence, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int n_heads;
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
// P is rounded to V's dtype before the P.V product (the TPU kernel casts p
// to v's dtype for the MXU); for fp32 inputs this is the identity.
__device__ __forceinline__ float round_like(float v, float) { return v; }
__device__ __forceinline__ float round_like(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stage rows [row0, row0 + 64) of one head into shared memory as fp32 with a
// padded row stride of D + 1; rows at or past n_rows are zero (zero V rows
// keep 0 * garbage out of the accumulator for masked tail keys).
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBlockM + 2 * kBlockN) * (D + 1) + kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kLdS = kBlockN + 1;
  constexpr int kCols = D / 4;  // output columns owned by each thread
  extern __shared__ float smem[];
  float* s_q = smem;                   // [64][D + 1]
  float* s_k = s_q + kBlockM * kLd;    // [64][D + 1]
  float* s_v = s_k + kBlockN * kLd;    // [64][D + 1]
  float* s_s = s_v + kBlockN * kLd;    // [64][65]: scores, then P

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh % p.n_heads;
  const int hk = h / p.group;
  const int q0 = blockIdx.y * kBlockM;
  const int q_off = p.t_k - p.t_q;

  const T* q_base = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k_base = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v_base = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, D>(s_q, q_base, p.q_st, q0, p.t_q);

  // Score layout: thread (ty, tx) computes rows ty + 16a, keys tx + 16b.
  const int ty = tid >> 4;
  const int tx = tid & 15;
  // Row layout: four consecutive lanes own row r; lane c4 holds keys
  // c4 + 4m of the score row and output columns c4 + 4k.
  const int r = tid >> 2;
  const int c4 = tid & 3;

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
  float m_i = kNegInf;
  float l_i = 0.f;

  int n_tiles = (p.t_k + kBlockN - 1) / kBlockN;
  if (p.causal) {
    // Causal skip: a tile is live while its first key is at or before the
    // position of this query tile's last row.
    const int last = q_off + q0 + kBlockM - 1;
    const int live = last < 0 ? 0 : last / kBlockN + 1;
    n_tiles = min(n_tiles, live);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockN;
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile<T, D>(s_k, k_base, p.k_st, k0, p.t_k);
    load_tile<T, D>(s_v, v_base, p.v_st, k0, p.t_k);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = s_q[(ty + 16 * a) * kLd + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = s_k[(tx + 16 * c) * kLd + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    // Only tiles holding tail keys or straddling the diagonal are masked.
    const bool needs_mask =
        (k0 + kBlockN > p.t_k) ||
        (p.causal && k0 + kBlockN - 1 > q_off + q0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float val = s[a][c] * p.scale;
        if (needs_mask) {
          const int k_pos = k0 + tx + 16 * c;
          const int q_pos = q_off + q0 + ty + 16 * a;
          if (k_pos >= p.t_k || (p.causal && q_pos < k_pos)) val = kNegInf;
        }
        s_s[(ty + 16 * a) * kLdS + tx + 16 * c] = val;
      }
    }
    __syncthreads();

    // Online softmax on row r (the four lanes of the row agree on m and l).
    float sv[kBlockN / 4];
    float row_max = kNegInf;
#pragma unroll
    for (int m = 0; m < kBlockN / 4; ++m) {
      sv[m] = s_s[r * kLdS + c4 + 4 * m];
      row_max = fmaxf(row_max, sv[m]);
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
    row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
    const float m_new = fmaxf(m_i, row_max);
    // Fully masked so far: shift by 0 so exp() stays finite.
    const float m_safe = m_new <= kMaskedBelow ? 0.f : m_new;
    const float alpha = m_i <= kMaskedBelow ? 0.f : expf(m_i - m_safe);
    float p_sum = 0.f;
#pragma unroll
    for (int m = 0; m < kBlockN / 4; ++m) {
      const float pv = sv[m] <= kMaskedBelow ? 0.f : expf(sv[m] - m_safe);
      p_sum += pv;
      s_s[r * kLdS + c4 + 4 * m] = round_like(pv, T());
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l_i = l_i * alpha + p_sum;
    m_i = m_new;
    // Row r's P was written by this warp's own lanes.
    __syncwarp();

#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      const float pj = s_s[r * kLdS + j];
      const float* v_row = s_v + j * kLd + c4;
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] = fmaf(pj, v_row[4 * k], acc[k]);
    }
  }

  const int q_row = q0 + r;
  if (q_row < p.t_q) {
    const float l = fmaxf(l_i, 1e-30f);
    T* o_row = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
               (int64_t)q_row * p.o_st;
#pragma unroll
    for (int k = 0; k < kCols; ++k) store_float(acc[k] / l, o_row + c4 + 4 * k);
    if (c4 == 0) {
      p.lse[(int64_t)bh * p.t_q + q_row] =
          (m_i <= kMaskedBelow ? 0.f : m_i) + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<D>();
  // The attribute belongs to the current device, so it is set on every
  // launch (a cheap host call) rather than once per process.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, t_q, H, D], k/v [B, t_k, H_kv, D], o [B, t_q, H, D], lse [B, H, t_q]
// (f32, contiguous). Strides are in elements; the last dimension is
// contiguous. dtype codes: 0 = float32, 1 = bfloat16; head_dim 64 or 128.
// Returns a cudaError_t value (0 on success); asynchronous on `stream`.
extern "C" int tony_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int64_t q_sb, int64_t q_st,
                              int64_t q_sh, int64_t k_sb, int64_t k_st,
                              int64_t k_sh, int64_t v_sb, int64_t v_st,
                              int64_t v_sh, int64_t o_sb, int64_t o_st,
                              int64_t o_sh, int batch, int n_heads,
                              int n_kv_heads, int t_q, int t_k, int head_dim,
                              float scale, int causal, int dtype,
                              void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.n_heads = n_heads;
  p.group = n_heads / n_kv_heads;
  p.t_q = t_q;
  p.t_k = t_k;
  p.scale = scale;
  p.causal = causal;
  const dim3 grid(batch * n_heads, (t_q + kBlockM - 1) / kBlockM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(p, grid, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(p, grid, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(p, grid, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(p, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
