// FlashAttention-2 forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V
// with an online softmax over key tiles, plus the per-row log-sum-exp.
//
// Replaces: tony_tpu/ops/attention.py::_flash_fwd_kernel (launched by
// _flash_attention_pallas). Same contract: s = (Q K^T) * scale in fp32, the
// scale applied after the product; the running max m and sum l in fp32, l
// summing the fp32 p; p rounded to V's dtype only as the operand of P.V,
// accumulated in fp32; key tiles wholly above the causal diagonal are
// skipped and only tiles that straddle the diagonal or hold tail keys pay
// for masking; when t_q != t_k the queries sit at the end of the keys
// (query row i has position t_k - t_q + i). A fully masked row yields O = 0
// and lse = log(1e-30). O is written in the input dtype, lse in fp32
// [B, H, t_q]. GQA is resolved by indexing: query head h reads KV head
// h / (H / H_kv), so K/V are never repeated. Inputs are read through
// batch/seq/head strides with a contiguous last dimension, so the q/k/v
// views of a fused projection go in without a copy.
//
// Bound on this card: at the training shape (B = 8, H = 16, T = 2048,
// D = 64, bf16, causal) the two products over the T(T+1)/2 visible pairs of
// each head are ~6.9e10 FLOP against ~34 MB of q/k/v/o/lse traffic, so it
// is bound by operations: ~0.0695 ms at the tensor cores' 989 TFLOP/s. At
// the generate prefill (B*H = 8*16, T = 128) it is bound by bytes.
//
// bf16 (the training and serving path): FA2's forward on the tensor cores
// through mma.sync.m16n8k16 (bf16 in, fp32 accumulators; helpers in
// mma_sync.cuh). One block of 4 warps per (batch*head, query tile of 128
// rows at D 64, 64 at D 128); each warp owns 32 or 16 of its rows, and its
// Q A-fragments stay in registers across the key loop. S = Q K^T lands in
// accumulator registers (K read as the B operand with ldmatrix), the online
// softmax runs there (row max and sum over the 4 lanes of a row by
// shuffles; the sum is kept per lane and reduced once at the end), p is
// packed to bf16 straight into the A operand of O += P V (V read with
// ldmatrix.trans), and O stays in registers. What bounds this design, and
// what it does about it:
// - mma.sync is not wgmma: Hopper's full tensor-core rate needs warpgroup
//   products; mma.sync reaches a fraction of it. wgmma + TMA is later work.
// - Shared-memory bandwidth: every warp reads the streamed K/V B-fragments
//   itself, ~16 FLOP per byte read per 16 rows it owns, against 128 bytes
//   per clock per SM. So tiles are bf16, rows are padded by 16 bytes so each
//   ldmatrix phase touches 8 distinct bank groups, the score tile never
//   goes through shared memory, and a warp may own 32 rows (two m-tiles
//   sharing each B-fragment) where registers allow it.
// - Load latency: K/V tiles are copied with cp.async, 16 bytes a thread,
//   rows past t_k zero-filled (they score 0, not -inf, so tiles holding
//   tail keys mask them explicitly), double-buffered so the next tile lands
//   during this one.
// - Registers, which bound the blocks per SM: a thread holds BN/2 (S),
//   D/2 (O) and D/4 (Q) floats per 16 rows its warp owns, so 32-row warps
//   fit only at D 64 (254 registers, 2 blocks per SM).
// - Causal imbalance: work per block differs by up to 32x at T = 2048, so
//   the last (heaviest) query tiles are issued first.
// The tile sizes (kM rows per block, kN keys per streamed tile) come from
// flash_bwd_study.py's fwd-sweep on an H100 at the training shape (D 64)
// and at [8, 2048, 8, 128]: at D 64, 128-row blocks with 64-key tiles ran
// 0.305 ms against 0.352-0.356 for 64-row blocks (32-key tiles 0.325;
// 128-key tiles slower, and they spill at 128 rows); at D 128 every
// 128-row block spills, and 64-row blocks ran 0.320 ms with 64-key tiles,
// 0.322 with 32 and 0.521 with 128 (which spill). PERF.md has the table.
//
// fp32: the tensor cores have no exact fp32 product (TF32 keeps 10 mantissa
// bits), so fp32 keeps the FMA design: one block of 256 threads per
// (batch*head, 64-row query tile); the query tile and each 64-row K/V tile
// are staged in shared memory as fp32 (rows padded by one float so the
// column walks of QK^T are free of bank conflicts); the score tile goes
// through shared memory, because the thread layout that computes it (a 4x4
// block of scores per thread) differs from the one that owns a row for the
// softmax and for P.V (four threads per row, each holding a quarter of the
// row's D outputs in registers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tc::load_tile_async;

constexpr float kNegInf = -1e30f;
constexpr float kMaskedBelow = kNegInf * 0.5f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Key tiles of BN keys that query rows [q0, q0 + BM) see: a tile is live
// while its first key is at or before the position of the last row.
template <int BM, int BN>
__device__ __forceinline__ int live_key_tiles(const Params& p, int q0) {
  const int n = (p.t_k + BN - 1) / BN;
  if (!p.causal) return n;
  const int last = p.t_k - p.t_q + q0 + BM - 1;
  return min(n, last < 0 ? 0 : last / BN + 1);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct FwdBf16 {
  static constexpr int kThreads = 128;  // 4 warps
  static constexpr int kM = D == 64 ? 128 : 64;  // query rows per block
  static constexpr int kN = 64;  // keys per streamed tile
  static constexpr int kLd = D + 8;     // padded row stride
  // Q [kM][kLd]; K, V [2][kN][kLd]
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)(kM + 4 * kN) * kLd;
};

template <int D>
__global__ void __launch_bounds__(FwdBf16<D>::kThreads)
    flash_fwd_kernel_bf16(const Params p) {
  using Cfg = FwdBf16<D>;
  constexpr int BM = Cfg::kM, BN = Cfg::kN, LD = Cfg::kLd, KS = D / 16;
  constexpr int NT = Cfg::kThreads;
  constexpr int MT = BM / 64;  // 16-row m-tiles per warp
  static_assert(BM % 64 == 0 && BN % 16 == 0, "tile sizes");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // [BM][LD]
  bf16* s_k = s_q + BM * LD;                  // [2][BN][LD]
  bf16* s_v = s_k + 2 * BN * LD;              // [2][BN][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh % p.n_heads;
  const int hk = h / p.group;
  // Causal work grows with the query tile: issue the last tiles first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int q_off = p.t_k - p.t_q;

  const bf16* q_base = static_cast<const bf16*>(p.q) + b * p.q_sb +
                       h * p.q_sh;
  const bf16* k_base = static_cast<const bf16*>(p.k) + b * p.k_sb +
                       hk * p.k_sh;
  const bf16* v_base = static_cast<const bf16*>(p.v) + b * p.v_sb +
                       hk * p.v_sh;
  const int n_tiles = live_key_tiles<BM, BN>(p, q0);

  auto load_kv = [&](int tile) {
    const int buf = (tile & 1) * BN * LD;
    load_tile_async<BN, D, NT>(s_k + buf, k_base, p.k_st, tile * BN, p.t_k);
    load_tile_async<BN, D, NT>(s_v + buf, v_base, p.v_st, tile * BN, p.t_k);
  };
  load_tile_async<BM, D, NT>(s_q, q_base, p.q_st, q0, p.t_q);
  if (n_tiles > 0) load_kv(0);
  tc::cp_async_commit();

  // This warp's query rows: m-tile mt holds rows row0 + 16 mt + g and + 8.
  const int row0 = q0 + warp * 16 * MT;
  const float scale_log2 = p.scale * kLog2e;

  float acc[MT][D / 8][4];
  float m_i[MT][2], l_i[MT][2];  // running max (raw scores), lane's sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_i[mt][i] = kNegInf;
      l_i[mt][i] = 0.f;
    }
  }

  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      tc::ldmatrix_x4(qa[mt][ks],
                      s_q + tc::a_frag(lane, row0 - q0 + 16 * mt, ks * 16,
                                       LD));

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // this tile's copies from every thread have landed
    const bf16* kt = s_k + (tile & 1) * BN * LD;
    const bf16* vt = s_v + (tile & 1) * BN * LD;
    const int k0 = tile * BN;

    // S = Q K^T: element e of n-tile n is row +8 (e / 2), key
    // k0 + 8 n + 2 t + e % 2.
    float s[MT][BN / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int np = 0; np < BN / 16; ++np)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, kt + tc::b_frag(lane, np * 16, ks * 16, LD));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma_bf16(s[mt][2 * np], qa[mt][ks], kb[0], kb[1]);
          tc::mma_bf16(s[mt][2 * np + 1], qa[mt][ks], kb[2], kb[3]);
        }
      }

    // Only tiles holding tail keys or straddling the diagonal are masked.
    const bool needs_mask = (k0 + BN > p.t_k) ||
                            (p.causal && k0 + BN - 1 > q_off + q0);
    if (needs_mask) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q_pos = q_off + row0 + 16 * mt + g + 8 * (e >> 1);
            const int k_pos = k0 + 8 * n + 2 * t + (e & 1);
            if (k_pos >= p.t_k || (p.causal && q_pos < k_pos))
              s[mt][n][e] = kNegInf;
          }
    }

    // Online softmax on rows g and g + 8 of each m-tile; the four lanes of
    // a row agree on m.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float m_new[2], neg[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m_i[mt][i];
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * i], s[mt][n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        m_new[i] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // Fully masked so far: shift by 0 so the exponentials stay finite
        // (masked scores then give exactly 0).
        const float m_safe = m_new[i] <= kMaskedBelow ? 0.f : m_new[i];
        alpha[i] = m_i[mt][i] <= kMaskedBelow
                       ? 0.f
                       : exp2f((m_i[mt][i] - m_safe) * scale_log2);
        neg[i] = -m_safe * scale_log2;
      }
      float p_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = exp2f(fmaf(s[mt][n][e], scale_log2, neg[e >> 1]));
          p_sum[e >> 1] += pv;
          s[mt][n][e] = pv;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_i[mt][i] = l_i[mt][i] * alpha[i] + p_sum[i];
        m_i[mt][i] = m_new[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= alpha[e >> 1];
    }

    // O += P V: p rounded to bf16 as the A operand, V as B via .trans.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::c_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        const int at = tc::b_frag_trans(lane, kk * 16, dn * 16, LD);
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, vt + at);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma_bf16(acc[mt][2 * dn], pa[mt], vb[0], vb[1]);
          tc::mma_bf16(acc[mt][2 * dn + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // reads of this buffer are done before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_i[mt][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 16 * mt + g + 8 * i;
      if (row >= p.t_q) continue;
      l = fmaxf(l, 1e-30f);
      bf16* o_row = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh +
                    (int64_t)row * p.o_st;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[mt][n][2 * i] / l,
                                  acc[mt][n][2 * i + 1] / l);
      if (t == 0) {
        const float m = m_i[mt][i];
        p.lse[(int64_t)bh * p.t_q + row] =
            (m <= kMaskedBelow ? 0.f : m * p.scale) + logf(l);
      }
    }
}

// ---------------------------------------------------------------------------
// fp32: FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int kBlockM32 = 64;  // query rows per block
constexpr int kBlockN32 = 64;  // keys per tile
constexpr int kThreads32 = 256;

// Stage rows [row0, row0 + 64) of one head into shared memory with a padded
// row stride of D + 1; rows at or past n_rows are zero (zero V rows keep
// 0 * garbage out of the accumulator for masked tail keys).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int kVecPerRow = D / 4;
  constexpr int kTotal = 64 * kVecPerRow;
  for (int i = threadIdx.x; i < kTotal; i += kThreads32) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float* out = dst + r * (D + 1) + c;
    const int row = row0 + r;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows)
      raw = *reinterpret_cast<const float4*>(src + (int64_t)row * row_stride +
                                             c);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
}

template <int D>
constexpr size_t smem_fp32() {
  return sizeof(float) * ((size_t)(kBlockM32 + 2 * kBlockN32) * (D + 1) +
                          kBlockM32 * (kBlockN32 + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads32)
    flash_fwd_kernel_fp32(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kLdS = kBlockN32 + 1;
  constexpr int kCols = D / 4;  // output columns owned by each thread
  extern __shared__ float smem32[];
  float* s_q = smem32;                  // [64][D + 1]
  float* s_k = s_q + kBlockM32 * kLd;   // [64][D + 1]
  float* s_v = s_k + kBlockN32 * kLd;   // [64][D + 1]
  float* s_s = s_v + kBlockN32 * kLd;   // [64][65]: scores, then P

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh % p.n_heads;
  const int hk = h / p.group;
  const int q0 = blockIdx.y * kBlockM32;
  const int q_off = p.t_k - p.t_q;

  const float* q_base = static_cast<const float*>(p.q) + b * p.q_sb +
                        h * p.q_sh;
  const float* k_base = static_cast<const float*>(p.k) + b * p.k_sb +
                        hk * p.k_sh;
  const float* v_base = static_cast<const float*>(p.v) + b * p.v_sb +
                        hk * p.v_sh;

  load_tile<D>(s_q, q_base, p.q_st, q0, p.t_q);

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

  const int n_tiles = live_key_tiles<kBlockM32, kBlockN32>(p, q0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockN32;
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile<D>(s_k, k_base, p.k_st, k0, p.t_k);
    load_tile<D>(s_v, v_base, p.v_st, k0, p.t_k);
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
        (k0 + kBlockN32 > p.t_k) ||
        (p.causal && k0 + kBlockN32 - 1 > q_off + q0);
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
    float sv[kBlockN32 / 4];
    float row_max = kNegInf;
#pragma unroll
    for (int m = 0; m < kBlockN32 / 4; ++m) {
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
    for (int m = 0; m < kBlockN32 / 4; ++m) {
      const float pv = sv[m] <= kMaskedBelow ? 0.f : expf(sv[m] - m_safe);
      p_sum += pv;
      s_s[r * kLdS + c4 + 4 * m] = pv;
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
    for (int j = 0; j < kBlockN32; ++j) {
      const float pj = s_s[r * kLdS + j];
      const float* v_row = s_v + j * kLd + c4;
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] = fmaf(pj, v_row[4 * k], acc[k]);
    }
  }

  const int q_row = q0 + r;
  if (q_row < p.t_q) {
    const float l = fmaxf(l_i, 1e-30f);
    float* o_row = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                   (int64_t)q_row * p.o_st;
#pragma unroll
    for (int k = 0; k < kCols; ++k) o_row[c4 + 4 * k] = acc[k] / l;
    if (c4 == 0) {
      p.lse[(int64_t)bh * p.t_q + q_row] =
          (m_i <= kMaskedBelow ? 0.f : m_i) + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The shared-memory attribute belongs to the current device, so it is set on
// every launch (a cheap host call) rather than once per process.
template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int threads, const Params& p,
                   dim3 grid, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int bh, cudaStream_t stream) {
  using Cfg = FwdBf16<D>;
  const dim3 grid(bh, (p.t_q + Cfg::kM - 1) / Cfg::kM);
  return launch(flash_fwd_kernel_bf16<D>, Cfg::kSmem, Cfg::kThreads, p, grid,
                stream);
}

template <int D>
cudaError_t launch_fp32(const Params& p, int bh, cudaStream_t stream) {
  const dim3 grid(bh, (p.t_q + kBlockM32 - 1) / kBlockM32);
  return launch(flash_fwd_kernel_fp32<D>, smem_fp32<D>(), kThreads32, p, grid,
                stream);
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
  const int bh = batch * n_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_fp32<64>(p, bh, s);
  if (dtype == 0 && head_dim == 128) return launch_fp32<128>(p, bh, s);
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(p, bh, s);
  if (dtype == 1 && head_dim == 128) return launch_bf16<128>(p, bh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
