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
// zero gradients. Inputs are read through batch/seq/head strides with a
// contiguous last dimension.
//
// Bound on this card: at the training shape (B = 8, H = 16, T = 2048,
// D = 64, bf16, causal) B2 does three products over the T(T+1)/2 visible
// pairs of each head (~1.03e11 FLOP) and B3 four (~1.38e11 FLOP) against
// ~70 MB of traffic each, so both are bound by operations: ~0.10 and
// ~0.14 ms at the tensor cores' 989 TFLOP/s.
//
// bf16 (the training path): FA2's backward on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators; helpers in mma_sync.cuh).
// Each warp owns 16 rows of the block's fixed operand and streams the other
// operand's tiles through shared memory:
// - B2: one block of 4 warps per (batch*head, 64-row query tile). The
//   warp's Q and dO A-fragments stay in registers across the key loop;
//   S = Q K^T and dP = dO V^T land in accumulator registers, ds is formed
//   there, packed to bf16 and fed straight back as the A operand of
//   dQ += dS K (K read as the B operand with ldmatrix.trans).
// - B3: one block of 4 warps per (batch*KV head, 64-key tile), looping over
//   the H / H_kv query heads of the KV head and over their query tiles.
//   It computes S^T = K Q^T and dP^T = V dO^T, so p^T and ds^T come out
//   with key rows as M and feed dV += P^T dO and dK += dS^T Q as A
//   operands (dO and Q read with ldmatrix.trans). dK/dV stay in registers
//   across both loops: summing the group inside the block is what autodiff
//   of the JAX route's repeated K/V computes, without atomics.
// What bounds this design, and what it does about it:
// - mma.sync is not wgmma: Hopper's full tensor-core rate needs warpgroup
//   products; mma.sync reaches a fraction of it. wgmma + TMA is later work.
// - Shared-memory bandwidth: every warp reads the streamed tile's B
//   fragments itself, ~16 FLOP per byte read, against 128 bytes per clock
//   per SM. So tiles are bf16 (half the bytes of fp32), rows are padded by
//   16 bytes so each ldmatrix phase touches 8 distinct bank groups, and p/ds
//   never go through shared memory.
// - Load latency: streamed tiles (K/V in B2; Q/dO with their lse/delta
//   rows in B3) are copied with cp.async, 16 bytes a thread, rows past T
//   zero-filled, double-buffered so the next tile lands during this one.
// - Registers, which bound the blocks per SM: the streamed tiles are
//   small (16 keys in B2, 32 query rows in B3), so the fp32 score tiles of
//   a warp take 8 (B2) or 16 (B3) registers each; B3 re-reads its K/V
//   A-fragments from shared memory rather than holding them. The sizes
//   come from flash_bwd_study.py's sweep on an H100: B2 is fastest with
//   16-key tiles at both head_dims (32 keys ~6 % slower; 64 slower still,
//   and they spill at D 128). B3 is fastest with 32-row query tiles at
//   D 64; at D 128, 64-row tiles were ~14 % faster but spill (255
//   registers), so B3 keeps 32 rows there too; 16-row tiles were slower
//   at both.
// - Causal imbalance: work per block differs by up to 32x; B2 issues its
//   last (heaviest) query tiles first, and B3's first key tiles, the
//   heaviest, are already issued first.
//
// fp32: the tensor cores have no exact fp32 product (TF32 keeps 10 mantissa
// bits), so fp32 keeps the FMA design: 256 threads per block, 64-row tiles
// staged in shared memory as fp32 rows padded by one float, both score
// products in one pass over D (4x4 per thread), p and ds through padded
// shared tiles to a row layout (four lanes per output row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;  // query rows per B2 block (both dtypes)
constexpr int kBlockN = 64;  // keys per B3 block (both dtypes)
constexpr float kLog2e = 1.4426950408889634f;

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

// Whether query row `q_row` (of t_q) sees key `k_pos` (of t_k).
__device__ __forceinline__ bool visible(const Params& p, int q_row,
                                        int k_pos) {
  return k_pos < p.t_k && q_row < p.t_q &&
         !(p.causal && p.t_k - p.t_q + q_row < k_pos);
}

// Whether the tile pair (BM query rows at q0, BN keys at k0) holds any
// masked pair: tail rows, tail keys or keys past the causal diagonal.
template <int BM, int BN>
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int k0) {
  return (k0 + BN > p.t_k) || (q0 + BM > p.t_q) ||
         (p.causal && k0 + BN - 1 > p.t_k - p.t_q + q0);
}

// Key tiles of BN keys that query rows [q0, q0 + BM) see.
template <int BM, int BN>
__device__ __forceinline__ int live_key_tiles(const Params& p, int q0) {
  const int n = (p.t_k + BN - 1) / BN;
  if (!p.causal) return n;
  // A key tile is live while its first key is at or before the position
  // of this query tile's last row.
  const int last = p.t_k - p.t_q + q0 + BM - 1;
  return min(n, last < 0 ? 0 : last / BN + 1);
}

// The first query tile of BM rows that sees keys from k0 on.
template <int BM>
__device__ __forceinline__ int first_query_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  // Live once its last row's position reaches k0: q_off + q0 + BM - 1 >= k0.
  const int need = k0 - (p.t_k - p.t_q) - (BM - 1);
  return need <= 0 ? 0 : (need + BM - 1) / BM;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using tc::load_tile_async;

template <int D>
struct DqBf16 {
  static constexpr int kThreads = 128;  // 4 warps x 16 query rows
  static constexpr int kN = 16;         // keys per streamed tile
  static constexpr int kLd = D + 8;     // padded row stride
  // Q, dO [64][kLd]; K, V [2][kN][kLd]
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(2 * kBlockM + 4 * kN) * kLd;
};

template <int D>
struct DkvBf16 {
  static constexpr int kThreads = 128;  // 4 warps x 16 keys
  static constexpr int kM = 32;         // query rows per streamed tile
  static constexpr int kLd = D + 8;
  // K, V [64][kLd]; Q, dO [2][kM][kLd]; lse, delta [2][kM] f32
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(2 * kBlockN + 4 * kM) * kLd +
      sizeof(float) * 4 * kM;
};

template <int D>
__global__ void __launch_bounds__(DqBf16<D>::kThreads)
    flash_bwd_dq_kernel_bf16(const Params p) {
  using Cfg = DqBf16<D>;
  constexpr int BM = kBlockM, BN = Cfg::kN, LD = Cfg::kLd, KS = D / 16;
  constexpr int NT = Cfg::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // [BM][LD]
  bf16* s_do = s_q + BM * LD;                 // [BM][LD]
  bf16* s_k = s_do + BM * LD;                 // [2][BN][LD]
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

  const bf16* q_base = static_cast<const bf16*>(p.q) + b * p.q_s[0] +
                       h * p.q_s[2];
  const bf16* do_base = static_cast<const bf16*>(p.dout) + b * p.do_s[0] +
                        h * p.do_s[2];
  const bf16* k_base = static_cast<const bf16*>(p.k) + b * p.k_s[0] +
                       hk * p.k_s[2];
  const bf16* v_base = static_cast<const bf16*>(p.v) + b * p.v_s[0] +
                       hk * p.v_s[2];
  const int n_tiles = live_key_tiles<BM, BN>(p, q0);

  auto load_kv = [&](int tile) {
    const int buf = (tile & 1) * BN * LD;
    load_tile_async<BN, D, NT>(s_k + buf, k_base, p.k_s[1], tile * BN, p.t_k);
    load_tile_async<BN, D, NT>(s_v + buf, v_base, p.v_s[1], tile * BN, p.t_k);
  };
  load_tile_async<BM, D, NT>(s_q, q_base, p.q_s[1], q0, p.t_q);
  load_tile_async<BM, D, NT>(s_do, do_base, p.do_s[1], q0, p.t_q);
  if (n_tiles > 0) load_kv(0);
  tc::cp_async_commit();

  // This lane's rows row_lo and row_lo + 8: lse (in log2 units) and delta.
  const int row_lo = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    const bool in = row < p.t_q;
    const int64_t at = (int64_t)bh * p.t_q + row;
    lse2[i] = in ? p.lse[at] * kLog2e : 0.f;
    dlt[i] = in ? p.delta[at] : 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[KS][4], doa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    tc::ldmatrix_x4(qa[ks], s_q + tc::a_frag(lane, warp * 16, ks * 16, LD));
    tc::ldmatrix_x4(doa[ks], s_do + tc::a_frag(lane, warp * 16, ks * 16, LD));
  }

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

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int np = 0; np < BN / 16; ++np)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, kt + tc::b_frag(lane, np * 16, ks * 16, LD));
        tc::ldmatrix_x4(vb, vt + tc::b_frag(lane, np * 16, ks * 16, LD));
        tc::mma_bf16(s[2 * np], qa[ks], kb[0], kb[1]);
        tc::mma_bf16(s[2 * np + 1], qa[ks], kb[2], kb[3]);
        tc::mma_bf16(dp[2 * np], doa[ks], vb[0], vb[1]);
        tc::mma_bf16(dp[2 * np + 1], doa[ks], vb[2], vb[3]);
      }

    // p and ds in the accumulator layout: element e of n-tile n is row
    // row_lo + 8 (e / 2), key k0 + 8 n + 2 t + e % 2. ds overwrites s.
    const bool needs_mask = tile_needs_mask<BM, BN>(p, q0, k0);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
        if (needs_mask &&
            !visible(p, row_lo + 8 * (e >> 1), k0 + 8 * n + 2 * t + (e & 1)))
          pv = 0.f;
        s[n][e] = pv * (dp[n][e] - dlt[e >> 1]);
      }

    // dQ += dS K: ds rounded to bf16 as the A operand, K as B via .trans.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t dsa[4];
      tc::c_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        const int at = tc::b_frag_trans(lane, kk * 16, dn * 16, LD);
        uint32_t kb[4];
        tc::ldmatrix_x4_trans(kb, kt + at);
        tc::mma_bf16(acc[2 * dn], dsa, kb[0], kb[1]);
        tc::mma_bf16(acc[2 * dn + 1], dsa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // reads of this buffer are done before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + 8 * i;
    if (row >= p.t_q) continue;
    bf16* dq_row = static_cast<bf16*>(p.dq) + b * p.dq_s[0] +
                   h * p.dq_s[2] + (int64_t)row * p.dq_s[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] * p.scale,
                                acc[n][2 * i + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvBf16<D>::kThreads)
    flash_bwd_dkv_kernel_bf16(const Params p) {
  using Cfg = DkvBf16<D>;
  constexpr int BN = kBlockN, BM = Cfg::kM, LD = Cfg::kLd, KS = D / 16;
  constexpr int NT = Cfg::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);  // [BN][LD]
  bf16* s_v = s_k + BN * LD;                  // [BN][LD]
  bf16* s_q = s_v + BN * LD;                  // [2][BM][LD]
  bf16* s_do = s_q + 2 * BM * LD;             // [2][BM][LD]
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * BM * LD);  // [2][BM]
  float* s_delta = s_lse + 2 * BM;                              // [2][BM]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / p.n_kv_heads;
  const int hk = blockIdx.x % p.n_kv_heads;
  // The first key tiles, the heaviest under a causal mask, are issued first.
  const int k0 = blockIdx.y * BN;

  load_tile_async<BN, D, NT>(
      s_k, static_cast<const bf16*>(p.k) + b * p.k_s[0] + hk * p.k_s[2],
      p.k_s[1], k0, p.t_k);
  load_tile_async<BN, D, NT>(
      s_v, static_cast<const bf16*>(p.v) + b * p.v_s[0] + hk * p.v_s[2],
      p.v_s[1], k0, p.t_k);

  // One flat loop over (query head of the group, live query tile).
  const int first = first_query_tile<BM>(p, k0);
  const int n_q = max((p.t_q + BM - 1) / BM - first, 0);
  const int total = p.group * n_q;

  auto load_q = [&](int it) {
    const int buf = it & 1;
    const int h = hk * p.group + it / n_q;
    const int q0 = (first + it % n_q) * BM;
    const int64_t rows = (int64_t)(b * p.n_heads + h) * p.t_q;
    load_tile_async<BM, D, NT>(
        s_q + buf * BM * LD,
        static_cast<const bf16*>(p.q) + b * p.q_s[0] + h * p.q_s[2],
        p.q_s[1], q0, p.t_q);
    load_tile_async<BM, D, NT>(
        s_do + buf * BM * LD,
        static_cast<const bf16*>(p.dout) + b * p.do_s[0] + h * p.do_s[2],
        p.do_s[1], q0, p.t_q);
    for (int i = threadIdx.x; i < BM; i += NT) {
      const bool valid = q0 + i < p.t_q;
      const int64_t at = rows + (valid ? q0 + i : 0);
      tc::cp_async_4(s_lse + buf * BM + i, p.lse + at, valid);
      tc::cp_async_4(s_delta + buf * BM + i, p.delta + at, valid);
    }
  };
  if (total > 0) load_q(0);
  tc::cp_async_commit();

  const int key_lo = k0 + warp * 16 + g;  // this lane's keys: +0 and +8
  const float scale_log2 = p.scale * kLog2e;
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      load_q(it + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // this tile's copies from every thread have landed
    const int buf = it & 1;
    const int q0 = (first + it % n_q) * BM;
    const bf16* qt = s_q + buf * BM * LD;
    const bf16* dot = s_do + buf * BM * LD;
    const float* lse = s_lse + buf * BM;
    const float* dl = s_delta + buf * BM;

    // S^T = K Q^T and dP^T = V dO^T: keys as rows, this tile's queries as
    // columns.
    float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      tc::ldmatrix_x4(ka, s_k + tc::a_frag(lane, warp * 16, ks * 16, LD));
      tc::ldmatrix_x4(va, s_v + tc::a_frag(lane, warp * 16, ks * 16, LD));
#pragma unroll
      for (int np = 0; np < BM / 16; ++np) {
        uint32_t qb[4], ob[4];
        tc::ldmatrix_x4(qb, qt + tc::b_frag(lane, np * 16, ks * 16, LD));
        tc::ldmatrix_x4(ob, dot + tc::b_frag(lane, np * 16, ks * 16, LD));
        tc::mma_bf16(st[2 * np], ka, qb[0], qb[1]);
        tc::mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
        tc::mma_bf16(dpt[2 * np], va, ob[0], ob[1]);
        tc::mma_bf16(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // p^T into st, ds^T into dpt: element e of n-tile n is key
    // key_lo + 8 (e / 2), query q0 + 8 n + 2 t + e % 2.
    const bool needs_mask = tile_needs_mask<BM, BN>(p, q0, k0);
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e & 1;
        float pv = exp2f(fmaf(st[n][e], scale_log2,
                              -(j ? l2.y : l2.x) * kLog2e));
        if (needs_mask && !visible(p, q0 + col + j, key_lo + 8 * (e >> 1)))
          pv = 0.f;
        dpt[n][e] = pv * (dpt[n][e] - (j ? d2.y : d2.x));
        st[n][e] = pv;
      }
    }

    // dV += P^T dO and dK += dS^T Q, p and ds rounded to bf16 as A
    // operands, dO and Q as B via .trans.
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], dsa[4];
      tc::c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      tc::c_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        const int at = tc::b_frag_trans(lane, kk * 16, dn * 16, LD);
        uint32_t ob[4], qb[4];
        tc::ldmatrix_x4_trans(ob, dot + at);
        tc::ldmatrix_x4_trans(qb, qt + at);
        tc::mma_bf16(acc_dv[2 * dn], pa, ob[0], ob[1]);
        tc::mma_bf16(acc_dv[2 * dn + 1], pa, ob[2], ob[3]);
        tc::mma_bf16(acc_dk[2 * dn], dsa, qb[0], qb[1]);
        tc::mma_bf16(acc_dk[2 * dn + 1], dsa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // reads of this buffer are done before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_lo + 8 * i;
    if (key >= p.t_k) continue;
    bf16* dk_row = static_cast<bf16*>(p.dk) + b * p.dk_s[0] +
                   hk * p.dk_s[2] + (int64_t)key * p.dk_s[1];
    bf16* dv_row = static_cast<bf16*>(p.dv) + b * p.dv_s[0] +
                   hk * p.dv_s[2] + (int64_t)key * p.dv_s[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc_dk[n][2 * i] * p.scale,
                                acc_dk[n][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc_dv[n][2 * i], acc_dv[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int kThreads32 = 256;
constexpr int kLdS = kBlockN + 1;  // padded row stride of the p / ds tiles

// Stage rows [row0, row0 + 64) of one head into shared memory with a padded
// row stride of D + 1; rows at or past n_rows are zero.
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
  if (needs_mask && !visible(p, q0 + row, k0 + col)) return 0.f;
  return expf(s * p.scale - lse);
}

template <int D>
constexpr size_t dq_smem_fp32() {
  return sizeof(float) * ((size_t)(2 * kBlockM + 2 * kBlockN) * (D + 1) +
                          kBlockM * kLdS + 2 * kBlockM);
}

template <int D>
constexpr size_t dkv_smem_fp32() {
  return sizeof(float) * ((size_t)(2 * kBlockM + 2 * kBlockN) * (D + 1) +
                          2 * kBlockM * kLdS + 2 * kBlockM);
}

template <int D>
__global__ void __launch_bounds__(kThreads32)
    flash_bwd_dq_kernel_fp32(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 4;  // output columns owned by each thread
  extern __shared__ float smem32[];
  float* s_q = smem32;                  // [64][D + 1]
  float* s_do = s_q + kBlockM * kLd;    // [64][D + 1]
  float* s_k = s_do + kBlockM * kLd;    // [64][D + 1]
  float* s_v = s_k + kBlockN * kLd;     // [64][D + 1]
  float* s_ds = s_v + kBlockN * kLd;    // [64][65]
  float* s_lse = s_ds + kBlockM * kLdS; // [64]
  float* s_delta = s_lse + kBlockM;     // [64]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh % p.n_heads;
  const int hk = h / p.group;
  const int q0 = blockIdx.y * kBlockM;

  const float* q_base =
      static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
  const float* do_base =
      static_cast<const float*>(p.dout) + b * p.do_s[0] + h * p.do_s[2];
  const float* k_base =
      static_cast<const float*>(p.k) + b * p.k_s[0] + hk * p.k_s[2];
  const float* v_base =
      static_cast<const float*>(p.v) + b * p.v_s[0] + hk * p.v_s[2];

  load_tile<D>(s_q, q_base, p.q_s[1], q0, p.t_q);
  load_tile<D>(s_do, do_base, p.do_s[1], q0, p.t_q);
  load_rows(s_lse, s_delta, p, bh, q0);

  const int ty = tid >> 4;  // score layout
  const int tx = tid & 15;
  const int r = tid >> 2;   // row layout: four lanes per query row
  const int c4 = tid & 3;

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;

  const int n_tiles = live_key_tiles<kBlockM, kBlockN>(p, q0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockN;
    __syncthreads();  // the previous tile's reads of K and ds are done
    load_tile<D>(s_k, k_base, p.k_s[1], k0, p.t_k);
    load_tile<D>(s_v, v_base, p.v_s[1], k0, p.t_k);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<D>(s_q, s_do, s_k, s_v, ty, tx, s, dp);
    const bool needs_mask = tile_needs_mask<kBlockM, kBlockN>(p, q0, k0);
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
        s_ds[row * kLdS + col] = pv * (dp[a][c] - delta);
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
    float* dq_row = static_cast<float*>(p.dq) + b * p.dq_s[0] +
                    h * p.dq_s[2] + (int64_t)q_row * p.dq_s[1];
#pragma unroll
    for (int k = 0; k < kCols; ++k) dq_row[c4 + 4 * k] = acc[k] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads32)
    flash_bwd_dkv_kernel_fp32(const Params p) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 4;
  extern __shared__ float smem32[];
  float* s_k = smem32;                  // [64][D + 1]
  float* s_v = s_k + kBlockN * kLd;     // [64][D + 1]
  float* s_q = s_v + kBlockN * kLd;     // [64][D + 1]
  float* s_do = s_q + kBlockM * kLd;    // [64][D + 1]
  float* s_p = s_do + kBlockM * kLd;    // [64 q][65]
  float* s_ds = s_p + kBlockM * kLdS;   // [64 q][65]
  float* s_lse = s_ds + kBlockM * kLdS; // [64]
  float* s_delta = s_lse + kBlockM;     // [64]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.n_kv_heads;
  const int hk = blockIdx.x % p.n_kv_heads;
  const int k0 = blockIdx.y * kBlockN;

  const float* k_base =
      static_cast<const float*>(p.k) + b * p.k_s[0] + hk * p.k_s[2];
  const float* v_base =
      static_cast<const float*>(p.v) + b * p.v_s[0] + hk * p.v_s[2];
  load_tile<D>(s_k, k_base, p.k_s[1], k0, p.t_k);
  load_tile<D>(s_v, v_base, p.v_s[1], k0, p.t_k);

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
  const int first = first_query_tile<kBlockM>(p, k0);
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const int bh = b * p.n_heads + h;
    const float* q_base =
        static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[2];
    const float* do_base =
        static_cast<const float*>(p.dout) + b * p.do_s[0] + h * p.do_s[2];
    for (int qt = first; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kBlockM;
      __syncthreads();  // the previous tile's reads of Q, dO, p, ds are done
      load_tile<D>(s_q, q_base, p.q_s[1], q0, p.t_q);
      load_tile<D>(s_do, do_base, p.do_s[1], q0, p.t_q);
      load_rows(s_lse, s_delta, p, bh, q0);
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<D>(s_q, s_do, s_k, s_v, ty, tx, s, dp);
      const bool needs_mask = tile_needs_mask<kBlockM, kBlockN>(p, q0, k0);
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
          s_p[row * kLdS + col] = pv;
          s_ds[row * kLdS + col] = pv * (dp[a][c] - delta);
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
    float* dk_row = static_cast<float*>(p.dk) + b * p.dk_s[0] +
                    hk * p.dk_s[2] + (int64_t)k_row * p.dk_s[1];
    float* dv_row = static_cast<float*>(p.dv) + b * p.dv_s[0] +
                    hk * p.dv_s[2] + (int64_t)k_row * p.dv_s[1];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      dk_row[c4 + 4 * k] = acc_dk[k] * p.scale;
      dv_row[c4 + 4 * k] = acc_dv[k];
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
    return launch(flash_bwd_dq_kernel_fp32<64>, dq_smem_fp32<64>(),
                  kThreads32, p, grid, s);
  if (dtype == 0 && head_dim == 128)
    return launch(flash_bwd_dq_kernel_fp32<128>, dq_smem_fp32<128>(),
                  kThreads32, p, grid, s);
  if (dtype == 1 && head_dim == 64)
    return launch(flash_bwd_dq_kernel_bf16<64>, DqBf16<64>::kSmem,
                  DqBf16<64>::kThreads, p, grid, s);
  if (dtype == 1 && head_dim == 128)
    return launch(flash_bwd_dq_kernel_bf16<128>, DqBf16<128>::kSmem,
                  DqBf16<128>::kThreads, p, grid, s);
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
    return launch(flash_bwd_dkv_kernel_fp32<64>, dkv_smem_fp32<64>(),
                  kThreads32, p, grid, s);
  if (dtype == 0 && head_dim == 128)
    return launch(flash_bwd_dkv_kernel_fp32<128>, dkv_smem_fp32<128>(),
                  kThreads32, p, grid, s);
  if (dtype == 1 && head_dim == 64)
    return launch(flash_bwd_dkv_kernel_bf16<64>, DkvBf16<64>::kSmem,
                  DkvBf16<64>::kThreads, p, grid, s);
  if (dtype == 1 && head_dim == 128)
    return launch(flash_bwd_dkv_kernel_bf16<128>, DkvBf16<128>::kSmem,
                  DkvBf16<128>::kThreads, p, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
