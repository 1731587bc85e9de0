// FlashAttention backward for Hopper (sm_90a): two passes from the saved
// per-row log-sum-exp, one for dq (B2) and one for dk/dv (B3), with no
// atomics, so the gradients are bit-identical from run to run.
//
// Replaces: tony_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (launched by _flash_attention_pallas_bwd). Same
// contract: s = (Q K^T) * scale in fp32 (the scale applied after the
// product); p = exp(s - lse) rebuilt from the forward's lse; dp = dO V^T;
// ds = p * (dp - delta), where delta = rowsum(dO * O) - g_lse in fp32
// [B, H, t_q]. B2 computes delta for its rows and writes it for B3, which
// runs after it on the same stream (with lse in log2 units, in rows padded
// to 4 values). B2 rounds ds to K's dtype before ds.K;
// B3 rounds p to dO's dtype before p^T.dO and ds to Q's dtype before
// ds^T.Q. All sums are fp32; dq and dk carry the scale; outputs are in the
// input dtype. Key/query tile pairs wholly above the causal diagonal are
// skipped, and only pairs that straddle it or hold tail rows or tail keys
// pay for masking (tail rows and keys are zero-filled, so they score 0,
// not -inf, and are masked explicitly). Query rows sit at the end of the
// keys (row i has position t_k - t_q + i), so a fully masked row (causal,
// t_q > t_k) gets p = 0 and zero gradients. Inputs are read through
// batch/seq/head strides with a contiguous last dimension.
//
// Bound on this card: at the training shape (B = 8, H = 16, T = 2048,
// D = 64, bf16, causal) B2 does three products over the T(T+1)/2 visible
// pairs of each head (~1.03e11 FLOP) and B3 four (~1.38e11 FLOP) against
// ~70 MB of traffic each, so both are bound by operations: ~0.10 and
// ~0.14 ms at the tensor cores' 989 TFLOP/s.
//
// bf16 (the training path): every product is a warpgroup wgmma.mma_async
// (m64nNk16, N = 64 or 128, bf16 in, fp32 accumulators; helpers in
// hopper.cuh), fed by TMA through shared memory. Each block has consumer
// warpgroups of 64 rows of its fixed operand and one producer warpgroup:
// - B2: one block per (batch*head, query tile of kM = 192 rows), heaviest
//   causal tiles first. Q, dO and O are loaded once; K and V stream through
//   a ring of kStages tiles of kN keys. S = Q K^T and dP = dO V^T read both
//   operands from shared memory; ds, packed to bf16 in registers, is the A
//   operand of dQ += dS K (N = D), K read with the transpose bit. The
//   prologue computes delta from the O and dO tiles and writes it, with
//   lse in log2 units, into rows padded to 4 values for B3.
// - B3: one block per (batch*KV head, key tile of kN keys: 192 at D 64,
//   128 at D 128), looping over the H / H_kv query heads of the KV head and
//   their live query tiles; Q and dO tiles of kM rows stream through the
//   ring with their lse and delta rows. S^T = K Q^T and dP^T = V dO^T put
//   keys on the rows, so p^T and ds^T are the register A operands of
//   dV += P^T dO and dK += dS^T Q (dO and Q read with the transpose bit).
//   dK/dV stay in registers across the whole loop: summing the group inside
//   the block is what autodiff of the JAX route's repeated K/V computes,
//   without atomics.
// What bounds this design, and what each choice does about it:
// - Tensor-core rate: only wgmma reaches it; a warpgroup's product reads
//   its B operand once per 64 rows from shared memory (mma.sync re-read it
//   per 16-row warp, which bound the old design by shared-memory
//   bandwidth), and p and ds never touch shared memory. At D 128 the
//   gradient products are m64n128k16, one instruction per 16 keys/rows.
// - Load latency and issue slots: one producer thread keeps the ring full
//   with TMA (cp.async.bulk.tensor, full/empty mbarriers), so the consumers
//   spend no instructions or registers on copies. Tiles land 128-byte
//   swizzled, the layout the wgmma descriptors read, and rows past the
//   sequence are zero-filled by the copy itself. A D = 128 row is two
//   64-column boxes; the descriptors step across both. A 1-D TMA box must
//   start 16-byte aligned, hence B3's padded lse/delta rows (which also
//   spare it a multiply and let it read them in pairs).
// - The softmax's instruction count, which at D 64 costs as much as the
//   products: exponentials on ex2.approx.ftz (exp2f chains every call
//   through one predicate register for its denormal guard), and masks as
//   one compare per element against per-row limits, in a pass of their own
//   that only tiles straddling the diagonal or holding tail rows or keys
//   run (per-element visible() tests were hoisted ahead of the products on
//   every tile).
// - Registers: the producer warpgroup gives its registers to the consumers
//   (setmaxnreg: 24 against 240 with two consumer warpgroups, 160 with
//   three). At D 128 a B3 consumer holds dK and dV (128 floats) beside S^T
//   and dP^T (64), so only two fit; three warpgroups hide more latency
//   where they fit.
// - Latency within a warpgroup: p is computed while dP's product is in
//   flight, and the other warpgroups' products run during one's softmax.
//   Keeping a tile's gradient products in flight across the next tile's
//   score products, or making the warpgroups take turns on the tensor
//   cores, measured slower (PERF.md).
// - Per-block cost (~25 % of the time at T = 2048: the fixed tiles'
//   latency, B2's delta prologue, the gap before the next block): B2 reads
//   its lse rows before the fixed tiles land. A persistent grid with a
//   static work split measured slower than the hardware's scheduling.
// - Causal imbalance: work per block differs by up to 11x at T = 2048; B2
//   issues its last (heaviest) query tiles first, B3's first key tiles are
//   the heaviest and go first, and a warpgroup whose 64 rows lie wholly
//   above the diagonal of a tile skips its products.
// The tile sizes and ring depths are flash_bwd_study.py's sweep's choice on
// an H100 (PERF.md has the table).
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

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per fp32 B2 block
constexpr int kBlockN = 64;  // keys per fp32 B3 block
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;     // B2: O, for delta
  const float* g_lse;  // B2: the cotangent of lse [B, H, t_q], or null
  const float* lse;    // [B, H, t_q]
  // B2 writes and B3 reads rows of t_pad values (t_q rounded up to 4, so
  // every head's row starts 16-byte aligned for B3's TMA): delta
  // [B * H, t_pad], then (bf16) lse * log2(e) [B * H, t_pad]; 0 past t_q.
  float* delta;
  float* lse2;
  int t_pad;
  void* dq;
  void* dk;
  void* dv;
  // element strides (batch, sequence, head) of q, k, v, dO, O and the
  // outputs
  int64_t q_s[3], k_s[3], v_s[3], do_s[3], o_s[3], dq_s[3], dk_s[3], dv_s[3];
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

// Query rows [first, first + n) clipped to t_q: the key tiles of BN keys
// they see (0 when the rows lie past t_q). A key tile is live while its
// first key is at or before the position of the last row.
template <int BN>
__device__ __forceinline__ int key_tiles_for(const Params& p, int first,
                                             int n) {
  if (first >= p.t_q) return 0;
  const int tiles = (p.t_k + BN - 1) / BN;
  if (!p.causal) return tiles;
  const int last = p.t_k - p.t_q + min(first + n, p.t_q) - 1;
  return min(tiles, last < 0 ? 0 : last / BN + 1);
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
// bf16: warpgroup products fed by TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kWgRows = 64;    // rows of one warpgroup's wgmma tile
constexpr int kBoxBytes = 128; // one 64-column swizzled row of bf16

// Byte offset of element (row, col) in a swizzled tile of `rows` rows
// (see hopper.cuh: column boxes of 64 one after another).
__device__ __forceinline__ int swz(int row, int col, int rows) {
  return (col >> 6) * rows * kBoxBytes + row * kBoxBytes +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// The register budgets of a block with `wgs` consumer warpgroups and one
// producer warpgroup: the producer gives its registers to the consumers.
template <int WGS>
struct Regs {
  static_assert(WGS >= 1 && WGS <= 3, "one to three consumer warpgroups");
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kMinBlocks = WGS == 1 ? 2 : 1;
  static constexpr int kProducer = 24;
  static constexpr int kConsumer = WGS == 1 ? 232 : WGS == 2 ? 240 : 160;
};

template <int D>
struct DqBf16 {
  static constexpr int kWarpGroups = 3;  // B2 consumers
  static constexpr int kN = 64;  // keys per streamed tile
  static_assert(kN == 64 || kN == 128, "one m64n64 or m64n128 product");
  static constexpr int kStages = D == 64 ? 4 : 2;  // K/V tiles in B2's ring
  static constexpr int kM = kWgRows * kWarpGroups;  // query rows per block
  static constexpr int kThreads = Regs<kWarpGroups>::kThreads;
  static constexpr int kFixed = kM * D * 2;    // bytes of Q, dO or O
  static constexpr int kStream = kN * D * 2;   // bytes of a K or V tile
  // Q, dO, O; K and V per stage; full/empty barriers per stage and one for
  // the fixed tiles; delta of the block's rows; 1024 bytes of alignment.
  static constexpr size_t kSmem = 1024 + 3 * (size_t)kFixed +
                                  2 * (size_t)kStages * kStream +
                                  8 * (2 * kStages + 1) + 4 * kM;
};

template <int D>
struct DkvBf16 {
  static constexpr int kWarpGroups = D == 64 ? 3 : 2;  // B3 consumers
  static constexpr int kM = 64;  // query rows per streamed tile
  static_assert(kM == 64 || kM == 128, "one m64n64 or m64n128 product");
  static constexpr int kStages = 4;  // Q/dO tiles in B3's ring
  static constexpr int kN = kWgRows * kWarpGroups;  // keys per block
  static constexpr int kThreads = Regs<kWarpGroups>::kThreads;
  static constexpr int kFixed = kN * D * 2;    // bytes of K or V
  static constexpr int kStream = kM * D * 2;   // bytes of a Q or dO tile
  static constexpr int kRowPitch = kM * 4;  // bytes of lse or delta rows
  // K, V; Q and dO per stage; lse and delta rows per stage; barriers.
  static constexpr size_t kSmem = 1024 + 2 * (size_t)kFixed +
                                  2 * (size_t)kStages * kStream +
                                  2 * (size_t)kStages * kRowPitch +
                                  8 * (2 * kStages + 1);
};

struct DqMaps {
  CUtensorMap q, k, v, dout, out;
};

struct DkvMaps {
  CUtensorMap q, k, v, dout, lse2, delta;
};

template <int D>
__global__ void __launch_bounds__(DqBf16<D>::kThreads,
                                  Regs<DqBf16<D>::kWarpGroups>::kMinBlocks)
    flash_bwd_dq_kernel_bf16(const Params p, const __grid_constant__ DqMaps m) {
  using Cfg = DqBf16<D>;
  using R = Regs<Cfg::kWarpGroups>;
  constexpr int BM = Cfg::kM, BN = Cfg::kN, S = Cfg::kStages, H2 = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_q = smem;
  unsigned char* s_do = s_q + Cfg::kFixed;
  unsigned char* s_o = s_do + Cfg::kFixed;
  unsigned char* s_k = s_o + Cfg::kFixed;    // [S] K tiles
  unsigned char* s_v = s_k + S * Cfg::kStream;  // [S] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(s_v + S * Cfg::kStream);
  uint64_t* empty = full + S;
  uint64_t* fixed = empty + S;
  float* s_delta = reinterpret_cast<float*>(fixed + 1);  // [BM]

  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh % p.n_heads;
  const int hk = h / p.group;
  // Causal work grows with the query tile: issue the last tiles first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int n_tiles = key_tiles_for<BN>(p, q0, BM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * Cfg::kWarpGroups);  // one arrival a warp
    }
    mbar_init(fixed, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (wg == Cfg::kWarpGroups) {
    // Producer: one thread issues every TMA load.
    reg_dealloc<R::kProducer>();
    if (tid == 0) {
      mbar_expect_tx(fixed, 3 * Cfg::kFixed);
#pragma unroll
      for (int c = 0; c < H2; ++c) {
        tma_load_4d(s_q + c * BM * kBoxBytes, &m.q, fixed, 64 * c, h, q0, b);
        tma_load_4d(s_do + c * BM * kBoxBytes, &m.dout, fixed, 64 * c, h, q0,
                    b);
        tma_load_4d(s_o + c * BM * kBoxBytes, &m.out, fixed, 64 * c, h, q0,
                    b);
      }
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int stage = tile % S;
        if (tile >= S) mbar_wait(&empty[stage], ((tile / S) - 1) & 1);
        mbar_expect_tx(&full[stage], 2 * Cfg::kStream);
        unsigned char* kt = s_k + stage * Cfg::kStream;
        unsigned char* vt = s_v + stage * Cfg::kStream;
#pragma unroll
        for (int c = 0; c < H2; ++c) {
          tma_load_4d(kt + c * BN * kBoxBytes, &m.k, &full[stage], 64 * c, hk,
                      tile * BN, b);
          tma_load_4d(vt + c * BN * kBoxBytes, &m.v, &full[stage], 64 * c, hk,
                      tile * BN, b);
        }
      }
    }
  } else {
    reg_alloc<R::kConsumer>();
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rw = wg * kWgRows;  // this warpgroup's first row in the block
    const int qw = q0 + rw;
    // Global reads before Q, dO and O land: the lse (and lse cotangent) of
    // the row this thread sums for delta (r), and the lse of its rows
    // row_lo and row_lo + 8 (log2 units).
    const int r = rw + (tid >> 1);
    const int64_t at_r = (int64_t)bh * p.t_q + q0 + r;
    const bool in_r = q0 + r < p.t_q;
    const float lse_r = in_r ? p.lse[at_r] : 0.f;
    const float g_lse_r = in_r && p.g_lse ? p.g_lse[at_r] : 0.f;
    const int row_lo = qw + warp * 16 + g;
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      lse2[i] = row < p.t_q ? p.lse[(int64_t)bh * p.t_q + row] * kLog2e : 0.f;
    }
    mbar_wait(fixed, 0);

    // delta = rowsum(dO * O) - g_lse in fp32 for this warpgroup's rows, two
    // threads a row, each over half of it; written for B3 and kept here.
    {
      const int half = tid & 1;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int off = swz(r, half * (D / 2) + 8 * c, BM);
        const uint4 a = *reinterpret_cast<const uint4*>(s_do + off);
        const uint4 o = *reinterpret_cast<const uint4*>(s_o + off);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(a2[i]);
          const float2 y = __bfloat1622float2(o2[i]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const int row = q0 + r;
      const float dl = in_r ? sum - g_lse_r : 0.f;
      const float l2 = lse_r * kLog2e;
      if (half == 0) {
        s_delta[r] = dl;
        if (row < p.t_pad) {
          p.delta[(int64_t)bh * p.t_pad + row] = dl;
          p.lse2[(int64_t)bh * p.t_pad + row] = l2;
        }
      }
    }
    named_sync(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) dlt[i] = s_delta[row_lo + 8 * i - q0];
    const float scale_log2 = p.scale * kLog2e;
    const int my_tiles = key_tiles_for<BN>(p, qw, kWgRows);

    float acc[D / 2];  // dQ, 64 rows x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int stage = tile % S;
      mbar_wait(&full[stage], (tile / S) & 1);
      if (tile < my_tiles) {
        const int k0 = tile * BN;
        const unsigned char* kt = s_k + stage * Cfg::kStream;
        const unsigned char* vt = s_v + stage * Cfg::kStream;
        // S = Q K^T and dP = dO V^T, both operands K-major in shared memory;
        // element i of s (and dp) is row row_lo + 8 ((i & 3) / 2), key
        // k0 + 8 (i / 4) + 2 t + i % 2.
        const uint64_t q_d = desc_k_major(s_q + rw * kBoxBytes);
        const uint64_t do_d = desc_k_major(s_do + rw * kBoxBytes);
        const uint64_t k_d = desc_k_major(kt);
        const uint64_t v_d = desc_k_major(vt);
        float s[BN / 2], dp[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<BN>(s, desc_add(q_d, (ks >> 2) * BM * kBoxBytes +
                                            (ks & 3) * 32),
                       desc_add(k_d, (ks >> 2) * BN * kBoxBytes +
                                         (ks & 3) * 32),
                       ks > 0);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<BN>(dp, desc_add(do_d, (ks >> 2) * BM * kBoxBytes +
                                              (ks & 3) * 32),
                       desc_add(v_d, (ks >> 2) * BN * kBoxBytes +
                                         (ks & 3) * 32),
                       ks > 0);
        wgmma_commit();
        // p while dP is still in flight.
        wgmma_wait<1>();
        fence_acc<BN / 2>(s);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const float pv = ex2(fmaf(s[i], scale_log2, -lse2[(i & 3) >> 1]));
          s[i] = pv;
        }
        // Only tiles that straddle the diagonal or hold tail rows or keys
        // pay for the mask: p is zeroed past each row's last visible key,
        // `lim` columns from this thread's first one.
        if (tile_needs_mask<kWgRows, BN>(p, qw, k0)) {
          int lim[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row_lo + 8 * r;
            const int last = row >= p.t_q ? -1
                             : p.causal   ? min(p.t_k - 1, p.t_k - p.t_q + row)
                                          : p.t_k - 1;
            lim[r] = last - k0 - 2 * t;
          }
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            if (8 * (i >> 2) + (i & 1) > lim[(i & 3) >> 1]) s[i] = 0.f;
        }
        wgmma_wait<0>();
        fence_acc<BN / 2>(dp);
        // ds = p (dp - delta), rounded to bf16 as the A operand of dQ += dS K.
        uint32_t dsa[BN / 16][4];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          s[i] = s[i] * (dp[i] - dlt[(i & 3) >> 1]);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) pack_a(dsa[kk], &s[8 * kk]);
        wgmma_fence();
        const uint64_t kt_d = desc_mn_major(kt, BN * kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_tb<D>(acc, dsa[kk], desc_add(kt_d, kk * 16 * kBoxBytes));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<D / 2>(acc);
      }
      // This warp's reads of the stage are done (its products waited for).
      if (lane == 0) mbar_arrive(&empty[stage]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + 8 * i;
      if (row >= p.t_q) continue;
      bf16* dq_row = static_cast<bf16*>(p.dq) + b * p.dq_s[0] +
                     h * p.dq_s[2] + (int64_t)row * p.dq_s[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * p.scale,
                                  acc[4 * j + 2 * i + 1] * p.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DkvBf16<D>::kThreads,
                                  Regs<DkvBf16<D>::kWarpGroups>::kMinBlocks)
    flash_bwd_dkv_kernel_bf16(const Params p,
                              const __grid_constant__ DkvMaps m) {
  using Cfg = DkvBf16<D>;
  using R = Regs<Cfg::kWarpGroups>;
  constexpr int BN = Cfg::kN, BM = Cfg::kM, S = Cfg::kStages, H2 = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_k = smem;
  unsigned char* s_v = s_k + Cfg::kFixed;
  unsigned char* s_q = s_v + Cfg::kFixed;       // [S] Q tiles
  unsigned char* s_do = s_q + S * Cfg::kStream;  // [S] dO tiles
  // [S] lse rows, then [S] delta rows, kRowPitch bytes each
  unsigned char* s_lse = s_do + S * Cfg::kStream;
  unsigned char* s_dl = s_lse + S * Cfg::kRowPitch;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_dl + S * Cfg::kRowPitch);
  uint64_t* empty = full + S;
  uint64_t* fixed = empty + S;

  const int b = blockIdx.x / p.n_kv_heads;
  const int hk = blockIdx.x % p.n_kv_heads;
  // The first key tiles, the heaviest under a causal mask, are issued first.
  const int k0 = blockIdx.y * BN;
  // One flat loop over (query head of the group, live query tile).
  const int first = first_query_tile<BM>(p, k0);
  const int n_q = max((p.t_q + BM - 1) / BM - first, 0);
  const int total = p.group * n_q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * Cfg::kWarpGroups);  // one arrival a warp
    }
    mbar_init(fixed, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  if (wg == Cfg::kWarpGroups) {
    reg_dealloc<R::kProducer>();
    if (tid == 0) {
      mbar_expect_tx(fixed, 2 * Cfg::kFixed);
#pragma unroll
      for (int c = 0; c < H2; ++c) {
        tma_load_4d(s_k + c * BN * kBoxBytes, &m.k, fixed, 64 * c, hk, k0, b);
        tma_load_4d(s_v + c * BN * kBoxBytes, &m.v, fixed, 64 * c, hk, k0, b);
      }
      for (int it = 0; it < total; ++it) {
        const int stage = it % S;
        const int h = hk * p.group + it / n_q;
        const int q0 = (first + it % n_q) * BM;
        if (it >= S) mbar_wait(&empty[stage], ((it / S) - 1) & 1);
        mbar_expect_tx(&full[stage],
                       2 * Cfg::kStream + 2 * Cfg::kRowPitch);
        unsigned char* qt = s_q + stage * Cfg::kStream;
        unsigned char* dot = s_do + stage * Cfg::kStream;
#pragma unroll
        for (int c = 0; c < H2; ++c) {
          tma_load_4d(qt + c * BM * kBoxBytes, &m.q, &full[stage], 64 * c, h,
                      q0, b);
          tma_load_4d(dot + c * BM * kBoxBytes, &m.dout, &full[stage], 64 * c,
                      h, q0, b);
        }
        // lse (log2 units) and delta of rows [q0, q0 + BM) of head (b, h);
        // rows past t_pad read the next head's values (or zeros at the
        // end), which the mask never lets through.
        const int at = (b * p.n_heads + h) * p.t_pad + q0;
        tma_load_1d(s_lse + stage * Cfg::kRowPitch, &m.lse2, &full[stage],
                    at);
        tma_load_1d(s_dl + stage * Cfg::kRowPitch, &m.delta, &full[stage],
                    at);
      }
    }
  } else {
    reg_alloc<R::kConsumer>();
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rw = wg * kWgRows;  // this warpgroup's first key in the block
    const int kw = k0 + rw;
    const int key_lo = kw + warp * 16 + g;  // this thread's keys: +0 and +8
    const float scale_log2 = p.scale * kLog2e;
    float acc_dk[D / 2], acc_dv[D / 2];  // dK, dV: 64 keys x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    mbar_wait(fixed, 0);

    for (int it = 0; it < total; ++it) {
      const int stage = it % S;
      const int q0 = (first + it % n_q) * BM;
      mbar_wait(&full[stage], (it / S) & 1);
      // Key tiles past t_k, or wholly after the last row's position, see
      // nothing of this query tile.
      const bool dead = kw >= p.t_k ||
                        (p.causal && kw > p.t_k - p.t_q + q0 + BM - 1);
      if (!dead) {
        const unsigned char* qt = s_q + stage * Cfg::kStream;
        const unsigned char* dot = s_do + stage * Cfg::kStream;
        const float* lse2 =
            reinterpret_cast<const float*>(s_lse + stage * Cfg::kRowPitch);
        const float* dl =
            reinterpret_cast<const float*>(s_dl + stage * Cfg::kRowPitch);
        // S^T = K Q^T and dP^T = V dO^T: keys as rows, queries as columns;
        // element i of st (and dpt) is key key_lo + 8 ((i & 3) / 2), query
        // q0 + 8 (i / 4) + 2 t + i % 2.
        const uint64_t k_d = desc_k_major(s_k + rw * kBoxBytes);
        const uint64_t v_d = desc_k_major(s_v + rw * kBoxBytes);
        const uint64_t q_d = desc_k_major(qt);
        const uint64_t do_d = desc_k_major(dot);
        float st[BM / 2], dpt[BM / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<BM>(st, desc_add(k_d, (ks >> 2) * BN * kBoxBytes +
                                             (ks & 3) * 32),
                       desc_add(q_d, (ks >> 2) * BM * kBoxBytes +
                                         (ks & 3) * 32),
                       ks > 0);
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<BM>(dpt, desc_add(v_d, (ks >> 2) * BN * kBoxBytes +
                                              (ks & 3) * 32),
                       desc_add(do_d, (ks >> 2) * BM * kBoxBytes +
                                          (ks & 3) * 32),
                       ks > 0);
        wgmma_commit();
        // p^T while dP^T is still in flight.
        wgmma_wait<1>();
        fence_acc<BM / 2>(st);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv =
                ex2(fmaf(st[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
            st[4 * j + e] = pv;
          }
        }
        // Only tiles that straddle the diagonal or hold tail rows or keys
        // pay for the mask: each key row sees the queries [lo, hi], in
        // columns from this thread's first one (none past t_k).
        if (tile_needs_mask<BM, kWgRows>(p, q0, kw)) {
          const int hi = p.t_q - 1 - q0 - 2 * t;
          int lo[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = key_lo + 8 * r;
            lo[r] = key >= p.t_k ? (1 << 30)
                    : p.causal   ? key - (p.t_k - p.t_q) - q0 - 2 * t
                                 : -(1 << 30);
          }
#pragma unroll
          for (int i = 0; i < BM / 2; ++i) {
            const int c = 8 * (i >> 2) + (i & 1);
            if (c < lo[(i & 3) >> 1] || c > hi) st[i] = 0.f;
          }
        }
        wgmma_wait<0>();
        fence_acc<BM / 2>(dpt);
        // ds^T = p^T (dp^T - delta); p^T rounded to dO's dtype and ds^T to
        // Q's, as the A operands of dV += P^T dO and dK += dS^T Q.
        uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * j + e] =
                st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          pack_a(pa[kk], &st[8 * kk]);
          pack_a(dsa[kk], &dpt[8 * kk]);
        }
        wgmma_fence();
        const uint64_t dot_d = desc_mn_major(dot, BM * kBoxBytes);
        const uint64_t qt_d = desc_mn_major(qt, BM * kBoxBytes);
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          wgmma_rs_tb<D>(acc_dv, pa[kk], desc_add(dot_d, kk * 16 * kBoxBytes));
          wgmma_rs_tb<D>(acc_dk, dsa[kk], desc_add(qt_d, kk * 16 * kBoxBytes));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<D / 2>(acc_dv);
        fence_acc<D / 2>(acc_dk);
      }
      // This warp's reads of the stage are done (its products waited for).
      if (lane == 0) mbar_arrive(&empty[stage]);
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
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc_dk[4 * j + 2 * i] * p.scale,
                                  acc_dk[4 * j + 2 * i + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc_dv[4 * j + 2 * i],
                                  acc_dv[4 * j + 2 * i + 1]);
      }
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
    s_lse[threadIdx.x] = in ? p.lse[(int64_t)bh * p.t_q + row] : 0.f;
    s_delta[threadIdx.x] = in ? p.delta[(int64_t)bh * p.t_pad + row] : 0.f;
  }
}

// B2's rows [q0, q0 + 64) of head (b, h): their lse, and delta =
// rowsum(dO * O) - g_lse in fp32, four lanes a row; delta is written for B3
// too. Zero past t_q.
template <int D>
__device__ __forceinline__ void delta_rows(float* s_lse, float* s_delta,
                                           const Params& p, int b, int h,
                                           int bh, int q0) {
  const int r = threadIdx.x >> 2;
  const int c4 = threadIdx.x & 3;
  const int row = q0 + r;
  const bool in = row < p.t_q;
  float sum = 0.f;
  if (in) {
    const float* o_row = static_cast<const float*>(p.out) + b * p.o_s[0] +
                         h * p.o_s[2] + (int64_t)row * p.o_s[1];
    const float* do_row = static_cast<const float*>(p.dout) + b * p.do_s[0] +
                          h * p.do_s[2] + (int64_t)row * p.do_s[1];
#pragma unroll 4
    for (int k = 0; k < D / 4; ++k)
      sum = fmaf(do_row[c4 + 4 * k], o_row[c4 + 4 * k], sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (c4 == 0) {
    const int64_t at = (int64_t)bh * p.t_q + row;
    float dl = 0.f;
    if (in) {
      dl = p.g_lse ? sum - p.g_lse[at] : sum;
      p.delta[(int64_t)bh * p.t_pad + row] = dl;
    }
    s_lse[r] = in ? p.lse[at] : 0.f;
    s_delta[r] = dl;
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
  delta_rows<D>(s_lse, s_delta, p, b, h, bh, q0);

  const int ty = tid >> 4;  // score layout
  const int tx = tid & 15;
  const int r = tid >> 2;   // row layout: four lanes per query row
  const int c4 = tid & 3;

  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.f;

  const int n_tiles = key_tiles_for<kBlockN>(p, q0, kBlockM);
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
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int threads, dim3 grid,
                   cudaStream_t stream, const Args&... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Tensor maps are built on every launch from the tensors' pointers, sizes
// and strides (a host call of a few microseconds) and passed by value.
template <int D>
cudaError_t launch_dq_bf16(const Params& p, int batch, cudaStream_t s) {
  using Cfg = DqBf16<D>;
  DqMaps m;
  const bool ok =
      hopper::map_bthd(&m.q, p.q, D, p.n_heads, p.t_q, batch, p.q_s,
                       Cfg::kM) &&
      hopper::map_bthd(&m.dout, p.dout, D, p.n_heads, p.t_q, batch, p.do_s,
                       Cfg::kM) &&
      hopper::map_bthd(&m.out, p.out, D, p.n_heads, p.t_q, batch, p.o_s,
                       Cfg::kM) &&
      hopper::map_bthd(&m.k, p.k, D, p.n_kv_heads, p.t_k, batch, p.k_s,
                       Cfg::kN) &&
      hopper::map_bthd(&m.v, p.v, D, p.n_kv_heads, p.t_k, batch, p.v_s,
                       Cfg::kN);
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid(batch * p.n_heads, (p.t_q + Cfg::kM - 1) / Cfg::kM);
  return launch(flash_bwd_dq_kernel_bf16<D>, Cfg::kSmem, Cfg::kThreads, grid,
                s, p, m);
}

template <int D>
cudaError_t launch_dkv_bf16(const Params& p, int batch, cudaStream_t s) {
  using Cfg = DkvBf16<D>;
  DkvMaps m;
  const uint64_t rows = (uint64_t)batch * p.n_heads * p.t_pad;
  const bool ok =
      hopper::map_bthd(&m.k, p.k, D, p.n_kv_heads, p.t_k, batch, p.k_s,
                       Cfg::kN) &&
      hopper::map_bthd(&m.v, p.v, D, p.n_kv_heads, p.t_k, batch, p.v_s,
                       Cfg::kN) &&
      hopper::map_bthd(&m.q, p.q, D, p.n_heads, p.t_q, batch, p.q_s,
                       Cfg::kM) &&
      hopper::map_bthd(&m.dout, p.dout, D, p.n_heads, p.t_q, batch, p.do_s,
                       Cfg::kM) &&
      hopper::map_f32(&m.lse2, p.lse2, rows, Cfg::kM) &&
      hopper::map_f32(&m.delta, p.delta, rows, Cfg::kM);
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid(batch * p.n_kv_heads, (p.t_k + Cfg::kN - 1) / Cfg::kN);
  return launch(flash_bwd_dkv_kernel_bf16<D>, Cfg::kSmem, Cfg::kThreads, grid,
                s, p, m);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, void* delta, int batch,
                   int n_heads, int n_kv_heads, int t_q, int t_k, float scale,
                   int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.t_pad = (t_q + 3) & ~3;
  p.delta = static_cast<float*>(delta);
  p.lse2 = p.delta + (int64_t)batch * n_heads * p.t_pad;
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

// Shapes: q/dO/O/dq [B, t_q, H, D], k/v [B, t_k, H_kv, D]; lse and g_lse
// [B, H, t_q] f32, contiguous (g_lse may be null: no lse cotangent);
// `delta` is fp32 scratch of 2 x B x H x t_pad values (t_pad = t_q rounded
// up to 4), 16-byte aligned. Writes dq, and into the scratch delta =
// rowsum(dO * O) - g_lse and lse * log2(e) for tony_flash_bwd_dkv.
// `strides` holds the (batch, seq, head) element strides of q, k, v, dO, dq
// and O in that order (18 values); the last dimension is contiguous, and
// for bf16 the bases and every stride are 16-byte aligned (TMA). dtype
// codes: 0 = float32, 1 = bfloat16; head_dim 64 or 128. Returns a
// cudaError_t value (0 on success); asynchronous on `stream`.
extern "C" int tony_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 void* delta, void* dq, const void* out,
                                 const void* g_lse, const int64_t* strides,
                                 int batch, int n_heads, int n_kv_heads,
                                 int t_q, int t_k, int head_dim, float scale,
                                 int causal, int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, batch, n_heads,
                         n_kv_heads, t_q, t_k, scale, causal);
  p.dq = dq;
  p.out = out;
  p.g_lse = static_cast<const float*>(g_lse);
  copy3(p.q_s, strides);
  copy3(p.k_s, strides + 3);
  copy3(p.v_s, strides + 6);
  copy3(p.do_s, strides + 9);
  copy3(p.dq_s, strides + 12);
  copy3(p.o_s, strides + 15);
  const dim3 grid(batch * n_heads, (t_q + kBlockM - 1) / kBlockM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_bwd_dq_kernel_fp32<64>, dq_smem_fp32<64>(),
                  kThreads32, grid, s, p);
  if (dtype == 0 && head_dim == 128)
    return launch(flash_bwd_dq_kernel_fp32<128>, dq_smem_fp32<128>(),
                  kThreads32, grid, s, p);
  if (dtype == 1 && head_dim == 64) return launch_dq_bf16<64>(p, batch, s);
  if (dtype == 1 && head_dim == 128) return launch_dq_bf16<128>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As tony_flash_bwd_dq, reading delta and writing dk and dv
// [B, t_k, H_kv, D]; `strides` holds those of q, k, v, dO, dk, dv (18
// values).
extern "C" int tony_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  void* delta, void* dk, void* dv,
                                  const int64_t* strides, int batch,
                                  int n_heads, int n_kv_heads, int t_q,
                                  int t_k, int head_dim, float scale,
                                  int causal, int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, batch, n_heads,
                         n_kv_heads, t_q, t_k, scale, causal);
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
                  kThreads32, grid, s, p);
  if (dtype == 0 && head_dim == 128)
    return launch(flash_bwd_dkv_kernel_fp32<128>, dkv_smem_fp32<128>(),
                  kThreads32, grid, s, p);
  if (dtype == 1 && head_dim == 64) return launch_dkv_bf16<64>(p, batch, s);
  if (dtype == 1 && head_dim == 128) return launch_dkv_bf16<128>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
