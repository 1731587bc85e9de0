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
// bf16 (the training and serving path): both products are warpgroup
// wgmma.mma_async (m64nNk16, bf16 in, fp32 accumulators; helpers in
// hopper.cuh), fed by TMA through shared memory. A work item is (batch*head,
// query tile of kM = 64 x kWarpGroups rows); a persistent grid of one block
// per SM walks the items, each block taking the next one from an atomic
// counter. A block has kWarpGroups consumer warpgroups of 64 query rows and
// one producer warpgroup, whose one thread fetches the items, loads each
// item's Q tile (kQTiles buffers) and streams its live K and V tiles of kN
// keys through a ring of kStages slots (full/empty mbarriers; 128-byte
// swizzled tiles, a D 128 row as two 64-column boxes; rows past t_q and t_k
// zero-filled by the copy). The ring runs on across items, so the next
// item's tiles land during this one's last products and epilogue. A
// consumer computes S = Q K^T with both operands K-major in shared memory,
// runs the online softmax in the accumulator layout (row max and sum over
// the 4 lanes of a quad; the sum is kept per lane and reduced once at the
// end), packs p to bf16 in registers as the A operand of O += P V (V read
// with the transpose bit), and keeps O in registers, rescaled by alpha
// there. Each step issues the S product of one tile and the P V product of
// the tile before it; with kOverlap the softmax of the new S runs while P V
// is still in flight, and with kTakeTurns the consumer warpgroups issue
// their products in turns, so one warpgroup's products run during the
// others' softmax (FA3's intra-warpgroup overlap and its scheduler
// barrier; the sweep measures each).
// What bounds this design, and what each choice does about it:
// - Tensor-core rate: only wgmma reaches it. A warpgroup reads each K/V
//   tile from shared memory once per 64 rows (the mma.sync design it
//   replaces re-read it with ldmatrix per 16-row warp, which bound it by
//   shared-memory bandwidth), and p never touches shared memory.
// - Load latency and issue slots: one producer thread keeps the ring full
//   with TMA, so the consumers spend no instructions or registers on
//   copies (the design it replaces copied 16 bytes a thread with cp.async);
//   a deeper ring (kStages) hid more of it than anything else in the sweep.
// - The softmax's instruction count, which at D 64 may cost as much as the
//   products (ex2 runs on the special-function unit, 16 a clock per SM):
//   exponentials on ex2.approx.ftz with scale * log2(e) folded into
//   one fma, masks as one compare per element against each row's last
//   visible key, in a pass of their own that only tiles straddling the
//   diagonal or holding tail keys run (tail keys are zero-filled, so they
//   score 0, not -inf, and must be masked).
// - ptxas serializes every wgmma of a function when a product sits in a
//   branch it cannot prove warp-uniform, or when the wait that frees an
//   accumulator depends on the path taken: the warpgroup index is read
//   through a shuffle (hopper::warpgroup_idx), and tile 0's scores and the
//   last tile's P V are peeled off the loop, whose body holds no branch
//   around a product.
// - Per-item cost (a large share of a block's time when each item was a
//   block of its own: the first tiles' latency, the epilogue, the gap
//   before the next block): the persistent grid loads the next item during
//   this one's epilogue; dynamic fetching keeps the causal imbalance in
//   check (a static split of heaviest-first items loads the SMs unevenly).
// - Registers: the producer warpgroup gives its registers to the consumers
//   (setmaxnreg). A consumer holds O (D / 2 floats), S (kN / 2) and p as
//   bf16 (kN / 4), so D 128 fits two consumer warpgroups and D 64 three.
// - L2: items walk bands of heads whose K/V fit kBandMB, each band's query
//   tiles heaviest (last) first, so the query tiles of one head read its
//   K/V from L2 rather than from memory, and the lightest close each band.
// The tile sizes, ring depth, overlap, turns, band, Q tiles and the
// persistent grid come from flash_bwd_study.py's fwd-sweep on an H100
// (PERF.md has the table). The entry point's `tile` (the autotuner's tile
// knob, ops/attention.py's block_q) names the bf16 block's query rows: 0
// or the one built instance's kM; it refuses any other.
//
// Where trouble was expected, and what the design does:
// - Sliced and strided inputs (the ring's key slices with t_q != t_k, the
//   prefill's views of one fused projection): the tensor maps are built on
//   every launch from the views' own pointers, sizes and (batch, seq,
//   head) strides (hopper::map_bthd), which _kernel_readable already holds
//   to a 16-byte aligned base and 16-byte strides; a map that fails to
//   encode returns an error, which the wrapper raises.
// - Hangs: the producer and every consumer count an item's live key tiles
//   with the one live_key_tiles(); a warpgroup whose rows see fewer tiles
//   still waits for and releases the rest, and an item whose rows see no
//   key (causal, t_q > t_k) loads nothing. The producer pushes an item's
//   first kStages tiles before its Q tile waits for a free buffer: those
//   slots only wait on earlier items, while later ones would wait on
//   consumers that wait on the Q tile. A wait that never completes traps
//   after ~10 s (hopper::mbar_wait) instead of hanging the card.
// - Fully masked rows: m stays at -1e30, and the shift is then 0, so ex2 of
//   a masked score is exactly 0 (never NaN or 1) and alpha 0; such a row
//   ends with l = 0, written as O = 0 and lse = log(1e-30).
// - The generate prefill (T = 128: one key tile an item): the producer
//   loads only the live tiles, so a ring deeper than the tile count waits
//   for nothing.
// - The work counter: each launch takes its own slot (launches in flight
//   at once on other streams do not share one), and the last block of the
//   launch to finish sets it back to zero.
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

#include <atomic>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

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
  // bf16: n_items = n_bh x n_qt work items, in bands of `band`
  // (batch*head)s, each band's n_qt query tiles a head heaviest first; the
  // launch's work counters are g_work[slot].
  int n_bh;
  int band;
  int n_qt;
  int n_items;
  int slot;
};

// Key tiles of BN keys that query rows [first, first + n), clipped to t_q,
// see (0 when the rows lie past t_q): a tile is live while its first key is
// at or before the position of the last row. A bf16 block's producer and
// consumers both count with it, so they agree on the tiles the ring carries.
template <int BN>
__device__ __forceinline__ int live_key_tiles(const Params& p, int first,
                                              int n) {
  if (first >= p.t_q) return 0;
  const int tiles = (p.t_k + BN - 1) / BN;
  if (!p.causal) return tiles;
  const int last = p.t_k - p.t_q + min(first + n, p.t_q) - 1;
  return min(tiles, last < 0 ? 0 : last / BN + 1);
}

// ---------------------------------------------------------------------------
// bf16: warpgroup products fed by TMA
// ---------------------------------------------------------------------------

template <int D>
struct FwdBf16 {
  static constexpr int kWarpGroups = D == 64 ? 3 : 2;  // B1 consumers
  static constexpr int kN = 128;  // keys per streamed tile
  static_assert(kN == 64 || kN == 128, "one m64n64 or m64n128 product");
  static constexpr int kStages = D == 64 ? 4 : 3;  // K/V tiles in B1's ring
  static_assert(kStages >= 2, "a step reads the K of one tile, V of another");
  static constexpr bool kOverlap = true;  // next S during this tile's P V
  static constexpr bool kTakeTurns = true;  // warpgroups issue in turns
  static constexpr int kQTiles = D == 64 ? 2 : 1;  // Q tiles of the items
  static constexpr int kBandMB = 16;  // MB of K/V a band of heads reads
  static constexpr bool kPersistent = true;  // a block an SM walks the items
  static constexpr int kM = kWgRows * kWarpGroups;  // query rows per block
  static constexpr int kThreads = Regs<kWarpGroups>::kThreads;
  // The producer's registers: its item loop needs more than 24, and beside
  // three consumer warpgroups of 160 the block has 32 a producer thread.
  static constexpr int kProducerRegs =
      kWarpGroups == 3 ? 32 : Regs<kWarpGroups>::kProducer;
  static constexpr int kFixed = kM * D * 2;    // bytes of the Q tile
  static constexpr int kStream = kN * D * 2;   // bytes of a K or V tile
  // kQTiles Q tiles; K and V per stage; full/empty barriers per stage and
  // per Q tile, turn barriers per consumer warpgroup; the Q tiles' item
  // indices; 1024 bytes of alignment.
  static constexpr size_t kSmem =
      1024 + (size_t)kQTiles * kFixed + 2 * (size_t)kStages * kStream +
      8 * (2 * kStages + 2 * kQTiles + kWarpGroups) + 4 * kQTiles;
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

// The tile of ring stage `tile % S` among tiles of `bytes` from base (the
// K or the V tiles).
template <int S>
__device__ __forceinline__ const unsigned char* ring_tile(
    const unsigned char* base, int tile, int bytes) {
  return base + (tile % S) * bytes;
}

// Issues S = Q K^T (64 rows x BN keys) into s, both operands K-major in
// shared memory: q_d the warpgroup's rows of the Q tile (BM rows), kt a K
// tile. Element i of s is row 16 warp + g + 8 ((i & 3) / 2), key
// 8 (i / 4) + 2 t + i % 2 (hopper.cuh's layout).
template <int D, int BM, int BN>
__device__ __forceinline__ void issue_scores(float (&s)[BN / 2],
                                             uint64_t q_d,
                                             const unsigned char* kt) {
  const uint64_t k_d = desc_k_major(kt);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss<BN>(s, desc_add(q_d, (ks >> 2) * BM * kBoxBytes + (ks & 3) * 32),
                 desc_add(k_d, (ks >> 2) * BN * kBoxBytes + (ks & 3) * 32),
                 ks > 0);
  wgmma_commit();
}

// Issues O += P V: p from registers (pa), the V tile vt read with the
// transpose bit.
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         const unsigned char* vt) {
  const uint64_t v_d = desc_mn_major(vt, BN * kBoxBytes);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs_tb<D>(acc, pa[kk], desc_add(v_d, kk * 16 * kBoxBytes));
  wgmma_commit();
}

// The online softmax of the key tile at k0 for the warpgroup whose rows
// start at qw, its scores landed in s: p into s, the running max m and this
// lane's part of the sum l updated, and alpha, the factor O's rows are
// rescaled by. `last` holds each of the thread's rows' last visible key
// less its first column.
template <int BN>
__device__ __forceinline__ void online_softmax(
    const Params& p, int qw, int k0, const int (&last)[2], float scale_log2,
    float (&s)[BN / 2], float (&m_i)[2], float (&l_i)[2],
    float (&alpha)[2]) {
  // Only tiles that straddle the diagonal or hold tail keys are masked.
  if (k0 + BN > p.t_k || (p.causal && k0 + BN - 1 > p.t_k - p.t_q + qw)) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      if (8 * (i >> 2) + (i & 1) > last[(i & 3) >> 1] - k0) s[i] = kNegInf;
  }
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], s[i]);
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // Fully masked so far: shift by 0 so the exponentials stay finite
    // (masked scores then give exactly 0).
    const float m_safe = mx[r] <= kMaskedBelow ? 0.f : mx[r];
    alpha[r] =
        m_i[r] <= kMaskedBelow ? 0.f : ex2((m_i[r] - m_safe) * scale_log2);
    neg[r] = -m_safe * scale_log2;
    m_i[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, neg[(i & 3) >> 1]));
    sum[(i & 3) >> 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + sum[r];
}

// A work item (batch*head, query tile) of the bf16 grid: bands of p.band
// heads one after another, within a band the last (heaviest) query tiles
// of every head first.
struct Item {
  int bh, b, h, hk, q0;
};

template <int BM>
__device__ __forceinline__ Item work_item(const Params& p, int i) {
  const int band0 = i / (p.band * p.n_qt) * p.band;
  const int heads = min(p.band, p.n_bh - band0);
  const int in_band = i - band0 * p.n_qt;
  Item w;
  w.bh = band0 + in_band % heads;
  w.b = w.bh / p.n_heads;
  w.h = w.bh % p.n_heads;
  w.hk = w.h / p.group;
  w.q0 = (p.n_qt - 1 - in_band / heads) * BM;
  return w;
}

// Work counters of the persistent bf16 grid, one slot per launch in flight
// (the host cycles through them): [next item, blocks done]. The last block
// of a launch to finish sets its slot back to zero.
constexpr int kWorkSlots = 64;
__device__ unsigned int g_work[kWorkSlots][2];

template <int D>
__global__ void __launch_bounds__(FwdBf16<D>::kThreads,
                                  Regs<FwdBf16<D>::kWarpGroups>::kMinBlocks)
    flash_fwd_kernel_bf16(const Params p, const __grid_constant__ FwdMaps m) {
  using Cfg = FwdBf16<D>;
  using R = Regs<Cfg::kWarpGroups>;
  constexpr int BM = Cfg::kM, BN = Cfg::kN, S = Cfg::kStages, H2 = D / 64;
  constexpr int QT = Cfg::kQTiles;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_q = smem;                     // [QT] Q tiles
  unsigned char* s_k = s_q + QT * Cfg::kFixed;   // [S] K tiles
  unsigned char* s_v = s_k + S * Cfg::kStream;   // [S] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(s_v + S * Cfg::kStream);
  uint64_t* empty = full + S;
  uint64_t* q_full = empty + S;     // [QT]
  uint64_t* q_empty = q_full + QT;  // [QT]
  uint64_t* turn_bar = q_empty + QT;  // [kWarpGroups]
  int* s_item = reinterpret_cast<int*>(turn_bar + Cfg::kWarpGroups);  // [QT]

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * Cfg::kWarpGroups);  // one arrival a warp
    }
    for (int j = 0; j < QT; ++j) {
      mbar_init(&q_full[j], 1);
      mbar_init(&q_empty[j], 4 * Cfg::kWarpGroups);
    }
    for (int w = 0; w < Cfg::kWarpGroups; ++w) mbar_init(&turn_bar[w], 4);
    fence_barrier_init();
  }
  __syncthreads();

  // The block walks work items: its first is blockIdx.x, every later one
  // comes from the launch's counter. The producer hands each item's index
  // to the consumers with its Q tile, and the K/V ring runs on across
  // items, so the next item's tiles load during this one's last products
  // and epilogue.
  const int wg = warpgroup_idx();
  const int tid = threadIdx.x % 128;
  if (wg == Cfg::kWarpGroups) {
    // Producer: one thread fetches the items and issues every TMA load.
    reg_dealloc<Cfg::kProducerRegs>();
    if (tid == 0) {
      unsigned int* work = g_work[p.slot];
      int pos = 0;  // K/V tiles pushed into the ring so far
      int j = 0;
      for (int i = blockIdx.x; i < p.n_items; ++j) {
        const int buf = j % QT;
        const Item w = work_item<BM>(p, i);
        const int n_tiles = live_key_tiles<BN>(p, w.q0, BM);
        // With one Q tile, its buffer waits for the previous item's
        // products: the item's first S tiles (ring slots that only earlier
        // items hold) go in before it, the rest after it. With more, the
        // buffer waits on an older item, and Q goes first.
        auto push = [&](int tile) {
          const int stage = pos % S;
          if (pos >= S) mbar_wait(&empty[stage], ((pos / S) - 1) & 1);
          mbar_expect_tx(&full[stage], 2 * Cfg::kStream);
          unsigned char* kt = s_k + stage * Cfg::kStream;
          unsigned char* vt = s_v + stage * Cfg::kStream;
#pragma unroll
          for (int c = 0; c < H2; ++c) {
            tma_load_4d(kt + c * BN * kBoxBytes, &m.k, &full[stage], 64 * c,
                        w.hk, tile * BN, w.b);
            tma_load_4d(vt + c * BN * kBoxBytes, &m.v, &full[stage], 64 * c,
                        w.hk, tile * BN, w.b);
          }
          ++pos;
        };
        const int ahead = QT > 1 ? 0 : min(n_tiles, S);
        for (int tile = 0; tile < ahead; ++tile) push(tile);
        if (j >= QT) mbar_wait(&q_empty[buf], ((j / QT) - 1) & 1);
        s_item[buf] = i;
        if (n_tiles > 0) {
          mbar_expect_tx(&q_full[buf], Cfg::kFixed);
#pragma unroll
          for (int c = 0; c < H2; ++c)
            tma_load_4d(s_q + buf * Cfg::kFixed + c * BM * kBoxBytes, &m.q,
                        &q_full[buf], 64 * c, w.h, w.q0, w.b);
        } else {
          mbar_arrive(&q_full[buf]);  // rows that see no key: no load
        }
        for (int tile = ahead; tile < n_tiles; ++tile) push(tile);
        i = (int)atomicAdd(&work[0], 1u) + (int)gridDim.x;
      }
      // No item left: the consumers stop at index -1.
      const int buf = j % QT;
      if (j >= QT) mbar_wait(&q_empty[buf], ((j / QT) - 1) & 1);
      s_item[buf] = -1;
      mbar_arrive(&q_full[buf]);
      __threadfence();
      if (atomicAdd(&work[1], 1u) == gridDim.x - 1) {
        __threadfence();
        atomicExch(&work[0], 0u);
        atomicExch(&work[1], 0u);
      }
    }
  } else {
    reg_alloc<R::kConsumer>();
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    int pos = 0;  // K/V tiles taken from the ring so far
    // With kTakeTurns the warpgroups issue their products in turns, 0, 1,
    // ...: a turn waits for the previous warpgroup's and passes to the
    // next (one arrival a warp). Every warpgroup takes n_tiles + 1 turns
    // an item (one a product issue; the warpgroups whose rows see fewer
    // tiles take the rest empty, one with each tile they release), so the
    // turns never wait on a warpgroup that has none left.
    int turns = 0;
    auto wait_turn = [&] {
      if (Cfg::kTakeTurns) mbar_wait(&turn_bar[wg], turns & 1);
    };
    auto pass_turn = [&] {
      if (Cfg::kTakeTurns && lane == 0)
        mbar_arrive(&turn_bar[(wg + 1) % Cfg::kWarpGroups]);
      ++turns;
    };
    // The last warpgroup passes first, so warpgroup 0 starts.
    if (Cfg::kTakeTurns && wg == Cfg::kWarpGroups - 1 && lane == 0)
      mbar_arrive(&turn_bar[0]);
    for (int j = 0;; ++j) {
      const int buf = j % QT;
      mbar_wait(&q_full[buf], (j / QT) & 1);
      const int item = s_item[buf];
      if (item < 0) break;
      const Item w = work_item<BM>(p, item);
      const int n_tiles = live_key_tiles<BN>(p, w.q0, BM);
      const int qw = w.q0 + wg * kWgRows;  // this warpgroup's first row
      const int row_lo = qw + warp * 16 + g;  // this thread's rows: +0, +8
      const int my_tiles = live_key_tiles<BN>(p, qw, kWgRows);
      // Each of this thread's rows' last visible key, less its first
      // column.
      int last[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        last[r] = (p.causal ? min(p.t_k - 1, p.t_k - p.t_q + row_lo + 8 * r)
                            : p.t_k - 1) -
                  2 * t;

      float acc[D / 2];  // O: 64 rows x D
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_i[2] = {kNegInf, kNegInf};  // running max of the raw scores
      float l_i[2] = {0.f, 0.f};  // this lane's part of the running sum
      float s[BN / 2];            // one tile's S, then its p
      uint32_t pa[BN / 16][4];    // p rounded to bf16: the A operand of P V
      const uint64_t q_d =
          desc_k_major(s_q + buf * Cfg::kFixed + wg * kWgRows * kBoxBytes);

      // Tile 0's scores and softmax; then each step issues the S product of
      // tile `tile` and the P V product of tile - 1, runs tile `tile`'s
      // softmax (with kOverlap while P V is still in flight), then rescales
      // O and packs p for the next step; then the last tile's P V. The loop
      // body holds no branch around a product, so ptxas keeps the products
      // asynchronous.
      if (my_tiles > 0) {
        float alpha[2];
        mbar_wait(&full[pos % S], (pos / S) & 1);
        wait_turn();
        wgmma_fence();
        issue_scores<D, BM, BN>(s, q_d, ring_tile<S>(s_k, pos, Cfg::kStream));
        pass_turn();
        wgmma_wait<0>();
        fence_acc<BN / 2>(s);
        online_softmax<BN>(p, qw, 0, last, scale_log2, s, m_i, l_i, alpha);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) pack_a(pa[kk], &s[8 * kk]);
        for (int tile = 1; tile < my_tiles; ++tile) {
          const int at = pos + tile;
          mbar_wait(&full[at % S], (at / S) & 1);
          wait_turn();
          wgmma_fence();
          issue_scores<D, BM, BN>(s, q_d,
                                  ring_tile<S>(s_k, at, Cfg::kStream));
          issue_pv<D, BN>(acc, pa, ring_tile<S>(s_v, at - 1, Cfg::kStream));
          pass_turn();
          if (Cfg::kOverlap) {
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_acc<BN / 2>(s);
          online_softmax<BN>(p, qw, tile * BN, last, scale_log2, s, m_i, l_i,
                             alpha);
          wgmma_wait<0>();
          fence_acc<D / 2>(acc);
          // This warp's reads of the stage are done (its products waited
          // for).
          if (lane == 0) mbar_arrive(&empty[(at - 1) % S]);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i & 3) >> 1];
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) pack_a(pa[kk], &s[8 * kk]);
        }
        wait_turn();
        wgmma_fence();
        issue_pv<D, BN>(acc, pa,
                        ring_tile<S>(s_v, pos + my_tiles - 1, Cfg::kStream));
        pass_turn();
        wgmma_wait<0>();
        fence_acc<D / 2>(acc);
        if (lane == 0) mbar_arrive(&empty[(pos + my_tiles - 1) % S]);
      }
      // This warp is done with the item's Q tile.
      if (lane == 0) mbar_arrive(&q_empty[buf]);
      // The item's tiles past this warpgroup's rows (which see none of
      // their keys): waited for and released, so the ring's counts stay
      // whole, each with the empty turn of the step that would have summed
      // it (a turn taken before the release would wait on warpgroups that
      // wait for the slot).
      if (my_tiles == 0 && n_tiles > 0) {
        wait_turn();
        pass_turn();
      }
      for (int tile = my_tiles; tile < n_tiles; ++tile) {
        const int at = pos + tile;
        mbar_wait(&full[at % S], (at / S) & 1);
        wait_turn();
        pass_turn();
        if (lane == 0) mbar_arrive(&empty[at % S]);
      }
      pos += n_tiles;

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_i[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = row_lo + 8 * i;
        if (row >= p.t_q) continue;
        l = fmaxf(l, 1e-30f);
        const float inv_l = 1.f / l;
        bf16* o_row = static_cast<bf16*>(p.o) + w.b * p.o_sb + w.h * p.o_sh +
                      (int64_t)row * p.o_st;
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * c + 2 * t) =
              __floats2bfloat162_rn(acc[4 * c + 2 * i] * inv_l,
                                    acc[4 * c + 2 * i + 1] * inv_l);
        if (t == 0) {
          const float mr = m_i[i];
          p.lse[(int64_t)w.bh * p.t_q + row] =
              (mr <= kMaskedBelow ? 0.f : mr * p.scale) + logf(l);
        }
      }
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

  const int n_tiles = live_key_tiles<kBlockN32>(p, q0, kBlockM32);
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

// The work-counter slot of the next bf16 launch: launches in flight at once
// (on other streams) take different slots.
int next_work_slot() {
  static std::atomic<unsigned int> launches{0};
  return (int)(launches.fetch_add(1) % kWorkSlots);
}

// Tensor maps are built on every launch from the tensors' pointers, sizes
// and strides (a host call of a few microseconds) and passed by value.
template <int D>
cudaError_t launch_bf16(Params p, int batch, int n_kv_heads,
                        cudaStream_t stream) {
  using Cfg = FwdBf16<D>;
  const int64_t q_s[3] = {p.q_sb, p.q_st, p.q_sh};
  const int64_t k_s[3] = {p.k_sb, p.k_st, p.k_sh};
  const int64_t v_s[3] = {p.v_sb, p.v_st, p.v_sh};
  FwdMaps m;
  const bool ok =
      map_bthd(&m.q, p.q, D, p.n_heads, p.t_q, batch, q_s, Cfg::kM) &&
      map_bthd(&m.k, p.k, D, n_kv_heads, p.t_k, batch, k_s, Cfg::kN) &&
      map_bthd(&m.v, p.v, D, n_kv_heads, p.t_k, batch, v_s, Cfg::kN);
  if (!ok) return cudaErrorInvalidValue;
  p.n_bh = batch * p.n_heads;
  p.n_qt = (p.t_q + Cfg::kM - 1) / Cfg::kM;
  p.n_items = p.n_bh * p.n_qt;
  // A band holds the query heads of as many KV heads as kBandMB of K/V.
  const int64_t kv_bytes = (int64_t)p.t_k * D * 2 * sizeof(bf16);
  const int64_t kv_heads = ((int64_t)Cfg::kBandMB << 20) / kv_bytes;
  p.band = (int)(kv_heads < 1 ? p.group
                              : (kv_heads * p.group < p.n_bh
                                     ? kv_heads * p.group
                                     : p.n_bh));
  // One block per SM (a block takes most of an SM's registers and shared
  // memory), each walking items until none is left; without kPersistent a
  // block per item (each block's first fetch then finds none left).
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  p.slot = next_work_slot();
  const dim3 grid(Cfg::kPersistent && sms < p.n_items ? sms : p.n_items);
  return launch(flash_fwd_kernel_bf16<D>, Cfg::kSmem, Cfg::kThreads, grid,
                stream, p, m);
}

template <int D>
cudaError_t launch_fp32(const Params& p, int bh, cudaStream_t stream) {
  const dim3 grid(bh, (p.t_q + kBlockM32 - 1) / kBlockM32);
  return launch(flash_fwd_kernel_fp32<D>, smem_fp32<D>(), kThreads32, grid,
                stream, p);
}

}  // namespace

// q [B, t_q, H, D], k/v [B, t_k, H_kv, D], o [B, t_q, H, D], lse [B, H, t_q]
// (f32, contiguous). Strides are in elements; the last dimension is
// contiguous, and for bf16 the bases and every stride are 16-byte aligned
// (TMA). dtype codes: 0 = float32, 1 = bfloat16; head_dim 64 or 128.
// `tile` is the bf16 block's query rows, 0 or FwdBf16<D>::kM (fp32: 0).
// Returns a cudaError_t value (0 on success); asynchronous on `stream`.
extern "C" int tony_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int64_t q_sb, int64_t q_st,
                              int64_t q_sh, int64_t k_sb, int64_t k_st,
                              int64_t k_sh, int64_t v_sb, int64_t v_st,
                              int64_t v_sh, int64_t o_sb, int64_t o_st,
                              int64_t o_sh, int batch, int n_heads,
                              int n_kv_heads, int t_q, int t_k, int head_dim,
                              float scale, int causal, int dtype, int tile,
                              void* stream) {
  Params p = {};
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
  if (dtype == 0 && tile == 0 && head_dim == 64)
    return launch_fp32<64>(p, bh, s);
  if (dtype == 0 && tile == 0 && head_dim == 128)
    return launch_fp32<128>(p, bh, s);
  if (dtype == 1 && head_dim == 64 && (tile == 0 || tile == FwdBf16<64>::kM))
    return launch_bf16<64>(p, batch, n_kv_heads, s);
  if (dtype == 1 && head_dim == 128 &&
      (tile == 0 || tile == FwdBf16<128>::kM))
    return launch_bf16<128>(p, batch, n_kv_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
