// Building blocks for Hopper (sm_90a) kernels: mbarriers, TMA tile loads
// (cp.async.bulk.tensor) from tensor maps built on the host, warpgroup
// products (wgmma.mma_async m64n64k16 and m64n128k16, bf16 in, fp32
// accumulators) with their shared-memory descriptors, register hand-over
// between warpgroups (setmaxnreg, Regs), a warp-uniform warpgroup index,
// named barriers, bf16 packing and ex2.approx. Both flash kernels
// (flash_fwd.cu, flash_bwd.cu) are built from them.
//
// Shared-memory tiles are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: rows of 64 bf16 (128 bytes), the 16-byte chunk c of row r stored
// at chunk c ^ (r % 8), each tile 1024-byte aligned. A tile of D > 64
// columns is D / 64 such column boxes one after another. Read
// - K-major (rows = M or N, the 64 columns = K): the wgmma of k-slice kk
//   (16 columns) starts 32 * kk bytes into the row, 8-row groups 1024 bytes
//   apart (SBO);
// - MN-major (rows = K, the 64 columns = N; the transpose bit): k-slice kk
//   starts at row 16 * kk, 8-row groups of K 1024 bytes apart; with N = 128
//   the second 64 columns are the next column box (the leading offset).
//
// Fragment layouts of wgmma m64nNk16 for thread 32 w + 4 g + t of a
// warpgroup (warp w, g in [0, 8), t in [0, 4)):
//   D (fp32): d[4j + e] is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2;
//   A (bf16 pairs): a0 = (16 w + g, 2t..2t+1), a1 = (+8, 2t..),
//                   a2 = (16 w + g, 2t+8..), a3 = (+8, 2t+8..).
// So the accumulator's columns [16 kk, 16 kk + 16), packed to bf16, are the
// A operand of k-slice kk: a product's result feeds the next one from
// registers (pack_a).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to nearest bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kWgRows = 64;     // rows of one warpgroup's wgmma tile
constexpr int kBoxBytes = 128;  // one 64-column swizzled row of bf16

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA traffic on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A pipeline fault
// (a load never issued, a count that never fills) would spin forever: after
// ~2^34 cycles (~10 s) the wait traps, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// --- TMA -------------------------------------------------------------------

// The box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at dst; completion counts on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// --- warpgroup products ----------------------------------------------------

// Descriptor of a 128-byte-swizzled bf16 operand tile in shared memory
// starting at p; byte offsets lbo and sbo (see the header note).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// K-major operand: the leading offset is unused within one swizzle row;
// 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  return smem_desc(p, 16, 1024);
}

// MN-major operand (read with the transpose bit): 8-row groups of K 1024
// bytes apart, and the next 64 columns of N (the next swizzle atom, used
// when N = 128) `atom_stride` bytes on.
__device__ __forceinline__ uint64_t desc_mn_major(const void* p,
                                                  uint32_t atom_stride) {
  return smem_desc(p, atom_stride, 1024);
}

// d with its start address moved by `bytes` (a multiple of 16 that keeps
// it inside shared memory).
__device__ __forceinline__ uint64_t desc_add(uint64_t d, int bytes) {
  return d + static_cast<uint64_t>(bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator's n registers at this point of the program, so the
// compiler moves no read or write of them across a wgmma issue or wait.
template <int n>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator operands of an m64nNk16 product: N / 2 fp32 registers.
#define TONY_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define TONY_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define TONY_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31])
#define TONY_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B for a 64 x 16 A and a 16 x N B, both K-major in shared
// memory; `accumulate` 0 overwrites d (N / 2 registers). N is 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TONY_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TONY_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t desc_a,
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TONY_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TONY_OUT64(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B for A from registers (pack_a) and a 16 x N B read MN-major
// (transposed) from shared memory. N is 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t (&a)[4],
                                            uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float* d,
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TONY_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TONY_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float* d,
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TONY_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TONY_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef TONY_D32
#undef TONY_D64
#undef TONY_OUT32
#undef TONY_OUT64

// The A fragment of k-slice kk from accumulator registers d[8 kk .. 8 kk + 8)
// (columns 16 kk .. 16 kk + 16), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* d) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

// 2^x on the special-function unit, a denormal result flushed to zero.
// (exp2f guards denormal results with a compare and two multiplies that
// chain every call through one predicate register.)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- warp specialisation ---------------------------------------------------

// The register budgets of a block with `WGS` consumer warpgroups and one
// producer warpgroup: the producer gives its registers to the consumers.
template <int WGS>
struct Regs {
  static_assert(WGS >= 1 && WGS <= 3, "one to three consumer warpgroups");
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kMinBlocks = WGS == 1 ? 2 : 1;
  static constexpr int kProducer = 24;
  static constexpr int kConsumer = WGS == 1 ? 232 : WGS == 2 ? 240 : 160;
};

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// This thread's warpgroup, read from lane 0 so that the compiler knows it
// is one value across the warp. Branches on it (and on what is computed
// from it) are then uniform; a wgmma in a branch ptxas cannot prove uniform
// makes it serialize the function's wgmma products.
__device__ __forceinline__ int warpgroup_idx() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// Barrier `id` (1-15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// --- host -------------------------------------------------------------------

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

// Tensor maps.


typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: it is fetched from the
// driver through the runtime once, so the library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A 4-D map {head_dim, heads, seq, batch} over a bf16 [batch, seq, heads,
// head_dim] tensor with (batch, seq, head) element strides `st` and a
// contiguous last dimension; boxes of 64 columns x `rows` rows of one head,
// 128-byte swizzled; rows past `seq` read as zeros. A dimension of size 1
// is never stepped, so its stride is replaced by one TMA accepts.
inline bool map_bthd(CUtensorMap* map, const void* base, int head_dim,
                     int heads, int seq, int batch, const int64_t* st,
                     int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const int64_t elems[3] = {st[2], st[1], st[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)elems[i] * 2
                                 : (cuuint64_t)head_dim * 2;
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 1-D map over n fp32 values with boxes of `len`; past n reads zeros.
inline bool map_f32(CUtensorMap* map, const float* base, uint64_t n,
                    int len) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {n};
  const cuuint64_t strides[1] = {n * 4};
  const cuuint32_t box[1] = {(cuuint32_t)len};
  const cuuint32_t unit[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
