// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w,
// computed in fp32 and stored in x's dtype.
//
// Replaces: tony_tpu/ops/norms.py::_rms_norm_kernel (launched by
// _rms_norm_pallas), which runs 256-row blocks through VMEM on the TPU.
//
// Bound on this card: bytes. Each call reads rows*d + d elements and writes
// rows*d; there are ~4 flops per element, far below the ~295 flop/byte
// balance point of the H100. On the serving path d = 1024 and rows is the
// slot count (16) for a decode step, so a call moves ~64 KB and its time is
// launch latency plus one round trip to memory.
//
// Design: one warp per row, four rows per block. Each lane reads 16 bytes at
// a time (8 bf16 or 4 fp32 values), so a warp covers 512 contiguous bytes
// per load. The fp32 sum of squares is reduced with warp shuffles (no shared
// memory, no block barrier); the second pass re-reads the row, which is
// still in L1, and writes the scaled values with the same 16-byte stores.
// The row length must be a multiple of the vector width; the Python wrapper
// checks that and the 16-byte alignment of both pointers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void store_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    rms_norm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ y, int rows, int d, float eps) {
  constexpr int kVec = 16 / sizeof(TX);  // elements per 16-byte access
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
  const int n_vec = d / kVec;

  float sum_sq = 0.f;
  for (int i = lane; i < n_vec; i += 32) {
    const uint4 raw = xr[i];
    const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_float(e[j]);
      sum_sq = fmaf(f, f, sum_sq);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sum_sq += __shfl_xor_sync(0xffffffffu, sum_sq, offset);
  }
  const float inv_rms = rsqrtf(sum_sq / (float)d + eps);

  for (int i = lane; i < n_vec; i += 32) {
    const uint4 raw = xr[i];
    const TX* e = reinterpret_cast<const TX*>(&raw);
    uint4 packed;
    TX* o = reinterpret_cast<TX*>(&packed);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float wf = to_float(__ldg(w + i * kVec + j));
      store_float(to_float(e[j]) * inv_rms * wf, o + j);
    }
    yr[i] = packed;
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  rms_norm_kernel<TX, TW><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TX*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t value
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int tony_rms_norm(const void* x, const void* w, void* y, int rows,
                             int d, float eps, int x_dtype, int w_dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w, y, rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
