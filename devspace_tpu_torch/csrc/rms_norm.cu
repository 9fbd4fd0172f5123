// RMSNorm for NVIDIA Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the Pallas TPU kernel `_rms_kernel` of
// devspace_tpu/ops/normalization.py (launched by `_rms_pallas_raw`) on
// x [rows, d] (bf16 or f32, row-major, contiguous) and w [d] (f32): the
// sum of squares, the normalisation and the weight are all taken in f32,
// and y comes out in x's dtype.
//
// Bound: bytes. Each element is read once and written once against about
// four operations, far below the ~295 flops per byte where the H100's
// arithmetic, not its memory, is the limit.
//
// Design: one warp per row, four rows per block, so a [4096, 1024] call
// fills the card with 1024 blocks and a row's reduction is five shuffles
// with no shared memory and no block-wide sync. Each lane moves 16 bytes
// at a time (8 bf16 or 4 f32; neighbouring lanes on neighbouring
// addresses). The row is read twice, the second time from L1/L2: holding
// it in registers would need one kernel per width. Rows whose byte length
// is no multiple of 16 (d % 8 for bf16, d % 4 for f32), or a base that
// is not 16-byte aligned, take an element-by-element loop with the same
// arithmetic. The TPU kernel's `[1, d]` weight block and its row tiling
// (`block_rows`) answer that machine's layouts and do not carry over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, int rows, int d, float eps) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per vector
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;

  float ss = 0.f;
  if constexpr (kVector) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / kPer; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float f = to_float(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_float(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  const float r = 1.0f / sqrtf(warp_sum(ss) / static_cast<float>(d) + eps);

  if constexpr (kVector) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / kPer; i += 32) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      __align__(16) T out[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        out[j] = from_float<T>(to_float(e[j]) * r * w[i * kPer + j]);
      yv[i] = *reinterpret_cast<const uint4*>(out);
    }
  } else {
    for (int i = lane; i < d; i += 32) yr[i] = from_float<T>(to_float(xr[i]) * r * w[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  const bool vector = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (vector)
    rms_norm_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), rows, d, eps);
  else
    rms_norm_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). is_bf16: x and y are bf16
// (else f32), [rows, d]; w is f32 [d]. Returns the cudaError_t of the
// launch.
extern "C" int rms_norm_fwd(int is_bf16, const void* x, const void* w, void* y,
                            int rows, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(x, w, y, rows, d, eps, st)
                 : launch<float>(x, w, y, rows, d, eps, st);
}
