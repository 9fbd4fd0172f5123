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
// Design: the row is read from device memory once and held in
// registers, NV 16-byte vectors a lane (8 bf16 or 4 f32 each;
// neighbouring lanes on neighbouring addresses), every load issued before
// the first is used. Rows up to 256 vectors (2048 bf16, 1024 f32) take one
// warp each, four rows a block, so a row's sum of squares is five
// shuffles with no shared memory and no block-wide sync; wider rows take
// one block of W warps each (4 warps up to 1024 vectors, 16 up to 4096:
// the 7B width 4096 is 512 bf16 vectors, W = 4, NV = 4), whose warps add
// their sums through one float a warp in shared memory, in warp order.
// w is read as 16-byte vectors. The launch picks the instance (W, NV)
// from d. Rows whose byte length is no multiple of 16 (d % 8 for bf16,
// d % 4 for f32), a base of x, y or w that is not 16-byte aligned, or a
// row wider than 4096 vectors take an element-by-element loop instead
// (one warp a row, reading the row twice), with the same arithmetic. The
// TPU kernel's `[1, d]` weight block and its row tiling (`block_rows`)
// answer that machine's layouts and do not carry over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// The row held in registers: W warps a row (one warp, kRowsPerBlock rows
// a block, when W = 1), NV vectors a lane.
template <typename T, int NV, int W>
__global__ void __launch_bounds__(W == 1 ? kThreads : 32 * W)
    rms_norm_row_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        T* __restrict__ y, int rows, int d, float eps) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per vector
  constexpr int kStride = 32 * W;                          // lanes over a row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = W == 1 ? blockIdx.x * kRowsPerBlock + warp : blockIdx.x;
  if (W == 1 && row >= rows) return;  // whole warps leave together
  const int first = W == 1 ? lane : threadIdx.x;  // this lane's first vector
  const int nvec = d / kPer;
  const uint4* xv = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * d);

  uint4 raw[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = first + k * kStride;
    raw[k] = i < nvec ? xv[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float f = to_float(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (W > 1) {
    __shared__ float part[W];
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) ss += part[i];
  }
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  const float4* wv = reinterpret_cast<const float4*>(w);
  uint4* yv = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * d);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = first + k * kStride;
    if (i >= nvec) continue;
    float wf[kPer];
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
      const float4 w4 = wv[i * (kPer / 4) + j];
      wf[4 * j] = w4.x;
      wf[4 * j + 1] = w4.y;
      wf[4 * j + 2] = w4.z;
      wf[4 * j + 3] = w4.w;
    }
    const T* e = reinterpret_cast<const T*>(&raw[k]);
    __align__(16) T out[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[j] = from_float<T>(to_float(e[j]) * r * wf[j]);
    yv[i] = *reinterpret_cast<const uint4*>(out);
  }
}

// Rows the register kernel does not take, element by element: one warp
// a row, the row read twice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, int rows, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float f = to_float(xr[i]);
    ss = fmaf(f, f, ss);
  }
  const float r = 1.0f / sqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32) yr[i] = from_float<T>(to_float(xr[i]) * r * w[i]);
}

template <typename T, int NV, int W>
void launch_rows(const void* x, const void* w, void* y, int rows, int d, float eps,
                 cudaStream_t stream) {
  const int blocks = W == 1 ? (rows + kRowsPerBlock - 1) / kRowsPerBlock : rows;
  rms_norm_row_kernel<T, NV, W><<<blocks, W == 1 ? kThreads : 32 * W, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), rows, d, eps);
}

// Vectors a lane holds for a row of nvec vectors over `lanes` lanes: the
// least of 1, 2, 4, 8 that covers it (0: more than 8).
int vectors_per_lane(int nvec, int lanes) {
  for (int nv = 1; nv <= 8; nv *= 2)
    if (nv * lanes >= nvec) return nv;
  return 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const bool vector = (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int nvec = d / kPer;
  if (vector) {
    // the least W of 1, 4, 16 whose warps hold the row in 8 vectors a lane
    for (const int W : {1, 4, 16}) {
      const int nv = vectors_per_lane(nvec, 32 * W);
      if (nv == 0) continue;
      switch (W * 16 + nv) {
        case 16 + 1: launch_rows<T, 1, 1>(x, w, y, rows, d, eps, stream); break;
        case 16 + 2: launch_rows<T, 2, 1>(x, w, y, rows, d, eps, stream); break;
        case 16 + 4: launch_rows<T, 4, 1>(x, w, y, rows, d, eps, stream); break;
        case 16 + 8: launch_rows<T, 8, 1>(x, w, y, rows, d, eps, stream); break;
        // wider rows: over 256 vectors (W = 4) or 1024 (W = 16), 3 to 8 a lane
        case 64 + 4: launch_rows<T, 4, 4>(x, w, y, rows, d, eps, stream); break;
        case 64 + 8: launch_rows<T, 8, 4>(x, w, y, rows, d, eps, stream); break;
        case 256 + 4: launch_rows<T, 4, 16>(x, w, y, rows, d, eps, stream); break;
        case 256 + 8: launch_rows<T, 8, 16>(x, w, y, rows, d, eps, stream); break;
        default: return cudaErrorInvalidValue;
      }
      return cudaGetLastError();
    }
  }
  rms_norm_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
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
