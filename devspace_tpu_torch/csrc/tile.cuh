// Tile helpers of the attention kernels' f32 paths (flash_attention.cu,
// attention.cu, flash_backward.cu): the element types, shared-memory row
// strides, tile loads with a masked ragged edge, the scalar f32 tile
// product, the row-group reductions of the softmax loops, and the launch
// helpers every attention source uses.
// Everything sits in an unnamed namespace: each source gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF mask value

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int rows = 32;
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// Shared-memory row strides, padded by 16 bytes so that neighbouring rows
// start in other banks (the tile products and the row loops read down
// columns).
template <typename T, int N>
struct Ld {
  static constexpr int value = N + 16 / static_cast<int>(sizeof(T));
};

// Rows row0 .. row0+R-1 of a [T, D] matrix into dst [R, ld D] with 16-byte
// vectors; rows at or past T are zero-filled.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int t_len) {
  constexpr int kVec = D * static_cast<int>(sizeof(T)) / 16;  // per row
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < R * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = i - r * kVec;
    const int row = row0 + r;
    d[r * (kVec + 1) + c] = row < t_len ? s[static_cast<size_t>(row) * kVec + c]
                                        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// C[M, N] (f32, shared) = (accumulate ? C : 0) + op(A) op(B), op(A) [M, K]
// and op(B) [K, N], in scalar f32 (one thread per output element). TA: A
// is stored [K, M] (lda = M's stride), else [M, K]; TB: B is stored
// [N, K], else [K, N]. All row-major in shared memory.
template <bool TA, bool TB, int M, int N, int K>
__device__ __forceinline__ void tile_mma(const float* A, int lda,
                                         const float* B, int ldb, float* C,
                                         int ldc, bool accumulate) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N;
    const int n = i - m * N;
    float acc = accumulate ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = TA ? A[k * lda + m] : A[m * lda + k];
      const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
      acc = fmaf(a, b, acc);
    }
    C[m * ldc + n] = acc;
  }
}

__device__ __forceinline__ bool live(int q_pos, int k_pos, int t_len,
                                     int causal) {
  return k_pos < t_len && q_pos < t_len && (!causal || q_pos >= k_pos);
}

// Reductions over the kTPR neighbouring lanes that share one row.
template <int kTPR>
__device__ __forceinline__ float group_max(float v) {
  for (int o = kTPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int kTPR>
__device__ __forceinline__ float group_sum(float v) {
  for (int o = kTPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory beyond 48 KB, and the largest shared-memory share
// of the SM's on-chip memory, so that as many blocks fit on an SM as
// their shared memory allows.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess || smem <= 48 * 1024) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Returns LAUNCH<T, D>(args...) for the runtime dtype flag `is_bf16` and
// head dim `d`; head dims other than 16, 32, 64 and 128 are refused.
#define TILE_DISPATCH(LAUNCH, ...)                                          \
  switch (d) {                                                              \
    case 16:                                                                \
      return is_bf16 ? LAUNCH<bf16, 16>(__VA_ARGS__)                        \
                     : LAUNCH<float, 16>(__VA_ARGS__);                      \
    case 32:                                                                \
      return is_bf16 ? LAUNCH<bf16, 32>(__VA_ARGS__)                        \
                     : LAUNCH<float, 32>(__VA_ARGS__);                      \
    case 64:                                                                \
      return is_bf16 ? LAUNCH<bf16, 64>(__VA_ARGS__)                        \
                     : LAUNCH<float, 64>(__VA_ARGS__);                      \
    case 128:                                                               \
      return is_bf16 ? LAUNCH<bf16, 128>(__VA_ARGS__)                       \
                     : LAUNCH<float, 128>(__VA_ARGS__);                     \
    default:                                                                \
      return cudaErrorInvalidValue;                                         \
  }

}  // namespace
