// Fused softmax cross-entropy forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_xent_kernel` in
// devspace_tpu/ops/losses.py (launched by `_xent_pallas_fwd`): for each
// row b of logits [B, V] (f32 or bf16) and its label, the per-row loss
// lse(logits[b]) - logits[b, label[b]] and the lse itself, both f32 [B].
// The backward, (softmax - onehot) * g, is plain tensor math in the
// wrapper, as in the reference.
//
// Labels are int64 (as tokens arrive), read directly. A label in [-V, 0)
// picks column label + V and any other label outside [0, V) gives a NaN
// loss: the reference function (cross_entropy_reference, whose gather
// wraps a negative index and fills an out-of-range one with NaN).
//
// Bound: memory. Each logit is read once and costs a handful of flops,
// far below the ~295 flops per byte where the tensor cores would bound
// it; at a training shape ([16384, 32000] f32) the read is 2.1 GB. So:
//   - one block per row streams the row once with 16-byte loads
//     (neighbouring threads on neighbouring addresses), never holding it:
//     a 32000-wide f32 row is 128 KB;
//   - each thread keeps an online (max, sum of exp) pair in f32, rescaled
//     once per 16-byte vector; the pairs merge across the warp by shuffles
//     and across warps through shared memory;
//   - the label's logit is one more load of an element the row just read.
// The TPU kernel's [BR, 1] label/output layout and its VMEM row budget do
// not carry over: any B works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (m, s) <- the pair for the union of two sets: max and sum of exp(x - max)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both sets empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_kernel(const T* __restrict__ logits,
                const int64_t* __restrict__ labels, float* __restrict__ loss,
                float* __restrict__ lse_out, int V) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte vector
  __shared__ float warp_m[kThreads / 32];
  __shared__ float warp_s[kThreads / 32];
  const int b = blockIdx.x;
  const T* x = logits + static_cast<size_t>(b) * V;

  float m = -INFINITY, s = 0.f;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int n_vec = vec ? V / kPer : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    float vals[kPer];
    float vm = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      vals[j] = to_float<T>(e[j]);
      vm = fmaxf(vm, vals[j]);
    }
    if (vm > m) {
      s *= expf(m - vm);
      m = vm;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) s += expf(vals[j] - m);
  }
  for (int i = n_vec * kPer + threadIdx.x; i < V; i += kThreads) {
    const float val = to_float<T>(x[i]);
    if (val > m) {
      s *= expf(m - val);
      m = val;
    }
    s += expf(val - m);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_m[warp] = m;
    warp_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) merge(m, s, warp_m[w], warp_s[w]);
    const float lse = m + logf(s);
    int64_t label = labels[b];
    if (label < 0) label += V;  // -V <= label < 0 wraps
    const float picked =
        (label >= 0 && label < V) ? to_float<T>(x[label]) : NAN;
    loss[b] = lse - picked;
    lse_out[b] = lse;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). is_bf16: logits are bf16 (else
// f32); labels int64 [B]; loss and lse f32 [B]. Returns the cudaError_t
// of the launch.
extern "C" int cross_entropy_fwd(int is_bf16, const void* logits,
                                 const void* labels, void* loss, void* lse,
                                 int B, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    xent_kernel<__nv_bfloat16><<<B, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<const int64_t*>(labels), static_cast<float*>(loss),
        static_cast<float*>(lse), V);
  else
    xent_kernel<float><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(logits), static_cast<const int64_t*>(labels),
        static_cast<float*>(loss), static_cast<float*>(lse), V);
  return cudaGetLastError();
}
