// Paged-KV decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// devspace_tpu/ops/paged_attention.py (launched by `_paged_decode_pallas`):
// one decode step of attention for every row b of q [B, H, D] against
// that row's paged cache. K/V live in a head-major block pool
// [N, Hkv, bs, D] (each (block, head) a contiguous [bs, D] tile); row b
// owns blocks tables[b, 0..MB) and lengths[b] valid positions. GQA:
// the n_rep = H / Hkv query heads of one KV head share every tile they
// read. Positions >= lengths[b] are masked, scores are scaled by
// 1/sqrt(D), the softmax is online with f32 running (m, l, acc), and a
// dead row (length 0) writes zeros.
//
// Int8 pools carry one f32 scale per (block, head, position) in
// k_scale/v_scale [N, Hkv, bs]; each element is dequantized in registers
// and rounded to q's dtype before it is used, as the reference's
// dequantize_kv(..., q.dtype) does.
//
// Bound: memory. The work is 4 * sum_b lengths[b] * H * D flops against
// 2 * sum_b lengths[b] * Hkv * D * sizeof(pool element) bytes of K/V
// (plus 2 * 4 bytes of scales per (position, head) for int8): about one
// flop per byte at MHA widths, far below the ~295 flops per byte where
// the H100's tensor cores would become the limit. So the design reads
// each K/V byte from device memory exactly once and nothing else:
//   - one CUDA block per (row b, KV head): the n_rep query heads of the
//     group are multiplied against each tile while it sits in shared
//     memory, so grouped K/V are never re-read or materialized;
//   - the block walks only j < ceil(lengths[b] / bs) (exact for per-row
//     lengths) and loads tables[b, j] itself, in place of the TPU's
//     scalar prefetch;
//   - each [bs, D] tile is copied with 16-byte loads, neighbouring
//     threads on neighbouring addresses;
//   - no gathered copy of the cache is written (the plain version's
//     pool[tables] gather is what the kernel removes).
// This first version does not overlap the next tile's load with the
// current tile's math (no cp.async/TMA pipeline), does not split long
// contexts over several blocks, and does its dots on CUDA cores; those
// are the known gaps to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF mask value

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Element (t, d) of a K/V tile in shared memory, as q's dtype holds it.
template <typename T, typename KV>
struct TileElem {
  static __device__ __forceinline__ float at(const KV* tile, const float*,
                                             int t, int d, int D) {
    return to_float<T>(tile[t * D + d]);
  }
};
template <typename T>
struct TileElem<T, int8_t> {
  static __device__ __forceinline__ float at(const int8_t* tile,
                                             const float* scale, int t, int d,
                                             int D) {
    const float x = static_cast<float>(tile[t * D + d]) * scale[t];
    return to_float<T>(from_float<T>(x));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte vector copy, global -> shared; `bytes` is a multiple of 16 and
// both addresses are 16-byte aligned (the wrapper checks).
__device__ __forceinline__ void copy_tile(void* dst, const void* src,
                                          int bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q,         // [B, H, D]
                        const KV* __restrict__ pool_k,   // [N, Hkv, bs, D]
                        const KV* __restrict__ pool_v,   // [N, Hkv, bs, D]
                        const float* __restrict__ k_scale,  // [N, Hkv, bs]
                        const float* __restrict__ v_scale,  // or null
                        const int* __restrict__ tables,   // [B, MB]
                        const int* __restrict__ lengths,  // [B]
                        T* __restrict__ out,              // [B, H, D]
                        int H, int Hkv, int D, int bs, int MB, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int n_rep = H / Hkv;
  const int tile_elems = bs * D;
  KV* k_tile = reinterpret_cast<KV*>(smem);
  KV* v_tile = k_tile + tile_elems;
  float* qs = reinterpret_cast<float*>(v_tile + tile_elems);  // [n_rep, D]
  float* acc = qs + n_rep * D;                                 // [n_rep, D]
  float* s = acc + n_rep * D;  // [n_rep, bs] scores, then probabilities
  float* ksc = s + n_rep * bs;  // [bs]
  float* vsc = ksc + bs;        // [bs]
  float* m = vsc + bs;          // [n_rep]
  float* l = m + n_rep;         // [n_rep]
  float* alpha = l + n_rep;     // [n_rep]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const size_t row0 = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * n_rep) * D;
  for (int i = tid; i < n_rep * D; i += blockDim.x) {
    qs[i] = to_float<T>(q[row0 + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < n_rep; r += blockDim.x) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const int length = max(0, min(lengths[b], MB * bs));
  const int n_blk = (length + bs - 1) / bs;
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(D));

  for (int j = 0; j < n_blk; ++j) {
    // out-of-range table entries are clamped (JAX's gather clamps too),
    // so a bad table can never read outside the pool
    const int blk = min(max(tables[static_cast<size_t>(b) * MB + j], 0), N - 1);
    const size_t tile = (static_cast<size_t>(blk) * Hkv + hk);
    __syncthreads();  // the previous tile is fully consumed
    copy_tile(k_tile, pool_k + tile * tile_elems, tile_elems * sizeof(KV));
    copy_tile(v_tile, pool_v + tile * tile_elems, tile_elems * sizeof(KV));
    if (k_scale != nullptr) {
      for (int t = tid; t < bs; t += blockDim.x) {
        ksc[t] = k_scale[tile * bs + t];
        vsc[t] = v_scale[tile * bs + t];
      }
    }
    __syncthreads();

    // scores: one warp per position, lanes split D
    const int base = j * bs;
    for (int t = warp; t < bs; t += nwarps) {
      const bool live = base + t < length;  // warp-uniform
      for (int r = 0; r < n_rep; ++r) {
        float dot = 0.f;
        if (live) {
          for (int d = lane; d < D; d += 32)
            dot += qs[r * D + d] * TileElem<T, KV>::at(k_tile, ksc, t, d, D);
          dot = warp_sum(dot);
        }
        if (lane == 0) s[r * bs + t] = live ? dot * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < n_rep; r += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, s[r * bs + t]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = expf(s[r * bs + t] - m_new);
        s[r * bs + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = a * l[r] + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V: one thread per (row, d)
    for (int i = tid; i < n_rep * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i - r * D;
      const float* p = s + r * bs;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < bs; ++t)
        a += p[t] * TileElem<T, KV>::at(v_tile, vsc, t, d, D);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < n_rep * D; i += blockDim.x) {
    const float li = l[i / D];
    out[row0 + i] = from_float<T>(acc[i] / (li == 0.f ? 1.f : li));
  }
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* lengths, void* out, int B,
                   int H, int Hkv, int D, int bs, int MB, int N,
                   cudaStream_t stream) {
  const int n_rep = H / Hkv;
  const size_t smem =
      2 * static_cast<size_t>(bs) * D * sizeof(KV) +
      sizeof(float) * (2 * static_cast<size_t>(n_rep) * D +
                       static_cast<size_t>(n_rep) * bs + 2 * static_cast<size_t>(bs) +
                       3 * static_cast<size_t>(n_rep));
  auto kernel = paged_decode_kernel<T, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(pool_k),
      static_cast<const KV*>(pool_v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, Hkv, D, bs,
      MB, N);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). q_bf16: q/out are bf16 (else
// f32); kv_int8: the pools are int8 with f32 scales (else q's dtype and
// the scale pointers are null). Returns the cudaError_t of the launch.
extern "C" int paged_decode(int q_bf16, int kv_int8, const void* q,
                            const void* pool_k, const void* pool_v,
                            const void* k_scale, const void* v_scale,
                            const void* tables, const void* lengths, void* out,
                            int B, int H, int Hkv, int D, int bs, int MB,
                            int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_int8)
      return launch<__nv_bfloat16, int8_t>(q, pool_k, pool_v, k_scale,
                                           v_scale, tables, lengths, out, B,
                                           H, Hkv, D, bs, MB, N, st);
    return launch<__nv_bfloat16, __nv_bfloat16>(q, pool_k, pool_v, nullptr,
                                                nullptr, tables, lengths, out,
                                                B, H, Hkv, D, bs, MB, N, st);
  }
  if (kv_int8)
    return launch<float, int8_t>(q, pool_k, pool_v, k_scale, v_scale, tables,
                                 lengths, out, B, H, Hkv, D, bs, MB, N, st);
  return launch<float, float>(q, pool_k, pool_v, nullptr, nullptr, tables,
                              lengths, out, B, H, Hkv, D, bs, MB, N, st);
}
