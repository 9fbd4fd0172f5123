// Paged-KV decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// devspace_tpu/ops/paged_attention.py (launched by `_paged_decode_pallas`):
// one decode step of attention for every row b of q [B, H, D] against
// that row's paged cache. K/V live in a head-major block pool
// [N, Hkv, bs, D] (each (block, head) a contiguous [bs, D] tile); row b
// owns blocks tables[b, 0..MB) and lengths[b] valid positions (clamped
// to MB * bs); table entries are clamped to [0, N). GQA: the
// n_rep = H / Hkv query heads of one KV head share every tile they read.
// Positions >= lengths[b] are masked, scores are scaled by 1/sqrt(D), the
// softmax is online with f32 running (m, l, acc), and a dead row
// (length 0) writes zeros.
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
// the H100's tensor cores would become the limit. So the design keeps
// enough K/V bytes in flight on every SM, reads each of them once, and
// keeps the per-tile math off the critical path:
//   - split-K over the cache: the grid is (split, query-head chunk, row).
//     The host picks the number of splits S from shapes alone
//     (`plan_splits` in ops/paged_attention.py), never from lengths, so a
//     launch reads nothing back and can be captured in a CUDA graph. On
//     the card each block cuts its row's ceil(length / bs) live blocks
//     into S near-equal runs (`split_range`) and walks its own: no block
//     walks masked tiles, and a short row leaves later splits empty;
//   - a ring of tiles fed by 1-D bulk copies: one producer warp issues,
//     per tile, one `cp.async.bulk` (the TMA unit without a tensor map)
//     for K and one for V (and two for the int8 scales) into a ring of
//     `stages` stages under full/empty mbarriers, so the next tiles' bytes
//     are in flight while this one is computed; no block-wide barrier
//     inside the loop;
//   - the math on CUDA cores, in registers: four consumer warps split each
//     tile by position. A group of `lanes` lanes spans a row's D elements
//     as 16-byte vectors (one or two a lane), holds its slice of the
//     block's R query heads, scores a position with one 16-byte load of K
//     and a shuffle reduction, and keeps its own online softmax (m, l,
//     acc, in the log2 domain) for the whole split; int8 tiles are
//     dequantized 16 values at a time. A chunk of positions is scored
//     with no branch, so their loads, products and shuffles overlap;
//   - the groups' partials merge once, at the end of the split, in group
//     order through shared memory. With S = 1 the block writes the output;
//     otherwise f32 partials (acc, m, l), which `combine_kernel` merges in
//     split order. No atomics: the output is bit-identical from launch to
//     launch.
// Tensor cores are not used: at ~1 flop per byte they would not move the
// bound.
//
// PAGED_DECODE_PROBE (scripts/probe_paged_decode.py) cuts the kernel for
// attribution: 1 keeps the loads and drops the math, 2 the reverse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

#ifndef PAGED_DECODE_PROBE
#define PAGED_DECODE_PROBE 0
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumerWarps = 4;
constexpr int kConsumerThreads = 32 * kConsumerWarps;
constexpr int kDecodeThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kMaxRingStages = 4;
constexpr int kMaxVecRegs = 64;    // floats of q (and of acc) a lane may hold
constexpr int kSmemLimit = 227 * 1024;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF mask value

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

// One 16-byte vector of the pool as f32 values of q's dtype T.
template <typename T, typename KV>
struct Vec {
  static constexpr int kElems = 16 / static_cast<int>(sizeof(KV));
  static __device__ __forceinline__ void load(const uint4& raw, float, float (&x)[kElems]) {
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int j = 0; j < kElems; ++j) x[j] = to_float(e[j]);
  }
};
template <typename T>
struct Vec<T, int8_t> {
  static constexpr int kElems = 16;
  // each int8 x becomes the f32 2^23 + (x + 128) by a byte permute, then x
  // by one subtraction (full-rate operations in place of the conversion
  // unit's); bf16 rounding takes two values per cvt.rn.bf16x2.f32
  static __device__ __forceinline__ void load(const uint4& raw, float scale, float (&x)[16]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = (__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + j)) - 8388736.f) * scale;
    }
    if constexpr (!std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[j], x[j + 1]);
        x[j] = __low2float(h);
        x[j + 1] = __high2float(h);
      }
    }
  }
};

struct Params {
  const void* q;         // [B, H, D], T
  const void* pool_k;    // [N, Hkv, bs, D], KV
  const void* pool_v;
  const float* k_scale;  // [N, Hkv, bs] (int8 pools)
  const float* v_scale;
  const int* tables;     // [B, MB]
  const int* lengths;    // [B]
  void* out;             // [B, H, D], T
  float* part_acc;       // [S, B, H, D] (S > 1)
  float* part_ml;        // [S, B, H, 2]: running max (log2 domain), sum
  int B, H, Hkv, D, bs, MB, N;
  int n_rep, n_chunks, n_split, stages, lanes;
  int tile_bytes, scale_bytes, stage_bytes, bar_offset;
  float scale_log2;      // log2(e) / sqrt(D)
};

// Run [j0, j1) of a row's n_blk live blocks that split s of S walks:
// near-equal runs in order (`split_range` in ops/paged_attention.py).
__device__ __forceinline__ void split_range(int s, int n_blk, int S, int& j0, int& j1) {
  j0 = static_cast<int>(static_cast<long long>(s) * n_blk / S);
  j1 = static_cast<int>(static_cast<long long>(s + 1) * n_blk / S);
}

// barrier 1 over the consumer warps (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

template <typename T, typename KV, int NV, int R>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(const Params p) {
  using V = Vec<T, KV>;
  constexpr int E = V::kElems;
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  // positions a group scores per softmax update: its share of a
  // 64-position tile at D = 128 (128 / E lanes a position), at most 8
  constexpr int C = 256 / (E * kConsumerWarps) < 8 ? 256 / (E * kConsumerWarps) : 8;
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x;
  const int hk = blockIdx.y / p.n_chunks;
  const int r0 = (blockIdx.y % p.n_chunks) * R;
  const int nr = min(R, p.n_rep - r0);  // query heads of this block
  const int b = blockIdx.z;
  const int length = max(0, min(p.lengths[b], p.MB * p.bs));
  const int n_blk = (length + p.bs - 1) / p.bs;
  int j0, j1;
  split_range(split, n_blk, p.n_split, j0, j1);
  const int n_tiles = j1 - j0;
  const int tid = threadIdx.x;
  const size_t head0 = static_cast<size_t>(b) * p.H + hk * p.n_rep + r0;  // first (row, head)
  const size_t part0 = static_cast<size_t>(split) * p.B * p.H + head0;

  if (n_tiles == 0) {  // a dead row writes zeros, an empty split l = 0
    if (p.n_split == 1) {
      T* out = static_cast<T*>(p.out) + head0 * p.D;
      for (int i = tid; i < nr * p.D; i += blockDim.x) out[i] = from_float<T>(0.f);
    } else {
      for (int r = tid; r < nr; r += blockDim.x) {
        p.part_ml[(part0 + r) * 2] = kNegInf;
        p.part_ml[(part0 + r) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  const uint32_t full0 = smem_u32(smem + p.bar_offset);
  const uint32_t empty0 = full0 + 8 * kMaxRingStages;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (warp == kConsumerWarps) {
    // producer: lane l reads table entry l of each run of 32 tiles (clamped
    // as JAX's gather clamps), lane 0 issues the copies
    const int* table = p.tables + static_cast<size_t>(b) * p.MB + j0;
    for (int base = 0; base < n_tiles; base += 32) {
      const int blk = base + lane < n_tiles ? min(max(table[base + lane], 0), p.N - 1) : 0;
      const int count = min(32, n_tiles - base);
      for (int k = 0; k < count; ++k) {
        const int bk = __shfl_sync(0xffffffffu, blk, k);
        if (lane == 0) {
          const int t = base + k;
          const int st = t % p.stages;
          const uint32_t full = full0 + 8 * st;
          if (t >= p.stages) mbar_wait(empty0 + 8 * st, ((t / p.stages) - 1) & 1);
#if PAGED_DECODE_PROBE == 2
          mbar_arrive(full);
#else
          const size_t tile = static_cast<size_t>(bk) * p.Hkv + hk;
          const uint32_t dst = smem_u32(smem + st * p.stage_bytes);
          mbar_arrive_expect_tx(full, 2 * (p.tile_bytes + p.scale_bytes));
          bulk_g2s(dst, static_cast<const char*>(p.pool_k) + tile * p.tile_bytes, p.tile_bytes,
                   full);
          bulk_g2s(dst + p.tile_bytes, static_cast<const char*>(p.pool_v) + tile * p.tile_bytes,
                   p.tile_bytes, full);
          if constexpr (kInt8) {
            bulk_g2s(dst + 2 * p.tile_bytes, p.k_scale + tile * p.bs, p.scale_bytes, full);
            bulk_g2s(dst + 2 * p.tile_bytes + p.scale_bytes, p.v_scale + tile * p.bs,
                     p.scale_bytes, full);
          }
#endif
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumers: group `group` of `lanes` lanes; lane gl holds 16-byte
  // vectors gl, gl + lanes, ... of every row
  const int lanes = p.lanes;
  const int groups = kConsumerThreads / lanes;
  const int group = tid / lanes;
  const int gl = tid - group * lanes;
  const int nvec = p.D / E;
  bool vlive[NV];  // a lane past the row's vectors holds zeros and reads vector 0
  int vec[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    vlive[k] = gl + k * lanes < nvec;
    vec[k] = vlive[k] ? gl + k * lanes : 0;
  }

  float q[R][NV][E], acc[R][NV][E], m[R], l[R];
  const T* qg = static_cast<const T*>(p.q) + head0 * p.D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc[r][k][e] = 0.f;
        q[r][k][e] = r < nr && vlive[k] ? to_float(qg[r * p.D + (gl + k * lanes) * E + e]) : 0.f;
      }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % p.stages;
    mbar_wait(full0 + 8 * st, (t / p.stages) & 1);
#if PAGED_DECODE_PROBE != 1
    const unsigned char* stage = smem + st * p.stage_bytes;
    const uint4* kt = reinterpret_cast<const uint4*>(stage);
    const uint4* vt = reinterpret_cast<const uint4*>(stage + p.tile_bytes);
    const float* ksc = reinterpret_cast<const float*>(stage + 2 * p.tile_bytes);
    const float* vsc = ksc + p.bs;
    const int valid = min(p.bs, length - (j0 + t) * p.bs);  // live positions of the tile
    // C positions a group, group + c * groups, scored with no branch: a
    // position past the tile's live ones reads row 0 and is masked; the
    // chunk's dot products reduce over the group's lanes level by level,
    // C * R independent shuffles a level
    for (int c0 = 0; c0 < valid; c0 += groups * C) {
      float s[R][C];
      bool live[C];
      int row[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int pos = c0 + group + c * groups;
        live[c] = pos < valid;
        row[c] = live[c] ? pos : 0;
        const float sc = kInt8 ? ksc[row[c]] : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][c] = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          float x[E];
          V::load(kt[row[c] * nvec + vec[k]], sc, x);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e) s[r][c] = fmaf(q[r][k][e], x[e], s[r][c]);
        }
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int r = 0; r < R; ++r) s[r][c] += __shfl_xor_sync(0xffffffffu, s[r][c], o);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][c] = live[c] ? s[r][c] * p.scale_log2 : kNegInf;
      // one online-softmax update for the chunk
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int c = 0; c < C; ++c) mx = fmaxf(mx, s[r][c]);
        const float alpha = exp2_approx(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[r][c] = live[c] ? exp2_approx(s[r][c] - mx) : 0.f;
          sum += s[r][c];
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][k][e] *= alpha;
      }
      // acc += p V (a masked position adds 0 * row 0)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float sc = kInt8 ? vsc[row[c]] : 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          float x[E];
          V::load(vt[row[c] * nvec + vec[k]], sc, x);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][k][e] = fmaf(s[r][c], x[e], acc[r][k][e]);
        }
      }
    }
#endif
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // merge the groups' partials in group order; the buffers reuse the ring
  // (every copy has landed), once every consumer has left it
  float* mbuf = reinterpret_cast<float*>(smem);  // [groups][R][2]
  float* abuf = mbuf + groups * R * 2;           // [groups][R][D]
  consumer_sync();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= nr) continue;
    if (gl == 0) {
      mbuf[(group * R + r) * 2] = m[r];
      mbuf[(group * R + r) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!vlive[k]) continue;
#pragma unroll
      for (int e = 0; e < E; ++e)
        abuf[(group * R + r) * p.D + (gl + k * lanes) * E + e] = acc[r][k][e];
    }
  }
  consumer_sync();
  for (int i = tid; i < nr * p.D; i += kConsumerThreads) {
    const int r = i / p.D;
    const int d = i - r * p.D;
    float mx = kNegInf;
    for (int g = 0; g < groups; ++g) mx = fmaxf(mx, mbuf[(g * R + r) * 2]);
    float sum = 0.f, a = 0.f;
    for (int g = 0; g < groups; ++g) {
      const float w = exp2_approx(mbuf[(g * R + r) * 2] - mx);
      sum += mbuf[(g * R + r) * 2 + 1] * w;
      a += abuf[(g * R + r) * p.D + d] * w;
    }
    if (p.n_split == 1) {
      static_cast<T*>(p.out)[head0 * p.D + i] = from_float<T>(sum > 0.f ? a / sum : 0.f);
    } else {
      p.part_acc[part0 * p.D + i] = a;
      if (d == 0) {
        p.part_ml[(part0 + r) * 2] = mx;
        p.part_ml[(part0 + r) * 2 + 1] = sum;
      }
    }
  }
}

// out[row, d] from the S splits' partials, merged in split order; a
// split with l = 0 holds nothing, and a row with none writes zeros.
template <typename T>
__global__ void __launch_bounds__(256)
    combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                   T* __restrict__ out, int rows, int D, int S) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * D) return;
  const size_t row = i / D;
  float mx = kNegInf;
  for (int s = 0; s < S; ++s) {
    const float* ml = part_ml + (static_cast<size_t>(s) * rows + row) * 2;
    if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
  }
  float sum = 0.f, a = 0.f;
  for (int s = 0; s < S; ++s) {
    const float* ml = part_ml + (static_cast<size_t>(s) * rows + row) * 2;
    if (ml[1] > 0.f) {
      const float w = exp2_approx(ml[0] - mx);
      sum += ml[1] * w;
      a += part_acc[static_cast<size_t>(s) * rows * D + i] * w;
    }
  }
  out[i] = from_float<T>(sum > 0.f ? a / sum : 0.f);
}

template <typename T, typename KV, int NV, int R>
cudaError_t launch_split(const Params& p, dim3 grid, int smem, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, KV, NV, R>;
  static int smem_set = 48 * 1024;  // dynamic shared memory granted so far
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kernel<<<grid, kDecodeThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// Query heads a block takes: every head of the group up to the register
// budget (a power of two).
template <typename T, typename KV, int NV>
cudaError_t launch_rows(Params& p, int R, int smem_ring, cudaStream_t stream) {
  constexpr int E = Vec<T, KV>::kElems;
  p.n_chunks = (p.n_rep + R - 1) / R;
  const int groups = kConsumerThreads / p.lanes;
  const int merge = groups * R * (p.D + 2) * 4;
  p.bar_offset = round_up(std::max(smem_ring, merge), 16);
  const int smem = p.bar_offset + 2 * kMaxRingStages * 8;
  if (smem > kSmemLimit || p.Hkv * p.n_chunks > 65535 || p.B > 65535) return cudaErrorInvalidValue;
  const dim3 grid(p.n_split, p.Hkv * p.n_chunks, p.B);
  switch (R) {
    case 1: return launch_split<T, KV, NV, 1>(p, grid, smem, stream);
    case 2:
      if constexpr (2 * NV * E <= kMaxVecRegs) return launch_split<T, KV, NV, 2>(p, grid, smem, stream);
      break;
    case 4:
      if constexpr (4 * NV * E <= kMaxVecRegs) return launch_split<T, KV, NV, 4>(p, grid, smem, stream);
      break;
    case 8:
      if constexpr (8 * NV * E <= kMaxVecRegs) return launch_split<T, KV, NV, 8>(p, grid, smem, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename KV>
cudaError_t launch(Params& p, cudaStream_t stream) {
  constexpr int E = Vec<T, KV>::kElems;
  if (p.D % E != 0 || p.stages < 1 || p.stages > kMaxRingStages || p.n_split < 1)
    return cudaErrorInvalidValue;
  const int nvec = p.D / E;
  if (nvec > 64) return cudaErrorInvalidValue;
  const int NV = nvec > 32 ? 2 : 1;
  p.lanes = NV == 1 ? pow2_at_least(nvec) : 32;
  p.tile_bytes = p.bs * p.D * static_cast<int>(sizeof(KV));
  p.scale_bytes = std::is_same<KV, int8_t>::value ? p.bs * 4 : 0;
  p.stage_bytes = 2 * (p.tile_bytes + p.scale_bytes);
  p.scale_log2 = kLog2e / sqrtf(static_cast<float>(p.D));
  const int rows_max = kMaxVecRegs / (NV * E);
  const int R = std::min(pow2_at_least(p.n_rep), std::min(rows_max, 8));
  const int ring = p.stages * p.stage_bytes;
  cudaError_t e = NV == 1 ? launch_rows<T, KV, 1>(p, R, ring, stream)
                          : launch_rows<T, KV, 2>(p, R, ring, stream);
  if (e != cudaSuccess || p.n_split == 1) return e;
  const size_t total = static_cast<size_t>(p.B) * p.H * p.D;
  combine_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      p.part_acc, p.part_ml, static_cast<T*>(p.out), p.B * p.H, p.D, p.n_split);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). q_bf16: q/out are bf16 (else
// f32); kv_int8: the pools are int8 with f32 scales (else q's dtype and
// the scale pointers are null). n_split: splits of each row's cache
// (plan_splits); stages: ring depth; scratch: f32 [n_split * B * H *
// (D + 2)] for the partials when n_split > 1 (else unused). Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int paged_decode(int q_bf16, int kv_int8, const void* q, const void* pool_k,
                            const void* pool_v, const void* k_scale, const void* v_scale,
                            const void* tables, const void* lengths, void* out, int B, int H,
                            int Hkv, int D, int bs, int MB, int N, int n_split, int stages,
                            void* scratch, void* stream) {
  Params p{};
  p.q = q;
  p.pool_k = pool_k;
  p.pool_v = pool_v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part_acc = static_cast<float*>(scratch);
  p.part_ml = p.part_acc == nullptr
                  ? nullptr
                  : p.part_acc + static_cast<size_t>(n_split) * B * H * D;
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.bs = bs;
  p.MB = MB;
  p.N = N;
  p.n_rep = H / Hkv;
  p.n_split = n_split;
  p.stages = stages;
  if (n_split > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    if (kv_int8) return launch<bf16, int8_t>(p, st);
    return launch<bf16, bf16>(p, st);
  }
  if (kv_int8) return launch<float, int8_t>(p, st);
  return launch<float, float>(p, st);
}
