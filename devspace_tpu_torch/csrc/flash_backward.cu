// Flash attention backward for NVIDIA Hopper (sm_90a): the dq kernel and
// the dk/dv kernel.
//
// Replaces the Pallas TPU kernels of devspace_tpu/ops/flash_attention.py:
//   flash_bwd_dq   <- `_bwd_dq_kernel`  (launched by `_flash_bwd_call`)
//   flash_bwd_dkv  <- `_bwd_dkv_kernel` (launched by `_flash_bwd_call`)
// on q, k, v, dO [BH, T, D] (row-major, contiguous) with lse and delta f32
// [BH, T]. P = exp(S scale - lse) with S = Q K^T and the -1e30 causal mask,
// delta = rowsum(dO * O) from the caller, dS = P (dP - delta) scale with
// dP = dO V^T; dQ = bf16(dS) K, dK = dS^T Q and dV = P^T dO.
//
// Bound: at training shapes (T = 2048, D = 64) the work is 6 D flops per
// (query, key) pair for dq and 8 D for dk/dv against 2 D bytes read per
// row: far above the ~295 flops per byte where the H100's tensor cores,
// not memory, are the limit. So the design keeps the tensor cores fed.
//
// bf16 design (warp specialised, one block of three warpgroups):
//   - warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//     streams tiles through a ring of kStages stages in shared memory with
//     16-byte cp.async into 128-byte-swizzled tiles (hopper.cuh); rows past
//     T, and the columns past D of a head dim below 64, are zero-filled. A
//     stage is guarded by two mbarriers: `full` (each producer thread
//     arrives once its copies land) and `empty` (each consumer thread
//     arrives once its products have read the stage);
//   - warpgroups 1 and 2 are consumers, 64 rows each, with the registers
//     the producer gave up. Every product is a wgmma with f32 accumulators
//     in registers;
//   - dk/dv: one block per (bh, 128 keys). K and V are loaded once; Q, dO,
//     lse and delta stream by q-tiles. S^T = K Q^T and dP^T = V dO^T come
//     out [k, q], so P^T and dS^T are formed in the accumulator registers
//     (lse and delta read per column) and repacked there into wgmma A
//     fragments; dV += P^T dO and dK += dS^T Q read dO and Q MN-major from
//     the same stage. The reference keeps dV and dK in f32: P and dS go in
//     as two bf16 terms (hi = bf16(x), lo = bf16(x - hi)), an error of
//     about 2^-16 of each term instead of bf16's 2^-8, at 12 D tensor
//     flops per pair instead of 8 D;
//   - dq: one block per (bh, 128 queries). Q, dO, lse and delta are loaded
//     once; K and V stream by k-tiles. S = Q K^T and dP = dO V^T, dS is
//     formed in registers and rounded to bf16 as the reference does, and
//     dQ += dS K reads K MN-major;
//   - one commit group a step: the previous step's register-A products
//     (dV, dK; or dQ) go out with this step's S and dP, and one wait
//     covers them; the previous stage is released after it;
//   - the elementwise part is what the tensor cores wait for: P comes from
//     ex2.approx, and only a step that crosses the diagonal or the end of T
//     runs the masked copy of the loop (rows past T are never stored, so
//     they go unmasked);
//   - no S, P or dS tile reaches shared memory; dQ, dK and dV stay in
//     registers across the loop and each block owns its output rows: no
//     atomics, two runs give bit-identical results;
//   - causal: tiles wholly above the diagonal are not loaded; a consumer
//     whose 64 rows lie wholly above the diagonal of a stage skips it; the
//     heaviest causal tiles launch first;
//   - head dims 16 and 32 are padded with zero columns to 64 in shared
//     memory (products over D read only D columns; products whose N is D
//     compute 64 columns and store D);
//   - registers: at D = 128 the dk/dv q-tile is 32 rows, so that dK and dV
//     (128 f32 registers a thread) leave room for S^T, dP^T and their
//     fragments; the dq k-tile is 128 keys up to D = 64 and 64 at D = 128.
// f32 inputs (parity at full precision, not a training path) take a scalar
// f32 kernel per output tile with block-wide steps.

#include <cmath>

#include "hopper.cuh"  // mbarriers, cp.async, wgmma, the ring, accumulator helpers
#include "tile.cuh"    // element types, scalar tile product, masks, launch helpers

namespace {

template <int R>
__device__ __forceinline__ void load_rowvec(uint32_t dst, const float* src, int row0, int t_len,
                                            int tid) {
  for (int i = tid; i < R; i += 128) {
    const bool ok = row0 + i < t_len;
    cp_async4(dst + 4 * i, ok ? src + row0 + i : src, ok);
  }
}

// hi and lo bf16 A fragments of an f32 accumulator whose columns are the
// next product's K (the layouts match register for register).
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N], uint32_t (&hi)[N / 2],
                                            uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
}

// ------------------------------------------------------------ bf16 dk/dv
template <int D>
struct DkvCfg {
  static constexpr int DP = D < 64 ? 64 : D;     // padded head dim
  static constexpr int BK = 64 * kConsumers;     // keys per block
  static constexpr int BQ = D > 64 ? 32 : 64;    // queries per stage
  static constexpr int kK = 0;
  static constexpr int kV = BK * DP * 2;
  static constexpr int kStage0 = 2 * BK * DP * 2;
  static constexpr int kQ = 0, kDo = BQ * DP * 2;  // inside a stage
  static constexpr int kLse = 2 * BQ * DP * 2, kDelta = kLse + BQ * 4;
  static constexpr int kStageBytes = round_up(kDelta + BQ * 4, 1024);
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr size_t bytes = kBar + (2 * kStages + 1) * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    flash_bwd_dkv_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
                              int causal) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, DP = C::DP, BK = C::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + C::kBar, empty = full + 8 * kStages, kv_bar = empty + 8 * kStages;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // causal: the first k-tiles see the most q-tiles
  const size_t mat = static_cast<size_t>(bh) * t_len * D;
  const size_t vec = static_cast<size_t>(bh) * t_len;
  const int nq = (t_len + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;  // earlier q-tiles lie above the diagonal
  const int n_steps = nq - q_first;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    mbar_init(kv_bar, 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    load_tile<BK, D, DP>(base + C::kK, k + mat, k0, t_len, tid);
    load_tile<BK, D, DP>(base + C::kV, v + mat, k0, t_len, tid);
    cp_async_arrive(kv_bar);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
      const int q0 = (q_first + i) * BQ;
      const uint32_t st = base + C::kStage0 + s * C::kStageBytes;
      load_tile<BQ, D, DP>(st + C::kQ, q + mat, q0, t_len, tid);
      load_tile<BQ, D, DP>(st + C::kDo, dout + mat, q0, t_len, tid);
      load_rowvec<BQ>(st + C::kLse, lse + vec, q0, t_len, tid);
      load_rowvec<BQ>(st + C::kDelta, delta + vec, q0, t_len, tid);
      cp_async_arrive(full + 8 * s);
    }
    cp_async_wait_all();
    return;
  }

  // consumer warpgroup w: keys kw0 .. kw0 + 63
  setmaxnreg_inc<kConsumerRegs>();
  const int w = wg - 1;
  const int kw0 = k0 + 64 * w;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: row, row + 8
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * kLog2e;
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // the first live query of this thread's rows (keys): q >= key when causal
  const int lo[2] = {causal ? kw0 + row : 0, causal ? kw0 + row + 8 : 0};
  // P^T and dS^T of the previous step as hi/lo A fragments: their products
  // go out with the next step's S^T and dP^T, in one commit group
  uint32_t p_hi[BQ / 4], p_lo[BQ / 4], ds_hi[BQ / 4], ds_lo[BQ / 4];
  bool have_prev = false;
  int prev = 0;
  mbar_wait(kv_bar, 0);
  for (int i = 0; i <= n_steps; ++i) {
    const int s = i % kStages;
    const int q0 = (q_first + i) * BQ;
    // a step whose (q, k) pairs are all masked is skipped
    const bool live_step = i < n_steps && !(causal && q0 + BQ - 1 < kw0);
    if (i < n_steps) mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t st = base + C::kStage0 + s * C::kStageBytes;
    const uint32_t pst = base + C::kStage0 + prev * C::kStageBytes;
    float s_t[BQ / 2], dp_t[BQ / 2];  // S^T, dP^T [64 keys, BQ queries]
    // dV += P^T dO and dK += dS^T Q of the previous step
    auto issue_dkv = [&]() {
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        const uint64_t b = desc_mnmajor<BQ>(pst + C::kDo, ks);
        wgmma_rs(dv_acc, p_hi + 4 * ks, b, 1);
        wgmma_rs(dv_acc, p_lo + 4 * ks, b, 1);
      }
#pragma unroll
      for (int ks = 0; ks < BQ / 16; ++ks) {
        const uint64_t b = desc_mnmajor<BQ>(pst + C::kQ, ks);
        wgmma_rs(dk_acc, ds_hi + 4 * ks, b, 1);
        wgmma_rs(dk_acc, ds_lo + 4 * ks, b, 1);
      }
    };
    // S^T = K Q^T and dP^T = V dO^T of this step
    auto issue_s = [&]() {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(s_t, desc_kmajor<BK>(base + C::kK, 64 * w, ks),
                 desc_kmajor<BQ>(st + C::kQ, 0, ks), ks);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dp_t, desc_kmajor<BK>(base + C::kV, 64 * w, ks),
                 desc_kmajor<BQ>(st + C::kDo, 0, ks), ks);
    };
    fence_proxy_async();
    // each branch fences, issues and commits on its own: wgmma issued
    // under a condition inside one fence-commit span is serialised
    if (have_prev && live_step) {
      wgmma_fence();
      issue_dkv();
      issue_s();
      wgmma_commit();
    } else if (have_prev) {
      wgmma_fence();
      issue_dkv();
      wgmma_commit();
    } else if (live_step) {
      wgmma_fence();
      issue_s();
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(p_hi);
    reg_fence(p_lo);
    reg_fence(ds_hi);
    reg_fence(ds_lo);
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    reg_fence(s_t);
    reg_fence(dp_t);
    if (i > 0) mbar_arrive(empty + 8 * prev);  // the previous stage is read
    if (live_step) {
      const float2* lse2 = reinterpret_cast<const float2*>(smem + C::kStage0 +
                                                           s * C::kStageBytes + C::kLse);
      const float2* delta2 = lse2 + BQ / 2;
      // P^T = 2^(S^T scale log2(e) - lse log2(e)) with lse per column; on a
      // step that crosses the diagonal or the end of T, pairs with q below
      // the key or at or past T get P = 0 (rows at or past T are not
      // stored, so they need no mask)
      auto form = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l = lse2[4 * j + (lane & 3)];
          const float2 dl = delta2[4 * j + (lane & 3)];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float l2 = (c ? l.y : l.x) * kLog2e;
            const float dlc = c ? dl.y : dl.x;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 4 * j + 2 * h + c;
              float x = s_t[r] * scale_log2 - l2;
              if constexpr (decltype(masked)::value) {
                const int qc = q0 + 8 * j + 2 * (lane & 3) + c;
                if (static_cast<unsigned>(qc - lo[h]) >= static_cast<unsigned>(t_len - lo[h]))
                  x = -INFINITY;
              }
              const float p = exp2_approx(x);
              dp_t[r] = p * (dp_t[r] - dlc) * scale;  // dS^T
              s_t[r] = p;                             // P^T
            }
          }
        }
      };
      if ((causal && q0 < kw0 + 63) || q0 + BQ > t_len)
        form(std::true_type{});
      else
        form(std::false_type{});
      split_frags(s_t, p_hi, p_lo);
      split_frags(dp_t, ds_hi, ds_lo);
    }
    have_prev = live_step;
    prev = s;
  }
  store_acc<D, DP>(dk + mat, dk_acc, kw0 + row, lane, t_len);
  store_acc<D, DP>(dv + mat, dv_acc, kw0 + row, lane, t_len);
}

// ------------------------------------------------------------ bf16 dq
template <int D>
struct DqCfg {
  static constexpr int DP = D < 64 ? 64 : D;
  static constexpr int BQ = 64 * kConsumers;  // queries per block
  static constexpr int BK = D > 64 ? 64 : 128;  // keys per stage
  static constexpr int kQ = 0, kDo = BQ * DP * 2;
  static constexpr int kLse = 2 * BQ * DP * 2, kDelta = kLse + BQ * 4;
  static constexpr int kStage0 = round_up(kDelta + BQ * 4, 1024);
  static constexpr int kK = 0, kV = BK * DP * 2;  // inside a stage
  static constexpr int kStageBytes = 2 * BK * DP * 2;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr size_t bytes = kBar + (2 * kStages + 1) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    flash_bwd_dq_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, int t_len, int causal) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, DP = C::DP, BK = C::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + C::kBar, empty = full + 8 * kStages, q_bar = empty + 8 * kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal tiles first
  const size_t mat = static_cast<size_t>(bh) * t_len * D;
  const size_t vec = static_cast<size_t>(bh) * t_len;
  const int nk = (t_len + BK - 1) / BK;
  const int n_steps = causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    load_tile<BQ, D, DP>(base + C::kQ, q + mat, q0, t_len, tid);
    load_tile<BQ, D, DP>(base + C::kDo, dout + mat, q0, t_len, tid);
    load_rowvec<BQ>(base + C::kLse, lse + vec, q0, t_len, tid);
    load_rowvec<BQ>(base + C::kDelta, delta + vec, q0, t_len, tid);
    cp_async_arrive(q_bar);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t st = base + C::kStage0 + s * C::kStageBytes;
      load_tile<BK, D, DP>(st + C::kK, k + mat, i * BK, t_len, tid);
      load_tile<BK, D, DP>(st + C::kV, v + mat, i * BK, t_len, tid);
      cp_async_arrive(full + 8 * s);
    }
    cp_async_wait_all();
    return;
  }

  // consumer warpgroup w: queries qw0 .. qw0 + 63
  setmaxnreg_inc<kConsumerRegs>();
  const int w = wg - 1;
  const int qw0 = q0 + 64 * w;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: row, row + 8
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const float scale_log2 = scale * kLog2e;
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  mbar_wait(q_bar, 0);
  const float* lse_s = reinterpret_cast<const float*>(smem + C::kLse);
  const float* delta_s = reinterpret_cast<const float*>(smem + C::kDelta);
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l2[h] = lse_s[64 * w + row + 8 * h] * kLog2e;
    dl[h] = delta_s[64 * w + row + 8 * h];
  }
  // keys at or past key_end[h] are masked in this thread's rows
  int key_end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_end[h] = causal ? min(qw0 + row + 8 * h + 1, t_len) : t_len;
  // bf16(dS) of the previous step as A fragments: its product goes out
  // with the next step's S and dP, in one commit group
  uint32_t ds[BK / 4];
  bool have_prev = false;
  int prev = 0;
  for (int i = 0; i <= n_steps; ++i) {
    const int s = i % kStages;
    const int k0 = i * BK;
    // a step whose (q, k) pairs are all masked is skipped
    const bool live_step = i < n_steps && !(causal && k0 > qw0 + 63);
    if (i < n_steps) mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t st = base + C::kStage0 + s * C::kStageBytes;
    const uint32_t pst = base + C::kStage0 + prev * C::kStageBytes;
    float s_acc[BK / 2], dp_acc[BK / 2];  // S, dP [64 queries, BK keys]
    // dQ += dS K of the previous step
    auto issue_dq = [&]() {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_rs(dq_acc, ds + 4 * ks, desc_mnmajor<BK>(pst + C::kK, ks), 1);
    };
    // S = Q K^T and dP = dO V^T of this step
    auto issue_s = [&]() {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(s_acc, desc_kmajor<BQ>(base + C::kQ, 64 * w, ks),
                 desc_kmajor<BK>(st + C::kK, 0, ks), ks);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(dp_acc, desc_kmajor<BQ>(base + C::kDo, 64 * w, ks),
                 desc_kmajor<BK>(st + C::kV, 0, ks), ks);
    };
    fence_proxy_async();
    // each branch fences, issues and commits on its own (see dk/dv)
    if (have_prev && live_step) {
      wgmma_fence();
      issue_dq();
      issue_s();
      wgmma_commit();
    } else if (have_prev) {
      wgmma_fence();
      issue_dq();
      wgmma_commit();
    } else if (live_step) {
      wgmma_fence();
      issue_s();
      wgmma_commit();
    }
    wgmma_wait<0>();
    reg_fence(ds);
    reg_fence(dq_acc);
    reg_fence(s_acc);
    reg_fence(dp_acc);
    if (i > 0) mbar_arrive(empty + 8 * prev);  // the previous stage is read
    if (live_step) {
      // dS = P (dP - delta) scale with P = 2^(S scale log2(e) - lse log2(e)),
      // rounded to bf16; on a step that crosses the diagonal or the end of
      // T, keys past the row's query or at or past T get P = 0 (rows at or
      // past T are not stored, so they need no mask)
      auto form = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int r = 4 * j + 2 * h + c;
              float e = s_acc[r] * scale_log2 - l2[h];
              if constexpr (decltype(masked)::value) {
                if (k0 + 8 * j + 2 * (lane & 3) + c >= key_end[h]) e = -INFINITY;
              }
              x[c] = exp2_approx(e) * (dp_acc[r] - dl[h]) * scale;
            }
            ds[2 * j + h] = pack_bf16(x[0], x[1]);  // dS rounded to bf16, as the reference
          }
        }
      };
      if ((causal && k0 + BK - 1 > qw0) || k0 + BK > t_len)
        form(std::true_type{});
      else
        form(std::false_type{});
    }
    have_prev = live_step;
    prev = s;
  }
  store_acc<D, DP>(dq + mat, dq_acc, qw0 + row, lane, t_len);
}

// ------------------------------------------------------------ f32 (scalar)
// One block of kThreads per (bh, 32-row tile), the products in scalar f32
// (tile_mma) on shared-memory tiles, the accumulators in shared memory.
constexpr int kR32 = Tile<float>::rows;

__device__ __forceinline__ void load_vec32(float* dst, const float* src, int row0, int t_len) {
  for (int i = threadIdx.x; i < kR32; i += kThreads) dst[i] = row0 + i < t_len ? src[row0 + i] : 0.f;
}

// Rows of an [R, ld] accumulator that lie before T into the [T, D] output.
template <int D>
__device__ __forceinline__ void store_rows32(float* dst, const float* acc, int ld, int row0,
                                             int t_len) {
  for (int i = threadIdx.x; i < kR32 * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    if (row0 + r < t_len) dst[static_cast<size_t>(row0 + r) * D + c] = acc[r * ld + c];
  }
}

template <int D>
struct Smem32 {
  static constexpr int kLdT = Ld<float, D>::value;
  static constexpr int kLdS = Ld<float, kR32>::value;
  static constexpr int kLdA = Ld<float, D>::value;
  // four [R, D] tiles, S and dP, `n_acc` accumulators, two row vectors
  static constexpr size_t bytes(int n_acc) {
    return (4 * kR32 * kLdT + 2 * kR32 * kLdS + n_acc * kR32 * kLdA + 2 * kR32) * sizeof(float);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int t_len, int causal) {
  using L = Smem32<D>;
  constexpr int R = kR32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + R * L::kLdT;
  float* ks = dos + R * L::kLdT;
  float* vs = ks + R * L::kLdT;
  float* ss = vs + R * L::kLdT;
  float* dps = ss + R * L::kLdS;
  float* acc = dps + R * L::kLdS;
  float* lse_s = acc + R * L::kLdA;
  float* delta_s = lse_s + R;

  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * R;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const size_t row_base = static_cast<size_t>(bh) * t_len;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  load_rows<float, D, R>(qs, q + base, q0, t_len);
  load_rows<float, D, R>(dos, dout + base, q0, t_len);
  load_vec32(lse_s, lse + row_base, q0, t_len);
  load_vec32(delta_s, delta + row_base, q0, t_len);
  for (int i = threadIdx.x; i < R * D; i += kThreads) acc[(i / D) * L::kLdA + i % D] = 0.f;
  const int nk = (t_len + R - 1) / R;
  const int k_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_rows<float, D, R>(ks, k + base, k0, t_len);
    load_rows<float, D, R>(vs, v + base, k0, t_len);
    __syncthreads();
    tile_mma<false, true, R, R, D>(qs, L::kLdT, ks, L::kLdT, ss, L::kLdS, false);   // S
    tile_mma<false, true, R, R, D>(dos, L::kLdT, vs, L::kLdT, dps, L::kLdS, false);  // dP
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R;
      const int c = i - r * R;
      const float p = live(q0 + r, k0 + c, t_len, causal)
                          ? expf(ss[r * L::kLdS + c] * scale - lse_s[r])
                          : 0.f;
      dps[r * L::kLdS + c] = p * (dps[r * L::kLdS + c] - delta_s[r]) * scale;  // dS
    }
    __syncthreads();
    tile_mma<false, false, R, D, R>(dps, L::kLdS, ks, L::kLdT, acc, L::kLdA, true);  // += dS K
  }
  __syncthreads();
  store_rows32<D>(dq + base, acc, L::kLdA, q0, t_len);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int t_len,
                             int causal) {
  using L = Smem32<D>;
  constexpr int R = kR32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + R * L::kLdT;
  float* qs = vs + R * L::kLdT;
  float* dos = qs + R * L::kLdT;
  float* ss = dos + R * L::kLdT;
  float* dps = ss + R * L::kLdS;
  float* dk_acc = dps + R * L::kLdS;
  float* dv_acc = dk_acc + R * L::kLdA;
  float* lse_s = dv_acc + R * L::kLdA;
  float* delta_s = lse_s + R;

  const int bh = blockIdx.y;
  const int kt = blockIdx.x;  // causal: the first k-tiles see the most q-tiles
  const int k0 = kt * R;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const size_t row_base = static_cast<size_t>(bh) * t_len;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  load_rows<float, D, R>(ks, k + base, k0, t_len);
  load_rows<float, D, R>(vs, v + base, k0, t_len);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    dk_acc[(i / D) * L::kLdA + i % D] = 0.f;
    dv_acc[(i / D) * L::kLdA + i % D] = 0.f;
  }
  const int nq = (t_len + R - 1) / R;
  // q-tiles entirely before this k-tile contribute nothing
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_rows<float, D, R>(qs, q + base, q0, t_len);
    load_rows<float, D, R>(dos, dout + base, q0, t_len);
    load_vec32(lse_s, lse + row_base, q0, t_len);
    load_vec32(delta_s, delta + row_base, q0, t_len);
    __syncthreads();
    tile_mma<false, true, R, R, D>(qs, L::kLdT, ks, L::kLdT, ss, L::kLdS, false);   // S [q, k]
    tile_mma<false, true, R, R, D>(dos, L::kLdT, vs, L::kLdT, dps, L::kLdS, false);  // dP [q, k]
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R;
      const int c = i - r * R;
      const int at = r * L::kLdS + c;
      const float p = live(q0 + r, k0 + c, t_len, causal) ? expf(ss[at] * scale - lse_s[r]) : 0.f;
      dps[at] = p * (dps[at] - delta_s[r]) * scale;  // dS
      ss[at] = p;
    }
    __syncthreads();
    tile_mma<true, false, R, D, R>(ss, L::kLdS, dos, L::kLdT, dv_acc, L::kLdA, true);  // += P^T dO
    tile_mma<true, false, R, D, R>(dps, L::kLdS, qs, L::kLdT, dk_acc, L::kLdA, true);  // += dS^T Q
  }
  __syncthreads();
  store_rows32<D>(dk + base, dk_acc, L::kLdA, k0, t_len);
  store_rows32<D>(dv + base, dv_acc, L::kLdA, k0, t_len);
}

// ----------------------------------------------------------------- launch
template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int t_len,
                      int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = DqCfg<D>::bytes;
    auto kernel = flash_bwd_dq_sm90_kernel<D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    const int tiles = (t_len + DqCfg<D>::BQ - 1) / DqCfg<D>::BQ;
    kernel<<<dim3(bh, tiles), kRingThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), t_len, causal);
  } else {
    const size_t smem = Smem32<D>::bytes(1);
    auto kernel = flash_bwd_dq_f32_kernel<D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((t_len + kR32 - 1) / kR32, bh), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), t_len, causal);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int t_len, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = DkvCfg<D>::bytes;
    auto kernel = flash_bwd_dkv_sm90_kernel<D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    const int tiles = (t_len + DkvCfg<D>::BK - 1) / DkvCfg<D>::BK;
    kernel<<<dim3(bh, tiles), kRingThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len,
        causal);
  } else {
    const size_t smem = Smem32<D>::bytes(2);
    auto kernel = flash_bwd_dkv_f32_kernel<D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((t_len + kR32 - 1) / kR32, bh), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), t_len, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). is_bf16: every [BH, T, D]
// tensor is bf16 (else f32); lse and delta are f32 [BH, T]. Each returns
// the cudaError_t of its launch.
extern "C" int flash_bwd_dq(int is_bf16, const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int bh, int t_len, int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TILE_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, t_len, causal, st)
}

extern "C" int flash_bwd_dkv(int is_bf16, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dv, int bh, int t_len, int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TILE_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, t_len, causal, st)
}
