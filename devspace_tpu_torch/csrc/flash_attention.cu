// Flash attention for NVIDIA Hopper (sm_90a): the forward kernel and the
// two backward kernels (dq, and dk/dv).
//
// Replaces the Pallas TPU kernels of devspace_tpu/ops/flash_attention.py:
//   flash_fwd      <- `_fwd_kernel`     (launched by `_flash_fwd_call`)
//   flash_bwd_dq   <- `_bwd_dq_kernel`  (launched by `_flash_bwd_call`)
//   flash_bwd_dkv  <- `_bwd_dkv_kernel` (launched by `_flash_bwd_call`)
// on q, k, v, o, dO [BH, T, D] (row-major, contiguous) with lse and
// delta f32 [BH, T]. Scores are S = Q K^T / sqrt(D), masked to -1e30
// above the diagonal when causal; the forward runs an online softmax
// with f32 (m, l, acc) and writes O and lse = m + log(l); the backward
// recomputes P = exp(S - lse) from the lse and takes delta = rowsum(dO*O)
// from the caller, as the reference does outside its kernels.
//
// Bound: at training shapes (T = 2048, D = 64) the work is about 4 D
// flops per (query, key) pair forward, 6 D for dq and 8 D for dk/dv,
// against 2 D bytes read per row: far above the ~295 flops per byte where
// the H100's tensor cores, not memory, are the limit. So the tile products
// run on the tensor cores (nvcuda::wmma m16n16k16, bf16 in, f32
// accumulate) for bf16 inputs; f32 inputs take a scalar f32 path with the
// same structure, for parity at full precision.
//
// Design:
//   - the TPU grid's sequential third dimension becomes a loop inside the
//     block: one block per (bh, q-tile) walks the k-tiles (forward, dq),
//     one block per (bh, k-tile) walks the q-tiles (dk/dv). Each block
//     owns its output tile, so there are no atomics and two runs give
//     bit-identical results;
//   - causal: tiles wholly above the diagonal are skipped (q- and k-tiles
//     have one size, so q-tile i meets k-tiles 0..i), the diagonal tile is
//     masked element by element; the heaviest causal tiles launch first;
//   - tiles are 64 rows for bf16 and 32 for f32 (shared memory), loaded
//     with 16-byte vectors into rows padded by 16 bytes (no bank
//     conflicts down a column); rows past T are zero-filled and masked, so
//     any T works;
//   - the forward's row loops give each row 4 (bf16) or 8 (f32) threads,
//     which keep the row's (m, l) in registers and reduce by shuffles;
//   - dq, dk and dv accumulate in wmma fragments held in registers across
//     the whole loop (each 16x16 output tile by one warp); the forward's
//     O accumulator, which is rescaled row by row, stays in shared memory;
//   - the reference rounds P to the input dtype for P V (forward) and dS
//     for dS K (dq), and so does this kernel. It keeps dV = P^T dO and
//     dK = dS^T Q in f32; on bf16 tensor cores this kernel carries P and
//     dS there as two bf16 terms (hi = bf16(x), lo = bf16(x - hi)), which
//     leaves an error of about 2^-16 of each term instead of bf16's 2^-8.
// This version does not overlap the next tile's load with the current
// tile's math (no cp.async/TMA pipeline), syncs the whole block between
// the steps of a tile, and runs mma.sync through wmma rather than
// wgmma: those are the known gaps to the bound.

#include "tile.cuh"  // tiles, tile products, row reductions

namespace {

template <int R>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int t_len) {
  for (int i = threadIdx.x; i < R; i += kThreads)
    dst[i] = row0 + i < t_len ? src[row0 + i] : 0.f;
}

// An [M, N] f32 accumulator the block owns across its loop (dq, dk, dv:
// no rescaling between tiles). bf16: wmma accumulator fragments kept in
// registers, each 16x16 tile by the warp that owns it in tile_mma. f32:
// a shared-memory array for the scalar path.
template <typename T, int M, int N>
struct Acc;

template <int M, int N>
struct Acc<bf16, M, N> {
  static constexpr int kTiles = (M / 16) * (N / 16);
  static constexpr int kPer = (kTiles + kWarps - 1) / kWarps;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[kPer];

  __device__ explicit Acc(float*) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) nvcuda::wmma::fill_fragment(f[j], 0.f);
  }

  // += op(A) op(B), with op as in tile_mma
  template <bool TA, bool TB, int K>
  __device__ __forceinline__ void mma(const bf16* A, int lda, const bf16* B, int ldb) {
    using namespace nvcuda;
    using LayoutA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
    using LayoutB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int t = warp + j * kWarps;
      if (t < kTiles) {
        const int tm = t / (N / 16);
        const int tn = t - tm * (N / 16);
#pragma unroll
        for (int kk = 0; kk < K; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b;
          wmma::load_matrix_sync(a, TA ? A + kk * lda + tm * 16 : A + tm * 16 * lda + kk, lda);
          wmma::load_matrix_sync(b, TB ? B + tn * 16 * ldb + kk : B + kk * ldb + tn * 16, ldb);
          wmma::mma_sync(f[j], a, b, f[j]);
        }
      }
    }
  }

  // The values into shared memory `stage` [M, ld]; returns it (read it
  // after a __syncthreads).
  __device__ __forceinline__ const float* to_smem(float* stage, int ld) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int t = warp + j * kWarps;
      if (t < kTiles) {
        const int tm = t / (N / 16);
        const int tn = t - tm * (N / 16);
        nvcuda::wmma::store_matrix_sync(stage + tm * 16 * ld + tn * 16, f[j], ld,
                                        nvcuda::wmma::mem_row_major);
      }
    }
    return stage;
  }
};

template <int M, int N>
struct Acc<float, M, N> {
  static constexpr int kLd = Ld<float, N>::value;
  float* p;  // [M, kLd] in shared memory

  __device__ explicit Acc(float* smem) : p(smem) {
    for (int i = threadIdx.x; i < M * N; i += kThreads) p[(i / N) * kLd + i % N] = 0.f;
  }

  template <bool TA, bool TB, int K>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb) {
    tile_mma<TA, TB, M, N, K>(A, lda, B, ldb, p, kLd, true);
  }

  __device__ __forceinline__ const float* to_smem(float*, int) { return p; }
};

// ---------------------------------------------------------------- forward
template <typename T, int D>
struct FwdSmem {
  static constexpr int R = Tile<T>::rows;
  static constexpr int kLdT = Ld<T, D>::value;      // q, k, v rows
  static constexpr int kLdP = Ld<T, R>::value;      // P rows
  static constexpr int kLdS = Ld<float, R>::value;  // S rows
  static constexpr int kLdA = Ld<float, D>::value;  // acc rows
  static constexpr size_t bytes = 3 * R * kLdT * sizeof(T) + R * kLdP * sizeof(T) +
                                  R * kLdS * sizeof(float) + R * kLdA * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t_len, int causal) {
  using L = FwdSmem<T, D>;
  constexpr int R = L::R;
  constexpr int kTPR = kThreads / R;  // threads per row in the row loops
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + R * L::kLdT;
  T* vs = ks + R * L::kLdT;
  T* ps = vs + R * L::kLdT;
  float* ss = reinterpret_cast<float*>(ps + R * L::kLdP);
  float* acc = ss + R * L::kLdS;

  const int row = threadIdx.x / kTPR;  // this thread's row in the row loops
  const int sub = threadIdx.x % kTPR;
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * R;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  load_rows<T, D, R>(qs, q + base, q0, t_len);
  for (int c = sub; c < D; c += kTPR) acc[row * L::kLdA + c] = 0.f;
  // the online-softmax state of this thread's row, kept by each of the
  // row's kTPR threads alike
  float m = kNegInf, l = 0.f;
  const int nk = (t_len + R - 1) / R;
  const int k_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the previous k/v tiles are consumed
    load_rows<T, D, R>(ks, k + base, k0, t_len);
    load_rows<T, D, R>(vs, v + base, k0, t_len);
    __syncthreads();
    tile_mma<false, true, R, R, D>(qs, L::kLdT, ks, L::kLdT, ss, L::kLdS, false);  // S = Q K^T
    __syncthreads();
    float* srow = ss + row * L::kLdS;
    float mx = kNegInf;
    for (int c = sub; c < R; c += kTPR) {
      float s = srow[c] * scale;
      if (!live(q0 + row, k0 + c, t_len, causal)) s = kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, group_max<kTPR>(mx));
    float sum = 0.f;
    for (int c = sub; c < R; c += kTPR) {
      const float p = expf(srow[c] - m_new);
      ps[row * L::kLdP + c] = from_float<T>(p);
      sum += p;
    }
    const float alpha = expf(m - m_new);
    l = alpha * l + group_sum<kTPR>(sum);
    m = m_new;
    for (int c = sub; c < D; c += kTPR) acc[row * L::kLdA + c] *= alpha;
    __syncthreads();
    tile_mma<false, false, R, D, R>(ps, L::kLdP, vs, L::kLdT, acc, L::kLdA, true);  // += P V
  }
  __syncthreads();
  if (q0 + row < t_len) {
    const float li = l == 0.f ? 1.f : l;
    T* orow = o + base + static_cast<size_t>(q0 + row) * D;
    for (int c = sub; c < D; c += kTPR) orow[c] = from_float<T>(acc[row * L::kLdA + c] / li);
    if (sub == 0) lse[static_cast<size_t>(bh) * t_len + q0 + row] = m + logf(li);
  }
}

// Writes rows of a [R, ld D] f32 accumulator that lie before T into the
// [T, D] output at row0, rounded to T.
template <typename T, int D, int R, int LD>
__device__ __forceinline__ void store_rows(T* dst, const float* acc, int row0,
                                           int t_len) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    if (row0 + r < t_len)
      dst[static_cast<size_t>(row0 + r) * D + c] = from_float<T>(acc[r * LD + c]);
  }
}

// ------------------------------------------------------------ backward dq
template <typename T, int D>
struct DqSmem {
  static constexpr int R = Tile<T>::rows;
  static constexpr int kAcc = std::is_same<T, float>::value ? 1 : 0;
  static constexpr int kLdT = Ld<T, D>::value;
  static constexpr int kLdP = Ld<T, R>::value;
  static constexpr int kLdS = Ld<float, R>::value;
  static constexpr int kLdA = Ld<float, D>::value;
  static constexpr size_t bytes = 4 * R * kLdT * sizeof(T)       // q, dO, k, v
                                  + 2 * R * kLdS * sizeof(float)  // S, dP
                                  + R * kLdP * sizeof(T)          // dS
                                  + kAcc * R * kLdA * sizeof(float)  // f32: dq accumulator
                                  + 2 * R * sizeof(float);        // lse, delta
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int t_len, int causal) {
  using L = DqSmem<T, D>;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + R * L::kLdT;
  T* ks = dos + R * L::kLdT;
  T* vs = ks + R * L::kLdT;
  float* ss = reinterpret_cast<float*>(vs + R * L::kLdT);
  float* dps = ss + R * L::kLdS;
  T* dss = reinterpret_cast<T*>(dps + R * L::kLdS);
  float* acc_smem = reinterpret_cast<float*>(dss + R * L::kLdP);
  float* lse_s = acc_smem + L::kAcc * R * L::kLdA;
  float* delta_s = lse_s + R;

  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * R;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const size_t row_base = static_cast<size_t>(bh) * t_len;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  load_rows<T, D, R>(qs, q + base, q0, t_len);
  load_rows<T, D, R>(dos, dout + base, q0, t_len);
  load_vec<R>(lse_s, lse + row_base, q0, t_len);
  load_vec<R>(delta_s, delta + row_base, q0, t_len);
  Acc<T, R, D> acc(acc_smem);
  const int nk = (t_len + R - 1) / R;
  const int k_end = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_rows<T, D, R>(ks, k + base, k0, t_len);
    load_rows<T, D, R>(vs, v + base, k0, t_len);
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
      dss[r * L::kLdP + c] = from_float<T>(p * (dps[r * L::kLdS + c] - delta_s[r]) * scale);
    }
    __syncthreads();
    acc.template mma<false, false, R>(dss, L::kLdP, ks, L::kLdT);  // += dS K
  }
  __syncthreads();  // S and dP are consumed: they stage the result
  const float* out = acc.to_smem(ss, L::kLdA);
  __syncthreads();
  store_rows<T, D, R, L::kLdA>(dq + base, out, q0, t_len);
}

// --------------------------------------------------------- backward dk/dv
template <typename T, int D>
struct DkvSmem {
  static constexpr int R = Tile<T>::rows;
  static constexpr int kSplit = std::is_same<T, bf16>::value ? 2 : 0;
  static constexpr int kAcc = std::is_same<T, float>::value ? 2 : 0;
  static constexpr int kLdT = Ld<T, D>::value;
  static constexpr int kLdP = Ld<T, R>::value;
  static constexpr int kLdS = Ld<float, R>::value;
  static constexpr int kLdA = Ld<float, D>::value;
  static constexpr size_t bytes = 4 * R * kLdT * sizeof(T)        // k, v, q, dO
                                  + 2 * R * kLdS * sizeof(float)   // S then P, dP then dS
                                  + kSplit * R * kLdP * sizeof(T)  // hi, lo terms
                                  + kAcc * R * kLdA * sizeof(float)  // f32: dk, dv accumulators
                                  + 2 * R * sizeof(float);         // lse, delta
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int t_len, int causal) {
  using L = DkvSmem<T, D>;
  constexpr int R = L::R;
  constexpr bool kSplit = L::kSplit != 0;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + R * L::kLdT;
  T* qs = vs + R * L::kLdT;
  T* dos = qs + R * L::kLdT;
  float* ss = reinterpret_cast<float*>(dos + R * L::kLdT);
  float* dps = ss + R * L::kLdS;
  T* hi = reinterpret_cast<T*>(dps + R * L::kLdS);
  T* lo = hi + (kSplit ? R * L::kLdP : 0);
  float* acc_smem = reinterpret_cast<float*>(lo + (kSplit ? R * L::kLdP : 0));
  float* lse_s = acc_smem + L::kAcc * R * L::kLdA;
  float* delta_s = lse_s + R;

  const int bh = blockIdx.y;
  const int kt = blockIdx.x;  // causal: the first k-tiles see the most q-tiles
  const int k0 = kt * R;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const size_t row_base = static_cast<size_t>(bh) * t_len;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  load_rows<T, D, R>(ks, k + base, k0, t_len);
  load_rows<T, D, R>(vs, v + base, k0, t_len);
  Acc<T, R, D> dk_acc(acc_smem);
  Acc<T, R, D> dv_acc(acc_smem + R * L::kLdA);
  const int nq = (t_len + R - 1) / R;
  // q-tiles entirely before this k-tile contribute nothing
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_rows<T, D, R>(qs, q + base, q0, t_len);
    load_rows<T, D, R>(dos, dout + base, q0, t_len);
    load_vec<R>(lse_s, lse + row_base, q0, t_len);
    load_vec<R>(delta_s, delta + row_base, q0, t_len);
    __syncthreads();
    tile_mma<false, true, R, R, D>(qs, L::kLdT, ks, L::kLdT, ss, L::kLdS, false);   // S [q, k]
    tile_mma<false, true, R, R, D>(dos, L::kLdT, vs, L::kLdT, dps, L::kLdS, false);  // dP [q, k]
    __syncthreads();
    for (int i = threadIdx.x; i < R * R; i += kThreads) {
      const int r = i / R;
      const int c = i - r * R;
      const int at = r * L::kLdS + c;
      const float p = live(q0 + r, k0 + c, t_len, causal)
                          ? expf(ss[at] * scale - lse_s[r])
                          : 0.f;
      dps[at] = p * (dps[at] - delta_s[r]) * scale;  // dS
      if constexpr (kSplit) {
        const T h = from_float<T>(p);
        hi[r * L::kLdP + c] = h;
        lo[r * L::kLdP + c] = from_float<T>(p - to_float(h));
      } else {
        ss[at] = p;
      }
    }
    __syncthreads();
    // dV += P^T dO
    if constexpr (kSplit) {
      dv_acc.template mma<true, false, R>(hi, L::kLdP, dos, L::kLdT);
      dv_acc.template mma<true, false, R>(lo, L::kLdP, dos, L::kLdT);
    } else {
      dv_acc.template mma<true, false, R>(ss, L::kLdS, dos, L::kLdT);
    }
    // dK += dS^T Q
    if constexpr (kSplit) {
      __syncthreads();  // the P terms are consumed
      for (int i = threadIdx.x; i < R * R; i += kThreads) {
        const int r = i / R;
        const int c = i - r * R;
        const float x = dps[r * L::kLdS + c];
        const T h = from_float<T>(x);
        hi[r * L::kLdP + c] = h;
        lo[r * L::kLdP + c] = from_float<T>(x - to_float(h));
      }
      __syncthreads();
      dk_acc.template mma<true, false, R>(hi, L::kLdP, qs, L::kLdT);
      dk_acc.template mma<true, false, R>(lo, L::kLdP, qs, L::kLdT);
    } else {
      dk_acc.template mma<true, false, R>(dps, L::kLdS, qs, L::kLdT);
    }
  }
  // S and dP are consumed: they stage the results, one after the other
  __syncthreads();
  const float* out = dk_acc.to_smem(ss, L::kLdA);
  __syncthreads();
  store_rows<T, D, R, L::kLdA>(dk + base, out, k0, t_len);
  __syncthreads();
  out = dv_acc.to_smem(ss, L::kLdA);
  __syncthreads();
  store_rows<T, D, R, L::kLdA>(dv + base, out, k0, t_len);
}

// ----------------------------------------------------------------- launch
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_len, int causal,
                       cudaStream_t stream) {
  constexpr int R = Tile<T>::rows;
  const size_t smem = FwdSmem<T, D>::bytes;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((t_len + R - 1) / R, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t_len, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t_len, int causal,
                      cudaStream_t stream) {
  constexpr int R = Tile<T>::rows;
  const size_t smem = DqSmem<T, D>::bytes;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((t_len + R - 1) / R, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t_len, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int t_len, int causal,
                       cudaStream_t stream) {
  constexpr int R = Tile<T>::rows;
  const size_t smem = DkvSmem<T, D>::bytes;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((t_len + R - 1) / R, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). is_bf16: every [BH, T, D]
// tensor is bf16 (else f32); lse and delta are f32 [BH, T]. Each returns
// the cudaError_t of its launch.
extern "C" int flash_fwd(int is_bf16, const void* q, const void* k,
                         const void* v, void* o, void* lse, int bh, int t_len,
                         int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TILE_DISPATCH(launch_fwd, q, k, v, o, lse, bh, t_len, causal, st)
}

extern "C" int flash_bwd_dq(int is_bf16, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int t_len,
                            int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TILE_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, t_len, causal,
                 st)
}

extern "C" int flash_bwd_dkv(int is_bf16, const void* q, const void* k,
                             const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int t_len, int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TILE_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, t_len,
                 causal, st)
}
