// Short-sequence fused attention for NVIDIA Hopper (sm_90a): the forward
// of softmax(Q K^T / sqrt(D) [causal mask]) V for T <= 1024.
//
// Replaces the Pallas TPU kernel `_attention_kernel` of
// devspace_tpu/ops/attention.py (launched by `_attention_pallas_raw`) on
// q, k, v, o [BH, T, D] (row-major, contiguous). Scores are f32,
// S = Q K^T / sqrt(D), masked to -1e30 above the diagonal when causal;
// the softmax is the full one (row max, exp, row sum, divide), and the
// probabilities are normalised BEFORE they are rounded to V's dtype for
// P V, as the TPU kernel does (flash attention rounds the unnormalised
// exp and divides the f32 accumulator at the end). No lse is kept: the
// backward is the plain version's gradient, outside any kernel.
//
// Bound: 4 D flops per live (query, key) pair against 8 D bytes per row in
// bf16 (q, k, v read, o written), which is T/4 flops per byte causal and
// T/2 otherwise. The H100's tensor cores, not memory, are the limit only
// above ~295 flops per byte, so bytes bound every causal call (T <= 1024)
// and every call at the training shapes (T = 128).
//
// bf16, T <= 128 (every training shape; draft prefill buckets up to 128):
// one pass. One block per bh of T / 64 (rounded up) warpgroups, 64 query
// rows each, loads Q, K and V once with cp.async into 128-byte-swizzled
// shared memory (V in a second copy group, which lands while S is
// computed). S [64, T] is one wgmma into f32 registers; the row max, the
// exponentials, the row sum and the divide run in those registers; P is
// rounded to bf16 and repacked in place as the A operand of O = P V (a
// wgmma reading V MN-major); O goes from registers to device memory. Q K^T
// runs once and nothing but the inputs touches shared memory. The kernel
// is bytes-bound, so it aims at blocks in flight (two an SM), not at a
// pipeline: a block's loads overlap the other block's math.
//
// bf16, T > 128: the two-pass streaming kernel of attention_fwd.cuh
// (Softmax::kTwoPass): pass 1 streams the K tiles for each row's (m, l),
// pass 2 streams K and V, recomputes S and accumulates the normalised,
// rounded P times V in registers. At 128 < T <= 256 one pass does not
// fit: its block of four warpgroups leaves a thread at most 128 registers
// (65536 / 512), which S [64, 256] alone fills (128 f32 a thread) before
// P's 64 and O's 32-64, so those T stream too.
//
// f32 (parity at full precision, not a training path): one block per
// (bh, 32-row q-tile), the same two passes with scalar f32 tile products
// in shared memory; rows past T are zero-filled and masked, so any T from
// 1 works; the heaviest causal tiles launch first.

#include "attention_fwd.cuh"  // the bf16 streaming forward
#include "tile.cuh"           // f32 tiles, tile products, row reductions

namespace {

// ------------------------------------------------------------------ f32
template <typename T, int D>
struct AttnSmem {
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
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int t_len,
                         int causal) {
  using L = AttnSmem<T, D>;
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
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * R;
  const size_t base = static_cast<size_t>(bh) * t_len * D;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  float* srow = ss + row * L::kLdS;

  load_rows<T, D, R>(qs, q + base, q0, t_len);
  const int nk = (t_len + R - 1) / R;
  const int k_end = causal ? min(nk, qt + 1) : nk;

  // pass 1: the row's max and the sum of exp(s - max), kept by each of the
  // row's kTPR threads alike. Every live row meets a live key in its
  // first tile (key 0), so m is a real score from there on.
  float m = kNegInf, l = 0.f;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the previous k tile and its scores are consumed
    load_rows<T, D, R>(ks, k + base, k0, t_len);
    __syncthreads();
    tile_mma<false, true, R, R, D>(qs, L::kLdT, ks, L::kLdT, ss, L::kLdS, false);  // S = Q K^T
    __syncthreads();
    float mx = kNegInf;
    for (int c = sub; c < R; c += kTPR) {
      float s = srow[c] * scale;
      if (!live(q0 + row, k0 + c, t_len, causal)) s = kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, group_max<kTPR>(mx));
    float sum = 0.f;
    for (int c = sub; c < R; c += kTPR) sum += expf(srow[c] - m_new);
    l = expf(m - m_new) * l + group_sum<kTPR>(sum);
    m = m_new;
  }

  // pass 2: P = exp(S - m) / l rounded to V's dtype, O += P V
  for (int c = sub; c < D; c += kTPR) acc[row * L::kLdA + c] = 0.f;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the previous k/v tiles, S and P are consumed
    load_rows<T, D, R>(ks, k + base, k0, t_len);
    load_rows<T, D, R>(vs, v + base, k0, t_len);
    __syncthreads();
    tile_mma<false, true, R, R, D>(qs, L::kLdT, ks, L::kLdT, ss, L::kLdS, false);
    __syncthreads();
    for (int c = sub; c < R; c += kTPR) {
      const float p = live(q0 + row, k0 + c, t_len, causal)
                          ? expf(srow[c] * scale - m) / l
                          : 0.f;
      ps[row * L::kLdP + c] = from_float<T>(p);
    }
    __syncthreads();
    tile_mma<false, false, R, D, R>(ps, L::kLdP, vs, L::kLdT, acc, L::kLdA, true);  // += P V
  }
  __syncthreads();
  if (q0 + row < t_len) {
    T* orow = o + base + static_cast<size_t>(q0 + row) * D;
    for (int c = sub; c < D; c += kTPR) orow[c] = from_float<T>(acc[row * L::kLdA + c]);
  }
}

// ------------------------------------------------------- bf16, T <= 128
template <int D, int NK>
struct OnePassCfg {
  static constexpr int DP = D < 64 ? 64 : D;  // padded head dim
  static constexpr int kThr = 2 * NK;         // NK / 64 warpgroups
  static constexpr int kQ = 0, kK = NK * DP * 2, kV = 2 * NK * DP * 2;
  static constexpr size_t bytes = 3 * NK * DP * 2 + 1024;  // + alignment slack
};

// T <= NK (64 or 128); warpgroup w owns query rows 64 w .. 64 w + 63.
template <int D, int NK>
__global__ void __launch_bounds__(2 * NK, 2)
    attention_fwd_onepass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, bf16* __restrict__ o, int t_len,
                                 int causal) {
  using C = OnePassCfg<D, NK>;
  constexpr int DP = C::DP, kThr = C::kThr;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const size_t mat = static_cast<size_t>(blockIdx.x) * t_len * D;
  const int tid = threadIdx.x;
  load_tile<NK, D, DP, kThr>(base + C::kQ, q + mat, 0, t_len, tid);
  load_tile<NK, D, DP, kThr>(base + C::kK, k + mat, 0, t_len, tid);
  cp_async_commit();
  load_tile<NK, D, DP, kThr>(base + C::kV, v + mat, 0, t_len, tid);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's Q and K copies have landed
  fence_proxy_async();
  __syncthreads();

  const int w = tid / 128;
  const int lane = tid & 31;
  const int row = 64 * w + 16 * ((tid % 128) >> 5) + (lane >> 2);  // rows row, row + 8
  float s_acc[NK / 2];  // S [64 queries, NK keys], then P
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss(s_acc, desc_kmajor<NK>(base + C::kQ, 64 * w, ks), desc_kmajor<NK>(base + C::kK, 0, ks),
             ks);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s_acc);

  // P = exp(S scale - m) / l in f32 (log2 domain), keys at or past
  // key_end[h] masked to 0, rounded to bf16 as the A fragments of P V
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key_end = causal ? min(row + 8 * h + 1, t_len) : t_len;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s_acc[4 * j + 2 * h + c];
        if (8 * j + 2 * (lane & 3) + c >= key_end) x = -INFINITY;
        mx[h] = fmaxf(mx[h], x);
      }
    mx[h] = quad_max(mx[h]) * scale_log2;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s_acc[4 * j + 2 * h + c];
        x = exp2_approx(fmaf(x, scale_log2, -mx[h]));
        sum[h] += x;
      }
    sum[h] = 1.f / quad_sum(sum[h]);
  }
  uint32_t pf[NK / 4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pf[2 * j + h] = pack_bf16(s_acc[4 * j + 2 * h] * sum[h], s_acc[4 * j + 2 * h + 1] * sum[h]);

  cp_async_wait<0>();  // this thread's V copies have landed
  fence_proxy_async();
  __syncthreads();
  float o_acc[DP / 2];  // O [64 queries, DP]
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < NK / 16; ++ks)
    wgmma_rs(o_acc, pf + 4 * ks, desc_mnmajor<NK>(base + C::kV, ks), ks);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(pf);
  reg_fence(o_acc);
  store_acc<D, DP>(o + mat, o_acc, row, lane, t_len);
}

// -------------------------------------------------------- bf16, T > 128
template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    attention_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o, int n_bh,
                              int t_len, int causal) {
  stream_fwd<D, Softmax::kTwoPass>(q, k, v, o, nullptr, n_bh, t_len, causal);
}

// ----------------------------------------------------------------- launch
template <int D, int NK>
cudaError_t launch_onepass(const void* q, const void* k, const void* v, void* o, int bh,
                           int t_len, int causal, cudaStream_t stream) {
  const size_t smem = OnePassCfg<D, NK>::bytes;
  auto kernel = attention_fwd_onepass_kernel<D, NK>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<bh, OnePassCfg<D, NK>::kThr, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), t_len, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int t_len, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (t_len <= 64) return launch_onepass<D, 64>(q, k, v, o, bh, t_len, causal, stream);
    if (t_len <= 128) return launch_onepass<D, 128>(q, k, v, o, bh, t_len, causal, stream);
    const size_t smem = FwdCfg<D>::bytes;
    auto kernel = attention_fwd_sm90_kernel<D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    const int tiles = bh * ((t_len + FwdCfg<D>::BQ - 1) / FwdCfg<D>::BQ);
    int blocks = 0;
    e = stream_blocks(tiles, &blocks);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kRingThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), bh, t_len, causal);
  } else {
    constexpr int R = Tile<T>::rows;
    const size_t smem = AttnSmem<T, D>::bytes;
    auto kernel = attention_fwd_kernel<T, D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(bh, (t_len + R - 1) / R), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), t_len, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). is_bf16: q, k, v and o are
// bf16 (else f32), each [bh, t_len, d]. Returns the cudaError_t of the
// launch.
extern "C" int attention_fwd(int is_bf16, const void* q, const void* k,
                             const void* v, void* o, int bh, int t_len, int d,
                             int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TILE_DISPATCH(launch, q, k, v, o, bh, t_len, causal, st)
}
