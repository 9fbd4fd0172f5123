// Flash attention forward for NVIDIA Hopper (sm_90a). The two backward
// kernels (dq, dk/dv) are in flash_backward.cu.
//
// Replaces the Pallas TPU kernel of devspace_tpu/ops/flash_attention.py:
//   flash_fwd      <- `_fwd_kernel`     (launched by `_flash_fwd_call`)
// on q, k, v, o [BH, T, D] (row-major, contiguous) with lse f32 [BH, T].
// Scores are S = Q K^T / sqrt(D), masked to -1e30 above the diagonal when
// causal; the kernel runs an online softmax with f32 (m, l, acc) and
// writes O and lse = m + log(l), which the backward recomputes P from. As
// the reference, P V takes the unnormalised exp(s - m) at the running max
// of the k-tiles seen so far, rounded to V's dtype, and l sums the
// unrounded p.
//
// Bound: at training shapes (T = 2048, D = 64) the work is about 4 D
// flops per (query, key) pair against 2 D bytes read per row: far above
// the ~295 flops per byte where the H100's tensor cores, not memory, are
// the limit, and one exponential a pair (16 a clock per SM) takes about as
// long as the products.
//
// bf16: the warp-specialised, persistent streaming kernel of
// attention_fwd.cuh (Softmax::kOnline): a producer warpgroup streams K/V
// tiles through a cp.async ring under mbarriers; two consumer warpgroups
// keep S, P and O in wgmma registers, P repacked in place as the A
// operand of P V, and take turns on the tensor cores.
//
// f32 (parity at full precision, not a training path): one block per
// (bh, 32-row q-tile) walks the k-tiles with scalar f32 tile products in
// shared memory; causal tiles wholly above the diagonal are skipped, the
// diagonal tile is masked element by element, rows past T are zero-filled
// and masked, and the heaviest causal tiles launch first.

#include "attention_fwd.cuh"  // the bf16 streaming forward
#include "tile.cuh"           // f32 tiles, tile products, row reductions

namespace {

// ---------------------------------------------------------------- f32
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
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
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

// ------------------------------------------------------------------ bf16
template <int D>
__global__ void __launch_bounds__(kRingThreads, 1)
    flash_fwd_sm90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int n_bh, int t_len, int causal) {
  stream_fwd<D, Softmax::kOnline>(q, k, v, o, lse, n_bh, t_len, causal);
}

// ----------------------------------------------------------------- launch
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_len, int causal,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = FwdCfg<D>::bytes;
    auto kernel = flash_fwd_sm90_kernel<D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    const int tiles = bh * ((t_len + FwdCfg<D>::BQ - 1) / FwdCfg<D>::BQ);
    int blocks = 0;
    e = stream_blocks(tiles, &blocks);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, kRingThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), bh, t_len, causal);
  } else {
    constexpr int R = Tile<T>::rows;
    const size_t smem = FwdSmem<T, D>::bytes;
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(bh, (t_len + R - 1) / R), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
        t_len, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). is_bf16: q, k, v and o are
// bf16 (else f32); lse is f32 [BH, T]. Returns the cudaError_t of the
// launch.
extern "C" int flash_fwd(int is_bf16, const void* q, const void* k,
                         const void* v, void* o, void* lse, int bh, int t_len,
                         int d, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TILE_DISPATCH(launch_fwd, q, k, v, o, lse, bh, t_len, causal, st)
}
