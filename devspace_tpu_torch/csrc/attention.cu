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
// and every call at the training shapes (T = 128); even so the tile
// products need the tensor cores to stay near that bound (nvcuda::wmma
// m16n16k16, bf16 in, f32 accumulate) for bf16 inputs; f32 inputs take a
// scalar f32 path with the same structure, for parity at full precision.
//
// Design:
//   - the TPU body holds the whole K and V rows in VMEM; at T = 1024,
//     D = 128 those are 256 KB each in bf16, more than an SM's shared
//     memory, so K and V stream through shared memory in tiles, and one
//     block owns one (bh, q-tile);
//   - two passes over the K tiles keep the reference's rounding: pass 1
//     recomputes nothing but the row statistics (m, l), online; pass 2
//     computes the scores again, forms exp(s - m) / l, rounds it to V's
//     dtype and accumulates P V in f32. The scores are computed twice
//     and K is read twice (from L2 the second time); V once;
//   - causal: tiles wholly above the diagonal are skipped, the diagonal
//     tile is masked element by element; the heaviest tiles launch first;
//   - tiles are 64 rows for bf16 and 32 for f32; rows past T are
//     zero-filled on load and masked, so any T from 1 works;
//   - each row's (m, l) lives in the registers of the 4 (bf16) or 8 (f32)
//     threads that share the row, reduced by shuffles.
// Like the flash kernels, this version does not overlap loads with math,
// syncs the block between the steps of a tile and keeps the O accumulator
// in shared memory: those are the known gaps to the bound.

#include "tile.cuh"  // tiles, tile products, row reductions

namespace {

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
  const int bh = blockIdx.y;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int t_len, int causal, cudaStream_t stream) {
  constexpr int R = Tile<T>::rows;
  const size_t smem = AttnSmem<T, D>::bytes;
  auto kernel = attention_fwd_kernel<T, D>;
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((t_len + R - 1) / R, bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, causal);
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
