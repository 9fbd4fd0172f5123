// The streaming attention forward for NVIDIA Hopper (sm_90a), bf16 in,
// f32 softmax, bf16 out, on q, k, v, o [BH, T, D] (row-major, contiguous).
// Two sources instantiate it under kernels of their own names:
//   - flash_attention.cu (Softmax::kOnline): one pass with an online
//     softmax. P = exp(s - m) at the running max m of the k-tiles seen so
//     far, unnormalised, rounded to bf16 for P V; l sums the unrounded
//     f32 p; O = acc / l (l == 0 gives 1) and lse = m + log(l), natural
//     log, for the backward;
//   - attention.cu (Softmax::kTwoPass), at T > 128: pass 1 streams the K
//     tiles for each row's (m, l); pass 2 streams K and V again, recomputes
//     S and forms the normalised exp(s - m) / l in f32 before it rounds it
//     to bf16 for P V, as the reference's full softmax does. No lse.
// Scores are S = Q K^T / sqrt(D); keys at or past T, and above the
// diagonal when causal, are masked (exp gives 0, as the reference's -1e30).
//
// Design (the dq kernel's of flash_backward.cu), three warpgroups a block:
//   - warpgroup 0 is the producer (setmaxnreg down): for each tile of 128
//     queries it loads the Q tile into one of two buffers, then streams K
//     (and V) tiles through a ring of kStages stages with cp.async into
//     128-byte-swizzled tiles, under full/empty mbarriers; rows past T,
//     and the columns past D of a head dim below 64, are zero-filled;
//   - warpgroups 1 and 2 are consumers of 64 query rows each (setmaxnreg
//     up). S = Q K^T is a wgmma from shared memory into f32 registers; the
//     softmax runs in those registers in the log2 domain with ex2.approx,
//     the row max over the quad of lanes that holds a row; P is rounded to
//     bf16 and repacked in place as the register-A fragment of O += P V,
//     a wgmma that reads V MN-major from the stage. O stays in registers
//     (rescaled there by the online softmax); no S, P or O tile reaches
//     shared memory, and each tile's rows belong to one block (no atomics,
//     two launches agree bit for bit);
//   - a step issues the previous step's P V and its own S as one commit
//     group, unconditionally, and waits for both; the two consumers take
//     turns to issue (named barriers), so that one's softmax runs while
//     the other's products are on the tensor cores;
//   - only a step that crosses the diagonal or the end of T runs the
//     masked copy of the softmax; rows at or past T are never stored, so
//     they need no mask;
//   - persistent: one block an SM walks the tiles, the heaviest causal
//     ones first, in a serpentine over the blocks; the next tile's Q and
//     K/V loads overlap this tile's last steps and its stores;
//   - causal: k-tiles wholly above a tile are never loaded, and a
//     consumer whose rows lie wholly above a k-tile only releases it;
//   - the k-tile is 128 keys up to D = 64 and 64 at D = 128 (registers,
//     and four stages in shared memory); head dims 16 and 32 are padded
//     with zero columns to 64.
// Bound: 4 D flops per live (query, key) pair against 8 D bytes per row:
// at T = 2048, D = 64 the tensor cores, not memory, are the limit, and the
// exponentials (one a pair, 16 a clock per SM) take about as long as the
// products.

#pragma once

#include <cmath>
#include <type_traits>

#include "hopper.cuh"  // mbarriers, cp.async, wgmma, the ring, accumulator helpers

namespace {

enum class Softmax { kOnline, kTwoPass };

template <int D>
struct FwdCfg {
  static constexpr int DP = D < 64 ? 64 : D;     // padded head dim
  static constexpr int BQ = 64 * kConsumers;     // queries per tile
  static constexpr int BK = D > 64 ? 64 : 128;   // keys per stage
  static constexpr int kQBytes = BQ * DP * 2;    // a Q tile; two of them
  static constexpr int kStage0 = 2 * kQBytes;
  static constexpr int kK = 0, kV = BK * DP * 2;  // inside a stage
  static constexpr int kStageBytes = 2 * BK * DP * 2;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  static constexpr size_t bytes = kBar + (2 * kStages + 4) * 8 + 1024;  // + alignment slack
};

// Blocks of the persistent grid for `tiles` tiles: one an SM of the
// current device (the shared memory holds one), fewer when there are fewer
// tiles.
inline cudaError_t stream_blocks(int tiles, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = tiles < sms ? tiles : sms;
  return e;
}

// Tile of block b in its round `it` (of gridDim.x tiles each), in a
// serpentine: b in even rounds, gridDim.x - 1 - b in odd ones. With the
// heaviest causal tiles first, a block that took a heavy tile in one round
// takes a light one in the next.
__device__ __forceinline__ int stream_tile(int it) {
  return it * gridDim.x + ((it & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// The body of a __global__ kernel of kRingThreads threads launched on
// the stream_blocks of n_bh * ceil(T / BQ) tiles with FwdCfg<D>::bytes of
// dynamic shared memory. Tile t (query rows BQ qt .. BQ qt + BQ - 1 of
// head bh) is bh = t % n_bh, qt = the last q-tile - t / n_bh: the heaviest
// causal tiles first; block b takes tiles stream_tile(0), stream_tile(1),
// ... lse is written in kOnline mode only.
template <int D, Softmax kMode>
__device__ __forceinline__ void stream_fwd(const __nv_bfloat16* __restrict__ q,
                                           const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ v,
                                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                           int n_bh, int t_len, int causal) {
  using C = FwdCfg<D>;
  constexpr int BQ = C::BQ, DP = C::DP, BK = C::BK;
  constexpr bool kTwoPass = kMode == Softmax::kTwoPass;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + C::kBar, empty = full + 8 * kStages;
  const uint32_t q_full = empty + 8 * kStages, q_empty = q_full + 16;

  const int nq = (t_len + BQ - 1) / BQ;
  const int n_tiles = n_bh * nq;
  const int nk = (t_len + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // a tile's first query row, head and k-tiles a pass
  auto tile_q0 = [&](int t) { return (nq - 1 - t / n_bh) * BQ; };
  auto tile_steps = [&](int q0) { return causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 128);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * s, 128);
      mbar_init(q_empty + 8 * s, 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: Q of each tile into one of two buffers, K/V through the ring
    setmaxnreg_dec<kProducerRegs>();
    int g = 0;  // ring steps so far
    for (int it = 0, t = stream_tile(0); t < n_tiles; t = stream_tile(++it)) {
      const int q0 = tile_q0(t);
      const size_t mat = static_cast<size_t>(t % n_bh) * t_len * D;
      const int n_steps = tile_steps(q0);
      if (it >= 2) mbar_wait(q_empty + 8 * (it & 1), ((it >> 1) & 1) ^ 1);
      load_tile<BQ, D, DP>(base + (it & 1) * C::kQBytes, q + mat, q0, t_len, tid);
      cp_async_arrive(q_full + 8 * (it & 1));
      for (int i = 0; i < (kTwoPass ? 2 : 1) * n_steps; ++i, ++g) {
        const int s = g % kStages;
        if (g >= kStages) mbar_wait(empty + 8 * s, ((g / kStages) & 1) ^ 1);
        const int pass = kTwoPass && i >= n_steps;
        const int k0 = (i - pass * n_steps) * BK;
        const uint32_t st = base + C::kStage0 + s * C::kStageBytes;
        load_tile<BK, D, DP>(st + C::kK, k + mat, k0, t_len, tid);
        if (!kTwoPass || pass) load_tile<BK, D, DP>(st + C::kV, v + mat, k0, t_len, tid);
        cp_async_arrive(full + 8 * s);
      }
    }
    cp_async_wait_all();
    return;
  }

  // consumer warpgroup w: query rows 64 w .. 64 w + 63 of each tile
  setmaxnreg_inc<kConsumerRegs>();
  const int w = wg - 1;
  const int lane = tid & 31;
  const int row = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: row, row + 8
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(D));
  auto stage = [&](int i) { return base + C::kStage0 + (i % kStages) * C::kStageBytes; };
  auto wait_full = [&](int i) { mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1); };
  auto release = [&](int i) { mbar_arrive(empty + 8 * (i % kStages)); };
  // turns: consumer w issues a step's products only after the other
  // consumer has issued its own (named barrier 1 + w, 256 threads: this
  // consumer's sync and the other's arrival), so that one consumer's
  // softmax runs while the other's products keep the tensor cores busy
  auto turn_wait = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory"); };
  auto turn_pass = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory"); };

  int g = 0;  // ring steps so far
  for (int it = 0, t = stream_tile(0); t < n_tiles; t = stream_tile(++it)) {
    const int q0 = tile_q0(t);
    const int bh = t % n_bh;
    const size_t mat = static_cast<size_t>(bh) * t_len * D;
    const int n_steps = tile_steps(q0);
    const int qw0 = q0 + 64 * w;
    const uint32_t q_tile = base + (it & 1) * C::kQBytes;
    // the steps of a pass that hold a live pair of these rows (causal:
    // the later k-tiles lie wholly above them; they are only released),
    // and the most of the two consumers (the second one's)
    const int n_live = causal ? min(n_steps, (qw0 + 63) / BK + 1) : n_steps;
    const int n_live_max = causal ? min(n_steps, (q0 + BQ - 1) / BK + 1) : n_steps;
    float o_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
    // per row h of this thread: the running max of S scale log2(e), and
    // this thread's share of the row sum (the quad's shares add up to l)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {1.f, 1.f}, alpha[2];
    // keys at or past key_end[h] are masked in this thread's rows
    int key_end[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) key_end[h] = causal ? min(qw0 + row + 8 * h + 1, t_len) : t_len;
    // bf16(P) of a step as A fragments: its product goes out in the next step
    uint32_t pf[BK / 4];

    auto s_products = [&](float (&s_acc)[BK / 2], uint32_t st) {  // S = Q K^T
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss(s_acc, desc_kmajor<BQ>(q_tile, 64 * w, ks), desc_kmajor<BK>(st + C::kK, 0, ks), ks);
    };
    auto pv_products = [&](uint32_t st) {  // O += P V
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_rs(o_acc, pf + 4 * ks, desc_mnmajor<BK>(st + C::kV, ks), 1);
    };
    // The softmax of one step on s_acc, keys k0 .. k0 + BK - 1: scores of
    // masked pairs become -inf; with `stats`, the row max, alpha and the
    // row sum move on (online; pass 1); then p = 2^(S scale log2(e) - m)
    // stays in s_acc (times 1 / l in pass 2).
    auto softmax = [&](float (&s_acc)[BK / 2], int k0, bool stats) {
      auto body = [&](auto masked) {
        if constexpr (decltype(masked)::value) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                if (k0 + 8 * j + 2 * (lane & 3) + c >= key_end[h]) s_acc[4 * j + 2 * h + c] = -INFINITY;
        }
        if (stats) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              mx[h] = fmaxf(mx[h], fmaxf(s_acc[4 * j + 2 * h], s_acc[4 * j + 2 * h + 1]));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float m_new = fmaxf(m[h], quad_max(mx[h]) * scale_log2);
            alpha[h] = exp2_approx(m[h] - m_new);
            m[h] = m_new;
          }
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int r = 4 * j + 2 * h + c;
              const float p = exp2_approx(fmaf(s_acc[r], scale_log2, -m[h]));
              sum[h] += p;
              s_acc[r] = kTwoPass ? p * inv_l[h] : p;
            }
        if (stats) {
#pragma unroll
          for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
        }
      };
      // only a step that crosses the diagonal or the end of T is masked
      if ((causal && k0 + BK - 1 > qw0) || k0 + BK > t_len)
        body(std::true_type{});
      else
        body(std::false_type{});
    };
    // after a step's softmax, with no product in flight: O *= alpha
    // (online) and P into the A fragments
    auto take_p = [&](const float (&s_acc)[BK / 2]) {
      if constexpr (!kTwoPass) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            o_acc[4 * j + 2 * h] *= alpha[h];
            o_acc[4 * j + 2 * h + 1] *= alpha[h];
          }
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          pf[2 * j + h] = pack_bf16(s_acc[4 * j + 2 * h], s_acc[4 * j + 2 * h + 1]);
    };
    // The steps of ring slots i0 .. i0 + n_steps - 1 (k-tiles 0, 1, ...)
    // that form P and accumulate P V. Each live step after the first
    // issues the previous step's P V and its own S as one commit group,
    // unconditionally (ptxas serialises wgmma issued under a condition),
    // then waits for both. Every consumer takes n_live_max + 1 turns.
    auto pv_pass = [&](int i0) {
      {
        wait_full(i0);
        fence_proxy_async();
        float s_acc[BK / 2];
        turn_wait();
        wgmma_fence();
        s_products(s_acc, stage(i0));
        wgmma_commit();
        turn_pass();
        wgmma_wait<0>();
        reg_fence(s_acc);
        softmax(s_acc, 0, !kTwoPass);
        take_p(s_acc);
      }
      for (int i = 1; i < n_live; ++i) {
        wait_full(i0 + i);
        fence_proxy_async();
        float s_acc[BK / 2];
        turn_wait();
        wgmma_fence();
        pv_products(stage(i0 + i - 1));
        s_products(s_acc, stage(i0 + i));
        wgmma_commit();
        turn_pass();
        wgmma_wait<0>();
        reg_fence(s_acc);
        reg_fence(pf);
        reg_fence(o_acc);
        release(i0 + i - 1);
        softmax(s_acc, i * BK, !kTwoPass);
        take_p(s_acc);
      }
      turn_wait();
      wgmma_fence();
      pv_products(stage(i0 + n_live - 1));
      wgmma_commit();
      // the second consumer's last turn ends the tile: no one waits on it
      if (w == 0 || n_live < n_live_max) turn_pass();
      // a consumer with fewer live steps takes its remaining turns idle
      for (int i = n_live; i < n_live_max; ++i) {
        turn_wait();
        if (w == 0) turn_pass();
      }
      wgmma_wait<0>();
      reg_fence(pf);
      reg_fence(o_acc);
      release(i0 + n_live - 1);
      for (int i = n_live; i < n_steps; ++i) {  // wholly above the diagonal
        wait_full(i0 + i);
        release(i0 + i);
      }
    };

    mbar_wait(q_full + 8 * (it & 1), (it >> 1) & 1);
    if (w == 1) turn_pass();  // consumer 0 takes the tile's first turn
    if constexpr (kTwoPass) {
      // pass 1: each row's max and sum
      for (int i = 0; i < n_live; ++i) {
        wait_full(g + i);
        fence_proxy_async();
        float s_acc[BK / 2];
        wgmma_fence();
        s_products(s_acc, stage(g + i));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s_acc);
        softmax(s_acc, i * BK, true);
        release(g + i);
      }
      for (int i = n_live; i < n_steps; ++i) {  // wholly above the diagonal
        wait_full(g + i);
        release(g + i);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) inv_l[h] = 1.f / quad_sum(l[h]);
      pv_pass(g + n_steps);
      g += 2 * n_steps;
    } else {
      pv_pass(g);
      g += n_steps;
    }
    mbar_arrive(q_empty + 8 * (it & 1));  // every product reading this Q has finished
    if constexpr (!kTwoPass) {
      float li[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        li[h] = quad_sum(l[h]);
        if (li[h] == 0.f) li[h] = 1.f;
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o_acc[4 * j + 2 * h] /= li[h];
          o_acc[4 * j + 2 * h + 1] /= li[h];
        }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = qw0 + row + 8 * h;
          if (r < t_len) lse[static_cast<size_t>(bh) * t_len + r] = m[h] / kLog2e + logf(li[h]);
        }
      }
    }
    store_acc<D, DP>(o + mat, o_acc, qw0 + row, lane, t_len);
  }
}

}  // namespace
