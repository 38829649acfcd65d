// The co-alignment solve for Hopper (sm_90a): every Adam step of the solve
// in one persistent, cooperative launch.
//
//   rd_coalign_solve  <- rollingdepth_tpu/aligner.py DepthAligner._optimize:
//                        the jitted lax.scan of num_iterations Adam steps
//                        (no Pallas kernel: XLA compiles the scan whole)
//
// The problem (rollingdepth_torch/aligner.py plain_step, the plain version):
// window i has a scale s_i and a shift t_i; a window row r = (i, j) holds the
// P subsampled values v_r of one frame; a_r = v_r * s_i + t_i.  Frame f's
// target is the sum of the a_r of the rows covering it, over the frame
// table's K slots from the left, divided by its coverage; the L1 loss is
// sum |a_r - target| / mean|target| per row, optionally plus the same for
// 1 / clamp(a_r, 1e-3) (the inverse term), over a fixed denominator; soft
// constraints lmda2 relu(1 - s)^2 + lmda3 t^2 per group.  The targets are
// detached, so a window's gradient is a sum over its rows of
//   sum_p sign(a - target) * (v, 1) / scale   (and the inverse term's
//   sign(1/c - target_inv) * (-1/c^2) [a >= 1e-3] * (v, 1) / scale_inv),
// then optax's Adam (b1, b2, eps, bias corrections from the step count).
//
// Bound on the H100: latency, not bytes or operations.  A step reads the
// views once (2.0 MB at `fast`, 5.6 MB at `full`: 0.6 and 1.7 us at 3.35 TB/s)
// and does ~10 operations a value; the op-by-op step (141 kernels, replayed
// as a CUDA graph) took 250 us.  Design:
//   grid          one block per SM at most (cooperative launch, so every block
//                 is resident), each owning `fpb` whole frames; a block keeps
//                 the K rows of each of its frames in shared memory for the
//                 whole solve when they fit (`resident`), else reads them from
//                 global memory (L2) at each pass.  Each row covers exactly
//                 one frame, so nothing is held twice.
//   a step        per frame: pass 1 takes each pixel's target (slots summed
//                 left to right, the same code in both passes, so the same
//                 bits) and reduces |target| (and the inverse target's), min
//                 and max over the frame; pass 2 takes each slot's sums of
//                 sign * v, sign and |residual| (six more with the inverse
//                 term), reduced over the block by a warp reduce-scatter and
//                 a fixed-order sum over warps; a thread per slot writes the
//                 row's two partials (gradient of s and of t) to one of two
//                 buffers, by the step's parity.  Thread 0 writes the block's
//                 loss parts, min, max and soft term.
//   once a step   one grid barrier (an integer counter, release/acquire);
//                 then every block sums, in row order, the partials of each
//                 window its frames use, adds the soft constraint's gradient
//                 and runs Adam on its own copy of those windows' state.
//                 Every block holding a window does the same arithmetic in
//                 the same order, so the copies keep the same bits without a
//                 second barrier; the two buffers keep a block that runs
//                 ahead from overwriting partials another still reads.
//                 Block 0 sums the blocks' loss parts into the history row.
// No float atomic anywhere and every reduction in an order fixed by the
// shapes: two runs give the same bits.  The products and sums that the plain
// step rounds one by one (a = v * s + t, the Adam update) are written with
// _rn intrinsics, so nvcc does not fuse them into FMAs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int ERR_UNSUPPORTED = -1;
constexpr int ERR_NOT_RESIDENT = -2;  // the grid would not fit on the card at once
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 10;  // slots a pass-2 sweep: 3 (or 6) sums each fit 32 (64) accumulators
constexpr int RED = 64;    // floats a warp in the pass-2 reduction scratch
constexpr int STATS = 8;   // floats a block in the per-step statistics
constexpr unsigned SPIN_POLLS = 1u << 12;  // polls of the barrier before each poll sleeps
constexpr unsigned MAX_POLLS = 1u << 28;  // a barrier that never opens traps instead of hanging the card

struct Args {
  const float* v;      // [n_all * w_max, P] window rows
  const int* meta;     // host-built tables (ops/coalign.py tables)
  float* params;       // [2, n_all]: s, then t
  float* mu;           // [2, n_all]
  float* nu;           // [2, n_all]
  float* history;      // [iters, 3]
  float2* part;        // [2][T * K] per (frame, slot) row: the gradient partials of s and t
  float* stats;        // [2][blocks][STATS]
  unsigned* barrier;   // one counter, zeroed before the launch
  int T, K, P, n_all, w_max, blocks, fpb, iters;
  float lr, b1, b2, omb1, omb2, eps, lmda2, lmda3, loss_scale, dlw, denom;
};

__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives before any leaves; this block's writes
// before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned polls = 0;
    while (ld_acquire(bar) < target) {
      if (++polls > MAX_POLLS) __trap();
      if (polls > SPIN_POLLS) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// The warp's sums of N values a lane: lane l ends holding the sums of values
// [l * N / 32, (l + 1) * N / 32), in a fixed butterfly order (N - N / 32
// shuffles, against 5 N for a tree a value).
template <int N>
__device__ __forceinline__ void warp_reduce_scatter(float (&a)[N], int lane) {
#pragma unroll
  for (int lvl = 0; lvl < 5; ++lvl) {
    const int o = 16 >> lvl, half = N >> (lvl + 1);
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? a[j] : a[j + half];
      const float keep = upper ? a[j + half] : a[j];
      a[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// optax.adam's update of one parameter, in adam_update_'s order and roundings.
__device__ __forceinline__ void adam(float& p, float& m, float& v, float g, float count, const Args& a) {
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(g, a.omb1));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(g, g), a.omb2));
  const float mh = __fdiv_rn(m, __fsub_rn(1.f, powf(a.b1, count)));
  const float vh = __fdiv_rn(v, __fsub_rn(1.f, powf(a.b2, count)));
  const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), a.eps));
  p = __fsub_rn(p, __fmul_rn(u, a.lr));
}

template <bool INV, bool RES>
__global__ void __launch_bounds__(THREADS, 1) coalign_solve(const Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  const int K = a.K, P = a.P, fpb = a.fpb, L = fpb * K, f0 = b * fpb, nf = min(fpb, a.T - f0);
  const int* slot_place = a.meta;                    // [T, K] row of v, -1 empty
  const int* slot_local = slot_place + a.T * K;      // [T, K] local window in its frame's block, -1 empty
  const int* win_rows = slot_local + a.T * K;        // [n_all, w_max] frame * K + slot of each row, -1 pad
  const int* win_size = win_rows + a.n_all * a.w_max;  // [n_all] windows in the window's group
  const int* blk_win = win_size + a.n_all;           // [blocks, L] the block's windows, ascending, -1 pad
  const int* blk_nwin = blk_win + a.blocks * L;      // [blocks]

  // shared memory (ops/coalign.py smem_bytes): state of the block's windows,
  // its slots, per-frame results, reduction scratch, then the resident rows
  float* st_s = smem;
  float* st_t = st_s + L;
  float* st_ms = st_t + L;
  float* st_mt = st_ms + L;
  float* st_ns = st_mt + L;
  float* st_nt = st_ns + L;
  float* w_size = st_nt + L;
  int* w_id = reinterpret_cast<int*>(w_size + L);
  int* w_own = w_id + L;
  int* sl_place = w_own + L;
  int* sl_lw = sl_place + L;
  float* f_loss = reinterpret_cast<float*>(sl_lw + L);  // [L][2]
  float* f_mm = f_loss + 2 * L;                         // [fpb][2]
  float* f_cnt = f_mm + 2 * fpb;                        // [fpb] coverage
  float* red1 = f_cnt + fpb;                            // [WARPS][4]
  float* red = red1 + WARPS * 4;                        // [WARPS][RED]
  float* sums = red + WARPS * RED;                      // [RED]
  float* rows = sums + RED;                             // [L][P] when RES

  const int nw = blk_nwin[b];
  for (int l = tid; l < L; l += THREADS) {
    const int i = l < nw ? blk_win[b * L + l] : -1;
    w_id[l] = i;
    st_s[l] = 1.f;
    st_t[l] = st_ms[l] = st_mt[l] = st_ns[l] = st_nt[l] = 0.f;
    w_size[l] = i >= 0 ? (float)win_size[i] : 1.f;
    w_own[l] = i >= 0 && (win_rows[(size_t)i * a.w_max] / K) / fpb == b;
    const bool mine = l < nf * K;
    sl_place[l] = mine ? slot_place[(size_t)f0 * K + l] : -1;
    sl_lw[l] = mine ? slot_local[(size_t)f0 * K + l] : -1;
  }
  __syncthreads();
  for (int lf = tid; lf < fpb; lf += THREADS) {
    int c = 0;
    for (int k = 0; k < K; ++k) c += sl_lw[lf * K + k] >= 0;
    f_cnt[lf] = (float)c;
  }
  if constexpr (RES) {
    for (int j = 0; j < nf * K; ++j) {
      const int pl = sl_place[j];
      if (pl < 0) continue;
      for (int p = tid; p < P; p += THREADS) rows[(size_t)j * P + p] = __ldg(a.v + (size_t)pl * P + p);
    }
  }
  __syncthreads();

  for (int n = 0; n < a.iters; ++n) {
    float2* part = a.part + (size_t)(n & 1) * a.T * K;
    float* stats = a.stats + (size_t)(n & 1) * a.blocks * STATS;
    for (int lf = 0; lf < nf; ++lf) {
      const int* pl = sl_place + lf * K;
      const int* lw = sl_lw + lf * K;
      const float* rs = rows + (size_t)lf * K * P;
      const float cnt = fmaxf(f_cnt[lf], 1.f);
      // the first SLOTS slots' (s, t) in registers for the frame's passes
      float s_r[SLOTS], t_r[SLOTS];
      unsigned live = 0;
#pragma unroll
      for (int kk = 0; kk < SLOTS; ++kk) {
        const int w = kk < K ? lw[kk] : -1;
        live |= w >= 0 ? 1u << kk : 0u;
        s_r[kk] = w >= 0 ? st_s[w] : 0.f;
        t_r[kk] = w >= 0 ? st_t[w] : 0.f;
      }
      auto value = [&](int k, int p) -> float {
        return RES ? rs[(size_t)k * P + p] : __ldg(a.v + (size_t)pl[k] * P + p);
      };
      // the pixel's target (and inverse target): slots from the left, as the plain step's frame_mean
      auto target = [&](int p, float& tg, float& ti) {
        float ts = 0.f, is = 0.f;
#pragma unroll
        for (int kk = 0; kk < SLOTS; ++kk) {
          if (!(live >> kk & 1u)) continue;
          const float x = __fadd_rn(__fmul_rn(value(kk, p), s_r[kk]), t_r[kk]);
          ts = __fadd_rn(ts, x);
          if constexpr (INV) is = __fadd_rn(is, __frcp_rn(fmaxf(x, 1e-3f)));
        }
        for (int k = SLOTS; k < K; ++k) {
          const int w = lw[k];
          if (w < 0) continue;
          const float x = __fadd_rn(__fmul_rn(value(k, p), st_s[w]), st_t[w]);
          ts = __fadd_rn(ts, x);
          if constexpr (INV) is = __fadd_rn(is, __frcp_rn(fmaxf(x, 1e-3f)));
        }
        tg = __fdiv_rn(ts, cnt);
        ti = INV ? __fdiv_rn(is, cnt) : 0.f;
      };

      // pass 1: the frame's mean |target| (and inverse's), min and max
      float sa = 0.f, sai = 0.f, mn = INFINITY, mx = -INFINITY;
      for (int p = tid; p < P; p += THREADS) {
        float tg, ti;
        target(p, tg, ti);
        sa += fabsf(tg);
        sai += fabsf(ti);
        mn = fminf(mn, tg);
        mx = fmaxf(mx, tg);
      }
      sa = warp_sum(sa);
      sai = warp_sum(sai);
      mn = warp_min(mn);
      mx = warp_max(mx);
      if (lane == 0) {
        red1[warp * 4] = sa;
        red1[warp * 4 + 1] = sai;
        red1[warp * 4 + 2] = mn;
        red1[warp * 4 + 3] = mx;
      }
      __syncthreads();
      {  // every warp the same butterfly over the warps' values: the same bits in every thread
        const bool has = lane < WARPS;
        sa = warp_sum(has ? red1[lane * 4] : 0.f);
        sai = warp_sum(has ? red1[lane * 4 + 1] : 0.f);
        mn = warp_min(has ? red1[lane * 4 + 2] : INFINITY);
        mx = warp_max(has ? red1[lane * 4 + 3] : -INFINITY);
      }
      const float sc = fmaxf(__fdiv_rn(sa, (float)P), 1e-12f);
      const float sci = fmaxf(__fdiv_rn(sai, (float)P), 1e-12f);
      if (tid == 0) {
        f_mm[lf * 2] = mn;
        f_mm[lf * 2 + 1] = mx;
      }

      // pass 2: each slot's sums, SLOTS slots a sweep
      for (int c0 = 0; c0 < K; c0 += SLOTS) {
        constexpr int N = INV ? 64 : 32;
        float acc[N];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] = 0.f;
        for (int p = tid; p < P; p += THREADS) {
          float tg, ti;
          target(p, tg, ti);
#pragma unroll
          for (int kk = 0; kk < SLOTS; ++kk) {
            const int k = c0 + kk;
            if (k < K && lw[k] >= 0) {
              const float sk = c0 == 0 ? s_r[kk] : st_s[lw[k]], tk = c0 == 0 ? t_r[kk] : st_t[lw[k]];
              const float v = value(k, p);
              const float x = __fadd_rn(__fmul_rn(v, sk), tk);
              const float d = __fsub_rn(x, tg), sg = sgn(d);
              acc[kk] += sg * v;
              acc[SLOTS + kk] += sg;
              acc[2 * SLOTS + kk] += fabsf(d);
              if constexpr (INV) {
                const float c = fmaxf(x, 1e-3f);
                const float di = __fsub_rn(__frcp_rn(c), ti), sgi = sgn(di);
                const float dc = x >= 1e-3f ? -__frcp_rn(__fmul_rn(c, c)) : 0.f;  // d(1/clamp(x))/dx
                acc[3 * SLOTS + kk] += sgi * dc * v;
                acc[4 * SLOTS + kk] += sgi * dc;
                acc[5 * SLOTS + kk] += fabsf(di);
              }
            }
          }
        }
        warp_reduce_scatter<N>(acc, lane);
#pragma unroll
        for (int j = 0; j < N / 32; ++j) red[warp * RED + lane * (N / 32) + j] = acc[j];
        __syncthreads();
        if (tid < N) {
          float s = 0.f;
          for (int w = 0; w < WARPS; ++w) s += red[w * RED + tid];
          sums[tid] = s;
        }
        __syncthreads();
        if (tid < SLOTS && c0 + tid < K && lw[c0 + tid] >= 0) {
          const int k = c0 + tid;
          float gs = __fdiv_rn(sums[tid], sc), gt = __fdiv_rn(sums[SLOTS + tid], sc), li = 0.f;
          if constexpr (INV) {
            gs = __fadd_rn(gs, __fmul_rn(a.dlw, __fdiv_rn(sums[3 * SLOTS + tid], sci)));
            gt = __fadd_rn(gt, __fmul_rn(a.dlw, __fdiv_rn(sums[4 * SLOTS + tid], sci)));
            li = __fdiv_rn(sums[5 * SLOTS + tid], sci);
          }
          __stcg(part + (size_t)(f0 + lf) * K + k, make_float2(gs, gt));
          f_loss[(lf * K + k) * 2] = __fdiv_rn(sums[2 * SLOTS + tid], sc);
          f_loss[(lf * K + k) * 2 + 1] = li;
        }
      }
    }
    __syncthreads();
    if (tid == 0) {  // the block's loss parts, min, max and soft term, in a fixed order
      float lm = 0.f, li = 0.f, soft = 0.f, mn = INFINITY, mx = -INFINITY;
      for (int j = 0; j < nf * K; ++j) {
        if (sl_lw[j] < 0) continue;
        lm += f_loss[j * 2];
        li += f_loss[j * 2 + 1];
      }
      for (int lf = 0; lf < nf; ++lf) {
        if (f_cnt[lf] == 0.f) continue;  // an uncovered frame is left out, as the plain step's `covered`
        mn = fminf(mn, f_mm[lf * 2]);
        mx = fmaxf(mx, f_mm[lf * 2 + 1]);
      }
      for (int l = 0; l < nw; ++l) {
        if (!w_own[l]) continue;
        const float r = fmaxf(__fsub_rn(1.f, st_s[l]), 0.f), t = st_t[l];
        soft += a.lmda2 * (r * r) / w_size[l] + a.lmda3 * (t * t) / w_size[l];
      }
      float* st = stats + (size_t)b * STATS;
      __stcg(st, lm);
      __stcg(st + 1, li);
      __stcg(st + 2, soft);
      __stcg(st + 3, mn);
      __stcg(st + 4, mx);
    }
    grid_barrier(a.barrier, (unsigned)(n + 1) * (unsigned)a.blocks);

    if (b == 0 && warp == WARPS - 1) {  // the history row: the blocks' parts, lane-strided, then a fixed tree
      float lm = 0.f, li = 0.f, soft = 0.f, mn = INFINITY, mx = -INFINITY;
      for (int bb = lane; bb < a.blocks; bb += 32) {
        const float* st = stats + (size_t)bb * STATS;
        lm += __ldcg(st);
        li += __ldcg(st + 1);
        soft += __ldcg(st + 2);
        mn = fminf(mn, __ldcg(st + 3));
        mx = fmaxf(mx, __ldcg(st + 4));
      }
      lm = warp_sum(lm);
      li = warp_sum(li);
      soft = warp_sum(soft);
      mn = warp_min(mn);
      mx = warp_max(mx);
      if (lane == 0) {
        const float loss = __fadd_rn(__fdiv_rn(lm, a.denom), __fmul_rn(a.dlw, __fdiv_rn(li, a.denom)));
        float* h = a.history + (size_t)n * 3;
        h[0] = __fadd_rn(__fmul_rn(a.loss_scale, loss), soft);
        h[1] = mn;
        h[2] = mx;
      }
    }
    // Adam on the block's copy of each window its frames use
    const float g0 = __fdiv_rn(a.loss_scale, a.denom), count = (float)(n + 1);
    for (int l = tid; l < nw; l += THREADS) {
      const int i = w_id[l];
      float gs = 0.f, gt = 0.f;
#pragma unroll 4
      for (int j = 0; j < a.w_max; ++j) {  // the window's rows in order (a padded row adds 0)
        const int r = __ldg(win_rows + (size_t)i * a.w_max + j);
        const float2 q = r >= 0 ? __ldcg(part + r) : make_float2(0.f, 0.f);
        gs += q.x;
        gt += q.y;
      }
      const float s = st_s[l], t = st_t[l], inv_n = __frcp_rn(w_size[l]);
      const float r = fmaxf(__fsub_rn(1.f, s), 0.f);
      const float g_s = __fsub_rn(__fmul_rn(gs, g0), __fmul_rn(__fmul_rn(2.f, __fmul_rn(inv_n, a.lmda2)), r));
      const float g_t = __fadd_rn(__fmul_rn(gt, g0), __fmul_rn(__fmul_rn(2.f, __fmul_rn(inv_n, a.lmda3)), t));
      adam(st_s[l], st_ms[l], st_ns[l], g_s, count, a);
      adam(st_t[l], st_mt[l], st_nt[l], g_t, count, a);
    }
    __syncthreads();
  }

  for (int l = tid; l < nw; l += THREADS) {  // each window written once, by the block of its first row
    if (!w_own[l]) continue;
    const int i = w_id[l];
    a.params[i] = st_s[l];
    a.params[a.n_all + i] = st_t[l];
    a.mu[i] = st_ms[l];
    a.mu[a.n_all + i] = st_mt[l];
    a.nu[i] = st_ns[l];
    a.nu[a.n_all + i] = st_nt[l];
  }
}

size_t smem_bytes(int fpb, int K, int P, bool resident) {
  const size_t L = (size_t)fpb * K;
  const size_t floats = 13 * L + 3 * (size_t)fpb + WARPS * 4 + WARPS * RED + RED + (resident ? L * P : 0);
  return floats * sizeof(float);
}

template <bool INV, bool RES>
int launch(const Args& a, size_t smem, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&coalign_solve<INV, RES>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem)) != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < a.blocks) return ERR_NOT_RESIDENT;
  if ((err = cudaMemsetAsync(a.barrier, 0, sizeof(unsigned), st)) != cudaSuccess) return (int)err;
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3(a.blocks), dim3(THREADS), params, smem, st);
  return (int)err;
}

}  // namespace

// The whole solve, num_iterations (iters) Adam steps from s = 1, t = 0 and
// zero moments; writes params, mu, nu ([2, n_all]) and history ([iters, 3]).
// The caller chooses the partition (ops/coalign.py launch_plan): blocks *
// fpb >= T > (blocks - 1) * fpb, and whether the rows stay in shared memory.
// part: 2 * T * K float2, stats: 2 * blocks * 8 floats, barrier: 4 bytes.
extern "C" int rd_coalign_solve(const void* v, const void* meta, void* params, void* mu, void* nu, void* history,
                                void* part, void* stats, void* barrier, int T, int K, int P, int n_all, int w_max,
                                int blocks, int fpb, int resident, int iters, int use_inv, float lr, float b1, float b2,
                                float omb1, float omb2, float eps, float lmda2, float lmda3, float loss_scale,
                                float dlw, float denom, void* stream) {
  if (T < 1 || K < 1 || P < 1 || n_all < 1 || w_max < 1 || iters < 1 || blocks < 1 || fpb < 1 ||
      (long long)blocks * fpb < T || (long long)(blocks - 1) * fpb >= T)
    return ERR_UNSUPPORTED;
  int dev = 0, smem_max = 0;
  cudaGetLastError();  // clear an earlier, unrelated error
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(fpb, K, P, resident != 0);
  if (smem > (size_t)smem_max) return ERR_UNSUPPORTED;
  Args a{static_cast<const float*>(v), static_cast<const int*>(meta), static_cast<float*>(params),
         static_cast<float*>(mu), static_cast<float*>(nu), static_cast<float*>(history),
         static_cast<float2*>(part), static_cast<float*>(stats), static_cast<unsigned*>(barrier),
         T, K, P, n_all, w_max, blocks, fpb, iters,
         lr, b1, b2, omb1, omb2, eps, lmda2, lmda3, loss_scale, dlw, denom};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_inv)
    return resident ? launch<true, true>(a, smem, st) : launch<true, false>(a, smem, st);
  return resident ? launch<false, true>(a, smem, st) : launch<false, false>(a, smem, st);
}
