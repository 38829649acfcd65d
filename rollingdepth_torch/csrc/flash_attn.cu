// Flash attention forward kernels for Hopper (sm_90a), the ports of eight TPU kernels.
//
//   rd_flash_nomax  <- rollingdepth_tpu/ops/flash_attention.py::_flash_kernel_packed_nomax
//   rd_flash_max    <- rollingdepth_tpu/ops/flash_attention.py::_flash_kernel_packed
//   rd_flash_wide   <- rollingdepth_tpu/ops/flash_attention.py::_flash_kernel_wide
//
// All three compute o = sum_j exp2(s_ij - m_i) v_j / sum_j exp2(s_ij - m_i)
// with s = (q . k) * scale * log2(e) in fp32.  The scale is applied to the
// fp32 score inside the kernel (one multiply per score), not folded into k
// beforehand as the TPU wrapper does, so k is read as given.  The max-free
// kernel drops m (m = 0): its caller guarantees |s| < ~120 (the load-time
// score probe, ops/score_probe.py).  The running-max kernels keep the
// online-softmax correction corr = exp2(m_prev - m_new).  Keys past L_k
// contribute exactly 0 to both the numerator and the normaliser.  P is
// rounded to v's dtype before P.V; the narrow kernels sum the rounded P
// (as the TPU kernel's ones-column did), the wide kernel the fp32 P.
//
// The sweep variants of scripts/bench_flash_variants.py are further
// instantiations of the narrow template (their fp32 inputs take the 3xTF32
// kernels; K7 and K9 without bf16_exp compute what rd_flash_max and
// rd_flash_nomax compute, and their wrappers launch those):
//
//   rd_flash_exp2           <- _kernel_exp2   running max, fp32 normaliser
//   rd_flash_bf16           <- _kernel_bf16   PRESCALE_Q + BF16_SCORES
//   rd_flash_nomax_bf16exp  <- _kernel_nomax(bf16_exp=True)  NO_MAX + BF16_SCORES
//   rd_flash_nomask         <- _kernel_nomask NO_MAX + PRESCALE_Q
//
// PRESCALE_Q rounds q * scale * log2(e) to bf16 once, in shared memory after
// the Q tile lands, and the score is then used unscaled.  BF16_SCORES rounds
// the score to bf16, and, with a running max, the difference s - m too; p =
// exp2 of that is rounded to bf16 as always.
//
// Layout: q, k, v and o are [B, L, H, D] contiguous, read in place (but a
// narrow head's k and v where d is not 64: below).  TMA
// reads them through 4-D tensor maps (d, H, L, B) in boxes of 64 columns
// (32 in fp32, 128 bytes either way): columns past d and rows past L arrive as zeros, and no box crosses a
// head or a batch.  bf16 runs on the tensor cores with wgmma (fp32
// accumulation), fp32 with 3xTF32 wgmma (below).  The PTX
// (cp.async.bulk.tensor, mbarrier, wgmma.mma_async, setmaxnreg) is wrapped
// in hopper.cuh.
//
// Narrow heads (d < 128): one CTA per (64*NCW-query tile, batch*head), NCW
// = 2 consumer warpgroups (3 for the bf16-score variants and for d > 64)
// plus one producer warpgroup.  One producer thread
// keeps a 3-stage ring of K and V tiles (128 keys for d <= 64, 64 for
// d <= 128) in flight with TMA; the producer gives up registers
// (setmaxnreg) to the consumers, which own 64 query rows each.  A consumer
// computes S = Q K^T with wgmma from shared memory, the softmax in
// registers, and O += P V with P as the register A operand and V as the
// transposed (MN-major) B operand in its natural [keys, d] layout.  The
// consumers take turns on the tensor cores, round robin (named barriers):
// turn j issues this tile's Q K^T and then the previous tile's P V, waits
// for the Q K^T alone, and runs the exp2 half of tile j's softmax under the
// P V (and under the other consumers' products); it then waits for the P V
// and rounds and packs P_j, the second half.
//
// Every narrow d but 64 (SD1.5's 40 and 80) is narrower than its 64 or 128
// columns in shared memory.  TMA reads a row of fewer than 64 bf16 columns,
// or one not 128-byte aligned, at a fraction of the rate of a whole aligned
// row: K and V alone of [8, 21600, 8, 40] stream in 16.2 ms in 64-column
// boxes (columns past d filled with zeros), 10.7 in boxes of exactly 40
// columns and 19.4 in boxes of 16 or 8, against 4.6 ms at d = 64.  That
// bound K1 there, which ran its products over the padding to no cost: at
// the head's width alone it took 17.9 ms, against 17.1-18.3.  So a pre-pass
// (flash_fwd_pad_kv) copies K and V into the caller's scratch padded to 64
// or 128 columns, TMA reads whole aligned rows, and the kernel is bound by its
// softmax and products, which run at the head's width, not the padding:
// Q K^T over d rounded up to 16 (3 k16 steps for d = 40, 5 for 80, not 4
// and 8; the columns past d are zeros in both operands), P V at N = d + 8
// (48, 88, not 64, 128) over V's 64-column blocks, N leaving the last block
// part unread.  Column d of the padded V is ones, so that column d of P V
// is the sum of the rounded P, the normaliser, and the threads no longer
// add it up score by score (two of the softmax's few instructions a score).
// The tensor core adds in another order than the threads did: the output
// differs from the kernel's on inputs zero-padded to 64 or 128 columns by
// one bf16 ulp on about 1e-4 of the elements (without the ones column it
// is bit-equal).  K6 normalises by the fp32 P and keeps the threads' sum.
// d = 64 runs as before.  K1 at [8, 21600, 8, 40] 17.1-17.6 -> 14.3-14.4 ms
// (bound 4.8 ms by the head's operations), [8, 5400, 8, 80] 1.57-1.60 ->
// 1.26-1.31 (bound 0.6); NVIDIA H100 80GB HBM3, 700 W.
//
// What bounds K1 at d = 40 then: a tile's softmax costs a consumer thread
// 64 ex2.approx and 32 cvt.rn.bf16x2.f32 for its 64 scores, both on the
// SM's quarter-rate pipe (16 an SM-clock, 8 cycles a warp instruction), so
// 1.5 of its operations a score, 768 cycles a tile for each consumer warp
// and 1536 for the two that share a sub-partition.  Clock stamps in one CTA
// of [8, 21600, 8, 40] (1.8 GHz) read 1618 cycles a tile: the exp2 half
// 720-760, the pack 250-280, the mbarrier waits 187, the wgmma issue
// 200-330, the wait for Q K^T 20-140; the pipe is busy 95% of the time.
// The turns used to wait for both products and then run the whole softmax
// (K1 14.4-14.9 ms); the exp2 half under the P V, with the order pinned by
// schedule_fence (narrow_fenced), takes 12.1-13.0 ms (NVIDIA H100 80GB HBM3,
// 700 W).  Part of each tile's
// exp2 on the FMA pipe as a polynomial (Cody-Waite reduction by adding 1.5 *
// 2^23, a degree-5 minimax fit, 2^n from n's bits: 11 issue slots a score,
// within 1.55e-7 of float64) made K1 slower at every width and share tried
// (1/8 to 1/2): +0.5% to +12.8% at [8, 21600, 8, 40] on the old turns,
// +5.6% to +20.8% on these, where the issue slots it adds cost more than the
// quarter-rate cycles it frees.  It is not built (PERF.md, section 6).
//
// Wide heads (d <= 512, padded to 128, 256 or 512): one CTA per (64-query
// tile, batch*head), 32-key tiles in a 2-stage ring.  For d = 512 two
// consumer warpgroups each own 256 output columns (a 64x256 fp32
// accumulator) and compute half of the 512-deep Q K^T contraction; the two
// partial score tiles are summed through shared memory, so each (query
// tile, key tile) product is computed once, and both apply the same m and l.
// Narrower wide heads use one consumer warpgroup.
//
// Bound on the H100 (data-sheet estimates): at the UNet's first level,
// [8, 15552, 5, 64] bf16, one launch is 2.48 TFLOP of mma (2.5 ms at
// 989 TFLOP/s) and 9.7e9 exp2 on the SFUs (~2.5 ms at 16 per SM-clock).
// The softmax binds it: without its exp2 the kernel takes 4.8 ms, not 5.7,
// without the normaliser's adds 5.3, without the scale's multiply 5.3; its
// loads alone 1.5 ms.  The VAE's d = 512 head,
// [4, 5184, 1, 512], is 0.22 TFLOP (0.22 ms), with 64 multiplies of the
// tensor cores per exp2.
//
// fp32 (every dtype == 1 entry; the paper preset's K1 and K3) runs 3xTF32
// wgmma: each product as three tf32 products, 3 x 2.48 TFLOP / 495 TFLOP/s
// = 15.0 ms for K1 at [8, 15552, 5, 64] and 3 x 0.22 / 495 = 1.34 ms for K3
// at [4, 5184, 1, 512], where fp32 FMA outside the tensor cores (67
// TFLOP/s) bounds at 37.0 and 3.3 ms.  It replaces a kernel with one warp
// per query row that reread each K and V tile from L2 for every 8 query
// rows, loaded both operands of each FMA from shared memory, broadcast P by
// shuffles, loaded scalars synchronously and used no tensor core.  Here a
// CTA takes 128 query rows (d <= 64; Q stays in shared memory) or 64 (wide
// heads), TMA brings 128-byte-swizzled tiles into a ring that a producer
// warpgroup keeps full, the operands go to wgmma straight from shared
// memory (and P from registers), and the split into tf32 parts is done once
// per element by a pre-pass, not once per product.  The tensor core's own
// fp32 sums drift by about 2^-24 of the sum per wgmma (one accumulator
// over all key tiles erred by 2.1e-4 of K1's output scale at L_k = 15,552,
// 1.5e-5 at 1,000), so P V goes to a fresh accumulator for each key tile
// (64 output columns at a time in the wide kernel) that the consumer adds
// to the output in fp32.  Keys past L_k give
// exactly 0 (masked scores, zero v^T), P stays in fp32, the normaliser sums
// the fp32 P.

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float MASKED = -1e30f;
constexpr int ERR_UNSUPPORTED = -1;
constexpr int ERR_TENSOR_MAP = -2;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// One key tile's softmax on a wgmma score accumulator of NT 8-key blocks
// (thread layout of m64nN: s[4*nt + e] is row g + 8*(e >> 1), key 8*nt +
// 2*tig + (e & 1)), in two halves.  softmax_exp scales and masks s, updates
// the running max m_r, the correction corr = exp2(m_old - m_new) of rows g
// and g + 8 and l_r *= corr, and leaves p = exp2(s - m) in s, touching
// neither the output accumulator nor pa, so that a P V product in flight
// runs under it.
template <int NT, bool NO_MAX, bool PRESCALE_Q, bool BF16_SCORES>
__device__ __forceinline__ void softmax_exp(float (&s)[NT * 4], float (&m_r)[2], float (&l_r)[2], float (&corr)[2],
                                            int k0, int Lk, int tig, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) {
    float x = PRESCALE_Q ? s[i] : s[i] * scale_log2;
    s[i] = BF16_SCORES ? round_bf16(x) : x;
  }
  if (k0 + NT * 8 > Lk) {  // the last tile: keys past L_k
#pragma unroll
    for (int i = 0; i < NT * 4; ++i)
      if (k0 + (i / 4) * 8 + tig * 2 + (i & 1) >= Lk) s[i] = MASKED;
  }

  float mrow[2] = {0.f, 0.f};
  if (!NO_MAX) {
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * nt + 0], s[4 * nt + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = fast_exp2(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
    mrow[0] = BF16_SCORES ? round_bf16(m_r[0]) : m_r[0];
    mrow[1] = BF16_SCORES ? round_bf16(m_r[1]) : m_r[1];
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked key is exactly 0: m is the max over at least one real
      // key, so s - m <= -1e30 (rounded to bf16 or not), and ex2.approx.ftz
      // of that is +0
      const float x = s[4 * nt + e];
      const float xm = (BF16_SCORES && !NO_MAX) ? round_bf16(x - mrow[e >> 1]) : x - mrow[e >> 1];
      s[4 * nt + e] = fast_exp2(xm);
    }
  }
}

// The second half: rescales the output accumulator by corr (running max),
// adds p to the partial row sums l_r (THREAD_SUM; rounded to bf16 where
// SUM_ROUNDED), and leaves p rounded to bf16 in pa as wgmma A fragments of
// 16 keys each.  Without THREAD_SUM the caller sums P in its P V product (a
// column of ones in V).
template <int NT, int NACC, bool NO_MAX, bool SUM_ROUNDED, bool THREAD_SUM>
__device__ __forceinline__ void softmax_pack(const float (&p)[NT * 4], float (&acc)[NACC], uint32_t (&pa)[NT / 2][4],
                                             float (&l_r)[2], const float (&corr)[2]) {
  if (!NO_MAX) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < NACC / 4; ++nt) {
        acc[4 * nt + 2 * r] *= corr[r];
        acc[4 * nt + 2 * r + 1] *= corr[r];
      }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(p[4 * nt + 0], p[4 * nt + 1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p[4 * nt + 2], p[4 * nt + 3]);
    if (THREAD_SUM && SUM_ROUNDED) {
      l_r[0] += __low2float(lo) + __high2float(lo);
      l_r[1] += __low2float(hi) + __high2float(hi);
    } else if (THREAD_SUM) {
      l_r[0] += p[4 * nt + 0] + p[4 * nt + 1];
      l_r[1] += p[4 * nt + 2] + p[4 * nt + 3];
    }
    pa[nt >> 1][(nt & 1) * 2 + 0] = bf16_bits(lo);
    pa[nt >> 1][(nt & 1) * 2 + 1] = bf16_bits(hi);
  }
}

// Normalise and store this thread's outputs: rows row0 + g and row0 + g + 8,
// columns col0 + 8*nt + 2*tig (+1), nt < NACC / 4.
template <int NACC>
__device__ __forceinline__ void store_rows(const float (&acc)[NACC], float (&l_r)[2], __nv_bfloat16* ob,
                                           long long rs, int row0, int col0, int Lq, int d, int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float inv0 = 1.f / l_r[0], inv1 = 1.f / l_r[1];
  const int qa = row0 + g, qc = qa + 8;
#pragma unroll
  for (int nt = 0; nt < NACC / 4; ++nt) {
    const int col = col0 + nt * 8 + tig * 2;
    if (col >= d) continue;
    if (qa < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qa * rs + col) =
          __floats2bfloat162_rn(acc[4 * nt + 0] * inv0, acc[4 * nt + 1] * inv0);
    if (qc < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qc * rs + col) =
          __floats2bfloat162_rn(acc[4 * nt + 2] * inv1, acc[4 * nt + 3] * inv1);
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// O += P V for one warpgroup: KEYS/16 wgmma of k16 at N = DV, V MN-major in
// 64-column blocks of KEYS rows; N need not fill the last block (N = 48
// reads the first 48 columns of one).
template <int DV, int KEYS>
__device__ __forceinline__ void pv_products(float (&acc)[DV / 2], const uint32_t (&pa)[KEYS / 16][4],
                                            const unsigned char* v_tile) {
  uint64_t dv = make_desc(v_tile, KEYS * 128, 1024);
  opaque(dv);
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) wgmma_rs<DV>(acc, pa[kk], dv + kk * 128);
}

// ---- narrow heads: d < 128 ------------------------------------------------------

constexpr int N_STAGES = 3;

// Consumer warpgroups of 64 query rows.  Two, unless the scores are
// rounded to bf16 or the head is wider than 64: the two extra conversions
// per score make the softmax longer than the products, and a third
// warpgroup keeps the tensor cores fed (measured: K1 5.4 ms with two, 6.1
// with three; K8 10.7 with two, 9.5 with three); above 64 columns the
// 64-key tiles make the turns short, and a third warpgroup hides more of
// them (K1 at [8, 5400, 8, 80] 1.42 ms with two, 1.28 with three; at d =
// 40 three are slower, 15.6 ms against 14.4).  NVIDIA H100 80GB HBM3, 700 W.
template <bool BF16_SCORES, int D>
__host__ __device__ constexpr int narrow_consumers() {
  return BF16_SCORES || D > 64 ? 3 : 2;
}

// A narrow head of d columns (d % 8 == 0, d < 128) runs the instantiation
// D = max(d, 32).  Q, K and V rows take narrow_padded(D) columns in shared
// memory (64-column blocks, 128-byte swizzle), zero past d.  Where D is not
// 64, K and V come from a copy padded to that many columns
// (launch_narrow_d), and the products run at the head's width, not the
// padding: Q K^T over narrow_qk_depth(D) columns, P V at N =
// narrow_pv_width(D), whose column D is a column of ones in the padded V
// that sums the rounded P (the normaliser) where SUM_ROUNDED.
__host__ __device__ constexpr int narrow_padded(int d) { return d <= 64 ? 64 : 128; }
__host__ __device__ constexpr int narrow_qk_depth(int d) { return (d + 15) / 16 * 16; }
__host__ __device__ constexpr bool narrow_ones(int d, bool sum_rounded) { return d != 64 && sum_rounded; }
__host__ __device__ constexpr int narrow_pv_width(int d, bool sum_rounded) {
  return narrow_ones(d, sum_rounded) ? d + 8 : d;
}

// Whether the consumers' loop pins its order with schedule_fence: before a
// turn, and between the exp2 half of a tile's softmax and the wait for the
// previous tile's P V.  Without the second, ptxas hoists that wait above all
// but one of the tile's ex2 (and mixes them with the pack's conversions),
// and the exp2 no longer runs under the P V.  Measured per width (PERF.md,
// section 6; NVIDIA H100 80GB HBM3, 700 W): K1 at [8, 21600, 8, 40]
// 13.7-13.9 ms without the fences, 12.1-13.0 with them, 14.4-14.9 on the
// turns before; [8, 5400, 8, 80] 1.11-1.26 with them against 1.29-1.38.
// At d = 64, where the products take a larger share of a tile, the fences
// made K1 slower at each of its eight served shapes, by 1.3-2.9% (median
// of 40 interleaved pairs, each shape slower in 39 or 40 of them), so d = 64
// runs without them.
__host__ __device__ constexpr bool narrow_fenced(int d) { return d != 64; }

// The clock reads of schedule_fence end here: the store is never taken, but
// ptxas cannot know that, so the reads stay.
__device__ unsigned long long clock_sink;
__device__ __forceinline__ void keep_clocks(unsigned long long clocks) {
  if (clocks == 1) clock_sink = clocks;
}

// keys per tile: the score accumulator is NK / 2 registers a thread
template <int D>
__host__ __device__ constexpr int narrow_keys() {
  return D <= 64 ? 128 : 64;
}

template <int D, int NCW>
constexpr int narrow_smem_bytes() {
  return narrow_padded(D) / 64 * (64 * NCW + 2 * N_STAGES * narrow_keys<D>()) * 128 + (1 + 3 * N_STAGES) * 8 + 1024;
}

template <int D, bool NO_MAX, bool SUM_ROUNDED, bool PRESCALE_Q, bool BF16_SCORES>
__global__ void __launch_bounds__(128 * (narrow_consumers<BF16_SCORES, D>() + 1), 1)
flash_fwd_narrow(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk,
                 int d, float scale_log2) {
  constexpr int NCW = narrow_consumers<BF16_SCORES, D>();
  constexpr int NQ = 64 * NCW;  // query rows per CTA
  constexpr int NK = narrow_keys<D>();
  constexpr int CB = narrow_padded(D) / 64;  // 64-column blocks of a row
  constexpr bool ONES = narrow_ones(D, SUM_ROUNDED);
  constexpr int DV = narrow_pv_width(D, SUM_ROUNDED);
  constexpr int Q_BLOCK = NQ * 128;          // bytes of one column block of the Q tile
  constexpr int KV_BLOCK = NK * 128;         // ... of a K or V tile
  constexpr int KV_TILE = CB * KV_BLOCK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + CB * Q_BLOCK;
  unsigned char* sV = sK + N_STAGES * KV_TILE;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + N_STAGES * KV_TILE);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + N_STAGES;
  uint64_t* empty = full_v + N_STAGES;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * NQ;
  const int n_kt = (Lk + NK - 1) / NK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < N_STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 128 * NCW);  // every consumer thread releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, CB * Q_BLOCK);
      for (int c = 0; c < CB; ++c) tma_load_4d(sQ + c * Q_BLOCK, &tq, full_q, 64 * c, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % N_STAGES;
        if (j >= N_STAGES) mbar_wait(empty + s, ((j / N_STAGES) + 1) & 1);
        mbar_expect_tx(full_k + s, KV_TILE);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(sK + s * KV_TILE + c * KV_BLOCK, &tk, full_k + s, 64 * c, h, j * NK, b);
        mbar_expect_tx(full_v + s, KV_TILE);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(sV + s * KV_TILE + c * KV_BLOCK, &tv, full_v + s, 64 * c, h, j * NK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64*cw ... + 63
    setmaxnreg_inc<NCW == 2 ? 240 : 160>();
    const int cw = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, tig = lane % 4;
    unsigned char* sQw = sQ + cw * 64 * 128;

    mbar_wait(full_q, 0);
    if (PRESCALE_Q) {
      // q * scale * log2(e) rounded to bf16, in place: the swizzle moves
      // whole 16-byte chunks, so an elementwise pass needs no addresses
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        uint4* rows = reinterpret_cast<uint4*>(sQw + c * Q_BLOCK);
#pragma unroll
        for (int i = ct; i < 64 * 8; i += 128) {
          uint4 val = rows[i];
          __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(hv[e]);
            hv[e] = __floats2bfloat162_rn(f.x * scale_log2, f.y * scale_log2);
          }
          rows[i] = val;
        }
      }
      fence_proxy_async();
      bar_sync(1 + NCW + cw, 128);  // ids 1..NCW are the turns
    }

    float acc[DV / 2];
    float sacc[NK / 2];
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NK / 16; ++i) pa[i][0] = pa[i][1] = pa[i][2] = pa[i][3] = 0u;
    float m_r[2] = {MASKED, MASKED};  // running max of rows g and g+8 (unused if NO_MAX)
    float l_r[2] = {0.f, 0.f};        // this thread's partial row sums

    // Turns on the tensor cores, round robin: consumer cw waits on barrier
    // 1 + cw and hands over on the next one's; consumer 0 goes first.  Turn
    // 0 issues Q K_0^T, turn j Q K_j^T and then the previous tile's P V,
    // turn n_kt the last P V.  Turn j waits for its Q K_j^T alone, runs
    // softmax_exp under the P V, then waits for the P V and runs
    // softmax_pack.  The first and last turns are peeled so that no wgmma
    // sits under a runtime branch (ptxas would serialize them).
    const int bar_mine = 1 + cw, bar_next = 1 + (cw + 1) % NCW;
    auto turn_begin = [&]() {
      bar_sync(bar_mine, 256);
      fence_regs(acc);
      fence_regs(sacc);
      fence_regs(pa);
      wgmma_fence();
    };
    auto turn_end = [&](bool last) {
      wgmma_commit();
      if (!(cw == NCW - 1 && last)) bar_arrive(bar_next, 256);  // consumer 0 has no turn after the last
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sacc);
      fence_regs(pa);
    };
    auto qk_products = [&](int s) {
      uint64_t dq = make_desc(sQw, 16, 1024), dk = make_desc(sK + s * KV_TILE, 16, 1024);
      opaque(dq);  // computed here, not hoisted out of the loop into registers
#pragma unroll
      for (int kk = 0; kk < narrow_qk_depth(D) / 16; ++kk) {
        const int off = ((kk / 4) * Q_BLOCK + (kk % 4) * 32) >> 4;
        const int koff = ((kk / 4) * KV_BLOCK + (kk % 4) * 32) >> 4;
        if constexpr (NK == 128) wgmma_ss_n128(sacc, dq + off, dk + koff, kk > 0);
        else wgmma_ss_n64(sacc, dq + off, dk + koff, kk > 0);
      }
    };
    float corr[2] = {1.f, 1.f};  // this tile's exp2(m_old - m_new), rows g and g + 8 (unused if NO_MAX)
    auto softmax_exp2 = [&](int j) {
      softmax_exp<NK / 8, NO_MAX, PRESCALE_Q, BF16_SCORES>(sacc, m_r, l_r, corr, j * NK, Lk, tig, scale_log2);
    };
    auto pack = [&]() { softmax_pack<NK / 8, DV / 2, NO_MAX, SUM_ROUNDED, !ONES>(sacc, acc, pa, l_r, corr); };

    if (cw == NCW - 1) bar_arrive(1, 256);
    mbar_wait(full_k, 0);
    turn_begin();
    qk_products(0);
    turn_end(false);
    softmax_exp2(0);
    pack();
    unsigned long long clocks = 0;  // schedule_fence's clock reads
    for (int j = 1; j < n_kt; ++j) {
      const int s = j % N_STAGES;                  // stage of tile j
      const int sp = (j + N_STAGES - 1) % N_STAGES;  // stage of tile j - 1
      mbar_wait(full_k + s, (j / N_STAGES) & 1);
      mbar_wait(full_v + sp, ((j - 1) / N_STAGES) & 1);
      if constexpr (narrow_fenced(D)) schedule_fence(clocks);
      turn_begin();
      qk_products(s);
      wgmma_commit();
      pv_products<DV, NK>(acc, pa, sV + sp * KV_TILE);
      wgmma_commit();
      bar_arrive(bar_next, 256);
      wgmma_wait<1>();  // Q K_j^T
      fence_regs(sacc);
      softmax_exp2(j);
      if constexpr (narrow_fenced(D)) schedule_fence(clocks);  // the exp2 half stays ahead of the wait
      wgmma_wait<0>();  // P V of tile j - 1
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + sp);
      pack();
    }
    keep_clocks(clocks);
    const int sl = (n_kt - 1) % N_STAGES;
    mbar_wait(full_v + sl, ((n_kt - 1) / N_STAGES) & 1);
    turn_begin();
    pv_products<DV, NK>(acc, pa, sV + sl * KV_TILE);
    turn_end(true);  // the last tile's stage is not released: nothing waits for it
    if (ONES) {
      // the normaliser is column D of the output accumulator, held by the
      // quad's first thread; store_rows sums it over the quad
      l_r[0] = tig == 0 ? acc[D / 2] : 0.f;
      l_r[1] = tig == 0 ? acc[D / 2 + 2] : 0.f;
    }

    const long long rs = (long long)H * d;
    __nv_bfloat16* ob = o + (long long)b * Lq * rs + (long long)h * d;
    store_rows<DV / 2>(acc, l_r, ob, rs, q0 + cw * 64 + warp * 16, 0, Lq, d, g, tig);
  }
}

// ---- wide heads: d <= 512 -------------------------------------------------------

constexpr int WQ = 64;  // query rows per CTA
constexpr int WK = 32;  // keys per tile
constexpr int W_STAGES = 2;

template <int DP, int NCWG>
constexpr int wide_smem_bytes() {
  return DP / 64 * (WQ + 2 * W_STAGES * WK) * 128 + (NCWG == 2 ? 2 * 2 * 16 * 128 * 4 : 0) +
         (1 + 3 * W_STAGES) * 8 + 1024;
}

// NCWG consumer warpgroups; each owns DP / NCWG output columns and the same
// share of the q.k contraction.
template <int DP, int NCWG>
__global__ void __launch_bounds__(128 * (NCWG + 1), 1)
flash_fwd_wide(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H, int Lq, int Lk,
               int d, float scale_log2) {
  constexpr int CB = DP / 64;
  constexpr int DV = DP / NCWG;  // output columns (and contraction depth) per consumer
  constexpr int CBV = DV / 64;
  constexpr int Q_BLOCK = WQ * 128;
  constexpr int KV_BLOCK = WK * 128;
  constexpr int KV_TILE = CB * KV_BLOCK;
  constexpr int X_SLOT = 16 * 128;  // floats of one warpgroup's partial score tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + CB * Q_BLOCK;
  unsigned char* sV = sK + W_STAGES * KV_TILE;
  float* xbuf = reinterpret_cast<float*>(sV + W_STAGES * KV_TILE);  // [2 tiles][2 warpgroups][X_SLOT]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + W_STAGES * KV_TILE + (NCWG == 2 ? 4 * X_SLOT * 4 : 0));
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + W_STAGES;
  uint64_t* empty = full_v + W_STAGES;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * WQ;
  const int n_kt = (Lk + WK - 1) / WK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 128 * NCWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if constexpr (NCWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, CB * Q_BLOCK);
      for (int c = 0; c < CB; ++c) tma_load_4d(sQ + c * Q_BLOCK, &tq, full_q, 64 * c, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % W_STAGES;
        if (j >= W_STAGES) mbar_wait(empty + s, ((j / W_STAGES) + 1) & 1);
        mbar_expect_tx(full_k + s, KV_TILE);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(sK + s * KV_TILE + c * KV_BLOCK, &tk, full_k + s, 64 * c, h, j * WK, b);
        mbar_expect_tx(full_v + s, KV_TILE);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(sV + s * KV_TILE + c * KV_BLOCK, &tv, full_v + s, 64 * c, h, j * WK, b);
      }
    }
  } else {
    if constexpr (NCWG == 2) setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, tig = lane % 4;

    float acc[DV / 2];
    float sacc[WK / 2];
    uint32_t pa[WK / 16][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) sacc[i] = 0.f;
    float m_r[2] = {MASKED, MASKED};
    float l_r[2] = {0.f, 0.f};
    float corr[2];

    mbar_wait(full_q, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % W_STAGES;
      mbar_wait(full_k + s, (j / W_STAGES) & 1);
      // this warpgroup's share of S = Q K^T: columns cw*DV ... + DV - 1 of q and k
      fence_regs(sacc);
      wgmma_fence();
      const uint64_t dq = make_desc(sQ + cw * CBV * Q_BLOCK, 16, 1024);
      const uint64_t dk = make_desc(sK + s * KV_TILE + cw * CBV * KV_BLOCK, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        wgmma_ss_n32(sacc, dq + (((kk / 4) * Q_BLOCK + (kk % 4) * 32) >> 4),
                     dk + (((kk / 4) * KV_BLOCK + (kk % 4) * 32) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if constexpr (NCWG == 2) {
        // exchange the partial tiles; own + other is the same fp32 sum in
        // both warpgroups, so both see the same scores, m and l
        float* mine = xbuf + ((j & 1) * 2 + cw) * X_SLOT;
        const float* other = xbuf + ((j & 1) * 2 + 1 - cw) * X_SLOT;
#pragma unroll
        for (int i = 0; i < WK / 2; ++i) mine[i * 128 + ct] = sacc[i];
        bar_sync(1, 256);
#pragma unroll
        for (int i = 0; i < WK / 2; ++i) sacc[i] = sacc[i] + other[i * 128 + ct];
      }
      softmax_exp<WK / 8, false, false, false>(sacc, m_r, l_r, corr, j * WK, Lk, tig, scale_log2);
      softmax_pack<WK / 8, DV / 2, false, false, true>(sacc, acc, pa, l_r, corr);
      mbar_wait(full_v + s, (j / W_STAGES) & 1);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      pv_products<DV, WK>(acc, pa, sV + s * KV_TILE + cw * CBV * KV_BLOCK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + s);
    }

    const long long rs = (long long)H * d;
    __nv_bfloat16* ob = o + (long long)b * Lq * rs + (long long)h * d;
    store_rows<DV / 2>(acc, l_r, ob, rs, q0 + warp * 16, cw * DV, Lq, d, g, tig);
  }
}

// ---- fp32: 3xTF32 on the tensor cores -----------------------------------------
//
// Each fp32 operand x is split into big = x with its low 13 mantissa bits
// cleared (a tf32 value) and small = x - big (exact in fp32); a product is
// big.big + big.small + small.big, three wgmma, fp32 sums.  What is dropped,
// small.small and the bits of small the tensor core does not read, is below
// 2^-20 of |x||y| per product.  The tensor core reads the top 19 bits of a
// 32-bit operand (it truncates), so the raw q and k serve as their own big
// parts; P and v^T, which are written anyway, are stored masked.
//
// A pre-pass (split_tf32, split_tf32_vt) writes the rest to a scratch buffer
// the wrapper allocates: the small parts of q and k in their [B, L, H, d]
// layout, and v transposed to [B, H, d, L_p], big and small (tf32 wgmma
// reads B K-major only, so P V needs V^T with the keys along the rows) with
// L_p = L_k rounded up to 8 and zero keys past L_k.  Within each group of 8 keys
// v^T is stored in the order 0 2 4 6 1 3 5 7: the score accumulator gives a
// thread keys 2 tig and 2 tig + 1 of each 8, the A fragment of a k8 step
// wants keys tig and tig + 4, and this order makes the two the same keys,
// so P goes from the softmax to the P V wgmma without a shuffle.

constexpr uint32_t TF32_BIG = 0xFFFFE000u;  // sign, exponent and the 10 mantissa bits of tf32

__device__ __forceinline__ float tf32_big(float x) { return __uint_as_float(__float_as_uint(x) & TF32_BIG); }

// x -> its small part, x - tf32_big(x)
__global__ void split_tf32(const float4* __restrict__ x, float4* __restrict__ small, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    small[i] = make_float4(v.x - tf32_big(v.x), v.y - tf32_big(v.y), v.z - tf32_big(v.z), v.w - tf32_big(v.w));
  }
}

// stored position j of a group of 8 keys holds key pv_key(j): 0 2 4 6 1 3 5 7
__device__ __forceinline__ int pv_key(int j) { return j < 4 ? 2 * j : 2 * j - 7; }

// v [B, L_k, H, d] -> v^T big and small [B, H, d, L_p]; one 32 x 32 tile a block
__global__ void __launch_bounds__(256) split_tf32_vt(const float* __restrict__ v, float* __restrict__ vtb,
                                                     float* __restrict__ vts, int H, int Lk, int d, int Lp) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const long long rs = (long long)H * d;
  const float* vb = v + (long long)b * Lk * rs + (long long)h * d;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int key = k0 + r, c = c0 + threadIdx.x;
    tile[r][threadIdx.x] = (key < Lk && c < d) ? vb[(long long)key * rs + c] : 0.f;
  }
  __syncthreads();
  const long long base = (long long)bh * d * Lp;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, kout = k0 + threadIdx.x;
    if (c >= d || kout >= Lp) continue;
    const float x = tile[(threadIdx.x & ~7) | pv_key(threadIdx.x & 7)][r];
    const float big = tf32_big(x);
    vtb[base + (long long)c * Lp + kout] = big;
    vts[base + (long long)c * Lp + kout] = x - big;
  }
}

// One key tile's softmax for the fp32 kernels: s scaled and masked as in
// softmax_exp, P kept in fp32 (the normaliser sums it), split into the
// big and small A fragments of NT k8 steps (keys of step nt: 8 nt ...).
template <int NT, int NACC, bool NO_MAX>
__device__ __forceinline__ void softmax_tile_f32(float (&s)[NT * 4], float (&acc)[NACC], uint32_t (&pb)[NT][4],
                                                 uint32_t (&ps)[NT][4], float (&m_r)[2], float (&l_r)[2], int k0,
                                                 int Lk, int tig, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) s[i] *= scale_log2;
  if (k0 + NT * 8 > Lk) {
#pragma unroll
    for (int i = 0; i < NT * 4; ++i)
      if (k0 + (i / 4) * 8 + tig * 2 + (i & 1) >= Lk) s[i] = MASKED;
  }
  float mrow[2] = {0.f, 0.f};
  if (!NO_MAX) {
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * nt + 0], s[4 * nt + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = fast_exp2(m_r[r] - mx[r]);
      m_r[r] = mrow[r] = mx[r];
      l_r[r] *= corr;
#pragma unroll
      for (int nt = 0; nt < NACC / 4; ++nt) {
        acc[4 * nt + 2 * r] *= corr;
        acc[4 * nt + 2 * r + 1] *= corr;
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = fast_exp2(s[4 * nt + e] - mrow[e >> 1]);  // masked keys: +0
    l_r[0] += p[0] + p[1];
    l_r[1] += p[2] + p[3];
    // A fragment: (row g, key tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4) of the
    // stored order, which are keys 2 tig, 2 tig, 2 tig + 1, 2 tig + 1 of the scores
    const float f[4] = {p[0], p[2], p[1], p[3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float big = tf32_big(f[e]);
      pb[nt][e] = __float_as_uint(big);
      ps[nt][e] = __float_as_uint(f[e] - big);
    }
  }
}

// store_rows for an fp32 output
template <int NACC>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[NACC], float (&l_r)[2], float* ob, long long rs,
                                               int row0, int col0, int Lq, int d, int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float inv0 = 1.f / l_r[0], inv1 = 1.f / l_r[1];
  const int qa = row0 + g, qc = qa + 8;
#pragma unroll
  for (int nt = 0; nt < NACC / 4; ++nt) {
    const int col = col0 + nt * 8 + tig * 2;
    if (col >= d) continue;
    if (qa < Lq)
      *reinterpret_cast<float2*>(ob + (long long)qa * rs + col) = make_float2(acc[4 * nt] * inv0, acc[4 * nt + 1] * inv0);
    if (qc < Lq)
      *reinterpret_cast<float2*>(ob + (long long)qc * rs + col) =
          make_float2(acc[4 * nt + 2] * inv1, acc[4 * nt + 3] * inv1);
  }
}

// Narrow fp32 heads (d <= 64, padded to 64): one CTA per (128-query tile,
// batch*head), two consumer warpgroups of 64 query rows and one producer
// warp.  ptxas counts the CTA in whole warpgroups, so a thread still gets
// 168 registers, and the four 32-register sets of a turn (output, tile
// accumulator, scores, P) spill a little.  Q's big and small tiles stay in shared memory; a 2-stage
// ring holds 64-key tiles of K big and small and of V^T big and small
// (64 KB a stage).  A consumer's turn issues the previous tile's P V and
// this tile's Q K^T (A and B from shared memory), as the bf16 kernel does.
constexpr int F_NQ = 128;
constexpr int F_NK = 64;
constexpr int F_STAGES = 2;
constexpr int F_QBLK = F_NQ * 128;  // bytes of one 32-column block of a Q tile
constexpr int F_KBLK = F_NK * 128;  // ... of a K tile
constexpr int F_VBLK = 64 * 128;    // one 32-key block of a V^T tile: 64 rows of d
constexpr int F_KTILE = 2 * F_KBLK;
constexpr int F_VTILE = F_NK / 32 * F_VBLK;
constexpr int F_STAGE = 2 * F_KTILE + 2 * F_VTILE;
constexpr int F_NARROW_SMEM = 4 * F_QBLK + F_STAGES * F_STAGE + (1 + 3 * F_STAGES) * 8 + 1024;

template <bool NO_MAX>
__global__ void __launch_bounds__(288, 1)
flash_fwd_narrow_f32(const __grid_constant__ CUtensorMap tqb, const __grid_constant__ CUtensorMap tqs,
                     const __grid_constant__ CUtensorMap tkb, const __grid_constant__ CUtensorMap tks,
                     const __grid_constant__ CUtensorMap tvb, const __grid_constant__ CUtensorMap tvs,
                     float* __restrict__ o, int H, int Lq, int Lk, int d, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQb = align_1024(smem_raw);
  unsigned char* sQs = sQb + 2 * F_QBLK;
  unsigned char* sStage = sQs + 2 * F_QBLK;  // stage s: Kb, Ks, Vb^T, Vs^T
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sStage + F_STAGES * F_STAGE);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + F_STAGES;
  uint64_t* empty = full_v + F_STAGES;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * F_NQ;
  const int n_kt = (Lk + F_NK - 1) / F_NK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one warp after the two consumer warpgroups, one thread of it
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, 4 * F_QBLK);
      for (int c = 0; c < 2; ++c) {
        tma_load_4d(sQb + c * F_QBLK, &tqb, full_q, 32 * c, h, q0, b);
        tma_load_4d(sQs + c * F_QBLK, &tqs, full_q, 32 * c, h, q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % F_STAGES;
        unsigned char* st = sStage + s * F_STAGE;
        if (j >= F_STAGES) mbar_wait(empty + s, ((j / F_STAGES) + 1) & 1);
        mbar_expect_tx(full_k + s, 2 * F_KTILE);
        for (int c = 0; c < 2; ++c) {
          tma_load_4d(st + c * F_KBLK, &tkb, full_k + s, 32 * c, h, j * F_NK, b);
          tma_load_4d(st + F_KTILE + c * F_KBLK, &tks, full_k + s, 32 * c, h, j * F_NK, b);
        }
        mbar_expect_tx(full_v + s, 2 * F_VTILE);
        for (int c = 0; c < F_NK / 32; ++c) {
          tma_load_4d(st + 2 * F_KTILE + c * F_VBLK, &tvb, full_v + s, j * F_NK + 32 * c, 0, h, b);
          tma_load_4d(st + 2 * F_KTILE + F_VTILE + c * F_VBLK, &tvs, full_v + s, j * F_NK + 32 * c, 0, h, b);
        }
      }
    }
  } else {
    const int cw = wg;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, tig = lane % 4;

    // acc takes one key tile's P V from wgmma and is added to o_acc in fp32
    float o_acc[32], acc[32], sacc[F_NK / 2];
    uint32_t pb[F_NK / 8][4], ps[F_NK / 8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < F_NK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < F_NK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) pb[i][e] = ps[i][e] = 0u;
    float m_r[2] = {MASKED, MASKED};
    float l_r[2] = {0.f, 0.f};

    auto begin = [&]() {
      fence_regs(acc);
      fence_regs(sacc);
      fence_regs(pb);
      fence_regs(ps);
      wgmma_fence();
    };
    auto end = [&]() {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sacc);
      fence_regs(pb);
      fence_regs(ps);
    };
    auto qk_products = [&](int s) {
      const unsigned char* st = sStage + s * F_STAGE;
      uint64_t dqb = make_desc(sQb + cw * 64 * 128, 16, 1024), dqs = make_desc(sQs + cw * 64 * 128, 16, 1024);
      uint64_t dkb = make_desc(st, 16, 1024), dks = make_desc(st + F_KTILE, 16, 1024);
      opaque(dqb);
      opaque(dqs);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int off = ((kk / 4) * F_QBLK + (kk % 4) * 32) >> 4;
        const int koff = ((kk / 4) * F_KBLK + (kk % 4) * 32) >> 4;
        wgmma_tf32_ss_n64(sacc, dqs + off, dkb + koff, kk > 0);
        wgmma_tf32_ss_n64(sacc, dqb + off, dks + koff, 1);
        wgmma_tf32_ss_n64(sacc, dqb + off, dkb + koff, 1);
      }
    };
    auto pv_products = [&](int s) {
      const unsigned char* st = sStage + s * F_STAGE + 2 * F_KTILE;
      uint64_t dvb = make_desc(st, 16, 1024), dvs = make_desc(st + F_VTILE, 16, 1024);
      opaque(dvb);
#pragma unroll
      for (int kk = 0; kk < F_NK / 8; ++kk) {
        const int off = ((kk / 4) * F_VBLK + (kk % 4) * 32) >> 4;
        wgmma_tf32_rs_n64(acc, ps[kk], dvb + off);
        wgmma_tf32_rs_n64(acc, pb[kk], dvs + off);
        wgmma_tf32_rs_n64(acc, pb[kk], dvb + off);
      }
    };
    auto softmax = [&](int j) {
      softmax_tile_f32<F_NK / 8, 32, NO_MAX>(sacc, o_acc, pb, ps, m_r, l_r, j * F_NK, Lk, tig, scale_log2);
    };
    auto zero_acc = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    };
    auto add_acc = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[i] += acc[i];
    };

    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    begin();
    qk_products(0);
    end();
    softmax(0);
    for (int j = 1; j < n_kt; ++j) {
      const int s = j % F_STAGES, sp = (j - 1) % F_STAGES;
      mbar_wait(full_k + s, (j / F_STAGES) & 1);
      mbar_wait(full_v + sp, ((j - 1) / F_STAGES) & 1);
      zero_acc();
      begin();
      pv_products(sp);
      qk_products(s);
      end();
      mbar_arrive(empty + sp);
      add_acc();
      softmax(j);
    }
    const int sl = (n_kt - 1) % F_STAGES;
    mbar_wait(full_v + sl, ((n_kt - 1) / F_STAGES) & 1);
    zero_acc();
    begin();
    pv_products(sl);
    end();
    add_acc();

    const long long rs = (long long)H * d;
    float* ob = o + (long long)b * Lq * rs + (long long)h * d;
    store_rows_f32<32>(o_acc, l_r, ob, rs, q0 + cw * 64 + warp * 16, 0, Lq, d, g, tig);
  }
}

// Wide fp32 heads (64 < d <= 512, padded to 128, 256 or 512): one CTA per
// (64-query tile, batch*head), 32-key tiles.  NCWG consumer warpgroups
// each own DV = DP / NCWG output columns (a 64 x DV fp32 accumulator) and
// the same share of the q.k contraction; for d = 512 the two partial score
// tiles are summed through shared memory, as in the bf16 kernel.  Q does
// not fit in shared memory beside the ring (64 x 512 fp32, big and small,
// is 256 KB), so the contraction streams: for each key tile the ring
// brings DV / 32 pieces of 32 columns (Q big and small, 64 rows; K big and
// small, 32 keys; Q is read again from L2 for each key tile), then DV / 64
// pieces of V^T big and small (64 output columns x 32 keys).  A stage is
// 32 KB for each consumer.  The producer is one warp, not a warpgroup: a
// thread gets 255 registers with one consumer, 168 with two (ptxas counts
// whole warpgroups), where the 64 x 256 output alone takes 128 and d = 512
// spills a little.
constexpr int FW_Q = 64;
constexpr int FW_K = 32;
constexpr int FW_SLOT = 32768;
constexpr int FW_XSLOT = 16 * 128;  // floats of one warpgroup's partial score tile

template <int NCWG>
__host__ __device__ constexpr int fw_stages() {
  return NCWG == 2 ? 3 : 6;
}

template <int NCWG>
constexpr int wide_f32_smem_bytes() {
  return fw_stages<NCWG>() * NCWG * FW_SLOT + (NCWG == 2 ? 4 * FW_XSLOT * 4 : 0) + 2 * fw_stages<NCWG>() * 8 + 1024;
}

template <int DP, int NCWG, bool NO_MAX>
__global__ void __launch_bounds__(128 * NCWG + 32, 1)
flash_fwd_wide_f32(const __grid_constant__ CUtensorMap tqb, const __grid_constant__ CUtensorMap tqs,
                   const __grid_constant__ CUtensorMap tkb, const __grid_constant__ CUtensorMap tks,
                   const __grid_constant__ CUtensorMap tvb, const __grid_constant__ CUtensorMap tvs,
                   float* __restrict__ o, int H, int Lq, int Lk, int d, float scale_log2) {
  constexpr int DV = DP / NCWG;
  constexpr int NQK = DV / 32;   // Q K^T pieces a key tile
  constexpr int NPV = DV / 64;   // P V pieces a key tile
  constexpr int S = fw_stages<NCWG>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sStage = align_1024(smem_raw);  // stage s, consumer cw: sStage + (s * NCWG + cw) * FW_SLOT
  float* xbuf = reinterpret_cast<float*>(sStage + S * NCWG * FW_SLOT);  // [2 tiles][2 warpgroups][FW_XSLOT]
  uint64_t* full = reinterpret_cast<uint64_t*>(sStage + S * NCWG * FW_SLOT + (NCWG == 2 ? 4 * FW_XSLOT * 4 : 0));
  uint64_t* empty = full + S;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * FW_Q;
  const int n_kt = (Lk + FW_K - 1) / FW_K;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * NCWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCWG) {
    // the producer: one warp after the consumer warpgroups, one thread of it
    if (threadIdx.x == 128 * NCWG) {
      int t = 0;
      for (int j = 0; j < n_kt; ++j) {
        for (int p = 0; p < NQK + NPV; ++p, ++t) {
          const int s = t % S;
          if (t >= S) mbar_wait(empty + s, ((t / S) + 1) & 1);
          unsigned char* st = sStage + s * NCWG * FW_SLOT;
          if (p < NQK) {
            mbar_expect_tx(full + s, NCWG * 24576);
            for (int cw = 0; cw < NCWG; ++cw) {
              unsigned char* slot = st + cw * FW_SLOT;
              const int col = cw * DV + 32 * p;
              tma_load_4d(slot, &tqb, full + s, col, h, q0, b);
              tma_load_4d(slot + 8192, &tqs, full + s, col, h, q0, b);
              tma_load_4d(slot + 16384, &tkb, full + s, col, h, j * FW_K, b);
              tma_load_4d(slot + 20480, &tks, full + s, col, h, j * FW_K, b);
            }
          } else {
            mbar_expect_tx(full + s, NCWG * 16384);
            for (int cw = 0; cw < NCWG; ++cw) {
              unsigned char* slot = st + cw * FW_SLOT;
              const int row = cw * DV + 64 * (p - NQK);
              tma_load_4d(slot, &tvb, full + s, j * FW_K, row, h, b);
              tma_load_4d(slot + 8192, &tvs, full + s, j * FW_K, row, h, b);
            }
          }
        }
      }
    }
  } else {
    const int cw = wg;
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct / 32, lane = ct % 32, g = lane / 4, tig = lane % 4;

    // acc takes one piece's P V from wgmma and is added to o_acc in fp32
    float o_acc[DV / 2], acc[32], sacc[16];
    uint32_t pb[4][4], ps[4][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) sacc[i] = 0.f;
    float m_r[2] = {MASKED, MASKED};
    float l_r[2] = {0.f, 0.f};

    int t = 0;
    for (int j = 0; j < n_kt; ++j) {
      // this warpgroup's share of S = Q K^T, NQK pieces; the wait for piece
      // p - 1 follows the issue of piece p
      int prev = 0;
#pragma unroll
      for (int p = 0; p < NQK; ++p, ++t) {
        const int s = t % S;
        mbar_wait(full + s, (t / S) & 1);
        const unsigned char* slot = sStage + (s * NCWG + cw) * FW_SLOT;
        fence_regs(sacc);
        wgmma_fence();
        const uint64_t dqb = make_desc(slot, 16, 1024), dqs = make_desc(slot + 8192, 16, 1024);
        const uint64_t dkb = make_desc(slot + 16384, 16, 1024), dks = make_desc(slot + 20480, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32_ss_n32(sacc, dqs + 2 * kk, dkb + 2 * kk, p > 0 || kk > 0);
          wgmma_tf32_ss_n32(sacc, dqb + 2 * kk, dks + 2 * kk, 1);
          wgmma_tf32_ss_n32(sacc, dqb + 2 * kk, dkb + 2 * kk, 1);
        }
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty + prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(sacc);
      mbar_arrive(empty + prev);
      if constexpr (NCWG == 2) {
        float* mine = xbuf + ((j & 1) * 2 + cw) * FW_XSLOT;
        const float* other = xbuf + ((j & 1) * 2 + 1 - cw) * FW_XSLOT;
#pragma unroll
        for (int i = 0; i < 16; ++i) mine[i * 128 + ct] = sacc[i];
        bar_sync(1, 256);
#pragma unroll
        for (int i = 0; i < 16; ++i) sacc[i] = sacc[i] + other[i * 128 + ct];
      }
      softmax_tile_f32<4, DV / 2, NO_MAX>(sacc, o_acc, pb, ps, m_r, l_r, j * FW_K, Lk, tig, scale_log2);

      // O += P V, NPV pieces of 64 output columns
#pragma unroll
      for (int p = 0; p < NPV; ++p, ++t) {
        const int s = t % S;
        mbar_wait(full + s, (t / S) & 1);
        const unsigned char* slot = sStage + (s * NCWG + cw) * FW_SLOT;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        fence_regs(acc);
        fence_regs(pb);
        fence_regs(ps);
        wgmma_fence();
        const uint64_t dvb = make_desc(slot, 16, 1024), dvs = make_desc(slot + 8192, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32_rs_n64(acc, ps[kk], dvb + 2 * kk);
          wgmma_tf32_rs_n64(acc, pb[kk], dvs + 2 * kk);
          wgmma_tf32_rs_n64(acc, pb[kk], dvb + 2 * kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pb);
        fence_regs(ps);
        mbar_arrive(empty + s);
#pragma unroll
        for (int i = 0; i < 32; ++i) o_acc[32 * p + i] += acc[i];
      }
    }

    const long long rs = (long long)H * d;
    float* ob = o + (long long)b * Lq * rs + (long long)h * d;
    store_rows_f32<DV / 2>(o_acc, l_r, ob, rs, q0 + warp * 16, cw * DV, Lq, d, g, tig);
  }
}

// ---- launchers ----------------------------------------------------------------

// The three tensor maps of a bf16 launch: q (d columns) in boxes of q_rows,
// k and v (kv_d columns: d, or d padded) of kv_rows.
bool encode_qkv(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int B, int H, int Lq,
                int Lk, int d, int q_rows, int kv_rows, int kv_d) {
  return hopper_host::encode_bf16_bhld(&maps[0], q, B, Lq, H, d, q_rows) &&
         hopper_host::encode_bf16_bhld(&maps[1], k, B, Lk, H, kv_d, kv_rows) &&
         hopper_host::encode_bf16_bhld(&maps[2], v, B, Lk, H, kv_d, kv_rows);
}

// k and v [rows, d] -> kp and vp [rows, dp]: columns past d zero, but for
// v's column `ones` (-1: none), which is 1.  In 16-byte chunks (d8 = d / 8
// a row in, dp8 out); blockIdx.y picks k or v.
__global__ void flash_fwd_pad_kv(const uint4* __restrict__ k, const uint4* __restrict__ v, uint4* __restrict__ kp,
                                 uint4* __restrict__ vp, long long rows, int d8, int dp8, int ones) {
  const uint4* src = blockIdx.y ? v : k;
  uint4* dst = blockIdx.y ? vp : kp;
  const int ones8 = blockIdx.y && ones >= 0 ? ones / 8 : -1;
  const uint4 one = make_uint4(0x3F80u, 0u, 0u, 0u);  // bf16 1.0 first in the chunk (ones % 8 == 0)
  const long long n = rows * dp8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / dp8;
    const int c = (int)(i - r * dp8);
    dst[i] = c < d8 ? src[r * d8 + c] : c == ones8 ? one : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Bytes of scratch a bf16 narrow launch takes: k and v padded to
// narrow_padded(d) columns, none for d = 64.
long long narrow_scratch_bytes(int B, int H, int Lk, int d) {
  return d == 64 ? 0 : 2LL * 2 * B * Lk * H * narrow_padded(d);
}

template <int D, bool NO_MAX, bool SUM_ROUNDED, bool PRESCALE_Q, bool BF16_SCORES>
int launch_narrow_d(const void* q, const void* k, const void* v, void* o, void* scratch, int B, int H, int Lq,
                    int Lk, int d, float scale_log2, cudaStream_t stream) {
  constexpr int dp = narrow_padded(D);
  if (D != 64) {
    // TMA reads a row of d < 64 columns, or one not 128-byte aligned, at a
    // fraction of the rate of a whole aligned row (the note at the top), so
    // k and v go to the scratch padded to dp columns first, with V's ones
    if (scratch == nullptr) return ERR_UNSUPPORTED;
    uint4* kp = static_cast<uint4*>(scratch);
    uint4* vp = kp + (long long)B * Lk * H * dp / 8;
    const long long rows = (long long)B * Lk * H, n = rows * (dp / 8);
    const int blocks = (int)(n + 255 < 132LL * 8 * 256 ? (n + 255) / 256 : 132 * 8);
    flash_fwd_pad_kv<<<dim3(blocks, 2), 256, 0, stream>>>(static_cast<const uint4*>(k), static_cast<const uint4*>(v),
                                                          kp, vp, rows, d / 8, dp / 8,
                                                          narrow_ones(D, SUM_ROUNDED) ? D : -1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k = kp;
    v = vp;
  }
  CUtensorMap maps[3];
  constexpr int ncw = narrow_consumers<BF16_SCORES, D>(), nq = 64 * ncw;
  if (!encode_qkv(maps, q, k, v, B, H, Lq, Lk, d, nq, narrow_keys<D>(), dp)) return ERR_TENSOR_MAP;
  auto kern = flash_fwd_narrow<D, NO_MAX, SUM_ROUNDED, PRESCALE_Q, BF16_SCORES>;
  constexpr int smem = narrow_smem_bytes<D, ncw>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + nq - 1) / nq, B * H);
  kern<<<grid, 128 * (ncw + 1), smem, stream>>>(maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), H, Lq,
                                               Lk, d, scale_log2);
  return (int)cudaGetLastError();
}

template <int DP, int NCWG>
int launch_wide_dp(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk, int d,
                   float scale_log2, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!encode_qkv(maps, q, k, v, B, H, Lq, Lk, d, WQ, WK, d)) return ERR_TENSOR_MAP;
  auto kern = flash_fwd_wide<DP, NCWG>;
  constexpr int smem = wide_smem_bytes<DP, NCWG>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + WQ - 1) / WQ, B * H);
  kern<<<grid, 128 * (NCWG + 1), smem, stream>>>(maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), H,
                                                 Lq, Lk, d, scale_log2);
  return (int)cudaGetLastError();
}

// The split operands of an fp32 launch: q and k as their own big parts,
// and in the wrapper's scratch buffer q small, k small ([B, L, H, d] each),
// v^T big, v^T small ([B, H, d, L_p] each).
struct F32Split {
  const float *qb, *kb;
  float *qs, *ks, *vb, *vs;
  int Lp;
};

long long f32_scratch_floats(int B, int H, int Lq, int Lk, int d) {
  const long long lp = (Lk + 7) / 8 * 8;
  return (long long)B * H * d * ((long long)Lq + Lk + 2 * lp);
}

int split_f32(F32Split& sp, const void* q, const void* k, const void* v, void* scratch, int B, int H, int Lq,
              int Lk, int d, cudaStream_t st) {
  const long long nq = (long long)B * Lq * H * d, nk = (long long)B * Lk * H * d;
  sp.Lp = (Lk + 7) / 8 * 8;
  sp.qb = static_cast<const float*>(q);
  sp.kb = static_cast<const float*>(k);
  sp.qs = static_cast<float*>(scratch);
  sp.ks = sp.qs + nq;
  sp.vb = sp.ks + nk;
  sp.vs = sp.vb + (long long)B * H * d * sp.Lp;
  for (int i = 0; i < 2; ++i) {
    const long long n4 = (i == 0 ? nq : nk) / 4;
    const int blocks = (int)(n4 + 255 < 132LL * 8 * 256 ? (n4 + 255) / 256 : 132 * 8);
    split_tf32<<<blocks, 256, 0, st>>>(static_cast<const float4*>(i == 0 ? q : k),
                                       reinterpret_cast<float4*>(i == 0 ? sp.qs : sp.ks), n4);
  }
  split_tf32_vt<<<dim3((sp.Lp + 31) / 32, (d + 31) / 32, B * H), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(v), sp.vb, sp.vs, H, Lk, d, sp.Lp);
  return (int)cudaGetLastError();
}

// The six tensor maps of an fp32 launch: q in boxes of q_rows, k of
// k_rows, v^T of 32 keys x vt_rows.
bool encode_f32_split(CUtensorMap (&maps)[6], const F32Split& sp, int B, int H, int Lq, int Lk, int d, int q_rows,
                      int k_rows, int vt_rows) {
  using namespace hopper_host;
  return encode_f32_bhld(&maps[0], sp.qb, B, Lq, H, d, q_rows) &&
         encode_f32_bhld(&maps[1], sp.qs, B, Lq, H, d, q_rows) &&
         encode_f32_bhld(&maps[2], sp.kb, B, Lk, H, d, k_rows) &&
         encode_f32_bhld(&maps[3], sp.ks, B, Lk, H, d, k_rows) &&
         encode_f32_bhdl(&maps[4], sp.vb, B, H, d, sp.Lp, vt_rows) &&
         encode_f32_bhdl(&maps[5], sp.vs, B, H, d, sp.Lp, vt_rows);
}

template <bool NO_MAX>
int launch_narrow_f32(const F32Split& sp, void* o, int B, int H, int Lq, int Lk, int d, float sl, cudaStream_t st) {
  CUtensorMap m[6];
  if (!encode_f32_split(m, sp, B, H, Lq, Lk, d, F_NQ, F_NK, 64)) return ERR_TENSOR_MAP;
  auto kern = flash_fwd_narrow_f32<NO_MAX>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F_NARROW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + F_NQ - 1) / F_NQ, B * H);
  kern<<<grid, 288, F_NARROW_SMEM, st>>>(m[0], m[1], m[2], m[3], m[4], m[5], static_cast<float*>(o), H, Lq, Lk, d,
                                         sl);
  return (int)cudaGetLastError();
}

template <int DP, int NCWG, bool NO_MAX>
int launch_wide_f32(const F32Split& sp, void* o, int B, int H, int Lq, int Lk, int d, float sl, cudaStream_t st) {
  CUtensorMap m[6];
  if (!encode_f32_split(m, sp, B, H, Lq, Lk, d, FW_Q, FW_K, 64)) return ERR_TENSOR_MAP;
  auto kern = flash_fwd_wide_f32<DP, NCWG, NO_MAX>;
  constexpr int smem = wide_f32_smem_bytes<NCWG>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + FW_Q - 1) / FW_Q, B * H);
  kern<<<grid, 128 * NCWG + 32, smem, st>>>(m[0], m[1], m[2], m[3], m[4], m[5], static_cast<float*>(o), H, Lq, Lk,
                                            d, sl);
  return (int)cudaGetLastError();
}

// Every fp32 entry: the split pre-pass, then the narrow kernel for d <= 64
// or the wide one.  d % 8 == 0, d <= 512.
template <bool NO_MAX>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* scratch, int B, int H, int Lq, int Lk,
               int d, float sl, cudaStream_t st) {
  if (d % 8 != 0 || d > 512 || scratch == nullptr) return ERR_UNSUPPORTED;
  F32Split sp;
  const int err = split_f32(sp, q, k, v, scratch, B, H, Lq, Lk, d, st);
  if (err != 0) return err;
  if (d <= 64) return launch_narrow_f32<NO_MAX>(sp, o, B, H, Lq, Lk, d, sl, st);
  if (d <= 128) return launch_wide_f32<128, 1, NO_MAX>(sp, o, B, H, Lq, Lk, d, sl, st);
  if (d <= 256) return launch_wide_f32<256, 1, NO_MAX>(sp, o, B, H, Lq, Lk, d, sl, st);
  return launch_wide_f32<512, 2, NO_MAX>(sp, o, B, H, Lq, Lk, d, sl, st);
}

// A narrow bf16 head (d % 8 == 0, d < 128): the instantiation D = max(d, 32).
template <bool NO_MAX, bool SUM_ROUNDED, bool PRESCALE_Q = false, bool BF16_SCORES = false>
int launch_narrow(const void* q, const void* k, const void* v, void* o, void* scratch, int B, int H, int Lq,
                  int Lk, int d, float sl, cudaStream_t st) {
  if (d % 8 != 0 || d >= 128) return ERR_UNSUPPORTED;
  auto at = [&](auto dd) {
    return launch_narrow_d<decltype(dd)::value, NO_MAX, SUM_ROUNDED, PRESCALE_Q, BF16_SCORES>(q, k, v, o, scratch, B,
                                                                                              H, Lq, Lk, d, sl, st);
  };
  switch (d < 32 ? 32 : d) {
    case 32: return at(std::integral_constant<int, 32>{});
    case 40: return at(std::integral_constant<int, 40>{});
    case 48: return at(std::integral_constant<int, 48>{});
    case 56: return at(std::integral_constant<int, 56>{});
    case 64: return at(std::integral_constant<int, 64>{});
    case 72: return at(std::integral_constant<int, 72>{});
    case 80: return at(std::integral_constant<int, 80>{});
    case 88: return at(std::integral_constant<int, 88>{});
    case 96: return at(std::integral_constant<int, 96>{});
    case 104: return at(std::integral_constant<int, 104>{});
    case 112: return at(std::integral_constant<int, 112>{});
    default: return at(std::integral_constant<int, 120>{});
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  scratch: rd_flash_scratch_bytes() bytes, the
// fp32 kernels' split operands or a narrow bf16 head's padded k and v (none
// for the wide bf16 kernel: narrow = 0).  Returns cudaGetLastError() after
// the launch, -1 for a shape the kernel does not take (the wrapper checks
// first), or -2 if cuTensorMapEncodeTiled refuses a tensor map.
extern "C" long long rd_flash_scratch_bytes(int dtype, int narrow, int B, int H, int Lq, int Lk, int d) {
  if (dtype == 1) return 4 * f32_scratch_floats(B, H, Lq, Lk, d);
  return narrow && d < 128 ? narrow_scratch_bytes(B, H, Lk, d) : 0;
}

extern "C" int rd_flash_nomax(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch,
                              int B, int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_f32<true>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
  return launch_narrow<true, true>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
}

extern "C" int rd_flash_max(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch,
                            int B, int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_f32<false>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
  return launch_narrow<false, true>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
}

extern "C" int rd_flash_wide(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch,
                             int B, int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_f32<false>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
  if (d % 8 != 0 || d > 512) return ERR_UNSUPPORTED;
  if (d <= 128) return launch_wide_dp<128, 1>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  if (d <= 256) return launch_wide_dp<256, 1>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  return launch_wide_dp<512, 2>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
}

// K6: running max, fp32 normaliser (the sum of unrounded P), narrow heads.
extern "C" int rd_flash_exp2(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch, int B,
                             int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_f32<false>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
  return launch_narrow<false, false>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
}

// K8: q pre-scaled and rounded, bf16 scores, running max; bf16 only.
extern "C" int rd_flash_bf16(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch, int B,
                             int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  if (dtype != 0) return ERR_UNSUPPORTED;
  return launch_narrow<false, true, true, true>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2,
                                                static_cast<cudaStream_t>(stream));
}

// K9 with bf16_exp: no max, p = exp2 of the score rounded to bf16; bf16 only.
extern "C" int rd_flash_nomax_bf16exp(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch,
                                      int B, int H, int Lq, int Lk, int d, float scale_log2,
                                      void* stream) {
  if (dtype != 0) return ERR_UNSUPPORTED;
  return launch_narrow<true, true, false, true>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2,
                                                static_cast<cudaStream_t>(stream));
}

// K10: q pre-scaled and rounded, no max; padded keys get p = 0.
extern "C" int rd_flash_nomask(int dtype, const void* q, const void* k, const void* v, void* o, void* scratch, int B,
                               int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_f32<true>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
  return launch_narrow<true, true, true, false>(q, k, v, o, scratch, B, H, Lq, Lk, d, scale_log2, st);
}
