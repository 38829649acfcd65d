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
// instantiations of the same bf16 template (their fp32 inputs take the FMA
// kernel; K7 and K9 without bf16_exp compute what rd_flash_max and
// rd_flash_nomax compute, and their wrappers launch those):
//
//   rd_flash_exp2           <- _kernel_exp2   running max, fp32 normaliser
//   rd_flash_bf16           <- _kernel_bf16   PRESCALE_Q + BF16_SCORES
//   rd_flash_nomax_bf16exp  <- _kernel_nomax(bf16_exp=True)  NO_MAX + BF16_SCORES
//   rd_flash_nomask         <- _kernel_nomask NO_MAX + PRESCALE_Q
//
// PRESCALE_Q rounds q * scale * log2(e) to bf16 once, as the Q tile is
// staged, and the score is then used unscaled.  BF16_SCORES rounds the
// score to bf16, and, with a running max, the difference s - m too; p =
// exp2 of that is rounded to bf16 as always.  Both default to false, so
// the first three kernels' instantiations are unchanged.
//
// Layout: q, k, v and o are [B, L, H, D] contiguous, read in place (no fold
// or padding pass).  bf16 inputs run on the tensor cores with
// mma.sync.m16n8k16 (fp32 accumulation): one CTA per (64-query tile,
// batch*head, output-column chunk), 4 warps of 16 query rows each, looping
// over 64-key tiles staged in shared memory.  fp32 inputs run a plain FMA
// kernel: one warp per query row, 32-key tiles.
//
// Bound on the H100 (data-sheet estimates): at the UNet's first level,
// [8, 15552, 5, 64] bf16, one launch is 2.48 TFLOP of mma (2.5 ms at
// 989 TFLOP/s) and 9.7e9 exp2 on the SFUs (~2.3 ms at 16 per SM-clock),
// so the exp stream bounds it as much as the tensor cores.  This first
// design uses synchronous tile loads and mma.sync, not TMA and wgmma; it
// reaches neither bound.  The d=512 head (VAE mid-block) splits the output
// columns over the grid (128 per CTA) and recomputes QK^T in each CTA,
// since a [64, 512] fp32 accumulator does not fit one CTA's registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA (4 warps x 16)
constexpr int BK = 64;       // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [row0, row0+ROWS) x cols [col0, col0+COLS) of a [L, row_stride]
// bf16 matrix into shared memory (row pitch `pitch`), zero past L and past d.
// d and col0 are multiples of 8, so each 16-byte vector is wholly in or out.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, int pitch, const __nv_bfloat16* g,
                                          long long row_stride, int row0, int L, int col0, int d) {
  constexpr int VPR = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && col0 + c < d)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * row_stride + col0 + c);
    *reinterpret_cast<uint4*>(s + r * pitch + c) = val;
  }
}

// load_tile, with every value multiplied by `scale` and rounded to bf16
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile_scaled(__nv_bfloat16* s, int pitch, const __nv_bfloat16* g,
                                                 long long row_stride, int row0, int L, int col0, int d,
                                                 float scale) {
  constexpr int VPR = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && col0 + c < d)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * row_stride + col0 + c);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(s + r * pitch + c) = val;
  }
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int DQK, int DV>
constexpr int bf16_smem_bytes() {
  return (BQ * (DQK + 8) + BK * (DQK + 8) + BK * (DV + 8)) * 2;
}

// DQK: padded q.k width (>= d); DV: output columns per CTA.
template <int DQK, int DV, bool NO_MAX, bool SUM_ROUNDED, bool PRESCALE_Q = false, bool BF16_SCORES = false>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int H, int Lq, int Lk, int d, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int QP = DQK + 8, KP = DQK + 8, VP = DV + 8;  // +16 B: no bank conflicts
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * QP;
  __nv_bfloat16* sV = sK + BK * KP;
  const uint16_t* sVu = reinterpret_cast<const uint16_t*>(sV);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int dv0 = blockIdx.z * DV;
  const long long rs = (long long)H * d;
  const __nv_bfloat16* qb = q + (long long)b * Lq * rs + (long long)h * d;
  const __nv_bfloat16* kb = k + (long long)b * Lk * rs + (long long)h * d;
  const __nv_bfloat16* vb = v + (long long)b * Lk * rs + (long long)h * d;
  __nv_bfloat16* ob = o + (long long)b * Lq * rs + (long long)h * d;

  if (PRESCALE_Q)
    load_tile_scaled<BQ, DQK>(sQ, QP, qb, rs, q0, Lq, 0, d, scale_log2);
  else
    load_tile<BQ, DQK>(sQ, QP, qb, rs, q0, Lq, 0, d);

  float m_r[2] = {MASKED, MASKED};  // running max of rows g and g+8 (unused if NO_MAX)
  float l_r[2] = {0.f, 0.f};        // this thread's partial row sums
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int r0 = warp * 16;
  const int n_kt = (Lk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    load_tile<BK, DQK>(sK, KP, kb, rs, k0, Lk, 0, d);
    load_tile<BK, DV>(sV, VP, vb, rs, k0, Lk, dv0, d);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const __nv_bfloat16* qp = sQ + (r0 + g) * QP + kk * 16 + tig * 2;
      const uint32_t a[4] = {ld32(qp), ld32(qp + 8 * QP), ld32(qp + 8), ld32(qp + 8 * QP + 8)};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kp = sK + (nt * 8 + g) * KP + kk * 16 + tig * 2;
        const uint32_t bb[2] = {ld32(kp), ld32(kp + 8)};
        mma_16816(s[nt], a, bb);
      }
    }

    // log2-domain scores, masked keys
    const bool ragged = k0 + BK > Lk;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = PRESCALE_Q ? s[nt][e] : s[nt][e] * scale_log2;
        if (BF16_SCORES) x = round_bf16(x);
        if (ragged && k0 + nt * 8 + tig * 2 + (e & 1) >= Lk) x = MASKED;
        s[nt][e] = x;
      }
    }

    float mrow[2] = {0.f, 0.f};
    if (!NO_MAX) {
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float corr = fast_exp2(m_r[r] - mx[r]);
        m_r[r] = mx[r];
        l_r[r] *= corr;
#pragma unroll
        for (int nt = 0; nt < DV / 8; ++nt) {
          acc[nt][2 * r] *= corr;
          acc[nt][2 * r + 1] *= corr;
        }
      }
      mrow[0] = BF16_SCORES ? round_bf16(m_r[0]) : m_r[0];
      mrow[1] = BF16_SCORES ? round_bf16(m_r[1]) : m_r[1];
    }

    // P = exp2(S - m) rounded to bf16, as mma A fragments (16 keys each)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        // a masked key is exactly 0 (in the max-free kernel exp2 alone
        // would give exp2(-1e30) = 0 too; the test keeps that explicit)
        const float xm = (BF16_SCORES && !NO_MAX) ? round_bf16(x - mrow[e >> 1]) : x - mrow[e >> 1];
        p[e] = (x == MASKED) ? 0.f : fast_exp2(xm);
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
      if (SUM_ROUNDED) {
        l_r[0] += __low2float(lo) + __high2float(lo);
        l_r[1] += __low2float(hi) + __high2float(hi);
      } else {
        l_r[0] += p[0] + p[1];
        l_r[1] += p[2] + p[3];
      }
      pa[nt >> 1][(nt & 1) * 2 + 0] = bf16_bits(lo);
      pa[nt >> 1][(nt & 1) * 2 + 1] = bf16_bits(hi);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int kr = kk * 16 + tig * 2;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        const int c = nt * 8 + g;
        const uint32_t bb[2] = {
            (uint32_t)sVu[kr * VP + c] | ((uint32_t)sVu[(kr + 1) * VP + c] << 16),
            (uint32_t)sVu[(kr + 8) * VP + c] | ((uint32_t)sVu[(kr + 9) * VP + c] << 16)};
        mma_16816(acc[nt], pa[kk], bb);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float inv0 = 1.f / l_r[0], inv1 = 1.f / l_r[1];
  const int qa = q0 + r0 + g, qc = qa + 8;
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt) {
    const int col = dv0 + nt * 8 + tig * 2;
    if (col >= d) continue;
    if (qa < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qa * rs + col) =
          __floats2bfloat162_rn(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (qc < Lq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qc * rs + col) =
          __floats2bfloat162_rn(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

// ---- fp32: one warp per query row, plain FMA ---------------------------------

constexpr int F32_ROWS = 8;   // warps (query rows) per CTA
constexpr int F32_KT = 32;    // keys per tile, one per lane for the scores

template <int NPL>
constexpr int f32_smem_bytes() {
  return (F32_ROWS + 2 * F32_KT) * (32 * NPL + 1) * 4;
}

// NPL: output columns per lane (d <= 32 * NPL)
template <int NPL, bool NO_MAX>
__global__ void __launch_bounds__(F32_ROWS * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ o, int H, int Lq, int Lk, int d, float scale_log2) {
  extern __shared__ float smem_f[];
  constexpr int P = 32 * NPL + 1;  // odd pitch: lane j reading row j is conflict-free
  float* sQ = smem_f;
  float* sK = sQ + F32_ROWS * P;
  float* sV = sK + F32_KT * P;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long rs = (long long)H * d;
  const float* qb = q + (long long)b * Lq * rs + (long long)h * d;
  const float* kb = k + (long long)b * Lk * rs + (long long)h * d;
  const float* vb = v + (long long)b * Lk * rs + (long long)h * d;
  const int row = blockIdx.x * F32_ROWS + warp;

  for (int c = lane; c < 32 * NPL; c += 32)
    sQ[warp * P + c] = (row < Lq && c < d) ? qb[(long long)row * rs + c] : 0.f;

  float m = MASKED, l = 0.f;
  float acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += F32_KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < F32_KT * 32 * NPL; i += F32_ROWS * 32) {
      const int r = i / (32 * NPL), c = i % (32 * NPL);
      const bool in = k0 + r < Lk && c < d;
      sK[r * P + c] = in ? kb[(long long)(k0 + r) * rs + c] : 0.f;
      sV[r * P + c] = in ? vb[(long long)(k0 + r) * rs + c] : 0.f;
    }
    __syncthreads();

    float sc = 0.f;
    for (int c = 0; c < d; ++c) sc = fmaf(sQ[warp * P + c], sK[lane * P + c], sc);
    const bool masked = k0 + lane >= Lk;
    sc = masked ? MASKED : sc * scale_log2;

    float mnew = 0.f;
    if (!NO_MAX) {
      mnew = fmaxf(m, sc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mnew = fmaxf(mnew, __shfl_xor_sync(0xffffffffu, mnew, off));
      const float corr = fast_exp2(m - mnew);
      m = mnew;
      l *= corr;
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] *= corr;
    }
    const float p = masked ? 0.f : fast_exp2(sc - mnew);
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l += psum;
    for (int j = 0; j < F32_KT; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] = fmaf(pj, sV[j * P + lane + 32 * i], acc[i]);
    }
  }

  if (row < Lq) {
    float* orow = o + (long long)b * Lq * rs + (long long)row * rs + (long long)h * d;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = acc[i] * inv;
    }
  }
}

// ---- launchers ----------------------------------------------------------------

template <int DQK, int DV, bool NO_MAX, bool SUM_ROUNDED, bool PRESCALE_Q = false, bool BF16_SCORES = false>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                int d, float scale_log2, cudaStream_t stream) {
  auto kern = flash_fwd_bf16<DQK, DV, NO_MAX, SUM_ROUNDED, PRESCALE_Q, BF16_SCORES>;
  constexpr int smem = bf16_smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, B * H, (d + DV - 1) / DV);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, Lq, Lk, d, scale_log2);
  return (int)cudaGetLastError();
}

template <int NPL, bool NO_MAX>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
               int d, float scale_log2, cudaStream_t stream) {
  auto kern = flash_fwd_f32<NPL, NO_MAX>;
  constexpr int smem = f32_smem_bytes<NPL>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + F32_ROWS - 1) / F32_ROWS, B * H, 1);
  kern<<<grid, F32_ROWS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Lq, Lk, d, scale_log2);
  return (int)cudaGetLastError();
}

template <bool NO_MAX>
int launch_f32_any(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
                   int Lk, int d, float sl, cudaStream_t st) {
  if (d <= 64) return launch_f32<2, NO_MAX>(q, k, v, o, B, H, Lq, Lk, d, sl, st);
  if (d <= 128) return launch_f32<4, NO_MAX>(q, k, v, o, B, H, Lq, Lk, d, sl, st);
  if (d <= 256) return launch_f32<8, NO_MAX>(q, k, v, o, B, H, Lq, Lk, d, sl, st);
  return launch_f32<16, NO_MAX>(q, k, v, o, B, H, Lq, Lk, d, sl, st);
}

constexpr int ERR_UNSUPPORTED = -1;

// A narrow bf16 head (d % 8 == 0, d < 128): 64 or 128 padded columns.
template <bool NO_MAX, bool SUM_ROUNDED, bool PRESCALE_Q = false, bool BF16_SCORES = false>
int launch_narrow(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk,
                  int d, float sl, cudaStream_t st) {
  if (d % 8 != 0 || d >= 128) return ERR_UNSUPPORTED;
  if (d <= 64)
    return launch_bf16<64, 64, NO_MAX, SUM_ROUNDED, PRESCALE_Q, BF16_SCORES>(q, k, v, o, B, H, Lq, Lk, d, sl, st);
  return launch_bf16<128, 128, NO_MAX, SUM_ROUNDED, PRESCALE_Q, BF16_SCORES>(q, k, v, o, B, H, Lq, Lk, d, sl, st);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  Returns cudaGetLastError() after the launch,
// or -1 for a shape the kernel does not take (the wrapper checks first).
extern "C" int rd_flash_nomax(int dtype, const void* q, const void* k, const void* v, void* o,
                              int B, int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d > 512) return ERR_UNSUPPORTED;
    return launch_f32_any<true>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  }
  return launch_narrow<true, true>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
}

extern "C" int rd_flash_max(int dtype, const void* q, const void* k, const void* v, void* o,
                            int B, int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d > 512) return ERR_UNSUPPORTED;
    return launch_f32_any<false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  }
  return launch_narrow<false, true>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
}

extern "C" int rd_flash_wide(int dtype, const void* q, const void* k, const void* v, void* o,
                             int B, int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d > 512) return ERR_UNSUPPORTED;
    return launch_f32_any<false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  }
  if (d % 8 != 0 || d > 512) return ERR_UNSUPPORTED;
  if (d <= 128) return launch_bf16<128, 128, false, false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  if (d <= 256) return launch_bf16<256, 128, false, false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  return launch_bf16<512, 128, false, false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
}

// K6: running max, fp32 normaliser (the sum of unrounded P), narrow heads.
extern "C" int rd_flash_exp2(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                             int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d > 512) return ERR_UNSUPPORTED;
    return launch_f32_any<false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  }
  return launch_narrow<false, false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
}

// K8: q pre-scaled and rounded, bf16 scores, running max; bf16 only.
extern "C" int rd_flash_bf16(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                             int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  if (dtype != 0) return ERR_UNSUPPORTED;
  return launch_narrow<false, true, true, true>(q, k, v, o, B, H, Lq, Lk, d, scale_log2,
                                                static_cast<cudaStream_t>(stream));
}

// K9 with bf16_exp: no max, p = exp2 of the score rounded to bf16; bf16 only.
extern "C" int rd_flash_nomax_bf16exp(int dtype, const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Lq, int Lk, int d, float scale_log2,
                                      void* stream) {
  if (dtype != 0) return ERR_UNSUPPORTED;
  return launch_narrow<true, true, false, true>(q, k, v, o, B, H, Lq, Lk, d, scale_log2,
                                                static_cast<cudaStream_t>(stream));
}

// K10: q pre-scaled and rounded, no max; padded keys get p = 0.
extern "C" int rd_flash_nomask(int dtype, const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Lq, int Lk, int d, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d > 512) return ERR_UNSUPPORTED;
    return launch_f32_any<true>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
  }
  return launch_narrow<true, true, true, false>(q, k, v, o, B, H, Lq, Lk, d, scale_log2, st);
}
