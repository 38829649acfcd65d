// 3x3 stride-1 SAME convolution for Hopper (sm_90a), two TPU kernels' ports.
//
//   rd_conv3x3     <- rollingdepth_tpu/ops/conv3x3.py::_conv_kernel     (conv3x3_same)
//   rd_conv3x3_db  <- rollingdepth_tpu/ops/conv3x3.py::_conv_kernel_db  (conv3x3_same_db)
//
// Both compute o[n, y, x, co] = sum_{dy, dx, ci} x[n, y+dy-1, x+dx-1, ci] *
// w[dy, dx, ci, co] with zeros outside the image, summed in fp32, rounded to
// x's dtype; then the bias, rounded to x's dtype, is added and the sum
// rounded again (the TPU wrapper's two roundings, conv3x3.py:121-123).
//
// Layout: x [N, H, W, Cin] (NHWC) and w [3, 3, Cin, Cout] (HWIO), read in
// place; o [N, H, W, Cout].  The TPU kernel flattened a halo-padded copy of
// x so that each tap was a contiguous slice; here the conv is an implicit
// GEMM with M = N*H*W output pixels, N = Cout and K = 9*Cin: each A tile
// (128 pixels x 32 channels of one tap) is gathered straight from x with
// the tap's (dy, dx) shift, pixels outside the image are zero-filled by
// predicate, and no padded copy or garbage halo column exists.  w read as
// [9, Cin, Cout] is already the B matrix.
//
// bf16: mma.sync.m16n8k16 (fp32 accumulation) fed by ldmatrix, 128x128
// output tile per CTA, 8 warps of 32x64.  fp32: an FMA kernel, 64x64 tile,
// 4x4 outputs per thread, any channel count.  rd_conv3x3 loads each
// (tap, channel-chunk) tile synchronously (one stage), as _conv_kernel
// waits on its one halo DMA; rd_conv3x3_db keeps a 2-stage cp.async ring,
// the next tile loading while the current one is multiplied (the Hopper
// form of _conv_kernel_db's prefetched halo).
//
// Bound on the H100 (data-sheet estimates): at the VAE decoder's widths,
// (N, H, W, Cin, Cout) = (4, 432, 768, 128, 128), (4, 216, 384, 256, 256)
// and (4, 108, 192, 512, 512), one call is 3.91e11 operations, 0.40 ms at
// 989 TFLOP/s, against 0.05-0.20 ms to read x and write o once at 3.35 TB/s:
// the conv is bound by operations.  This first design puts the work on the
// tensor cores with large output tiles (each A element feeds 128 output
// channels from shared memory); it uses neither TMA nor wgmma, so it is
// expected to miss the bound by several times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ERR_UNSUPPORTED = -1;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 16-byte (bf16) or 4-byte (fp32) copy into shared memory, zero when !ok.
// STAGES == 1: a plain load and store; otherwise cp.async (src-size 0 fills
// zeros), completed by cp_async_wait.
template <int STAGES>
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  if (STAGES == 1) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok) v = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(ok ? 16 : 0));
  }
}

template <int STAGES>
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  if (STAGES == 1) {
    *dst = ok ? *src : 0.f;
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Run the K loop over (tap, channel chunk) steps with STAGES tiles in
// shared memory: load(stage, step) fills a tile, compute(stage) consumes it.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void k_loop(int n_steps, Load load, Compute compute) {
  if (STAGES == 1) {
    for (int s = 0; s < n_steps; ++s) {
      __syncthreads();  // the previous tile is consumed
      load(0, s);
      __syncthreads();
      compute(0);
    }
  } else {
    load(0, 0);
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      if (s + 1 < n_steps) load((s + 1) & 1, s + 1);
      cp_async_commit();  // an empty group on the last step keeps the count
      cp_async_wait<1>();  // this thread's copies of tile s have landed
      __syncthreads();     // ... and every thread's
      compute(s & 1);
      __syncthreads();  // tile s is consumed before step s + 1 refills its slot
    }
  }
}

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int BM = 128;      // output pixels per CTA
constexpr int BN = 128;      // output channels per CTA
constexpr int BKC = 32;      // input channels per K step
constexpr int NT = 256;      // 8 warps: 4 along M (32 rows) x 2 along N (64 columns)
constexpr int AP = BKC + 8;  // row pitches in bf16 (+16 B: ldmatrix without bank conflicts)
constexpr int BP = BN + 8;

template <int STAGES>
__global__ void __launch_bounds__(NT)
conv3x3_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ o, int H, int W,
             int Cin, int Cout, int M) {
  __shared__ __align__(16) __nv_bfloat16 sA[STAGES][BM * AP];
  __shared__ __align__(16) __nv_bfloat16 sB[STAGES][BKC * BP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // This thread's A copies: pixel rows tid/4 and tid/4 + 64, 8 channels at
  // (tid % 4) * 8 of the chunk.  Pixel coordinates are decoded once.
  const int a_c = (tid & 3) * 8;
  int a_y[2], a_x[2];
  bool a_in[2];
  const __nv_bfloat16* a_px[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    a_in[i] = m < M;
    const int mm = a_in[i] ? m : 0;
    a_x[i] = mm % W;
    a_y[i] = (mm / W) % H;
    a_px[i] = x + (long long)mm * Cin;
  }
  // This thread's B copies: k rows tid/16 and tid/16 + 16, 8 output
  // channels at (tid % 16) * 8 of the tile.
  const int b_n = (tid & 15) * 8;

  const int n_chunks = (Cin + BKC - 1) / BKC;
  auto load = [&](int st, int step) {
    const int tap = step / n_chunks, c0 = (step - tap * n_chunks) * BKC;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int c = c0 + a_c;  // Cin % 8 == 0: a vector is wholly in or out
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_in[i] && c < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const __nv_bfloat16* src = ok ? a_px[i] + ((long long)dy * W + dx) * Cin + c : x;
      copy16<STAGES>(&sA[st][((tid >> 2) + 64 * i) * AP + a_c], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = (tid >> 4) + 16 * i;
      const int ci = c0 + kr, co = n0 + b_n;
      const bool ok = ci < Cin && co < Cout;
      const __nv_bfloat16* src = ok ? w + ((long long)tap * Cin + ci) * Cout + co : w;
      copy16<STAGES>(&sB[st][kr * BP + b_n], src, ok);
    }
  };

  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto compute = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BKC; kk += 16) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], &sA[st][(wm + mi * 16 + (lane & 15)) * AP + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, &sB[st][(kk + (lane & 15)) * BP + wn + nj * 16 + (lane >> 4) * 8]);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16816(acc[mi][ni], af[mi], bf[ni]);
    }
  };

  k_loop<STAGES>(9 * n_chunks, load, compute);

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = n0 + wn + ni * 8 + t4 * 2;
    if (col >= Cout) continue;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = __bfloat162float(bias[col]);
      b1 = __bfloat162float(bias[col + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + mi * 16 + g + half * 8;
        if (m >= M) continue;
        __nv_bfloat162 r = __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        if (bias != nullptr) r = __floats2bfloat162_rn(__low2float(r) + b0, __high2float(r) + b1);
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)m * Cout + col) = r;
      }
    }
  }
}

// ---- fp32: FMA ----------------------------------------------------------------

constexpr int FM = 64;   // output pixels per CTA
constexpr int FN = 64;   // output channels per CTA
constexpr int FK = 16;   // input channels per K step
constexpr int FT = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <int STAGES>
__global__ void __launch_bounds__(FT)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
            float* __restrict__ o, int H, int W, int Cin, int Cout, int M) {
  __shared__ __align__(16) float sA[STAGES][FK][FM + 4];  // k-major: a row of 4 pixels is one float4
  __shared__ __align__(16) float sB[STAGES][FK][FN + 4];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;

  // A copies: channel tid % 16 of pixel rows tid/16 + 16 i; B copies:
  // output channel tid % 64 of k rows tid/64 + 4 i.
  const int a_k = tid & 15;
  int a_y[4], a_x[4];
  bool a_in[4];
  const float* a_px[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 4) + 16 * i;
    a_in[i] = m < M;
    const int mm = a_in[i] ? m : 0;
    a_x[i] = mm % W;
    a_y[i] = (mm / W) % H;
    a_px[i] = x + (long long)mm * Cin;
  }
  const int b_n = tid & 63;

  const int n_chunks = (Cin + FK - 1) / FK;
  auto load = [&](int st, int step) {
    const int tap = step / n_chunks, c0 = (step - tap * n_chunks) * FK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int c = c0 + a_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_in[i] && c < Cin && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const float* src = ok ? a_px[i] + ((long long)dy * W + dx) * Cin + c : x;
      copy4<STAGES>(&sA[st][a_k][(tid >> 4) + 16 * i], src, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = (tid >> 6) + 4 * i;
      const int ci = c0 + kr, co = n0 + b_n;
      const bool ok = ci < Cin && co < Cout;
      const float* src = ok ? w + ((long long)tap * Cin + ci) * Cout + co : w;
      copy4<STAGES>(&sB[st][kr][b_n], src, ok);
    }
  };

  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  auto compute = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[st][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[st][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };

  k_loop<STAGES>(9 * n_chunks, load, compute);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Cout) o[(long long)m * Cout + col] = acc[i][j] + (bias != nullptr ? bias[col] : 0.f);
    }
  }
}

// ---- launchers ----------------------------------------------------------------

template <int STAGES>
int launch(int dtype, const void* x, const void* w, const void* b, void* o, int N, int H, int W,
           int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) return ERR_UNSUPPORTED;
  const long long m_ll = (long long)N * H * W;
  if (m_ll >= (1LL << 31)) return ERR_UNSUPPORTED;
  const int M = (int)m_ll;
  if (dtype == 0) {
    if (Cin % 8 != 0 || Cout % 8 != 0) return ERR_UNSUPPORTED;
    const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
    if (grid.y > 65535) return ERR_UNSUPPORTED;
    conv3x3_bf16<STAGES><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(o), H, W, Cin, Cout, M);
  } else if (dtype == 1) {
    const dim3 grid((M + FM - 1) / FM, (Cout + FN - 1) / FN);
    if (grid.y > 65535) return ERR_UNSUPPORTED;
    conv3x3_f32<STAGES><<<grid, FT, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                            static_cast<const float*>(b), static_cast<float*>(o), H, W,
                                            Cin, Cout, M);
  } else {
    return ERR_UNSUPPORTED;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  b may be null (no bias); it has x's dtype.
// Returns cudaGetLastError() after the launch, or -1 for a shape the kernel
// does not take (the wrapper checks first).
extern "C" int rd_conv3x3(int dtype, const void* x, const void* w, const void* b, void* o, int N, int H,
                          int W, int Cin, int Cout, void* stream) {
  return launch<1>(dtype, x, w, b, o, N, H, W, Cin, Cout, stream);
}

extern "C" int rd_conv3x3_db(int dtype, const void* x, const void* w, const void* b, void* o, int N,
                             int H, int W, int Cin, int Cout, void* stream) {
  return launch<2>(dtype, x, w, b, o, N, H, W, Cin, Cout, stream);
}
