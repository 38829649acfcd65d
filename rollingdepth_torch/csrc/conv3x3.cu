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
// place; o [N, H, W, Cout].
//
// Bound on the H100 (data-sheet estimates): at the VAE decoder's widths,
// (N, H, W, Cin, Cout) = (4, 432, 768, 128, 128), (4, 216, 384, 256, 256)
// and (4, 108, 192, 512, 512), one call is 3.91e11 operations, 0.40 ms at
// 989 TFLOP/s, against 0.05-0.20 ms to read x and write o once at 3.35 TB/s:
// the conv is bound by operations.  An implicit GEMM that gathers a fresh A
// tile for every tap (the first port) moves ~6 GB a call through L2 and is
// bound by that traffic instead, so this design reuses what it loads.
//
// bf16 (one template, conv3x3_wgmma): an output tile is BH image rows x 64
// columns of one image x 128 output channels.  The TPU kernel's scheme, one
// DMA of a haloed row block and nine shifted slices of it, becomes: per
// 64-channel chunk, ONE TMA load of the haloed tile x[n, y0-1 : y0+BH+1,
// x0-1 : x0+65, c0 : c0+64] (a 4-D tensor map over (Cin, W, H, N); the box
// starts at negative coordinates at the image's top and left, and TMA
// fills everything outside the tensor with zeros, so the border is the SAME
// padding and there is no padded copy).  The nine taps read shifted windows
// of it: an output pixel's A row for tap (dy, dx) is halo row (py + dy) *
// 66 + px + dx.  Those windows start off the swizzle's 8-row atom, so A
// goes through registers: ldmatrix with the 128-byte-swizzle XOR computed
// per row, then wgmma with A in registers and B from shared memory.  B is
// the (tap, chunk) weight tile, 64 input x 128 output channels, TMA-loaded
// from a 3-D map over w as (Cout, Cin, 9) in its natural MN-major layout.
// Channels past Cin or Cout arrive as zeros, and the stores are masked.
// Each consumer warpgroup owns two image rows (two m64 wgmma per k16 step,
// 128 fp32 accumulators a thread), and loads the next k16 step's A
// fragments while the current step's wgmma run.
//
//   rd_conv3x3 (K4): one consumer warpgroup, BH = 2, one halo stage and one
//     weight stage.  A thread of the CTA issues the loads of a step only
//     after the previous step's products have finished, waits on the
//     mbarrier, and multiplies: nothing is in flight during a product, as
//     _conv_kernel waits on its one DMA.  ~58 KB of shared memory and ~170
//     registers a thread, so two CTAs share an SM and overlap each other.
//   rd_conv3x3_db (K5): persistent, one CTA per SM walking the tiles; a
//     producer warpgroup (one thread issues TMA) keeps a ring of 2 halo
//     tiles and 4 weight tiles in flight, the Hopper form of
//     _conv_kernel_db's prefetched halo, and the next tile's loads run
//     under this tile's epilogue.  Two consumer warpgroups (BH = 4),
//     registers moved to them by setmaxnreg; ~181 KB of shared memory.
//
// The epilogue rounds, adds the rounded bias and rounds again in registers,
// then each warp turns its 16 pixels x 64 channels around in 2 KB of its
// own shared memory (stmatrix in, 16-byte loads out), so that every lane
// stores whole 16-byte pieces of output rows; stores of bf16 pairs straight
// from the accumulator layout left the tensor cores idle for longer.
//
// Traffic through L2 at BH = 4 (K5): each halo tile is (BH+2)/BH = 1.5x the
// x rows it covers (66/64 of its columns), and every pixel tile reads the
// whole weight once: 9 * Cin * Cout * 2 bytes per 256 pixels.  At the three
// widths that is ~2.1 GB a call, ~3.8 GB for K4's 128-pixel tiles
// (chip_smoke.py logs the count per call).
//
// fp32: an FMA kernel, 64x64 tile, 4x4 outputs per thread, any channel
// count (wgmma's TF32 would miss the 1e-4 bound).  rd_conv3x3 loads each
// (tap, channel-chunk) tile synchronously; rd_conv3x3_db keeps a 2-stage
// cp.async ring.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int ERR_UNSUPPORTED = -1;
constexpr int ERR_TENSOR_MAP = -2;

// ---- bf16: TMA + wgmma ----------------------------------------------------------

constexpr int TW = 64;            // output columns per tile (pixels of one image row)
constexpr int HALO_W = TW + 2;    // halo tile columns
constexpr int BN = 128;           // output channels per tile
constexpr int BK = 64;            // input channels per chunk: one 128-byte swizzled row
constexpr int B_BLOCK = BK * 128;           // one weight box: 64 input x 64 output channels
constexpr int B_STAGE = BN / 64 * B_BLOCK;  // one (tap, chunk) weight tile

// NCW consumer warpgroups of two image rows each.
template <int NCW>
struct Tile {
  static constexpr int BH = 2 * NCW;                          // image rows per tile
  static constexpr int HALO_BYTES = HALO_W * (BH + 2) * 128;  // one haloed 64-channel chunk
  static constexpr int A_STAGE = (HALO_BYTES + 1023) / 1024 * 1024;
};

constexpr int O_SCRATCH = 16 * 128;  // per warp: 16 pixels x 64 output channels, for the store transpose

template <int NCW, int NA, int NB>
constexpr int conv_smem_bytes() {
  return NA * Tile<NCW>::A_STAGE + NB * B_STAGE + 4 * NCW * O_SCRATCH + 2 * (NA + NB) * 8 + 1024;
}

#ifdef RD_CONV_TRACE
// A cycle trace of the persistent kernel, built only by
// tools/conv_breakdown.py (-DRD_CONV_TRACE): for each CTA's first
// TRACE_TILES tiles, consumer thread 0 records clock64() at the tile's
// start, once its first halo and weight tiles have landed, after the main
// loop and after the epilogue, and the cycles it waited inside the loop
// for halo tiles and for weight tiles.
constexpr int TRACE_CTAS = 1024, TRACE_TILES = 64, TRACE_FIELDS = 6;
__device__ long long g_trace[TRACE_CTAS * TRACE_TILES * TRACE_FIELDS];
#define TRACE(...) __VA_ARGS__
#else
#define TRACE(...)
#endif

// NCW consumer warpgroups; NA halo stages and NB weight stages.  PRODUCER:
// warpgroup NCW is a producer whose first thread keeps the rings full, and
// the grid is persistent; otherwise thread 0 issues each step's loads once
// the previous step's products are done (NA = NB = 1).
template <int NCW, int NA, int NB, bool PRODUCER>
__global__ void __launch_bounds__(128 * (NCW + (PRODUCER ? 1 : 0)), 1)
conv3x3_wgmma(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
              const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ o, int H, int W, int Cout,
              int n_chunks, int tiles_x, int tiles_y, int tiles_n, int n_tiles) {
  static_assert(PRODUCER || (NA == 1 && NB == 1), "without a producer the rings have one stage");
  using T = Tile<NCW>;
  constexpr int BH = T::BH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* sB = sA + NA * T::A_STAGE;
  unsigned char* sO = sB + NB * B_STAGE;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(sO + 4 * NCW * O_SCRATCH);
  uint64_t* empty_a = full_a + NA;
  uint64_t* full_b = empty_a + NA;
  uint64_t* empty_b = full_b + NB;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NA; ++s) {
      mbar_init(full_a + s, 1);
      mbar_init(empty_a + s, 128 * NCW);  // every consumer thread releases the stage
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(full_b + s, 1);
      mbar_init(empty_b + s, 128 * NCW);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int steps = 9 * n_chunks;  // step = chunk * 9 + tap
  int x0 = 0, y0 = 0, n = 0, co0 = 0;
  auto decode = [&](int tile) {
    co0 = (tile % tiles_n) * BN;
    tile /= tiles_n;  // the output-channel tiles of one pixel tile are neighbours: x is read once
    x0 = (tile % tiles_x) * TW;
    tile /= tiles_x;
    y0 = (tile % tiles_y) * BH;
    n = tile / tiles_y;
  };
  // Load i of a ring waits until load i - stages has been released.
  auto load_halo = [&](int i, int chunk) {
    const int s = i % NA;
    if (i >= NA) mbar_wait(empty_a + s, ((i / NA) + 1) & 1);
    mbar_expect_tx(full_a + s, T::HALO_BYTES);
    tma_load_4d(sA + s * T::A_STAGE, &tmx, full_a + s, chunk * BK, x0 - 1, y0 - 1, n);
  };
  auto load_weights = [&](int i, int step) {
    const int s = i % NB;
    if (i >= NB) mbar_wait(empty_b + s, ((i / NB) + 1) & 1);
    mbar_expect_tx(full_b + s, B_STAGE);
#pragma unroll
    for (int b = 0; b < BN / 64; ++b)
      tma_load_3d(sB + s * B_STAGE + b * B_BLOCK, &tmw, full_b + s, co0 + 64 * b, (step / 9) * BK, step % 9);
  };

  const int wg = threadIdx.x / 128;
  if (PRODUCER && wg == NCW) {
    // ---- producer: one thread issues every load, as far ahead as the rings allow
    if constexpr (PRODUCER) setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * NCW) {
      int ia = 0, ib = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        decode(tile);
        for (int c = 0; c < n_chunks; ++c) {
          load_halo(ia++, c);
          for (int t = 0; t < 9; ++t) load_weights(ib++, c * 9 + t);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns image rows y0 + 2 cw and y0 + 2 cw + 1
  if constexpr (PRODUCER) setmaxnreg_inc<232>();
  const int cw = wg;
  const int ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32;
  // This lane's ldmatrix row at tap (0, 0): warp w covers pixels 16 w ... 16 w + 15
  // of each row; lanes 16-31 read the upper 8 channels of each k16 step.
  const int lrow = 2 * cw * HALO_W + 16 * warp + (lane & 15);
  const uint32_t sA_u32 = smem_u32(sA);

  float acc[2][64];
  uint32_t af[2][2][4];  // A fragments: [k16 step parity][image row][4]
  uint32_t row_addr[2];  // stage bases are 1024-byte aligned: a row's swizzle is (row_addr >> 7) & 7

  // the A rows of `tap` in halo stage `s`, for both image rows
  auto set_tap = [&](int s, int tap) {
    const int r = lrow + (tap / 3) * HALO_W + tap % 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int rr = r + mi * HALO_W;
      row_addr[mi] = sA_u32 + s * T::A_STAGE + rr * 128;
    }
  };
  // k16 step j's fragments: 16-byte chunk 2 j of the row for lanes 0-15,
  // 2 j + 1 for lanes 16-31, swizzled
  auto frags = [&](uint32_t (&a)[2][4], int j) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], row_addr[mi] + (((2 * j + ((threadIdx.x >> 4) & 1)) ^ ((row_addr[mi] >> 7) & 7)) << 4));
  };
  auto fence_all = [&]() {
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(af[0]);
    fence_regs(af[1]);
  };

  int ia = 0, ib = 0;  // halo tiles and weight tiles consumed so far
  TRACE(int traced = 0;)
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    TRACE(const long long t_start = clock64(); long long wait_a = 0, wait_b = 0;)
    decode(tile);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;

    if (!PRODUCER && threadIdx.x == 0) {
      load_halo(ia, 0);
      load_weights(ib, 0);
    }
    mbar_wait(full_a + ia % NA, (ia / NA) & 1);
    mbar_wait(full_b + ib % NB, (ib / NB) & 1);
    __syncwarp();
    set_tap(ia % NA, 0);
    frags(af[0], 0);
    TRACE(const long long t_landed = clock64();)

    for (int step = 0; step < steps; ++step) {
      const int tap = step % 9;
      const int sb = (ib + step) % NB;
      uint64_t db = make_desc(sB + sb * B_STAGE, B_BLOCK, 1024);
      opaque(db);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fence_all();
        wgmma_fence();
        wgmma_rs_n128(acc[0], af[j & 1][0], db + j * 128);
        wgmma_rs_n128(acc[1], af[j & 1][1], db + j * 128);
        wgmma_commit();
        if (j < 3 || PRODUCER) {
          wgmma_wait<1>();  // the previous k16 step is done: its fragments and, at j = 0, its weights are free
          fence_all();
        }
        if constexpr (PRODUCER) {
          if (j == 0 && step > 0) mbar_arrive(empty_b + (ib + step - 1) % NB);
          if (j < 3) {
            frags(af[(j + 1) & 1], j + 1);
          } else if (step + 1 < steps) {
            const int ga = ia + step / 9;  // this chunk's halo tile
            TRACE(const long long w0 = clock64();)
            if (tap == 8) {               // its last fragments are loaded: release it, wait for the next
              mbar_arrive(empty_a + ga % NA);
              mbar_wait(full_a + (ga + 1) % NA, ((ga + 1) / NA) & 1);
            }
            TRACE(const long long w1 = clock64(); wait_a += w1 - w0;)
            mbar_wait(full_b + (ib + step + 1) % NB, ((ib + step + 1) / NB) & 1);
            TRACE(wait_b += clock64() - w1;)
            __syncwarp();
            set_tap((ia + (step + 1) / 9) % NA, (step + 1) % 9);
            frags(af[0], 0);
          }
        } else if (j < 3) {
          frags(af[(j + 1) & 1], j + 1);
        }
      }
      if constexpr (!PRODUCER) {
        // one stage: release this step's tiles once its products are done,
        // and only then load the next step's
        wgmma_wait<0>();
        fence_all();
        mbar_arrive(empty_b);
        if (tap == 8) mbar_arrive(empty_a);
        if (step + 1 < steps) {
          if (threadIdx.x == 0) {
            if (tap == 8) load_halo(ia + (step + 1) / 9, (step + 1) / 9);
            load_weights(ib + step + 1, step + 1);
          }
          if (tap == 8) mbar_wait(full_a, (ia + (step + 1) / 9) & 1);
          mbar_wait(full_b, (ib + step + 1) & 1);
          __syncwarp();
          set_tap(0, (step + 1) % 9);
          frags(af[0], 0);
        }
      }
    }
    if constexpr (PRODUCER) {
      wgmma_wait<0>();
      fence_all();
      mbar_arrive(empty_b + (ib + steps - 1) % NB);
      mbar_arrive(empty_a + (ia + n_chunks - 1) % NA);
    }
    ia += n_chunks;
    ib += steps;
    TRACE(const long long t_loop = clock64();)

    // ---- epilogue: round, add the rounded bias, round; mask x >= W, y >= H, co >= Cout
    // every bias pair first, so that their loads overlap: one after another,
    // each waiting on L2, they stalled the epilogue
    const int t4 = lane & 3;
    __nv_bfloat162 bias2[BN / 8];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = co0 + nt * 8 + t4 * 2;
      bias2[nt] = __floats2bfloat162_rn(0.f, 0.f);
      if (bias != nullptr && col < Cout) bias2[nt] = *reinterpret_cast<const __nv_bfloat162*>(bias + col);
    }
    // Through this warp's scratch, 16 pixels x 64 channels at a time: the
    // fragments go in by stmatrix (lane i addresses row i % 8 of matrix i /
    // 8; the 16-byte chunks of a row swizzled by the row), and each lane
    // stores whole 16-byte chunks, 4 pixels x 128 bytes a warp instruction.
    const uint32_t scratch = smem_u32(sO) + (ct / 32 + 4 * cw) * O_SCRATCH;
    const int srow = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int py = y0 + 2 * cw + mi;
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
        __syncwarp();  // the scratch's last reads are done
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t r[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int nt = 8 * h + 2 * p + (k >> 1), e = 4 * nt + 2 * (k & 1);
            __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][e], acc[mi][e + 1]);
            if (bias != nullptr)
              v = __floats2bfloat162_rn(__low2float(v) + __low2float(bias2[nt]),
                                        __high2float(v) + __high2float(bias2[nt]));
            r[k] = *reinterpret_cast<uint32_t*>(&v);
          }
          stmatrix_x4(scratch + srow * 128 + (((2 * p + (lane >> 4)) ^ (lane & 7)) << 4), r);
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int row = (lane >> 3) + 4 * k, c = lane & 7;
          const uint4 v = *reinterpret_cast<const uint4*>(sO + (scratch - smem_u32(sO)) + row * 128 +
                                                          ((c ^ (row & 7)) << 4));
          const int px = x0 + 16 * warp + row, col = co0 + 64 * h + 8 * c;
          if (py < H && px < W && col < Cout)  // Cout % 8 == 0: a chunk is wholly in or out
            *reinterpret_cast<uint4*>(o + (((long long)n * H + py) * W + px) * Cout + col) = v;
        }
      }
    }
    TRACE(if (PRODUCER && ct == 0 && cw == 0 && blockIdx.x < TRACE_CTAS && traced < TRACE_TILES) {
      long long* e = g_trace + ((long long)blockIdx.x * TRACE_TILES + traced++) * TRACE_FIELDS;
      e[0] = t_start, e[1] = t_landed, e[2] = t_loop, e[3] = clock64(), e[4] = wait_a, e[5] = wait_b;
    })
  }
}


// ---- fp32: the cp.async pipeline of the FMA kernel ---------------------------

// A 4-byte copy into shared memory, zero when !ok.  STAGES == 1: a plain
// load and store; otherwise cp.async (src-size 0 fills zeros), completed
// by cp_async_wait.
template <int STAGES>
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  if (STAGES == 1) {
    *dst = ok ? *src : 0.f;
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// x as (Cin, W, H, N) in haloed boxes of 64 channels x 66 columns x BH + 2
// rows; w as (Cout, Cin, 9) in boxes of 64 output x 64 input channels.
bool encode_maps(CUtensorMap& mx, CUtensorMap& mw, const void* x, const void* w, int N, int H, int W, int Cin,
                 int Cout, int bh) {
  const cuuint64_t xd[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2, (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xb[4] = {BK, HALO_W, (cuuint32_t)bh + 2, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)Cout, (cuuint64_t)Cin, 9};
  const cuuint64_t ws[2] = {(cuuint64_t)Cout * 2, (cuuint64_t)Cin * Cout * 2};
  const cuuint32_t wb[3] = {64, BK, 1};
  return hopper_host::encode_bf16(&mx, x, 4, xd, xs, xb) && hopper_host::encode_bf16(&mw, w, 3, wd, ws, wb);
}

template <int NCW, int NA, int NB, bool PRODUCER>
int launch_bf16(const void* x, const void* w, const void* b, void* o, int N, int H, int W, int Cin, int Cout,
                cudaStream_t st) {
  if (Cin % 8 != 0 || Cout % 8 != 0) return ERR_UNSUPPORTED;
  constexpr int bh = Tile<NCW>::BH;
  CUtensorMap mx, mw;
  if (!encode_maps(mx, mw, x, w, N, H, W, Cin, Cout, bh)) return ERR_TENSOR_MAP;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + bh - 1) / bh, tiles_n = (Cout + BN - 1) / BN;
  const long long tiles = (long long)N * tiles_y * tiles_x * tiles_n;
  if (tiles >= (1LL << 31)) return ERR_UNSUPPORTED;
  const int n_tiles = (int)tiles;
  int grid = n_tiles;
  if (PRODUCER) {
    const int sms = sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    grid = n_tiles < sms ? n_tiles : sms;
  }
  auto kern = conv3x3_wgmma<NCW, NA, NB, PRODUCER>;
  constexpr int smem = conv_smem_bytes<NCW, NA, NB>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 128 * (NCW + (PRODUCER ? 1 : 0)), smem, st>>>(
      mx, mw, static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(o), H, W, Cout,
      (Cin + BK - 1) / BK, tiles_x, tiles_y, tiles_n, n_tiles);
  return (int)cudaGetLastError();
}

template <int STAGES>
int launch_f32(const void* x, const void* w, const void* b, void* o, int H, int W, int Cin, int Cout, int M,
               cudaStream_t st) {
  const dim3 grid((M + FM - 1) / FM, (Cout + FN - 1) / FN);
  if (grid.y > 65535) return ERR_UNSUPPORTED;
  conv3x3_f32<STAGES><<<grid, FT, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                          static_cast<const float*>(b), static_cast<float*>(o), H, W, Cin,
                                          Cout, M);
  return (int)cudaGetLastError();
}

// The checks both entry points share; M = N * H * W.
bool shape_ok(int N, int H, int W, int Cin, int Cout) {
  return N > 0 && H > 0 && W > 0 && Cin > 0 && Cout > 0 && (long long)N * H * W < (1LL << 31);
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32.  b may be null (no bias); it has x's dtype.
// Returns cudaGetLastError() after the launch, -1 for a shape the kernel
// does not take (the wrapper checks first), or -2 if the CUDA driver refuses a
// tensor map.
extern "C" int rd_conv3x3(int dtype, const void* x, const void* w, const void* b, void* o, int N, int H,
                          int W, int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, H, W, Cin, Cout)) return ERR_UNSUPPORTED;
  if (dtype == 0) return launch_bf16<1, 1, 1, false>(x, w, b, o, N, H, W, Cin, Cout, st);
  if (dtype == 1) return launch_f32<1>(x, w, b, o, H, W, Cin, Cout, N * H * W, st);
  return ERR_UNSUPPORTED;
}

extern "C" int rd_conv3x3_db(int dtype, const void* x, const void* w, const void* b, void* o, int N,
                             int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, H, W, Cin, Cout)) return ERR_UNSUPPORTED;
  if (dtype == 0) return launch_bf16<2, 2, 4, true>(x, w, b, o, N, H, W, Cin, Cout, st);
  if (dtype == 1) return launch_f32<2>(x, w, b, o, H, W, Cin, Cout, N * H * W, st);
  return ERR_UNSUPPORTED;
}

#ifdef RD_CONV_TRACE
// Copies the trace of the last rd_conv3x3_db launch: [TRACE_CTAS][TRACE_TILES][TRACE_FIELDS] int64.
extern "C" int rd_conv3x3_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
#endif
