// bf16 GroupNorm (+ silu) for Hopper (sm_90a): one reduction and one fused
// elementwise pass, the two things XLA makes of the JAX package's norm.
//
//   rd_group_norm  <- rollingdepth_tpu/models/layers.py::group_norm (bf16
//                     branch) and the silu after it (layers.py::resnet_block,
//                     unet.py, vae.py), which XLA runs as a few reduction
//                     fusions and one loop fusion (no Pallas kernel)
//
// It computes, for x [N, C, H, W] bf16 in channels_last memory ([N, H*W, C]
// contiguous) and G groups of C/G contiguous channels:
//   mean, var  fp32 statistics of each (image, group) over H*W*C/G values,
//              variance with correction 0;  inv = rsqrt(var + eps) in fp32;
//   y          bf16(bf16(bf16(bf16(x - bf16(mean)) * bf16(inv)) * w) + b),
//              rounding to bf16 after every op as XLA's fusion and PyTorch's
//              bf16 ops do (w and b are bf16);
//   silu       bf16(y / (1 + expf(-y))) in fp32 from the bf16 y, as F.silu
//              on a bf16 CUDA tensor computes it (expf, IEEE division: no
//              fast-math, so these bits are PyTorch's).
// So only the bf16 roundings of mean and inv can part from the plain
// version (ops/group_norm.py group_norm_reference), where the fp32
// statistics differ from torch.var_mean's in their last bits.
//
// Bound on the H100: bytes.  A call reads x twice (statistics, then the
// pass) and writes y once, 6 bytes an element against ~1 operation a byte;
// the op-by-op chain moves ~30 (an fp32 copy, its reduction, four bf16
// passes and the silu).  Design:
//   gn_stats      grid (chunks, N), a block of R rows x V = C/8 threads:
//                 thread (r, v) owns channels 8v..8v+7 (one 16-byte vector
//                 of a pixel's channel row) and walks pixels p0+r, p0+r+R,
//                 ...  of its block's chunk, summing x - K and (x - K)^2 in
//                 fp32, K the chunk's first pixel (a per-channel shift, so
//                 the sum of squares does not cancel).  The block adds its
//                 rows in a fixed order in shared memory, turns each
//                 channel's sums into a mean and an M2, and each group's
//                 channels into the group's (mean, M2) of the chunk (equal
//                 counts: the mean of the means, M2 = sum of M2 + n * sum of
//                 squared offsets).  A pixel's channel row is loaded whole,
//                 so groups of 10, 20 or 30 channels (not 16-byte aligned)
//                 cost nothing: channels map to groups in the merge.  Chunks
//                 spread one image over many blocks (~1056 blocks a call,
//                 8 a SM), however few images a call has.
//   gn_merge      a warp per (image, group): lane l merges chunks l, l+32,
//                 ... in order (Chan's formula), then the lanes merge in a
//                 fixed shuffle tree; lane 0 writes mean and inv.  No atomics
//                 anywhere: the same input gives the same bits every run.
//   gn_apply      the same (r, v) layout, four pixels a thread: one 16-byte
//                 load and one 16-byte store a vector, the eight channels'
//                 bf16 mean, inv, w and b held in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ERR_UNSUPPORTED = -1;
constexpr int VEC = 8;           // bf16 channels in a 16-byte vector
constexpr int THREADS = 256;     // the rows of a block: max(1, THREADS / (C / VEC))
constexpr int MAX_C = 4096;      // shared memory of the stats block: 3 * C floats at one row
constexpr int MAX_THREADS = MAX_C / VEC;  // a block: rows * C / VEC <= max(THREADS, C / VEC)
constexpr int APPLY_PIXELS = 4;  // pixels a thread in gn_apply

__device__ __forceinline__ float round_bf16(float f) { return __bfloat162float(__float2bfloat16_rn(f)); }

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) {
    float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return u;
}

// Chan's merge of (count, mean, M2) b into a.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa, float nb, float mb, float qb) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb, ma = mb, qa = qb;
    return;
  }
  const float n = na + nb, d = mb - ma;
  ma += d * (nb / n);
  qa += qb + d * d * (na * nb / n);
  na = n;
}

// partial[(n * chunks + k) * G + g] = (mean, M2) of group g over chunk k of image n.
__global__ void __launch_bounds__(MAX_THREADS) gn_stats(const __nv_bfloat16* __restrict__ x, float2* __restrict__ partial,
                                                 int hw, int c, int cg, int groups, int pixels_per_chunk) {
  extern __shared__ float smem[];
  const int vecs = c / VEC, rows = blockDim.x / vecs;
  const int r = threadIdx.x / vecs, v = threadIdx.x % vecs;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int p0 = chunk * pixels_per_chunk, p1 = min(p0 + pixels_per_chunk, hw);
  const __nv_bfloat16* xn = x + (size_t)n * hw * c + v * VEC;
  float* s1 = smem;                   // [rows][c]
  float* s2 = smem + rows * c;        // [rows][c]
  float* shift = smem + 2 * rows * c; // [c]

  float k[VEC], a1[VEC], a2[VEC];
  unpack(*reinterpret_cast<const uint4*>(xn + (size_t)p0 * c), k);
#pragma unroll
  for (int j = 0; j < VEC; ++j) a1[j] = a2[j] = 0.f;
  int p = p0 + r;
  for (; p + 3 * rows < p1; p += 4 * rows) {
    uint4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = *reinterpret_cast<const uint4*>(xn + (size_t)(p + i * rows) * c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[VEC];
      unpack(u[i], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = f[j] - k[j];
        a1[j] += d;
        a2[j] = fmaf(d, d, a2[j]);
      }
    }
  }
  for (; p < p1; p += rows) {
    float f[VEC];
    unpack(*reinterpret_cast<const uint4*>(xn + (size_t)p * c), f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = f[j] - k[j];
      a1[j] += d;
      a2[j] = fmaf(d, d, a2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s1[r * c + v * VEC + j] = a1[j];
    s2[r * c + v * VEC + j] = a2[j];
    if (r == 0) shift[v * VEC + j] = k[j];
  }
  __syncthreads();

  // each channel: its rows in order, then mean and M2 of the chunk (into row 0)
  const float np = (float)(p1 - p0);
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < rows; ++i) {
      t1 += s1[i * c + ch];
      t2 += s2[i * c + ch];
    }
    s1[ch] = shift[ch] + t1 / np;
    s2[ch] = fmaxf(t2 - t1 * (t1 / np), 0.f);
  }
  __syncthreads();

  // each group: its channels in order (equal counts)
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const float* m = s1 + g * cg;
    const float* q = s2 + g * cg;
    float mean = 0.f;
    for (int i = 0; i < cg; ++i) mean += m[i];
    mean /= (float)cg;
    float m2 = 0.f, spread = 0.f;
    for (int i = 0; i < cg; ++i) {
      const float d = m[i] - mean;
      m2 += q[i];
      spread = fmaf(d, d, spread);
    }
    partial[((size_t)n * gridDim.x + chunk) * groups + g] = make_float2(mean, fmaf(np, spread, m2));
  }
}

// mean[n * G + g] and inv[n * G + g] from the chunks' partials; a warp per (n, g).
__global__ void gn_merge(const float2* __restrict__ partial, float* __restrict__ mean, float* __restrict__ inv,
                         int pairs, int groups, int chunks, int pixels_per_chunk, int hw, int cg, float eps) {
  const int pair = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (pair >= pairs) return;
  const int n = pair / groups, g = pair % groups;
  float cnt = 0.f, m = 0.f, q = 0.f;
  for (int k = lane; k < chunks; k += 32) {
    const float2 pq = partial[((size_t)n * chunks + k) * groups + g];
    const float nk = (float)(min(pixels_per_chunk, hw - k * pixels_per_chunk)) * (float)cg;
    chan_merge(cnt, m, q, nk, pq.x, pq.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, cnt, off);
    const float mb = __shfl_down_sync(0xffffffffu, m, off);
    const float qb = __shfl_down_sync(0xffffffffu, q, off);
    if (lane < off) chan_merge(cnt, m, q, nb, mb, qb);
  }
  if (lane == 0) {
    mean[pair] = m;
    inv[pair] = rsqrtf(q / cnt + eps);
  }
}

template <bool SILU>
__global__ void __launch_bounds__(MAX_THREADS) gn_apply(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean,
                                                 const float* __restrict__ inv, const __nv_bfloat16* __restrict__ w,
                                                 const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y,
                                                 int hw, int c, int cg, int groups) {
  const int vecs = c / VEC, rows = blockDim.x / vecs;
  const int r = threadIdx.x / vecs, v = threadIdx.x % vecs;
  const int n = blockIdx.y;
  float mb[VEC], ib[VEC], wb[VEC], bb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int ch = v * VEC + j, g = n * groups + ch / cg;
    mb[j] = round_bf16(mean[g]);
    ib[j] = round_bf16(inv[g]);
    wb[j] = __bfloat162float(w[ch]);
    bb[j] = __bfloat162float(b[ch]);
  }
  const size_t base = (size_t)n * hw * c + v * VEC;
  const int p0 = blockIdx.x * rows * APPLY_PIXELS + r;
  uint4 u[APPLY_PIXELS];
#pragma unroll
  for (int i = 0; i < APPLY_PIXELS; ++i) {
    const int p = p0 + i * rows;
    if (p < hw) u[i] = *reinterpret_cast<const uint4*>(x + base + (size_t)p * c);
  }
#pragma unroll
  for (int i = 0; i < APPLY_PIXELS; ++i) {
    const int p = p0 + i * rows;
    if (p >= hw) break;
    float f[VEC];
    unpack(u[i], f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float t = round_bf16(f[j] - mb[j]);
      t = round_bf16(t * ib[j]);
      t = round_bf16(t * wb[j]);
      t = round_bf16(t + bb[j]);
      if (SILU) t = t / (1.0f + expf(-t));
      f[j] = t;
    }
    *reinterpret_cast<uint4*>(y + base + (size_t)p * c) = pack(f);
  }
}

int block_threads(int c) {
  const int vecs = c / VEC;
  return vecs * (vecs < THREADS ? THREADS / vecs : 1);
}

}  // namespace

// Statistics (mean and inv, fp32 [N, G]) and the normalised output y.
// workspace: N * chunks * G float2 partials.  The caller picks the
// chunking (ops/group_norm.py stats_plan): chunks * pixels_per_chunk >= H*W,
// pixels_per_chunk a multiple of the block's rows.
extern "C" int rd_group_norm(const void* x, const void* w, const void* b, void* y, void* workspace, void* mean,
                             void* inv, int N, int HW, int C, int G, float eps, int silu, int pixels_per_chunk,
                             int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 65535 || HW < 1 || C < VEC || C % VEC || C > MAX_C || G < 1 || C % G) return ERR_UNSUPPORTED;
  const int threads = block_threads(C), rows = threads / (C / VEC);
  if (threads > MAX_THREADS || pixels_per_chunk < 1 || pixels_per_chunk % rows || chunks < 1 ||
      (long long)chunks * pixels_per_chunk < HW || (long long)(chunks - 1) * pixels_per_chunk >= HW)
    return ERR_UNSUPPORTED;
  const int cg = C / G;
  const size_t smem = (size_t)(2 * rows + 1) * C * sizeof(float);
  cudaGetLastError();  // clear an earlier, unrelated error
  gn_stats<<<dim3(chunks, N), threads, smem, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<float2*>(workspace), HW, C, cg, G, pixels_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pairs = N * G, warps = 8;
  gn_merge<<<(pairs + warps - 1) / warps, warps * 32, 0, st>>>(static_cast<const float2*>(workspace),
                                                               static_cast<float*>(mean), static_cast<float*>(inv),
                                                               pairs, G, chunks, pixels_per_chunk, HW, cg, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((HW + rows * APPLY_PIXELS - 1) / (rows * APPLY_PIXELS), N);
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* bb = static_cast<const __nv_bfloat16*>(b);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* mf = static_cast<const float*>(mean);
  auto* inf = static_cast<const float*>(inv);
  if (silu)
    gn_apply<true><<<grid, threads, 0, st>>>(xb, mf, inf, wb, bb, yb, HW, C, cg, G);
  else
    gn_apply<false><<<grid, threads, 0, st>>>(xb, mf, inf, wb, bb, yb, HW, C, cg, G);
  return (int)cudaGetLastError();
}
