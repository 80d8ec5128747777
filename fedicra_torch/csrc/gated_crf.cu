// Gated CRF loss (Potts kernel, no masks) for sm_90a: one fused pass that
// gives the loss and the accumulator of its gradient together.
//
// Replaces the Pallas TPU kernels of fedicra_tpu/ops/gated_crf_pallas.py:
// _fwd_kernel (:77) and _bwd_kernel (:106), both launched from _run (:132).
//
// For image b, with offsets o = (dy, dx), |dy|, |dx| <= r, o != 0:
//   k_o(q)  = exp(-1/2 ||f(q+o) - f(q)||^2)
//   K(q)    = sum_o k_o(q),   acc(q) = sum_o k_o(q) * y(q+o)
//   S_b     = sum_q sum_o k_o(q) (1 - <y(q), y(q+o)>) = sum_q [K(q) - <y(q), acc(q)>]
// y is (B, C, H, W) probabilities, f32 or bf16 (the softmax of bf16 logits
// under AMP), f is (B, F, H, W) f32 features [x/6, y/6, rgb/0.1]. A bf16 y
// is widened to f32 once, exactly, as it is staged; everything after is the
// f32 arithmetic of an f32 y, so a bf16 launch gives the loss and acc of an
// f32 launch on the widened y bit for bit. Outside the image both y AND f are zero, so a border
// neighbour still adds exp(-1/2 ||f(q)||^2) to K(q) and nothing to acc(q);
// the identity above holds exactly under that padding. The loss is
// sum_b S_b / (B H W); dL/dy = -2 g / (B H W) * acc, which the caller forms
// from the acc this pass writes (when asked), so the backward runs no stencil.
//
// Bound on the H100 SXM at the main-path shape (B=12, C=3, F=5, 384^2, r=5):
// 120 offsets x 1.77 M pixels = 212 M ordered (pixel, offset) pairs, 209 M of
// them with both pixels inside. k_o(q) = k_{-o}(q+o) there, so the function
// needs each such unordered pair's difference and squared norm (3F fp32
// operations, an FMA counting two) and exp once, then 2C + 1 per ordered pair
// (C FMAs into acc, one add to K), plus the border pixels' exp(-|f(q)|^2/2)
// and each pixel's K - <y, acc>: 3.05 G operations over 67 TFLOP/s = 46 us
// (tools/kernel_times.py gated_crf_work). Its 105 M exps run on the special-function
// units (16 a clock per SM), ~25 us beside that. y + f read once and acc
// written once are 78 MB over 3.35 TB/s = 23 us. So the pass is bound by
// operations. This design forms every ordered pair's weight: it issues
// 2F + 1 + C = 14 FP32-pipe instructions a pair (F FMAs for the scaled
// difference, F for the squared norm, the add to K, C for acc) and one
// MUFU.EX2, ~89 us of FP32 issue at the 1.98 GHz boost clock: about twice
// the bound before any load, loop or stall. Pair symmetry would halve the
// distances and exps it forms.
//
// Design.
// - One pass: K and acc are formed together; the loss is K - <y, acc> per
//   pixel, taken in double (cancellation: K and <y, acc> are close on
//   confident maps), so no second stencil pass is needed for the gradient.
// - Register blocking: each thread owns a strip of STRIP pixels down one
//   column. For each dx it walks the STRIP + 2r rows of the neighbour column
//   once, loads each neighbour's F + C words once (as float4 quads) and uses
//   them for every pixel of its strip whose dy is in range: 2.55 words a pair
//   at r = 5 instead of 8. Strip centres, K and acc stay in registers.
// - One exp2 a pair: exp(-|d|^2/2) = exp2(-|s d|^2) with s = sqrt(log2(e)/2).
//   The centres are scaled and negated in registers, so the scaled difference
//   s n - s c is one FMA, and the negated squared norm feeds ex2.approx.ftz.
// - Staging: one block per 24 x 32 output tile (192 threads) stages the tile
//   with an r-pixel halo (34 x 42 positions at r = 5, 1.86x the tile) by
//   4-byte cp.async with zero-fill outside the image (a bf16 y: a 2-byte
//   read-only load, widened by a 16-bit shift, stored as f32), into a quad-major
//   shared layout [quad][row][col] (a warp's float4 reads are consecutive:
//   no bank conflicts); each position's row and column come from a divisor
//   known at compile time. 45.7 KB at C=3, F=5, r=5, so 4 blocks (24 warps)
//   stay resident per SM and one block's copies overlap the others' compute;
//   where a tile needs more than 48 KB, cudaFuncSetAttribute raises the limit.
//   Occupancy hides the latency better than prefetch did: a persistent grid
//   that double-buffered 32 x 32 tiles (2 blocks, 16 warps per SM) ran
//   slower (PERF.md), and so did the other tile heights and strips tried.
// - Fixed summation order: each tile's sum goes to its own slot in double;
//   the last block to finish (a __threadfence() counter) adds the slots in
//   tile order. No float atomics, no second launch: repeated runs give the
//   bit-identical loss.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE_W = 32;                       // output tile: TILE_H x TILE_W pixels
constexpr int TILE_H = 24;
constexpr int STRIP = 4;                         // pixels per thread, down a column
constexpr int THREADS = TILE_W * TILE_H / STRIP;  // 192
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RADIUS = 5;
constexpr int MAX_DEVICES = 64;
// sqrt(log2(e) / 2): exp(-|d|^2 / 2) = exp2(-|scale * d|^2)
constexpr float FEATURE_SCALE = 0.84932180028801904f;

template <int C, int F, int R>
struct Shape {
  static constexpr int QUADS = (F + C + 3) / 4;   // float4s per staged position
  static constexpr int SW = TILE_W + 2 * R;       // staged columns
  static constexpr int POS = (TILE_H + 2 * R) * SW;
  static constexpr size_t SMEM = sizeof(float4) * QUADS * POS;
};

__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Start the copies of one tile's y and f, with the halo, into `buf` as
// [quad][row][col] float4s, channel ch at quad ch / 4, lane ch % 4, in the
// order f_0 .. f_{F-1}, y_0 .. y_{C-1}. Zero outside the image. With BF16_Y,
// y holds bf16 bit patterns; each is widened (bits << 16) and stored as f32.
template <bool BF16_Y, int C, int F, int R>
__device__ __forceinline__ void stage(float4* buf, const void* __restrict__ y,
                                      const float* __restrict__ f, int H, int W, int b, int ty0,
                                      int tx0) {
  using S = Shape<C, F, R>;
  const size_t hw = (size_t)H * W;
  const float* fb = f + (size_t)b * F * hw;
  const float* yb = static_cast<const float*>(y) + (size_t)b * C * hw;
  const unsigned short* yb16 = static_cast<const unsigned short*>(y) + (size_t)b * C * hw;
  const unsigned base = (unsigned)__cvta_generic_to_shared(buf);
  for (int i = threadIdx.x; i < S::POS; i += THREADS) {
    const int row = i / S::SW;  // a compile-time divisor: a multiply and a shift
    const int col = i - row * S::SW;
    const int gy = ty0 - R + row;
    const int gx = tx0 - R + col;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t off = inside ? (size_t)gy * W + gx : 0;
    const int nbytes = inside ? 4 : 0;  // 0: nothing is read, the word is zero-filled
#pragma unroll
    for (int ch = 0; ch < F + C; ++ch) {
      const unsigned dst = base + (unsigned)((((ch >> 2) * S::POS + i) * 4 + (ch & 3)) * 4);
      if (BF16_Y && ch >= F) {
        const float v =
            inside ? __uint_as_float((unsigned)__ldg(yb16 + (ch - F) * hw + off) << 16) : 0.0f;
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst), "f"(v));
      } else {
        const float* src = (ch < F ? fb + ch * hw : yb + (ch - F) * hw) + off;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                     "r"(nbytes));
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void load_channels(const float4* p, int stride, float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < (N + 3) / 4; ++q) {
    const float4 t = p[q * stride];
    if (4 * q + 0 < N) v[4 * q + 0] = t.x;
    if (4 * q + 1 < N) v[4 * q + 1] = t.y;
    if (4 * q + 2 < N) v[4 * q + 2] = t.z;
    if (4 * q + 3 < N) v[4 * q + 3] = t.w;
  }
}

// One tile from the staged buffer: this thread's strip of K and acc, acc
// stored when WRITE_ACC; returns the strip's sum of K - <y, acc> in double.
template <int C, int F, int R, bool WRITE_ACC>
__device__ __forceinline__ double tile_pass(const float4* buf, float* __restrict__ acc_out,
                                            int H, int W, int b, int ty0, int tx0) {
  using S = Shape<C, F, R>;
  constexpr int NEIGHBOURS = STRIP + 2 * R;  // rows of a neighbour column one dx walks
  const int lx = threadIdx.x % TILE_W;
  const int ly0 = (threadIdx.x / TILE_W) * STRIP;

  float nc[STRIP][F];  // -scale * f(q) of the strip's pixels
  float K[STRIP];
  float acc[STRIP][C];
#pragma unroll
  for (int p = 0; p < STRIP; ++p) {
    float v[F + C];
    load_channels(buf + (ly0 + p + R) * S::SW + lx + R, S::POS, v);
#pragma unroll
    for (int ch = 0; ch < F; ++ch) nc[p][ch] = -FEATURE_SCALE * v[ch];
    K[p] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[p][c] = 0.0f;
  }

#pragma unroll 1
  for (int dx = -R; dx <= R; ++dx) {
    // neighbour row j of this column is staged row ly0 + j: dy = j - R - p
    const float4* col = buf + ly0 * S::SW + lx + R + dx;
#pragma unroll
    for (int j = 0; j < NEIGHBOURS; ++j) {
      float v[F + C];
      load_channels(col + j * S::SW, S::POS, v);
#pragma unroll
      for (int p = 0; p < STRIP; ++p) {
        if (j - p < 0 || j - p > 2 * R) continue;  // |dy| > r: resolved at compile time
        float nd2 = 0.0f;                           // -|scale * (f(q+o) - f(q))|^2
#pragma unroll
        for (int ch = 0; ch < F; ++ch) {
          const float d = fmaf(v[ch], FEATURE_SCALE, nc[p][ch]);
          nd2 = fmaf(-d, d, nd2);
        }
        float k = exp2_ftz(nd2);
        if (j - p == R && dx == 0) k = 0.0f;  // o = 0: the pixel itself
        K[p] += k;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[p][c] = fmaf(k, v[F + c], acc[p][c]);
      }
    }
  }

  double sum = 0.0;
  const int gx = tx0 + lx;
  const size_t hw = (size_t)H * W;
#pragma unroll
  for (int p = 0; p < STRIP; ++p) {
    const int gy = ty0 + ly0 + p;
    if (gy < H && gx < W) {
      float v[F + C];
      load_channels(buf + (ly0 + p + R) * S::SW + lx + R, S::POS, v);
      double d = (double)K[p];
#pragma unroll
      for (int c = 0; c < C; ++c) d = fma(-(double)v[F + c], (double)acc[p][c], d);
      sum += d;
      if (WRITE_ACC) {
        float* dst = acc_out + (size_t)b * C * hw + (size_t)gy * W + gx;
#pragma unroll
        for (int c = 0; c < C; ++c) dst[c * hw] = acc[p][c];
      }
    }
  }
  return sum;
}

// Sum of `v` over the block in a fixed order; the result is valid in thread 0.
// Ends with a __syncthreads() between the per-warp writes and thread 0's reads.
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += warp_sums[w];
  }
  return t;
}

template <bool BF16_Y, int C, int F, int R, bool WRITE_ACC>
__global__ void __launch_bounds__(THREADS)
gated_crf_fused_kernel(const void* __restrict__ y, const float* __restrict__ f,
                       float* __restrict__ acc_out, double* __restrict__ partial,
                       unsigned* __restrict__ done, float* __restrict__ loss, int H, int W,
                       int tiles_x, int tiles_per_image, double denom) {
  extern __shared__ float4 smem[];
  __shared__ double warp_sums[WARPS];
  __shared__ bool last_block;

  const int tile = blockIdx.x;
  const int b = tile / tiles_per_image;
  const int rem = tile - b * tiles_per_image;
  const int ty0 = (rem / tiles_x) * TILE_H;
  const int tx0 = (rem % tiles_x) * TILE_W;
  stage<BF16_Y, C, F, R>(smem, y, f, H, W, b, ty0, tx0);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();  // the tile's copies, from every thread, have landed
  const double s = tile_pass<C, F, R, WRITE_ACC>(smem, acc_out, H, W, b, ty0, tx0);
  const double t = block_sum(s, warp_sums);

  // The last block to finish adds the per-tile sums in tile order.
  if (threadIdx.x == 0) {
    partial[tile] = t;
    __threadfence();
    last_block = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  double u = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) u += __ldcg(partial + i);
  const double total = block_sum(u, warp_sums);
  if (threadIdx.x == 0) {
    loss[0] = (float)(total / denom);
    *done = 0u;  // ready for the next launch on this counter
  }
}

struct Args {
  const void* y;
  bool y_bf16;
  const float* f;
  float* acc;
  double* partial;
  unsigned* done;
  float* loss;
  int B, H, W, device;
  cudaStream_t stream;
};

int tiles_along(int n, int tile) { return (n + tile - 1) / tile; }

template <bool BF16_Y, int C, int F, int R, bool WRITE_ACC>
int launch(const Args& a) {
  using S = Shape<C, F, R>;
  auto kernel = gated_crf_fused_kernel<BF16_Y, C, F, R, WRITE_ACC>;
  // above 48 KB of dynamic shared memory only once allowed, per device
  static bool smem_raised[MAX_DEVICES] = {false};
  if (a.device < 0 || a.device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_raised[a.device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_raised[a.device] = true;
  }
  const int tiles_x = tiles_along(a.W, TILE_W);
  const int tiles_per_image = tiles_x * tiles_along(a.H, TILE_H);
  kernel<<<a.B * tiles_per_image, THREADS, S::SMEM, a.stream>>>(
      a.y, a.f, a.acc, a.partial, a.done, a.loss, a.H, a.W, tiles_x, tiles_per_image,
      (double)a.B * a.H * a.W);
  return (int)cudaGetLastError();
}

template <bool BF16_Y, int C, int F, int R>
int launch_acc(const Args& a) {
  return a.acc ? launch<BF16_Y, C, F, R, true>(a) : launch<BF16_Y, C, F, R, false>(a);
}

template <int C, int F, int R>
int launch_dtype(const Args& a) {
  return a.y_bf16 ? launch_acc<true, C, F, R>(a) : launch_acc<false, C, F, R>(a);
}

// Instantiate radius 1..5.
template <int C, int F>
int launch_radius(const Args& a, int r) {
  switch (r) {
    case 1: return launch_dtype<C, F, 1>(a);
    case 2: return launch_dtype<C, F, 2>(a);
    case 3: return launch_dtype<C, F, 3>(a);
    case 4: return launch_dtype<C, F, 4>(a);
    case 5: return launch_dtype<C, F, 5>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool shape_ok(int B, int C, int F, int H, int W, int r) {
  return B > 0 && H > 0 && W > 0 && r >= 1 && r <= MAX_RADIUS && C >= 1 && C <= 4 &&
         (F == 3 || F == 5) &&
         (long long)B * tiles_along(H, TILE_H) * tiles_along(W, TILE_W) <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Number of per-tile sums (doubles) the pass writes to `partial` for one call.
int gated_crf_num_tiles(int B, int H, int W) {
  return B * tiles_along(H, TILE_H) * tiles_along(W, TILE_W);
}

// loss[0] = sum_b S_b / (B H W); acc (B, C, H, W), f32 = sum_o k_o(q) y(q+o)
// when `acc` is not NULL. `y` holds f32, or bf16 when `y_bf16` is not 0.
// `partial` holds gated_crf_num_tiles doubles; `done` is an unsigned counter
// that is 0 before the launch and that the launch leaves at 0 (one counter
// per stream). `device` is the CUDA ordinal the tensors and `stream` belong
// to. Instantiates C in 1..4 and F in {3, 5}: F = 2 + image channels, and the
// tasks' images have 1 or 3 channels; each for both y types. Returns the
// CUDA error of the launch (0 on success).
int gated_crf_fused(const void* y, int y_bf16, const float* f, float* acc, double* partial,
                    unsigned* done, float* loss, int B, int C, int F, int H, int W, int r,
                    int device, void* stream) {
  if (!shape_ok(B, C, F, H, W, r)) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const Args a{y, y_bf16 != 0, f, acc, partial, done, loss, B, H, W, device,
               (cudaStream_t)stream};
  switch (C * 16 + F) {
    case 1 * 16 + 3: return launch_radius<1, 3>(a, r);
    case 1 * 16 + 5: return launch_radius<1, 5>(a, r);
    case 2 * 16 + 3: return launch_radius<2, 3>(a, r);
    case 2 * 16 + 5: return launch_radius<2, 5>(a, r);
    case 3 * 16 + 3: return launch_radius<3, 3>(a, r);
    case 3 * 16 + 5: return launch_radius<3, 5>(a, r);
    case 4 * 16 + 3: return launch_radius<4, 3>(a, r);
    case 4 * 16 + 5: return launch_radius<4, 5>(a, r);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
