// Gated CRF loss (Potts kernel, no masks): forward and backward for sm_90a.
//
// Replaces the Pallas TPU kernels of fedicra_tpu/ops/gated_crf_pallas.py:
// _fwd_kernel (:77) and _bwd_kernel (:106), both launched from _run (:132).
//
// For image b, with offsets o = (dy, dx), |dy|, |dx| <= r, o != 0:
//   k_o(q) = exp(-1/2 ||f(q+o) - f(q)||^2)
//   forward:  S_b    = sum_q sum_o k_o(q) * (1 - <y(q), y(q+o)>)
//   backward: acc(q) = sum_o k_o(q) * y(q+o)
// y is (B, C, H, W) f32 probabilities, f is (B, F, H, W) f32 features
// [x/6, y/6, rgb/0.1]. Outside the image both y AND f are zero, so a border
// neighbour still contributes exp(-1/2 ||f(q)||^2) to S_b; it is not skipped.
// The loss is sum_b S_b / (B H W); the caller scales acc by -2 g / (B H W).
//
// Design. One thread per output pixel; a block owns a TILE_H x TILE_W tile
// and stages its y and f planes plus an r-pixel halo in shared memory, zero
// outside the image, so the 120 neighbour reads of each pixel hit shared
// memory. A warp covers one tile row of 32 pixels, so its shared-memory
// reads are consecutive words (no bank conflicts). The forward reduces each
// block to one partial sum in a fixed tree order and a second one-block
// kernel sums the partials in a fixed order: no float atomics, so repeated
// runs give the bit-identical loss.
//
// Bound on the H100 SXM at the main-path shape (B=12, C=3, F=5, 384^2, r=5):
// 120 offsets x 1.77 M pixels = 212 M (pixel, offset) pairs. Per pair the
// forward does 3F + 2C + 5 = 26 fp32 operations (5-dim difference and squared
// norm, one exp, 3-dim dot, accumulate; an FMA counts two, the exp one) and
// the backward 3F + 2C + 2 = 23: 5.5 and 4.9 G operations over 67 TFLOP/s
// fp32 = 82 and 73 us. The exps alone, 212 M over the special-function units
// (16 per SM per clock, 132 SMs, 1.98 GHz), take ~50 us. Memory is far below:
// y + f = 57 MB read once per pass (78 MB with the backward's output) over
// 3.35 TB/s = 17 and 23 us. So both kernels are bound by operations; the
// staging makes every neighbour read a shared-memory read (8 words per pair),
// leaving shared-memory traffic and the ALU and SFU work as the cost.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int THREADS = TILE_W * TILE_H;
constexpr int MAX_RADIUS = 5;

// Copy planes [0, n) of one image's (n, H, W) array into shared memory as
// (n, TILE_H + 2r, TILE_W + 2r), zero outside the image.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* __restrict__ dst,
                                      int n, int H, int W, int y0, int x0, int r) {
  const int sw = TILE_W + 2 * r;
  const int plane = (TILE_H + 2 * r) * sw;
  for (int i = threadIdx.x; i < n * plane; i += THREADS) {
    const int c = i / plane;
    const int rem = i - c * plane;
    const int yy = rem / sw;
    const int xx = rem - yy * sw;
    const int gy = y0 - r + yy;
    const int gx = x0 - r + xx;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = src[(size_t)c * H * W + (size_t)gy * W + gx];
    }
    dst[i] = v;
  }
}

template <int C, int F>
__global__ void __launch_bounds__(THREADS)
gated_crf_fwd_kernel(const float* __restrict__ y, const float* __restrict__ f,
                     float* __restrict__ partial, int H, int W, int r, int tiles_x) {
  extern __shared__ float smem[];
  const int sw = TILE_W + 2 * r;
  const int plane = (TILE_H + 2 * r) * sw;
  float* ys = smem;
  float* fs = smem + C * plane;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE_H;
  const int tx0 = (blockIdx.x % tiles_x) * TILE_W;
  const size_t hw = (size_t)H * W;
  stage(y + (size_t)b * C * hw, ys, C, H, W, ty0, tx0, r);
  stage(f + (size_t)b * F * hw, fs, F, H, W, ty0, tx0, r);
  __syncthreads();

  const int ly = threadIdx.x / TILE_W;
  const int lx = threadIdx.x % TILE_W;
  float sum = 0.0f;
  if (ty0 + ly < H && tx0 + lx < W) {
    const int centre = (ly + r) * sw + (lx + r);
    float f0[F];
    float y0[C];
#pragma unroll
    for (int c = 0; c < F; ++c) f0[c] = fs[c * plane + centre];
#pragma unroll
    for (int c = 0; c < C; ++c) y0[c] = ys[c * plane + centre];
    for (int dy = -r; dy <= r; ++dy) {
      for (int dx = -r; dx <= r; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int q = centre + dy * sw + dx;
        float d2 = 0.0f;
#pragma unroll
        for (int c = 0; c < F; ++c) {
          const float d = fs[c * plane + q] - f0[c];
          d2 = fmaf(d, d, d2);
        }
        const float k = expf(-0.5f * d2);
        float cross = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) cross = fmaf(ys[c * plane + q], y0[c], cross);
        sum = fmaf(k, 1.0f - cross, sum);
      }
    }
  }

  // Block sum in a fixed order: within each warp by shuffles, then warp 0
  // over the per-warp sums.
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, s);
  __shared__ float warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    float v = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (lane == 0) partial[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = v;
  }
}

// One block: loss = sum(partial) / denom, in a fixed order, accumulated in double.
constexpr int REDUCE_THREADS = 256;

__global__ void __launch_bounds__(REDUCE_THREADS)
sum_partials_kernel(const float* __restrict__ partial, int n, double denom,
                    float* __restrict__ out) {
  __shared__ double buf[REDUCE_THREADS];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += REDUCE_THREADS) acc += (double)partial[i];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)(buf[0] / denom);
}

template <int C, int F>
__global__ void __launch_bounds__(THREADS)
gated_crf_bwd_kernel(const float* __restrict__ y, const float* __restrict__ f,
                     float* __restrict__ acc_out, int H, int W, int r, int tiles_x) {
  extern __shared__ float smem[];
  const int sw = TILE_W + 2 * r;
  const int plane = (TILE_H + 2 * r) * sw;
  float* ys = smem;
  float* fs = smem + C * plane;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE_H;
  const int tx0 = (blockIdx.x % tiles_x) * TILE_W;
  const size_t hw = (size_t)H * W;
  stage(y + (size_t)b * C * hw, ys, C, H, W, ty0, tx0, r);
  stage(f + (size_t)b * F * hw, fs, F, H, W, ty0, tx0, r);
  __syncthreads();

  const int ly = threadIdx.x / TILE_W;
  const int lx = threadIdx.x % TILE_W;
  const int gy = ty0 + ly;
  const int gx = tx0 + lx;
  if (gy >= H || gx >= W) return;

  const int centre = (ly + r) * sw + (lx + r);
  float f0[F];
  float acc[C];
#pragma unroll
  for (int c = 0; c < F; ++c) f0[c] = fs[c * plane + centre];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int q = centre + dy * sw + dx;
      float d2 = 0.0f;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        const float d = fs[c * plane + q] - f0[c];
        d2 = fmaf(d, d, d2);
      }
      const float k = expf(-0.5f * d2);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(k, ys[c * plane + q], acc[c]);
    }
  }
  float* dst = acc_out + (size_t)b * C * hw + (size_t)gy * W + gx;
#pragma unroll
  for (int c = 0; c < C; ++c) dst[(size_t)c * hw] = acc[c];
}

size_t smem_bytes(int C, int F, int r) {
  return sizeof(float) * (size_t)(C + F) * (TILE_H + 2 * r) * (TILE_W + 2 * r);
}

template <int C, int F>
void launch_fwd(const float* y, const float* f, float* partial, int B, int H, int W, int r,
                cudaStream_t stream) {
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int tiles_y = (H + TILE_H - 1) / TILE_H;
  dim3 grid(tiles_x * tiles_y, B);
  gated_crf_fwd_kernel<C, F><<<grid, THREADS, smem_bytes(C, F, r), stream>>>(
      y, f, partial, H, W, r, tiles_x);
}

template <int C, int F>
void launch_bwd(const float* y, const float* f, float* acc, int B, int H, int W, int r,
                cudaStream_t stream) {
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int tiles_y = (H + TILE_H - 1) / TILE_H;
  dim3 grid(tiles_x * tiles_y, B);
  gated_crf_bwd_kernel<C, F><<<grid, THREADS, smem_bytes(C, F, r), stream>>>(
      y, f, acc, H, W, r, tiles_x);
}

// Instantiate C in 1..4 and F in {3, 5}: F = 2 + image channels, and the
// tasks' images have 1 or 3 channels.
#define GATED_CRF_DISPATCH(FN, ...)                                 \
  switch (C * 16 + F) {                                             \
    case 1 * 16 + 3: FN<1, 3>(__VA_ARGS__); break;                  \
    case 1 * 16 + 5: FN<1, 5>(__VA_ARGS__); break;                  \
    case 2 * 16 + 3: FN<2, 3>(__VA_ARGS__); break;                  \
    case 2 * 16 + 5: FN<2, 5>(__VA_ARGS__); break;                  \
    case 3 * 16 + 3: FN<3, 3>(__VA_ARGS__); break;                  \
    case 3 * 16 + 5: FN<3, 5>(__VA_ARGS__); break;                  \
    case 4 * 16 + 3: FN<4, 3>(__VA_ARGS__); break;                  \
    case 4 * 16 + 5: FN<4, 5>(__VA_ARGS__); break;                  \
    default: return (int)cudaErrorInvalidValue;                     \
  }

bool shape_ok(int B, int C, int F, int H, int W, int r) {
  return B > 0 && B <= 65535 && H > 0 && W > 0 && r >= 1 && r <= MAX_RADIUS &&
         C >= 1 && C <= 4 && (F == 3 || F == 5);
}

}  // namespace

extern "C" {

// Number of per-block partial sums the forward writes for one call.
int gated_crf_num_partials(int B, int H, int W) {
  return B * ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
}

// loss[0] = sum_b S_b / (B H W). `partial` holds gated_crf_num_partials floats.
// `device` is the CUDA ordinal the tensors and `stream` belong to. Returns the
// CUDA error of the launches (0 on success).
int gated_crf_fwd(const float* y, const float* f, float* partial, float* loss, int B, int C,
                  int F, int H, int W, int r, int device, void* stream) {
  if (!shape_ok(B, C, F, H, W, r)) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  GATED_CRF_DISPATCH(launch_fwd, y, f, partial, B, H, W, r, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, REDUCE_THREADS, 0, s>>>(
      partial, gated_crf_num_partials(B, H, W), (double)B * H * W, loss);
  return (int)cudaGetLastError();
}

// acc (B, C, H, W) = sum_o k_o(q) y(q+o). Returns the CUDA error of the launch.
int gated_crf_bwd(const float* y, const float* f, float* acc, int B, int C, int F, int H,
                  int W, int r, int device, void* stream) {
  if (!shape_ok(B, C, F, H, W, r)) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  GATED_CRF_DISPATCH(launch_bwd, y, f, acc, B, H, W, r, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
