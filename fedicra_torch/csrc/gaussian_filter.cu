// Exact Gaussian kernel filter (dense-CRF message passing) for sm_90a.
//
// Replaces the Pallas TPU kernel _filter_kernel of
// fedicra_tpu/ops/pallas_kernels.py:38, launched from _gaussian_filter_impl
// (:80). Its custom VJP (:119-147) applies the same kernel to the cotangent,
// and so does the port's autograd.Function.
//
// For image b, with features f (B, N, D) and values v (B, N, C), fp32:
//   out[b, i, c] = sum_j exp(-1/2 ||f[b, i] - f[b, j]||^2) * v[b, j, c]
// over every j, i itself included.
//
// Design. The Pallas kernel forms f_i.f_j - |f_i|^2/2 - |f_j|^2/2 on the MXU
// and pads N with +inf norms. Here each thread owns ROWS query rows of one
// image and keeps their features and C sums in registers; the block streams
// the image's columns through shared memory in tiles of TILE (features and
// values, loaded contiguously), and every thread reads each staged column
// once for its ROWS rows (a broadcast read, no bank conflicts). The squared
// distance is formed directly, which keeps full fp32 accuracy where |f|^2
// is large; the features are scaled by sqrt(log2(e)/2) on load, so the
// weight is one exp2 of the negated scaled distance. Columns past N are
// staged as f = 0, v = 0 and add exact zeros; rows past N are not stored.
// Each sum runs over j in order in fp32 with no atomics, so a call is
// bit-reproducible. No tensor cores: the arithmetic is IEEE fp32 FMA.
//
// Bound on the H100 SXM at the dense-CRF shape beside the headline config
// (B = 12, N = 192^2 = 36864, D = 5, C = 3): 1.63e10 ordered pairs per
// launch. k(i, j) = k(j, i), so the function needs each unordered pair's
// exponent, expanded from per-point norms (one add, D FMAs; an FMA counts
// two), and exp once, then C accumulating FMAs per ordered pair: 0.19 TFLOP
// over 67 TFLOP/s = 2.8 ms (chip_smoke.gaussian_filter_work). Its 8.2 G exps
// on the special-function units (16 per SM per clock) take ~1.9 ms beside
// that; the 3.5 MB of inputs and output move in ~1 us. This kernel forms
// every ordered pair's weight by the direct distance, D + D + C = 13
// FP32-pipe instructions a pair, so it cannot beat ~6 ms at the boost clock.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 4;          // query rows per thread
constexpr int TILE = THREADS;    // columns staged per pass
// sqrt(log2(e) / 2): exp(-|d|^2 / 2) = exp2(-|scale * d|^2)
constexpr float FEATURE_SCALE = 0.84932180028801904f;

template <int D, int C>
__global__ void __launch_bounds__(THREADS)
gaussian_filter_kernel(const float* __restrict__ f, const float* __restrict__ v,
                       float* __restrict__ out, int N) {
  __shared__ float fs[TILE * D];
  __shared__ float vs[TILE * C];
  const int b = blockIdx.y;
  const float* fb = f + (size_t)b * N * D;
  const float* vb = v + (size_t)b * N * C;
  const int row0 = blockIdx.x * (THREADS * ROWS) + threadIdx.x;

  float q[ROWS][D];
  float acc[ROWS][C];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = row0 + r * THREADS;
#pragma unroll
    for (int d = 0; d < D; ++d) q[r][d] = i < N ? fb[(size_t)i * D + d] * FEATURE_SCALE : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  }

  for (int j0 = 0; j0 < N; j0 += TILE) {
    const int n_cols = min(TILE, N - j0);
    for (int k = threadIdx.x; k < TILE * D; k += THREADS) {
      fs[k] = k < n_cols * D ? fb[(size_t)j0 * D + k] * FEATURE_SCALE : 0.0f;
    }
    for (int k = threadIdx.x; k < TILE * C; k += THREADS) {
      vs[k] = k < n_cols * C ? vb[(size_t)j0 * C + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int t = 0; t < TILE; ++t) {
      float kf[D];
      float kv[C];
#pragma unroll
      for (int d = 0; d < D; ++d) kf[d] = fs[t * D + d];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = vs[t * C + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float d2 = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float diff = q[r][d] - kf[d];
          d2 = fmaf(diff, diff, d2);
        }
        const float k = exp2f(-d2);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(k, kv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = row0 + r * THREADS;
    if (i < N) {
      float* dst = out + ((size_t)b * N + i) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c] = acc[r][c];
    }
  }
}

template <int D, int C>
void launch(const float* f, const float* v, float* out, int B, int N, cudaStream_t stream) {
  dim3 grid((N + THREADS * ROWS - 1) / (THREADS * ROWS), B);
  gaussian_filter_kernel<D, C><<<grid, THREADS, 0, stream>>>(f, v, out, N);
}

// Instantiate D in 3..5 (2 + image channels, or any feature stack of that
// width) and C in 1..4.
#define GAUSSIAN_FILTER_DISPATCH(...)                      \
  switch (D * 16 + C) {                                    \
    case 3 * 16 + 1: launch<3, 1>(__VA_ARGS__); break;     \
    case 3 * 16 + 2: launch<3, 2>(__VA_ARGS__); break;     \
    case 3 * 16 + 3: launch<3, 3>(__VA_ARGS__); break;     \
    case 3 * 16 + 4: launch<3, 4>(__VA_ARGS__); break;     \
    case 4 * 16 + 1: launch<4, 1>(__VA_ARGS__); break;     \
    case 4 * 16 + 2: launch<4, 2>(__VA_ARGS__); break;     \
    case 4 * 16 + 3: launch<4, 3>(__VA_ARGS__); break;     \
    case 4 * 16 + 4: launch<4, 4>(__VA_ARGS__); break;     \
    case 5 * 16 + 1: launch<5, 1>(__VA_ARGS__); break;     \
    case 5 * 16 + 2: launch<5, 2>(__VA_ARGS__); break;     \
    case 5 * 16 + 3: launch<5, 3>(__VA_ARGS__); break;     \
    case 5 * 16 + 4: launch<5, 4>(__VA_ARGS__); break;     \
    default: return (int)cudaErrorInvalidValue;           \
  }

}  // namespace

extern "C" {

// out (B, N, C) = the Gaussian filter of v (B, N, C) under features f (B, N, D).
// `device` is the CUDA ordinal the tensors and `stream` belong to. Returns the
// CUDA error of the launch (0 on success).
int gaussian_filter(const float* f, const float* v, float* out, int B, int N, int D, int C,
                    int device, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t s = (cudaStream_t)stream;
  GAUSSIAN_FILTER_DISPATCH(f, v, out, B, N, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
