// Exact Gaussian kernel filter (dense-CRF message passing) for sm_90a, with
// the exponents on the tensor cores.
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
// Bound on the H100 SXM at the dense-CRF shape beside the headline config
// (B = 12, N = 192^2 = 36864, D = 5, C = 3): 1.63e10 ordered pairs a launch.
// The function's least fp32 work (each unordered pair's exponent once from
// per-point norms, C FMAs per ordered pair) over 67 TFLOP/s is 2.7991 ms
// (tools/kernel_times.py gaussian_filter_work), bound by operations. Its exps run on
// the special-function units, 16 per SM per clock: one per ordered pair, as
// this kernel takes them, is 3.9 ms at 1.98 GHz and 4.4 ms at 1.75 GHz, the
// floor of this design. The first design formed every pair's direct
// distance on the FP32 pipe (~17 issue slots a pair) and ran 12.4-13.0 ms
// per call on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit; this
// design's times on that card are in PERF.md, kernel row 3.
//
// Design. What the FP32 pipe did per pair moves to the tensor cores and the
// special-function units:
// - The exponent is a product of depth 8 on augmented operands,
//     A_i = [L g_i, -L/2 |g_i|^2, 1, 0..],  B_j = [g_j, 1, -L/2 |g_j|^2, 0..],
//   g = f - (the mean feature of the block's query rows), L = log2(e), so
//   A_i.B_j = -L/2 |f_i - f_j|^2. Plain TF32 loses ~1e-2 of a weight where
//   |f|^2 ~ 900, so each operand is split into hi and lo, each rounded to
//   TF32 (~22 bits together), and the exponent is hi.hi + hi.lo + lo.hi:
//   three wgmma.m64n64k8 TF32 products, A (64 query rows) from registers and
//   B (64 columns) from shared memory. Centring keeps the terms that cancel
//   small; distances do not change under translation. The operands keep
//   their own rounding out of the split (L g by an FMA, the norms in
//   double): on white pixels the hardware's sums need that.
// - The weight is one ex2.approx.ftz (MUFU.EX2), log2(e) being folded into A.
// - The value sums stay on the FP32 pipe, C FMAs a pair in full fp32. P.V
//   as one TF32 product of rounded P and v misses rtol 1e-4 (the CPU
//   emulation shows it), so it would take P and v both split, and a design
//   that ran those products and the exponent's by mma.sync was slower than
//   this one on the card (PERF.md).
// tests/test_torch_gaussian_numerics.py emulates this arithmetic.
//
// Layout. A block of WARPGROUPS warpgroups owns ROWS = 64 GROUPS WARPGROUPS
// query rows of one image (256 by default), each warpgroup GROUPS 64-row A
// operands in registers. The block streams the image's columns in tiles of
// TILE, one column per thread: each thread loads its column's raw f and v
// into registers a tile ahead, then writes the split operands into a
// double-buffered shared tile in the no-swizzle K-major core-matrix order
// that wgmma reads (8 columns x 4 k a core matrix: 128 B along k, 256 B per
// 8 columns). Each thread's accumulator holds rows g, g + 8 of its warp's 16
// in each group and columns 8j + 2t, 8j + 2t + 1 of each 64; it sums exp2
// times v over its columns in fp32, and the four lanes of a row add theirs
// at the end. Columns past N are staged as f = 0, v = 0 and add exact zeros
// (their weights are finite); rows past N are not stored.
//
// Waves. Every block takes the same time, so a last partial wave that puts
// two blocks on any SM costs a whole wave (B = 12 at N = 192^2: 1728 blocks
// over 264 slots, 6.5 waves run as 7). launch() runs the images that fill
// whole waves as whole blocks, then splits the columns of the last few
// images into equal shares, a block each, chosen by plan() to fill whole
// waves of short blocks (there: 11 images in 6 waves, then the 12th in 11
// shares of 13-14 tiles, 6 more waves, each 1/11 as long). The shares go to
// a workspace and combine_shares adds them in share order. No atomics and a
// fixed order everywhere, so a call is bit-reproducible on a given card
// (the plan depends on its SM count).
//
// ptxas for <5, 3> (ops/_build.py build_all's report): 128 registers, 41120 bytes
// of static shared memory, two blocks (16 warps) per SM; the whole blocks
// spill 24 bytes and reload 32 (one reload a tile in the main loop), the
// shares 12 and 12. Tilings that take fewer registers, or pipeline the
// products across groups, spilled more and ran slower.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPGROUPS = 2;  // warpgroups per block, sharing the staged columns
constexpr int GROUPS = 2;      // 64-row groups of query rows per warpgroup
constexpr int MIN_BLOCKS = 2;  // blocks per SM that the register budget must allow
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int ROWS = 64 * GROUPS * WARPGROUPS;  // query rows per block, 64 (m of m64n64k8) a group
constexpr int TILE = THREADS;                   // columns per tile, one per thread when staged
constexpr int SUB = 64;                         // columns per product (n of m64n64k8)
constexpr uint32_t K_BYTES = 128;  // between the two 4-k core matrices of 8 columns
constexpr uint32_t N_BYTES = 256;  // between core matrices of consecutive 8 columns
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;  // device ordinals whose block capacity is cached

struct __align__(128) Tile {
  float b_hi[TILE * 8];  // B operand, hi part, in core-matrix order (core_index)
  float b_lo[TILE * 8];  // lo part
  float4 v[TILE];        // values, C of 4 used
};

// Position of (column j, depth k) of a tile's B operand.
__device__ __forceinline__ int core_index(int j, int k) {
  return ((j >> 3) * 2 + (k >> 2)) * 32 + (j & 7) * 4 + (k & 3);
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero: on
// the integer pipe, not the conversion unit that the exps share.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// hi = tf32_rna(x), lo = tf32_rna(x - hi): x to ~22 bits in two TF32 parts.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// -L/2 |g|^2 to ~22 bits in two TF32 parts, the norm summed in double.
template <int D>
__device__ __forceinline__ void split_half_norm(const float (&g)[D], float& hi, float& lo) {
  double norm = 0.0;
#pragma unroll
  for (int d = 0; d < D; ++d) norm = fma((double)g[d], (double)g[d], norm);
  const double x = -0.5 * (double)LOG2E * norm;
  hi = tf32_rna((float)x);
  lo = tf32_rna((float)(x - (double)hi));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Shared-memory descriptor of 64 columns of B: no swizzle, K-major.
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(K_BYTES >> 4) << 16) |
         ((uint64_t)(N_BYTES >> 4) << 32);
}

// d (64 x 64) = [d +] a (64 x 8, registers) . b (8 x 64, shared memory), TF32 with fp32 sums
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const float (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc), "r"(accumulate));
}

// Element k (run-time, 0..7) of an unrolled array, without local memory.
__device__ __forceinline__ float pick(const float (&x)[8], int k) {
  float r = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) r = (i == k) ? x[i] : r;
  return r;
}

template <int D, int C>
__device__ __forceinline__ void load_column(const float* __restrict__ fb, const float* __restrict__ vb,
                                            int j, int N, float (&fr)[D], float (&vr)[C]) {
  const bool in = j < N;
#pragma unroll
  for (int d = 0; d < D; ++d) fr[d] = in ? __ldg(fb + (size_t)j * D + d) : 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) vr[c] = in ? __ldg(vb + (size_t)j * C + c) : 0.0f;
}

// Write column p of the tile (raw features fr, values vr), centred on mu:
// B = [g, 1, -L/2 |g|^2, 0..], each entry as hi and lo.
template <int D, int C>
__device__ __forceinline__ void stage_column(Tile& tile, int p, const float (&fr)[D],
                                             const float (&vr)[C], const float (&mu)[D]) {
  float g[D], hi[8], lo[8];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    g[d] = fr[d] - mu[d];
    split(g[d], hi[d], lo[d]);
  }
  hi[D] = 1.0f;
  lo[D] = 0.0f;
  split_half_norm(g, hi[D + 1], lo[D + 1]);
#pragma unroll
  for (int k = D + 2; k < 8; ++k) hi[k] = lo[k] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += 4) {
    const int at = core_index(p, k0);
    *reinterpret_cast<float4*>(&tile.b_hi[at]) = make_float4(hi[k0], hi[k0 + 1], hi[k0 + 2], hi[k0 + 3]);
    *reinterpret_cast<float4*>(&tile.b_lo[at]) = make_float4(lo[k0], lo[k0 + 1], lo[k0 + 2], lo[k0 + 3]);
  }
  float vq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < C; ++c) vq[c] = vr[c];
  tile.v[p] = make_float4(vq[0], vq[1], vq[2], vq[3]);
  // make the generic-proxy stores visible to the products, which read through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d[m] = the exponents of group m's 64 rows against columns 64 sub .. 64 sub + 63
// of the tile, hi.hi + hi.lo + lo.hi, then waited for. hi.hi goes first: its
// large terms cancel to the small exponent while the sum holds only them,
// and the corrections then join that small sum, so aligning the addends to
// the largest does not cut the corrections' low bits.
template <int G>
__device__ __forceinline__ void exponents(float (&d)[G][32], const float (&a_hi)[G][4],
                                          const float (&a_lo)[G][4], const Tile& tile, int sub) {
  const uint64_t hi = b_desc(tile.b_hi + sub * SUB * 8), lo = b_desc(tile.b_lo + sub * SUB * 8);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int m = 0; m < G; ++m) {
    wgmma_tf32(d[m], a_hi[m], hi, 0);
    wgmma_tf32(d[m], a_hi[m], lo, 1);
    wgmma_tf32(d[m], a_lo[m], hi, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int m = 0; m < G; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[m][i])::"memory");
}

// acc[h][c] += sum over this lane's columns of exp2(d) v[c]: d[4 j + 2 h + e]
// is (row g + 8 h, column 8 j + 2 t + e) of the product.
template <int C>
__device__ __forceinline__ void accumulate(const float (&d)[32], const Tile& tile, int sub, int t,
                                           float (&acc)[2][C]) {
#pragma unroll
  for (int j = 0; j < SUB / 8; ++j) {
    const float4 v0 = tile.v[sub * SUB + 8 * j + 2 * t], v1 = tile.v[sub * SUB + 8 * j + 2 * t + 1];
    const float vx[2][4] = {{v0.x, v0.y, v0.z, v0.w}, {v1.x, v1.y, v1.z, v1.w}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = fast_exp2(d[4 * j + 2 * h]), p1 = fast_exp2(d[4 * j + 2 * h + 1]);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[h][c] = fmaf(p1, vx[1][c], fmaf(p0, vx[0][c], acc[h][c]));
    }
  }
}

// Block (x, y, z): query rows ROWS x .. of image b_first + y. PART false:
// against every column, sums to out (B, N, C). PART true: against share z
// of gridDim.z equal shares of the column tiles, sums to out = the
// workspace (gridDim.z, gridDim.y, N, C), for combine_shares to add.
template <int D, int C, bool PART>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gaussian_filter_kernel(const float* __restrict__ f, const float* __restrict__ v,
                       float* __restrict__ out, int N, int b_first) {
  __shared__ Tile tiles[2];
  __shared__ float partial[THREADS / 32][D];

  const int b = b_first + blockIdx.y;
  const float* fb = f + (size_t)b * N * D;
  const float* vb = v + (size_t)b * N * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the first row of this warp's 16 in each of its warpgroup's 64-row groups
  const int warp_row0 = (warp >> 2) * GROUPS * 64 + (warp & 3) * 16;
  const int row0 = blockIdx.x * ROWS;
  const int n_rows = min(ROWS, N - row0);

  // the mean feature of the block's rows, summed in a fixed order
  float mu[D];
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = 0.0f;
  for (int r = tid; r < n_rows; r += THREADS) {
#pragma unroll
    for (int d = 0; d < D; ++d) mu[d] += fb[(size_t)(row0 + r) * D + d];
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mu[d] += __shfl_xor_sync(0xffffffffu, mu[d], o);
    if (lane == 0) partial[warp][d] = mu[d];
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += partial[w][d];
    mu[d] = s / (float)n_rows;
  }

  // A fragments of each 64-row group: a0 = (row 16 warp + g, k = t),
  // a1 = (+8, t), a2 = (+0, t + 4), a3 = (+8, t + 4)
  float a_hi[GROUPS][4], a_lo[GROUPS][4];
#pragma unroll
  for (int m = 0; m < GROUPS; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + warp_row0 + m * 64 + g + 8 * h;
      // A = [L g, -L/2 |g|^2, 1, 0..]; L g = p + e exactly (e by an FMA)
      float g_i[D], hi[8], lo[8];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        g_i[d] = i < N ? fb[(size_t)i * D + d] - mu[d] : 0.0f;
        const float p = LOG2E * g_i[d], e = fmaf(LOG2E, g_i[d], -p);
        hi[d] = tf32_rna(p);
        lo[d] = tf32_rna((p - hi[d]) + e);
      }
      split_half_norm(g_i, hi[D], lo[D]);
      hi[D + 1] = 1.0f;
      lo[D + 1] = 0.0f;
#pragma unroll
      for (int k = D + 2; k < 8; ++k) hi[k] = lo[k] = 0.0f;
      a_hi[m][h] = pick(hi, t);
      a_hi[m][2 + h] = pick(hi, t + 4);
      a_lo[m][h] = pick(lo, t);
      a_lo[m][2 + h] = pick(lo, t + 4);
    }
  }

  // sums of rows g (h = 0) and g + 8 (h = 1) of each group over this lane's columns
  float acc[GROUPS][2][C];
#pragma unroll
  for (int m = 0; m < GROUPS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[m][h][c] = 0.0f;

  // Tile k + 1 is staged from registers loaded a tile earlier; the other
  // blocks on the SM take their exps while this one waits on its products.
  const int n_tiles = (N + TILE - 1) / TILE;
  const int t0 = PART ? blockIdx.z * n_tiles / gridDim.z : 0;
  const int t1 = PART ? (blockIdx.z + 1) * n_tiles / gridDim.z : n_tiles;
  float fr[D], vr[C];
  load_column<D, C>(fb, vb, t0 * TILE + tid, N, fr, vr);
  stage_column<D, C>(tiles[t0 & 1], tid, fr, vr, mu);
  __syncthreads();

  float d[GROUPS][32];
#pragma unroll
  for (int m = 0; m < GROUPS; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) d[m][e] = 0.0f;
  for (int tile = t0; tile < t1; ++tile) {
    const bool next = tile + 1 < t1;
    if (next) load_column<D, C>(fb, vb, (tile + 1) * TILE + tid, N, fr, vr);
    const Tile& cur = tiles[tile & 1];
#pragma unroll
    for (int sub = 0; sub < TILE / SUB; ++sub) {
      exponents(d, a_hi, a_lo, cur, sub);
#pragma unroll
      for (int m = 0; m < GROUPS; ++m) accumulate<C>(d[m], cur, sub, t, acc[m]);
    }
    // the other buffer was last read in the previous tile, before the barrier that ended it
    if (next) stage_column<D, C>(tiles[(tile + 1) & 1], tid, fr, vr, mu);
    __syncthreads();
  }

  // add the four lanes of each row (t = 0..3) in a fixed order; lane t stores channel t
#pragma unroll
  for (int m = 0; m < GROUPS; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + warp_row0 + m * 64 + g + 8 * h;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float x = acc[m][h][c];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const size_t image = PART ? (size_t)blockIdx.z * gridDim.y + blockIdx.y : (size_t)b;
        if (t == c && i < N) out[(image * N + i) * C + c] = x;
      }
    }
}

// out of images b_first .. b_first + n_images - 1 = the sum of their shares
// in the workspace, in share order.
__global__ void combine_shares(const float* __restrict__ ws, float* __restrict__ out, int shares,
                               size_t per_share, size_t first) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per_share) return;
  float x = ws[e];
  for (int s = 1; s < shares; ++s) x += ws[s * per_share + e];
  out[first + e] = x;
}

// How a call splits its work. Blocks of whole images run in waves of
// `slots` (the blocks the card holds at once); the last `split` images,
// where they leave a partial wave, run instead in `shares` shares of the
// columns each, chosen to fill whole waves as nearly as they can.
struct Plan {
  int split = 0, shares = 1;
};

template <int D, int C>
cudaError_t plan(int B, int N, int device, Plan& p) {
  static int slots_of[MAX_DEVICES];  // per device ordinal, 0 until first asked
  long long slots = device < MAX_DEVICES ? slots_of[device] : 0;
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gaussian_filter_kernel<D, C, false>,
                                                          THREADS, 0);
    if (err != cudaSuccess) return err;
    if (sms * per_sm == 0) return cudaErrorInvalidConfiguration;
    slots = (long long)sms * per_sm;
    if (device < MAX_DEVICES) slots_of[device] = (int)slots;
  }
  const long long per_image = (N + ROWS - 1) / ROWS;
  const int n_tiles = (N + TILE - 1) / TILE;
  // waves of whole blocks, in units of one block's time
  double best = (double)((B * per_image + slots - 1) / slots);
  p = Plan{};
  // split no more images than two waves hold: the partial wave's are among
  // them, and it bounds the workspace
  for (int k = 1; k <= B && k * per_image <= 2 * slots; ++k)
    for (int s = 2; s <= 16 && s <= n_tiles; ++s) {
      const double waves = (double)(((B - k) * per_image + slots - 1) / slots) +
                           (double)((k * per_image * s + slots - 1) / slots) / s;
      if (waves < best - 1e-9) best = waves, p.split = k, p.shares = s;
    }
  return cudaSuccess;
}

template <int D, int C>
long long workspace(int B, int N, int device) {
  Plan p;
  if (plan<D, C>(B, N, device, p) != cudaSuccess) return -1;
  return (long long)p.split * p.shares * N * C;
}

template <int D, int C>
int launch(const float* f, const float* v, float* out, float* ws, int B, int N, int device,
           cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan<D, C>(B, N, device, p);
  if (err != cudaSuccess) return (int)err;
  const int per_image = (N + ROWS - 1) / ROWS, whole = B - p.split;
  if (whole > 0)
    gaussian_filter_kernel<D, C, false><<<dim3(per_image, whole), THREADS, 0, stream>>>(f, v, out, N, 0);
  if (p.split > 0) {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    gaussian_filter_kernel<D, C, true><<<dim3(per_image, p.split, p.shares), THREADS, 0, stream>>>(
        f, v, ws, N, whole);
    const size_t per_share = (size_t)p.split * N * C;
    combine_shares<<<(unsigned)((per_share + 255) / 256), 256, 0, stream>>>(ws, out, p.shares, per_share,
                                                                             (size_t)whole * N * C);
  }
  return (int)cudaGetLastError();
}

// Instantiate D in 3..5 (2 + image channels, or any feature stack of that
// width) and C in 1..4.
#define GAUSSIAN_FILTER_DISPATCH(bad, fn, ...)             \
  switch (D * 16 + C) {                                    \
    case 3 * 16 + 1: return fn<3, 1>(__VA_ARGS__);         \
    case 3 * 16 + 2: return fn<3, 2>(__VA_ARGS__);         \
    case 3 * 16 + 3: return fn<3, 3>(__VA_ARGS__);         \
    case 3 * 16 + 4: return fn<3, 4>(__VA_ARGS__);         \
    case 4 * 16 + 1: return fn<4, 1>(__VA_ARGS__);         \
    case 4 * 16 + 2: return fn<4, 2>(__VA_ARGS__);         \
    case 4 * 16 + 3: return fn<4, 3>(__VA_ARGS__);         \
    case 4 * 16 + 4: return fn<4, 4>(__VA_ARGS__);         \
    case 5 * 16 + 1: return fn<5, 1>(__VA_ARGS__);         \
    case 5 * 16 + 2: return fn<5, 2>(__VA_ARGS__);         \
    case 5 * 16 + 3: return fn<5, 3>(__VA_ARGS__);         \
    case 5 * 16 + 4: return fn<5, 4>(__VA_ARGS__);         \
    default: return bad;                                   \
  }

}  // namespace

extern "C" {

// Floats of workspace a call at (B, N, D, C) on `device` needs (0: none),
// or -1 if the shape is not taken or the card cannot be queried.
long long gaussian_filter_workspace(int B, int N, int D, int C, int device) {
  if (B <= 0 || B > 65535 || N <= 0 || cudaSetDevice(device) != cudaSuccess) return -1;
  GAUSSIAN_FILTER_DISPATCH(-1, workspace, B, N, device);
}

// out (B, N, C) = the Gaussian filter of v (B, N, C) under features f (B, N, D).
// `ws` holds gaussian_filter_workspace(B, N, D, C, device) floats (null when
// that is 0). `device` is the CUDA ordinal the tensors and `stream` belong
// to. Returns the CUDA error of the launches (0 on success).
int gaussian_filter(const float* f, const float* v, float* out, float* ws, int B, int N, int D, int C,
                    int device, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  GAUSSIAN_FILTER_DISPATCH((int)cudaErrorInvalidValue, launch, f, v, out, ws, B, N, device,
                           (cudaStream_t)stream);
}

}  // extern "C"
