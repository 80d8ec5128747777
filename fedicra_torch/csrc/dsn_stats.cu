// Batch moments of a 3x3 convolution's output, from its input alone: the
// statistics-only forward of a deep-supervision head (models/blocks.py
// DSNHead.advance_stats).
//
// Replaces no Pallas kernel. The JAX package's DSNHead runs in two passes,
// the batch statistics tile by tile first; where only the statistics are
// used (its contrast forwards), XLA drops the second pass under jit. This
// kernel is that first pass, written for the card: it never forms the
// conv's 512-channel output.
//
// With p the zero-padded 3x3 patch at a pixel (K = 9 C entries, ordered as
// the conv weight's (C, 3, 3)), M = B H W pixels, mu the patch mean and
// G = sum_m (p_m - mu)(p_m - mu)^T the centred patch Gram matrix, output
// channel o with weights w_o and bias b_o has
//     mean_o = w_o . mu + b_o,       var_o = w_o^T G w_o / M   (biased).
// The input is staged shifted by its channel mean m_c (rounded to fp32),
// so the Gram is accumulated about m instead of mu, and corrected exactly:
//     G = G_m - M d d^T,  d = mu - m,  so  var_o = w_o^T G_m w_o / M - (w_o . d)^2.
//
// Launches, in order (the wrapper, ops/dsn_stats_cuda.py, may sum the tap
// sums and the Gram over a data group between them):
//   dsn_tap_sums  - dsn_plane_sums_kernel: each (image, channel) plane's nine
//                   tap sums in fp64 (the plane's sum less its border rows
//                   and columns); the grid's last block sums them over the
//                   batch, in image order (it finds itself by a counter in
//                   the scratch, which it leaves at zero).
//   dsn_gram      - dsn_gram_kernel: a block takes one pair of 16-channel
//                   groups and one band of rows of one image; a thread takes
//                   one pair of input channels (a, b) and accumulates their
//                   9 x 9 block of G_m in fp32 FFMA over the band, sliding a
//                   3 x 3 window of each channel along staged rows in shared
//                   memory (6 shared loads for 81 FMAs a pixel). Tiles of 4
//                   rows x 32 columns (and their halo) are staged by
//                   asynchronous copies (cp.async) into two buffers, the next
//                   while this one is summed; each block writes its partial
//                   tiles. dsn_gram_sum_kernel: each entry of G_m summed over
//                   the bands in a fixed order in fp64.
//   dsn_moments   - dsn_moments_kernel: the quadratic forms and means in
//                   fp64, 4 output channels a block (their weight rows in
//                   shared memory); the running mean and variance advanced in
//                   place (momentum, biased variance, as BatchNorm does) when
//                   given.
// Nothing is read back to the host.
//
// Bound: operations. The least work is the patch Gram's distinct entries:
// G is block-Toeplitz, each 9 x 9 block (a, b) made of the 25 lag
// correlations of channels a and b (13 where a = b, by symmetry) over the
// image, less border rows and columns. This kernel forms all 81 entries of
// each block instead, about 3x that (81 FFMA a pixel a channel pair); a
// diagonal group pair's 136 threads compute all 81 entries of an (a, a)
// block, and every group pair is padded to 16 channels.

#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 16;                             // input channels in a channel group
constexpr int TAPS = 9;
constexpr int ENTRIES = TAPS * TAPS;                  // a channel pair's block of G
constexpr int COLS = 32;                              // output columns a staged tile
constexpr int ROWS = 4;                               // output rows a staged tile
constexpr int SROW = COLS + 2;                        // a staged row, with its halo
constexpr int SCH = (ROWS + 2) * SROW + 1;            // a staged channel; odd, so 16 channels hit 16 banks
constexpr int PAIR_THREADS = GROUP * GROUP;           // an off-diagonal group pair's channel pairs
constexpr int DIAG_PAIRS = GROUP * (GROUP + 1) / 2;   // a diagonal group pair's (a <= b)
constexpr int DIAG_THREADS = 160;                     // DIAG_PAIRS in whole warps
constexpr int GRAM_SMEM = 2 * 2 * GROUP * SCH * (int)sizeof(float);  // two staged tiles
constexpr int PLANE_THREADS = 1024;
constexpr int SUM_THREADS = 256;
constexpr int MOMENT_CHANNELS = 4;                    // output channels a moments block
constexpr int MOMENT_THREADS = 256;

// the group pair gp of (ga <= gb), enumerated (0,0), (0,1), ..., (0,g-1), (1,1), ...
__device__ __forceinline__ void group_pair(int gp, int groups, int& ga, int& gb) {
    ga = 0;
    while (gp >= groups - ga) {
        gp -= groups - ga;
        ++ga;
    }
    gb = ga + gp;
}

// thread t's channel pair, as indices into the block's staged channels
// (diagonal: 16 of group ga, la <= lb; otherwise ga's 16, then gb's 16)
__device__ __forceinline__ bool block_pair(bool diag, int t, int& la, int& lb) {
    if (!diag) {
        la = t / GROUP;
        lb = GROUP + t % GROUP;
        return true;
    }
    if (t >= DIAG_PAIRS) return false;
    la = 0;
    while (t >= GROUP - la) {
        t -= GROUP - la;
        ++la;
    }
    lb = la + t;
    return true;
}

__device__ __forceinline__ int stage_channel(int ch, int ga, int gb) {
    return (ch < GROUP ? ga : gb) * GROUP + ch % GROUP;
}

// channel c's shift: its mean over the batch (the centre tap's), in fp32
__device__ __forceinline__ float channel_shift(const double* tap, int c, double count) {
    return (float)(tap[c * TAPS + 4] / count);
}

__device__ __forceinline__ double warp_sum(double v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// After each block has written its results: true in the grid's last block
// to arrive, which then reads them all (by __ldcg, past L1); it leaves the
// counter at zero for the next launch.
__device__ __forceinline__ bool last_block(unsigned* counter) {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
        last = atomicAdd(counter, 1u) == blocks - 1;
        if (last) *counter = 0u;
    }
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// grid (C, B); plane: B * C * 9 doubles, tap: C * 9 doubles
__global__ void __launch_bounds__(PLANE_THREADS)
dsn_plane_sums_kernel(const float* __restrict__ x, int B, int C, int H, int W, double* __restrict__ plane,
                      double* __restrict__ tap, unsigned* __restrict__ counter) {
    const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const float* p = x + ((size_t)b * C + c) * H * W;
    // the plane, its first and last row, its first and last column
    double s[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    for (int i = t; i < H * W; i += PLANE_THREADS) {
        const int r = i / W, col = i - r * W;
        const double v = p[i];
        s[0] += v;
        if (r == 0) s[1] += v;
        if (r == H - 1) s[2] += v;
        if (col == 0) s[3] += v;
        if (col == W - 1) s[4] += v;
    }
    __shared__ double red[5][PLANE_THREADS / 32];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const double v = warp_sum(s[k]);
        if (t % 32 == 0) red[k][t / 32] = v;
    }
    __syncthreads();
    if (t < TAPS) {
        double sum[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
        for (int k = 0; k < 5; ++k)
            for (int wp = 0; wp < PLANE_THREADS / 32; ++wp) sum[k] += red[k][wp];
        // tap (dy, dx) reads x[i + dy - 1][j + dx - 1]: dy = 0 never reads
        // the last row, dy = 2 never the first; the same for columns
        const int dy = t / 3, dx = t % 3;
        double v = sum[0];
        if (dy == 0) v -= sum[2];
        if (dy == 2) v -= sum[1];
        if (dx == 0) v -= sum[4];
        if (dx == 2) v -= sum[3];
        // a corner left out twice
        if (dy != 1 && dx != 1) v += p[(dy == 0 ? H - 1 : 0) * W + (dx == 0 ? W - 1 : 0)];
        plane[((size_t)b * C + c) * TAPS + t] = v;
    }
    if (!last_block(counter)) return;
    for (int k = t; k < C * TAPS; k += PLANE_THREADS) {
        double v = 0.0;
#pragma unroll 4
        for (int i = 0; i < B; ++i) v += __ldcg(plane + (size_t)i * C * TAPS + k);
        tap[k] = v;
    }
}

// One output pixel: staged column s + 2 of each channel into window slot
// (Q + 2) % 3, then the 81 products of a's and b's 3 x 3 windows, whose
// column dx sits in slot (Q + dx) % 3 (Q = s % 3, known at compile time).
template <int Q>
__device__ __forceinline__ void accumulate_pixel(float (&acc)[ENTRIES], float (&wa)[3][3],
                                                 float (&wb)[3][3], const float* pa, const float* pb) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
        wa[(Q + 2) % 3][dy] = pa[dy * SROW + 2];
        wb[(Q + 2) % 3][dy] = pb[dy * SROW + 2];
    }
#pragma unroll
    for (int i = 0; i < TAPS; ++i) {
        const float va = wa[(Q + i % 3) % 3][i / 3];
#pragma unroll
        for (int j = 0; j < TAPS; ++j)
            acc[i * TAPS + j] = fmaf(va, wb[(Q + j % 3) % 3][j / 3], acc[i * TAPS + j]);
    }
}

// acc[i * 9 + j] += (a's tap i) (b's tap j) over one staged row's ncols
// output pixels; pa and pb point at the row's top-left staged value of each
// channel. Staged column q sits in window slot q % 3; the loop body takes
// three pixels, so the slots are fixed in it and the body stays small.
__device__ __forceinline__ void accumulate_row(float (&acc)[ENTRIES], const float* pa,
                                               const float* pb, int ncols) {
    float wa[3][3], wb[3][3];  // [slot][dy]
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            wa[q][dy] = pa[dy * SROW + q];
            wb[q][dy] = pb[dy * SROW + q];
        }
    }
#pragma unroll 1
    for (int s = 0; s < ncols; s += 3) {
        accumulate_pixel<0>(acc, wa, wb, pa + s, pb + s);
        if (s + 1 < ncols) accumulate_pixel<1>(acc, wa, wb, pa + s + 1, pb + s + 1);
        if (s + 2 < ncols) accumulate_pixel<2>(acc, wa, wb, pa + s + 2, pb + s + 2);
    }
}

// 4 bytes from device memory into shared memory without registers (zeros
// where !valid), in the current group of asynchronous copies
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void copy_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

constexpr int STAGED = (ROWS + 2) * SROW;  // a staged channel's values, its padding aside

// Tile k of the block's band into buf: rows r0 - 1 .. r0 + ROWS and columns
// c0 - 1 .. c0 + COLS of each staged channel, zeros outside the image and
// past C (the shift is taken off once they land, by shift_tile).
__device__ __forceinline__ void stage_tile(float* buf, const float* x, const float* xb, int k, int r_begin,
                                           int col_tiles, int nstage, int ga, int gb, int C, int H, int W) {
    const int r0 = r_begin + (k / col_tiles) * ROWS, c0 = (k % col_tiles) * COLS;
    for (int i = threadIdx.x; i < nstage * STAGED; i += blockDim.x) {
        const int ch = i / STAGED, rem = i - ch * STAGED;
        const int rr = rem / SROW, cc = rem - rr * SROW;
        const int c = stage_channel(ch, ga, gb);
        const int gr = r0 - 1 + rr, gc = c0 - 1 + cc;
        const bool valid = c < C && gr >= 0 && gr < H && gc >= 0 && gc < W;
        copy_async(buf + ch * SCH + rem, valid ? xb + ((size_t)c * H + gr) * W + gc : x, valid);
    }
    copy_async_commit();
}

// this thread's staged elements less their channel's shift (a padded value
// becomes 0 - shift; a channel past C has shift 0 and stays 0)
__device__ __forceinline__ void shift_tile(float* buf, const float* shift, int nstage) {
    for (int i = threadIdx.x; i < nstage * STAGED; i += blockDim.x) {
        const int ch = i / STAGED;
        buf[ch * SCH + i - ch * STAGED] -= shift[ch];
    }
}

// grid (B * bands, group pairs), dynamic shared memory 2 tiles (GRAM_SMEM
// bytes); partial[slice][gp][81][blockDim.x]. The next tile's copy runs
// while this one is summed.
__global__ void __launch_bounds__(PAIR_THREADS, 2)
dsn_gram_kernel(const float* __restrict__ x, const double* __restrict__ tap, double count,
                int C, int H, int W, int band_rows, int bands, float* __restrict__ partial) {
    extern __shared__ float stage[];  // [2][2 * GROUP * SCH]
    __shared__ float shift[2 * GROUP];
    const int t = threadIdx.x, groups = (C + GROUP - 1) / GROUP;
    const int slice = blockIdx.x, gp = blockIdx.y;
    int ga, gb;
    group_pair(gp, groups, ga, gb);
    const bool diag = ga == gb;
    const int nstage = diag ? GROUP : 2 * GROUP;
    int la = 0, lb = 0;
    const bool active = block_pair(diag, t, la, lb);
    if (t < nstage) {
        const int c = stage_channel(t, ga, gb);
        shift[t] = c < C ? channel_shift(tap, c, count) : 0.0f;
    }
    const int b = slice / bands;
    const int r_begin = (slice % bands) * band_rows;
    const int r_end = min(H, r_begin + band_rows);
    const int col_tiles = (W + COLS - 1) / COLS;
    const int tiles = (r_end - r_begin + ROWS - 1) / ROWS * col_tiles;
    const float* xb = x + (size_t)b * C * H * W;
    float acc[ENTRIES];
#pragma unroll
    for (int e = 0; e < ENTRIES; ++e) acc[e] = 0.0f;
    stage_tile(stage, x, xb, 0, r_begin, col_tiles, nstage, ga, gb, C, H, W);
    for (int k = 0; k < tiles; ++k) {
        float* buf = stage + (k & 1) * 2 * GROUP * SCH;
        copy_async_wait_all();
        __syncthreads();  // the shifts written; every thread done with tile k - 1
        shift_tile(buf, shift, nstage);
        __syncthreads();  // tile k complete
        if (k + 1 < tiles)
            stage_tile(stage + ((k + 1) & 1) * 2 * GROUP * SCH, x, xb, k + 1, r_begin, col_tiles, nstage,
                       ga, gb, C, H, W);
        if (active) {
            const int r0 = r_begin + (k / col_tiles) * ROWS, c0 = (k % col_tiles) * COLS;
            const int nrows = min(ROWS, r_end - r0), ncols = min(COLS, W - c0);
            for (int rr = 0; rr < nrows; ++rr)
                accumulate_row(acc, buf + la * SCH + rr * SROW, buf + lb * SCH + rr * SROW, ncols);
        }
    }
    if (active) {
        float* out = partial + ((size_t)slice * gridDim.y + gp) * ENTRIES * blockDim.x + t;
#pragma unroll
        for (int e = 0; e < ENTRIES; ++e) out[(size_t)e * blockDim.x] = acc[e];
    }
}

// G_m[k1][k2] (both halves) = the sum over slices of its partial, in slice order
__global__ void dsn_gram_sum_kernel(const float* __restrict__ partial, int C, int slices,
                                    int threads, double* __restrict__ G) {
    const int groups = (C + GROUP - 1) / GROUP, ngp = groups * (groups + 1) / 2;
    const size_t per_slice = (size_t)ngp * ENTRIES * threads;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= per_slice) return;
    const int t = (int)(idx % threads);
    const int e = (int)(idx / threads % ENTRIES);
    const int gp = (int)(idx / ((size_t)threads * ENTRIES));
    int ga, gb, la, lb;
    group_pair(gp, groups, ga, gb);
    if (!block_pair(ga == gb, t, la, lb)) return;
    const int a = stage_channel(la, ga, gb), b = stage_channel(lb, ga, gb);
    const int i = e / TAPS, j = e % TAPS;
    if (a >= C || b >= C || (a == b && i > j)) return;
    double s = 0.0;
    for (int k = 0; k < slices; ++k) s += partial[k * per_slice + idx];
    const size_t K = (size_t)C * TAPS;
    const size_t k1 = (size_t)a * TAPS + i, k2 = (size_t)b * TAPS + j;
    G[k1 * K + k2] = s;
    G[k2 * K + k1] = s;
}

// grid ceil(O / 4), dynamic shared memory 4 K doubles (the block's weight rows)
__global__ void __launch_bounds__(MOMENT_THREADS)
dsn_moments_kernel(const double* __restrict__ G, const double* __restrict__ tap,
                   const float* __restrict__ w, const float* __restrict__ bias, int O, int C,
                   double count, float momentum, float* __restrict__ running_mean,
                   float* __restrict__ running_var, double* __restrict__ mean_out,
                   double* __restrict__ var_out) {
    constexpr int M = MOMENT_CHANNELS;
    extern __shared__ double wsh[];  // [M][K]
    const int K = C * TAPS, o0 = blockIdx.x * M, t = threadIdx.x;
    for (int i = t; i < M * K; i += MOMENT_THREADS)
        wsh[i] = (double)w[(size_t)min(o0 + i / K, O - 1) * K + i % K];
    __syncthreads();
    // per output channel: w^T G_m w, w . mu, w . d
    double q[M], m1[M], wd[M];
#pragma unroll
    for (int c = 0; c < M; ++c) q[c] = m1[c] = wd[c] = 0.0;
    for (int k2 = t; k2 < K; k2 += MOMENT_THREADS) {
        double y[M];
#pragma unroll
        for (int c = 0; c < M; ++c) y[c] = 0.0;
#pragma unroll 8
        for (int k1 = 0; k1 < K; ++k1) {
            const double g = G[(size_t)k1 * K + k2];
#pragma unroll
            for (int c = 0; c < M; ++c) y[c] += g * wsh[c * K + k1];
        }
        const double mu = tap[k2] / count;
        const double d = mu - (double)channel_shift(tap, k2 / TAPS, count);
#pragma unroll
        for (int c = 0; c < M; ++c) {
            const double wk = wsh[c * K + k2];
            q[c] += wk * y[c];
            m1[c] += wk * mu;
            wd[c] += wk * d;
        }
    }
    __shared__ double red[MOMENT_THREADS / 32][3 * M];
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int c = 0; c < M; ++c) {
        const double a = warp_sum(q[c]), b = warp_sum(m1[c]), d = warp_sum(wd[c]);
        if (lane == 0) {
            red[warp][c] = a;
            red[warp][M + c] = b;
            red[warp][2 * M + c] = d;
        }
    }
    __syncthreads();
    if (t < M && o0 + t < O) {
        double sq = 0.0, sm = 0.0, sd = 0.0;
        for (int k = 0; k < MOMENT_THREADS / 32; ++k) {
            sq += red[k][t];
            sm += red[k][M + t];
            sd += red[k][2 * M + t];
        }
        const int o = o0 + t;
        const double mean = sm + (bias != nullptr ? (double)bias[o] : 0.0);
        const double var = fmax(sq / count - sd * sd, 0.0);
        mean_out[o] = mean;
        var_out[o] = var;
        if (running_mean != nullptr) {
            running_mean[o] = running_mean[o] * (1.0f - momentum) + momentum * (float)mean;
            running_var[o] = running_var[o] * (1.0f - momentum) + momentum * (float)var;
        }
    }
}

}  // namespace

extern "C" {

// the gram kernel's block size for C input channels
int dsn_gram_threads(int C) { return C <= GROUP ? DIAG_THREADS : PAIR_THREADS; }

// Once a device, before any launch: the gram kernel's shared-memory limit
// raised to its two staged tiles; blocks: its resident blocks on one SM at
// that block size.
int dsn_prepare(int threads, int* blocks) {
    const cudaError_t err = cudaFuncSetAttribute(dsn_gram_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, GRAM_SMEM);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dsn_gram_kernel, threads, GRAM_SMEM);
}

// plane: B * C * 9 doubles of scratch; tap: C * 9 doubles out; counter: a
// zero in device memory, left at zero
int dsn_tap_sums(const float* x, double* plane, double* tap, unsigned* counter, int B, int C, int H, int W,
                 void* stream) {
    dsn_plane_sums_kernel<<<dim3(C, B), PLANE_THREADS, 0, (cudaStream_t)stream>>>(x, B, C, H, W, plane, tap,
                                                                                  counter);
    return (int)cudaGetLastError();
}

// partial: B * bands * group pairs * 81 * dsn_gram_threads(C) floats of
// scratch; G: (9 C)^2 doubles out; count: the pixels the tap sums cover
// (dsn_prepare first)
int dsn_gram(const float* x, const double* tap, double count, float* partial, double* G,
             int B, int C, int H, int W, int band_rows, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int groups = (C + GROUP - 1) / GROUP, ngp = groups * (groups + 1) / 2;
    const int bands = (H + band_rows - 1) / band_rows, threads = dsn_gram_threads(C);
    dsn_gram_kernel<<<dim3(B * bands, ngp), threads, GRAM_SMEM, s>>>(x, tap, count, C, H, W, band_rows,
                                                                     bands, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t entries = (size_t)ngp * ENTRIES * threads;
    dsn_gram_sum_kernel<<<(unsigned)((entries + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0, s>>>(
        partial, C, B * bands, threads, G);
    return (int)cudaGetLastError();
}

// mean_out, var_out: O doubles; running_mean / running_var: O floats
// advanced in place, or both null
int dsn_moments(const double* G, const double* tap, const float* w, const float* bias, int O, int C,
                double count, float momentum, float* running_mean, float* running_var,
                double* mean_out, double* var_out, void* stream) {
    const size_t smem = (size_t)MOMENT_CHANNELS * C * TAPS * sizeof(double);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(dsn_moments_kernel,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dsn_moments_kernel<<<(O + MOMENT_CHANNELS - 1) / MOMENT_CHANNELS, MOMENT_THREADS, smem,
                         (cudaStream_t)stream>>>(G, tap, w, bias, O, C, count, momentum, running_mean,
                                                 running_var, mean_out, var_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
