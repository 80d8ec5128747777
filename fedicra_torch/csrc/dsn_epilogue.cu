// A deep-supervision head's epilogue: BatchNorm, ReLU, Dropout2d and the
// 1x1 convolution over the 3x3 convolution's output y (B, C, H, W), in
// passes over y that form none of the chain's C-channel maps
// (models/blocks.py DSNHead.forward, ops/dsn_epilogue_cuda.py).
//
// Replaces no Pallas kernel: the JAX package's DSNHead leaves the chain to
// XLA, which fuses it on the TPU. On the card the same chain was five
// PyTorch operations, each reading and writing the C-channel map, and
// autograd kept three such maps a head for the backward.
//
// With mu, rstd the batch mean and 1 / sqrt(var + eps) of a channel (or
// the running ones in eval mode), gamma, beta its affine weights, keep the
// (image, channel) Dropout2d mask, q = 1 - p and W the 1x1 weights:
//     xh = (y - mu) rstd,  u = gamma xh + beta,  r = relu(u),
//     z = (r keep) / q,    aux_k = sum_c W[k, c] z_c.
// The division by q is a product by 1 / q, as PyTorch's CUDA division by a
// scalar computes it. The backward, for g the gradient of aux and
// M = B H W pixels (the whole client batch's under a data shard):
//     du = [u > 0] keep (sum_k W[k, c] g_k) / q
//     dW[k, c] = sum g_k z_c,  dbeta = sum du,  dgamma = sum du xh
//     dy = gamma rstd (du - dbeta / M - xh dgamma / M)     (train mode)
//     dy = gamma rstd du                                   (eval mode)
//
// Launches, in order (the wrapper may sum the per-channel sums over a data
// group between them):
//   forward, train mode only:
//     dsn_epilogue_plane_moments_kernel - each (image, channel) plane's sum
//         and sum of squares in fp64, a block a plane, in a fixed order;
//     dsn_epilogue_moments_kernel - those summed over the images in order;
//         then mu, rstd and the running buffers (BatchNorm's rule: momentum,
//         biased variance);
//   forward: dsn_epilogue_forward_kernel - a block takes 256 pixels of one
//         image; its 8 warps take every 8th group of 4 channels, a lane 8
//         pixels as two 16-byte loads a channel (a channel the mask drops is
//         not read: it adds W 0); each lane sums its pixels' aux over its
//         channels in registers, then the warps' sums are added in warp
//         order through shared memory. Only aux is written.
//   backward:
//     dsn_epilogue_backward_kernel<false> (pass A) - a block takes 2,048
//         pixels of one image and 128 channels; g's tile is staged in shared
//         memory once for them; a warp takes every 8th channel, a lane 64
//         pixels in 4 rounds of four 16-byte loads; per channel the tile's
//         K + 2 sums (dW, dbeta, dgamma) in fp32, summed over the warp;
//     dsn_epilogue_grad_sums_kernel - those summed over the tiles in fp64,
//         in a fixed order; the parameters' gradients in fp32;
//     dsn_epilogue_backward_kernel<true> (pass B) - the same tiles, dy.
// No float atomics anywhere: two launches on the same input give the same
// bits. Nothing is read back to the host.
//
// Bound: bytes. The forward reads y twice in train mode (statistics, then
// the chain) and once in eval mode; the backward reads y twice and writes
// dy. g, aux and the per-channel values are ~1% of y at 512 channels.
// Each pass keeps 16-byte loads of several channels or rounds in flight on
// every lane, so that an SM has tens of kilobytes of loads outstanding.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // every block but the moments kernel's
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLASSES = 4;
constexpr int MAX_CHANNELS = 1024;  // keeps the forward's shared memory under 48 KB
constexpr int STAT_UNROLL = 4;      // statistics: 16-byte loads a thread at once
constexpr int FWD_VECS = 2;         // forward: 4-pixel vectors a lane a channel
constexpr int FWD_TILE = 32 * 4 * FWD_VECS;                // forward: pixels a block
constexpr int FWD_CHANNELS = 4;     // forward: channels a warp loads at once
constexpr int BWD_VECS = 4;         // backward: vectors a lane loads at once
constexpr int BWD_ROUNDS = 4;       // backward: rounds of them a channel
constexpr int BWD_TILE = 32 * 4 * BWD_VECS * BWD_ROUNDS;   // backward: pixels a block
constexpr int BWD_GROUP = 128;      // backward: channels a block
constexpr int MOMENT_THREADS = 128;

template <int N>
using Int = std::integral_constant<int, N>;

// four consecutive values of a plane from pixel p (a multiple of 4), zeros
// past n: one 16-byte load where V = 4 (n a multiple of 4), else four
template <int V>
__device__ __forceinline__ void load4(const float* __restrict__ plane, int p, int n, float (&v)[4]) {
    if constexpr (V == 4) {
        if (p < n) {
            const float4 t = __ldcs(reinterpret_cast<const float4*>(plane + p));
            v[0] = t.x;
            v[1] = t.y;
            v[2] = t.z;
            v[3] = t.w;
        } else {
            v[0] = v[1] = v[2] = v[3] = 0.0f;
        }
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = p + e < n ? __ldcs(plane + p + e) : 0.0f;
    }
}

template <int V>
__device__ __forceinline__ void store4(float* __restrict__ plane, int p, int n, const float (&v)[4]) {
    if constexpr (V == 4) {
        if (p < n) __stcs(reinterpret_cast<float4*>(plane + p), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (p + e < n) __stcs(plane + p + e, v[e]);
    }
}

__device__ __forceinline__ double warp_sum(double v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// u = gamma (y - mu) rstd + beta, as F.batch_norm orders it; prm = {mu, rstd, gamma, beta}
__device__ __forceinline__ float normalized(float y, const float4& prm, float& xh) {
    xh = (y - prm.x) * prm.y;
    return fmaf(xh, prm.z, prm.w);
}

// ---- forward ---------------------------------------------------------------

// grid (C, B): plane (b, c)'s sum and sum of squares in fp64 into
// partial[b][c][2], each thread over its pixels in order, then the block's
// threads in a fixed tree
template <int V>
__global__ void __launch_bounds__(THREADS)
dsn_epilogue_plane_moments_kernel(const float* __restrict__ y, int C, int HW, double* __restrict__ partial) {
    const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
    const float* plane = y + ((size_t)b * C + c) * HW;
    double s = 0.0, q = 0.0;
    for (int p0 = 4 * t; p0 < HW; p0 += 4 * THREADS * STAT_UNROLL) {
        float v[STAT_UNROLL][4];
#pragma unroll
        for (int u = 0; u < STAT_UNROLL; ++u) load4<V>(plane, p0 + u * 4 * THREADS, HW, v[u]);
#pragma unroll
        for (int u = 0; u < STAT_UNROLL; ++u) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const double d = v[u][e];
                s += d;
                q = fma(d, d, q);
            }
        }
    }
    __shared__ double red[2][WARPS];
    s = warp_sum(s);
    q = warp_sum(q);
    if (t % 32 == 0) {
        red[0][t / 32] = s;
        red[1][t / 32] = q;
    }
    __syncthreads();
    if (t < 2) {
        double v = 0.0;
        for (int w = 0; w < WARPS; ++w) v += red[t][w];
        partial[((size_t)b * C + c) * 2 + t] = v;
    }
}

// a thread a channel: its sum and sum of squares over `rows` rows of
// partial, in row order (rows = 0: read from sums). Without `mean` it
// writes them to sums and stops (the wrapper then sums them over a data
// group); with it, it writes mu and rstd as fp32 and advances the running
// buffers.
__global__ void __launch_bounds__(MOMENT_THREADS)
dsn_epilogue_moments_kernel(const double* __restrict__ partial, int rows, int C, double count, float eps,
                            float momentum, double* __restrict__ sums, float* __restrict__ running_mean,
                            float* __restrict__ running_var, float* __restrict__ mean, float* __restrict__ rstd) {
    const int c = blockIdx.x * MOMENT_THREADS + threadIdx.x;
    if (c >= C) return;
    double s = 0.0, q = 0.0;
    if (rows > 0) {
        for (int r = 0; r < rows; ++r) {
            s += partial[((size_t)r * C + c) * 2];
            q += partial[((size_t)r * C + c) * 2 + 1];
        }
    } else {
        s = sums[2 * c];
        q = sums[2 * c + 1];
    }
    if (mean == nullptr) {
        sums[2 * c] = s;
        sums[2 * c + 1] = q;
        return;
    }
    const double mu = s / count;
    const double var = fmax(q / count - mu * mu, 0.0);  // biased, as BatchNorm normalises
    mean[c] = (float)mu;
    rstd[c] = (float)(1.0 / sqrt(var + (double)eps));
    running_mean[c] = running_mean[c] * (1.0f - momentum) + momentum * (float)mu;
    running_var[c] = running_var[c] * (1.0f - momentum) + momentum * (float)var;
}

// grid B * tiles, dynamic shared memory forward_smem(C, K): aux of FWD_TILE
// pixels of one image. keep: [B][C] or null (no dropout); inv_q = 1 / (1 - p).
template <int K, int V>
__global__ void __launch_bounds__(THREADS)
dsn_epilogue_forward_kernel(const float* __restrict__ y, const float* __restrict__ mean,
                            const float* __restrict__ rstd, const float* __restrict__ gamma,
                            const float* __restrict__ beta, const float* __restrict__ w,
                            const float* __restrict__ keep, float inv_q, int C, int HW, int tiles,
                            float* __restrict__ aux) {
    extern __shared__ float4 smem[];
    float4* prm = smem;                                    // [C] {mu, rstd, gamma, beta}
    float* wsh = reinterpret_cast<float*>(prm + C);        // [K][C]
    float* kept = wsh + K * C;                             // [C] this image's mask
    float* red = reinterpret_cast<float*>(smem);           // [WARPS][K][FWD_TILE], after the channels
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int b = blockIdx.x / tiles, tile0 = (blockIdx.x % tiles) * FWD_TILE;
    for (int c = t; c < C; c += THREADS) {
        prm[c] = make_float4(mean[c], rstd[c], gamma[c], beta[c]);
        kept[c] = keep != nullptr ? keep[(size_t)b * C + c] : 1.0f;
    }
    for (int i = t; i < K * C; i += THREADS) wsh[i] = w[i];
    __syncthreads();

    const float* yb = y + (size_t)b * C * HW;
    float acc[K][FWD_VECS][4];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < FWD_VECS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[k][j][e] = 0.0f;

    for (int c0 = warp * FWD_CHANNELS; c0 < C; c0 += WARPS * FWD_CHANNELS) {
        float v[FWD_CHANNELS][FWD_VECS][4];
#pragma unroll
        for (int u = 0; u < FWD_CHANNELS; ++u) {
            const int c = c0 + u;
            const bool live = c < C && kept[c] != 0.0f;
#pragma unroll
            for (int j = 0; j < FWD_VECS; ++j)
                load4<V>(yb + (size_t)c * HW, tile0 + (j * 32 + lane) * 4, live ? HW : 0, v[u][j]);
        }
#pragma unroll
        for (int u = 0; u < FWD_CHANNELS; ++u) {
            const int c = c0 + u;
            if (c >= C || kept[c] == 0.0f) continue;  // a dropped channel adds W 0
            const float4 pc = prm[c];
            const float kc = kept[c];
            float wc[K];
#pragma unroll
            for (int k = 0; k < K; ++k) wc[k] = wsh[k * C + c];
#pragma unroll
            for (int j = 0; j < FWD_VECS; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float xh;
                    const float un = normalized(v[u][j][e], pc, xh);
                    const float z = ((un < 0.0f ? 0.0f : un) * kc) * inv_q;
#pragma unroll
                    for (int k = 0; k < K; ++k) acc[k][j][e] = fmaf(wc[k], z, acc[k][j][e]);
                }
            }
        }
    }
    __syncthreads();  // the per-channel values are read: red takes their place
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < FWD_VECS; ++j)
            *reinterpret_cast<float4*>(red + (warp * K + k) * FWD_TILE + (j * 32 + lane) * 4) =
                make_float4(acc[k][j][0], acc[k][j][1], acc[k][j][2], acc[k][j][3]);
    __syncthreads();
    for (int i = t; i < K * FWD_TILE; i += THREADS) {
        const int k = i / FWD_TILE, p = i % FWD_TILE;
        float s = red[k * FWD_TILE + p];
#pragma unroll
        for (int wp = 1; wp < WARPS; ++wp) s += red[(wp * K + k) * FWD_TILE + p];
        if (tile0 + p < HW) aux[((size_t)b * K + k) * HW + tile0 + p] = s;
    }
}

size_t forward_smem(int C, int K) {
    const size_t params = (size_t)C * (sizeof(float4) + (K + 1) * sizeof(float));
    const size_t red = (size_t)WARPS * K * FWD_TILE * sizeof(float);
    return params > red ? params : red;
}

// ---- backward --------------------------------------------------------------

// grid B * tiles * groups (the groups of one tile adjacent, so g's tile is
// read from L2 by all but the first): BWD_TILE pixels of image b and
// BWD_GROUP channels. Pass A (DY false): per channel, the tile's sums of
// g_k z (K), du and du xh into partial[slice][c][K + 2], slice = b * tiles +
// tile. Pass B (DY true): dy; bn_sums[c * stride] and [c * stride + 1] hold
// the channel's dbeta and dgamma over all `count` pixels (null: eval mode).
template <int K, int V, bool DY>
__global__ void __launch_bounds__(THREADS)
dsn_epilogue_backward_kernel(const float* __restrict__ y, const float* __restrict__ g,
                             const float* __restrict__ mean, const float* __restrict__ rstd,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const float* __restrict__ w, const float* __restrict__ keep, float inv_q,
                             int C, int HW, int tiles, int groups, float* __restrict__ partial,
                             const double* __restrict__ bn_sums, int stride, double count,
                             float* __restrict__ dy) {
    __shared__ __align__(16) float gs[K][BWD_TILE];
    __shared__ float4 prm[BWD_GROUP];
    __shared__ float wsh[K][BWD_GROUP];
    __shared__ float kept[BWD_GROUP];
    __shared__ float2 coef[BWD_GROUP];  // pass B: dbeta / M, dgamma / M
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int group = blockIdx.x % groups, slice = blockIdx.x / groups;
    const int b = slice / tiles, tile0 = (slice % tiles) * BWD_TILE, cg0 = group * BWD_GROUP;
    for (int i = t; i < K * BWD_TILE / 4; i += THREADS) {
        const int k = i / (BWD_TILE / 4), p = (i % (BWD_TILE / 4)) * 4;
        float v[4];
        load4<V>(g + ((size_t)b * K + k) * HW, tile0 + p, HW, v);
        *reinterpret_cast<float4*>(&gs[k][p]) = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int i = t; i < BWD_GROUP; i += THREADS) {
        const int c = min(cg0 + i, C - 1);
        prm[i] = make_float4(mean[c], rstd[c], gamma[c], beta[c]);
        kept[i] = keep != nullptr ? keep[(size_t)b * C + c] : 1.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) wsh[k][i] = w[(size_t)k * C + c];
        if (DY)
            coef[i] = bn_sums == nullptr ? make_float2(0.0f, 0.0f)
                                         : make_float2((float)(bn_sums[(size_t)c * stride] / count),
                                                       (float)(bn_sums[(size_t)c * stride + 1] / count));
    }
    __syncthreads();

    for (int i = warp; i < BWD_GROUP && cg0 + i < C; i += WARPS) {
        const int c = cg0 + i;
        const float4 pc = prm[i];
        const float kc = kept[i];
        if (!DY && kc == 0.0f) {  // dropped: z = 0 and du = 0, so every sum is 0
            if (lane < K + 2) partial[((size_t)slice * C + c) * (K + 2) + lane] = 0.0f;
            continue;
        }
        float wc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) wc[k] = wsh[k][i];
        const float scale = pc.z * pc.y;  // gamma rstd
        const float2 cf = DY ? coef[i] : make_float2(0.0f, 0.0f);
        const size_t plane = ((size_t)b * C + c) * HW;
        float sw[K], sb = 0.0f, sg = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) sw[k] = 0.0f;
#pragma unroll 2
        for (int r = 0; r < BWD_ROUNDS; ++r) {
            float v[BWD_VECS][4];
#pragma unroll
            for (int j = 0; j < BWD_VECS; ++j)
                load4<V>(y + plane, tile0 + ((r * BWD_VECS + j) * 32 + lane) * 4, HW, v[j]);
#pragma unroll
            for (int j = 0; j < BWD_VECS; ++j) {
                const int p = ((r * BWD_VECS + j) * 32 + lane) * 4;  // within the tile
                float gv[K][4];
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const float4 q4 = *reinterpret_cast<const float4*>(&gs[k][p]);
                    gv[k][0] = q4.x;
                    gv[k][1] = q4.y;
                    gv[k][2] = q4.z;
                    gv[k][3] = q4.w;
                }
                float d[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float xh;
                    const float un = normalized(v[j][e], pc, xh);
                    float dz = wc[0] * gv[0][e];  // the 1x1 convolution's input gradient
#pragma unroll
                    for (int k = 1; k < K; ++k) dz = fmaf(wc[k], gv[k][e], dz);
                    const float du = un > 0.0f ? (dz * inv_q) * kc : 0.0f;
                    if (DY) {
                        d[e] = scale * (du - cf.x - xh * cf.y);
                    } else {
                        const float z = ((un < 0.0f ? 0.0f : un) * kc) * inv_q;
#pragma unroll
                        for (int k = 0; k < K; ++k) sw[k] = fmaf(gv[k][e], z, sw[k]);
                        sb += du;
                        sg = fmaf(du, xh, sg);
                    }
                }
                if (DY) store4<V>(dy + plane, tile0 + p, HW, d);
            }
        }
        if (!DY) {
#pragma unroll
            for (int k = 0; k < K; ++k) sw[k] = warp_sum(sw[k]);
            sb = warp_sum(sb);
            sg = warp_sum(sg);
            if (lane == 0) {
                float* out = partial + ((size_t)slice * C + c) * (K + 2);
#pragma unroll
                for (int k = 0; k < K; ++k) out[k] = sw[k];
                out[K] = sb;
                out[K + 1] = sg;
            }
        }
    }
}

// grid ceil(n / 32), n = C (K + 2): a lane an entry of the partial rows, the
// block's warps each summing every WARPS-th slice in order in fp64, then the
// warps' sums in warp order. sums: the n fp64 sums, [c][K + 2]; grads: the
// same in fp32 as [K + 2][C] (dW as the weight's [K][C], then dbeta, dgamma).
__global__ void __launch_bounds__(THREADS)
dsn_epilogue_grad_sums_kernel(const float* __restrict__ partial, int slices, int C, int K,
                              double* __restrict__ sums, float* __restrict__ grads) {
    __shared__ double red[WARPS][32];
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int n = C * (K + 2), e = blockIdx.x * 32 + lane;
    double s = 0.0;
    if (e < n)
        for (int sl = warp; sl < slices; sl += WARPS) s += (double)partial[(size_t)sl * n + e];
    red[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && e < n) {
        double v = 0.0;
        for (int wp = 0; wp < WARPS; ++wp) v += red[wp][lane];
        sums[e] = v;
        grads[(e % (K + 2)) * C + e / (K + 2)] = (float)v;
    }
}

// f(Int<K>, Int<V>) for K in 1..MAX_CLASSES and V in {1, 4}
template <class F>
cudaError_t by_shape(int K, int V, F f) {
    if (V != 1 && V != 4) return cudaErrorInvalidValue;
    switch (K) {
        case 1: return V == 4 ? f(Int<1>{}, Int<4>{}) : f(Int<1>{}, Int<1>{});
        case 2: return V == 4 ? f(Int<2>{}, Int<4>{}) : f(Int<2>{}, Int<1>{});
        case 3: return V == 4 ? f(Int<3>{}, Int<4>{}) : f(Int<3>{}, Int<1>{});
        case 4: return V == 4 ? f(Int<4>{}, Int<4>{}) : f(Int<4>{}, Int<1>{});
        default: return cudaErrorInvalidValue;
    }
}

int tiles_of(int HW, int tile) { return (HW + tile - 1) / tile; }

}  // namespace

extern "C" {

int dsn_epilogue_max_classes() { return MAX_CLASSES; }
int dsn_epilogue_max_channels() { return MAX_CHANNELS; }
// the backward's slices (rows of pass A's partial sums) for B images of HW pixels
int dsn_epilogue_slices(int B, int HW) { return B * tiles_of(HW, BWD_TILE); }

// partial: B * C * 2 doubles; V = 4 where HW is a multiple of 4 and y 16-byte aligned
int dsn_epilogue_plane_moments(const float* y, int B, int C, int HW, int V, double* partial, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (V == 4)
        dsn_epilogue_plane_moments_kernel<4><<<dim3(C, B), THREADS, 0, s>>>(y, C, HW, partial);
    else
        dsn_epilogue_plane_moments_kernel<1><<<dim3(C, B), THREADS, 0, s>>>(y, C, HW, partial);
    return (int)cudaGetLastError();
}

// see dsn_epilogue_moments_kernel; mean, rstd: C floats, or null
int dsn_epilogue_moments(const double* partial, int rows, int C, double count, float eps, float momentum,
                         double* sums, float* running_mean, float* running_var, float* mean, float* rstd,
                         void* stream) {
    dsn_epilogue_moments_kernel<<<(C + MOMENT_THREADS - 1) / MOMENT_THREADS, MOMENT_THREADS, 0,
                                  (cudaStream_t)stream>>>(partial, rows, C, count, eps, momentum, sums,
                                                          running_mean, running_var, mean, rstd);
    return (int)cudaGetLastError();
}

// aux: B * K * HW floats; w: the 1x1 weight as [K][C]; keep: [B][C] or null
int dsn_epilogue_forward(const float* y, const float* mean, const float* rstd, const float* gamma,
                         const float* beta, const float* w, const float* keep, float inv_q, int B, int C,
                         int HW, int K, int V, float* aux, void* stream) {
    if (C > MAX_CHANNELS) return (int)cudaErrorInvalidValue;
    const int tiles = tiles_of(HW, FWD_TILE);
    return (int)by_shape(K, V, [&](auto k, auto v) {
        dsn_epilogue_forward_kernel<decltype(k)::value, decltype(v)::value>
            <<<B * tiles, THREADS, forward_smem(C, K), (cudaStream_t)stream>>>(
                y, mean, rstd, gamma, beta, w, keep, inv_q, C, HW, tiles, aux);
        return cudaGetLastError();
    });
}

// pass A, then the sums: partial: dsn_epilogue_slices(B, HW) * C * (K + 2)
// floats of scratch; sums: C * (K + 2) doubles; grads: (K + 2) * C floats
int dsn_epilogue_grad_params(const float* y, const float* g, const float* mean, const float* rstd,
                             const float* gamma, const float* beta, const float* w, const float* keep,
                             float inv_q, int B, int C, int HW, int K, int V, float* partial, double* sums,
                             float* grads, void* stream) {
    if (C > MAX_CHANNELS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int tiles = tiles_of(HW, BWD_TILE), groups = (C + BWD_GROUP - 1) / BWD_GROUP;
    const cudaError_t err = by_shape(K, V, [&](auto k, auto v) {
        dsn_epilogue_backward_kernel<decltype(k)::value, decltype(v)::value, false>
            <<<B * tiles * groups, THREADS, 0, s>>>(y, g, mean, rstd, gamma, beta, w, keep, inv_q, C, HW,
                                                    tiles, groups, partial, nullptr, 0, 1.0, nullptr);
        return cudaGetLastError();
    });
    if (err != cudaSuccess) return (int)err;
    const int n = C * (K + 2);
    dsn_epilogue_grad_sums_kernel<<<(n + 31) / 32, THREADS, 0, s>>>(partial, B * tiles, C, K, sums, grads);
    return (int)cudaGetLastError();
}

// pass B: dy, B * C * HW floats; bn_sums: see dsn_epilogue_backward_kernel
int dsn_epilogue_grad_input(const float* y, const float* g, const float* mean, const float* rstd,
                            const float* gamma, const float* beta, const float* w, const float* keep,
                            float inv_q, int B, int C, int HW, int K, int V, const double* bn_sums, int stride,
                            double count, float* dy, void* stream) {
    if (C > MAX_CHANNELS) return (int)cudaErrorInvalidValue;
    const int tiles = tiles_of(HW, BWD_TILE), groups = (C + BWD_GROUP - 1) / BWD_GROUP;
    return (int)by_shape(K, V, [&](auto k, auto v) {
        dsn_epilogue_backward_kernel<decltype(k)::value, decltype(v)::value, true>
            <<<B * tiles * groups, THREADS, 0, (cudaStream_t)stream>>>(
                y, g, mean, rstd, gamma, beta, w, keep, inv_q, C, HW, tiles, groups, nullptr, bn_sums,
                stride, count, dy);
        return cudaGetLastError();
    });
}

}  // extern "C"
