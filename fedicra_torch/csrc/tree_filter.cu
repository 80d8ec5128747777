// The tree-energy chain for sm_90a: MST selection, BFS rooting, the two-pass
// tree filter and its analytic backward, one kernel each (K1-K4).
//
// Replaces the native route of fedicra_tpu (host C++ there, one CPU thread
// per image):
//   K1 mst_kernel       <- native/boruvka.cpp boruvka_mst_batch (:93) and
//                          native/tree_filter_host.cpp mst_select (:78)
//   K2 root_kernel      <- tree_filter_host.cpp root_tree (:131), finish_tree
//                          (:124) and build_level's weights (:434)
//   K3 filter_fwd_kernel<- tree_filter_host.cpp two_pass_ord_t (:166) on
//                          [x, 1], y = F_x / F_1 (filter_one :283-300,
//                          level_forward :468)
//   K4 filter_bwd_kernel<- the same two-pass on [g/z, g*y/z] for dx, then the
//                          crossing-pair edge gradient and d embed
//                          (filter_one :303-336, level_backward :489)
//
// Grids are 4-connected, H x W, V = H*W vertices, edges as ops/mst.py
// grid_edges lists them: vertical edges first, edge i*W + j joins (i, j) and
// (i+1, j); then horizontal edges, edge (H-1)*W + i*(W-1) + j joins (i, j)
// and (i, j+1). A vertex's four edges are found from its coordinates, so no
// kernel reads an edge list or builds an adjacency list. Indices are int32.
//
// K1 (MST). Boruvka under the total order (weight, edge index): each edge
// packs its positive fp32 weight's bits (order-preserving as uint32) over its
// index into one uint64 key, so one atomicMin per endpoint component finds
// each component's least edge, ties broken toward the smaller index. Each
// component hooks to the one across that edge (of a mutual pair, which shares
// the edge, the smaller id stays root), pointer jumping flattens the hooks,
// and every vertex takes its new label. The MST under a total order is
// unique, so the selection equals ops/mst.py boruvka_mst's and mst_select's
// bit for bit on the same weights. One block of 1024 threads per image loops
// over the rounds (at most ceil(log2 V), each at least halves the
// components), so one launch covers all images of a step.
// Bound: the function reads the weights once and writes the mask once
// (5 bytes an edge): ~21 us for 48 images of 384^2 at 3.35 TB/s. The design
// is bound instead by its rounds: each re-reads every edge's endpoint labels
// and the per-vertex labels (L2-resident per image), and a block can use only
// one SM, so 48 images fill 48 of 132 SMs.
//
// K2 (rooting). A BFS from vertex 0 over the selected edges, one block per
// image looping over the levels inside the kernel. When a vertex is dequeued
// root_tree appends its unvisited neighbours in the order its adjacency list
// holds them, decreasing edge index (it inserts at the list head), so the
// children of (i, j) come as right, left, down, up (the horizontal edges
// follow the vertical ones in the numbering). A level's vertices count their
// children, a block-wide scan places them, and the next level is contiguous
// in the queue, ordered by parent position: the BFS queue of root_tree
// exactly. Outputs per image: order (queue position -> vertex), parent (by
// vertex), ppos (parent's queue position; the root's is 0), cptr (children of
// position q are positions cptr[q] .. cptr[q+1]-1), level (level L spans
// level[L] .. level[L+1]-1), the number of levels, and the filter weights in
// queue order, w = exp(-||embed(v) - embed(parent)||^2 * inv_sigma) with
// inv_sigma = 1/sigma on the first n_low images (the low tree) and 1 on the
// rest, 0 at the root. The weights are formed after the BFS, in parallel:
// the squared distance as a chain of fused multiply-adds in channel order
// (what g++ -O3 -march=native makes of the native code's s += df * df, and
// what the plain twin computes), times inv_sigma, negated, expf.
// Bound: bytes (the function's own: the mask and the embeddings in; order,
// parent, ppos and w out, and the level offsets: ~0.064 ms for 48 images at
// 384^2; cptr is the design's); the design is bound by the dependency
// chain, one block step per BFS level (2,379-3,377 levels for one step's
// trees at 384^2 in chip_smoke.py's [tree-kernels]), each a few dependent
// L2 loads and a block scan.
//
// K3 (filter forward) and K4 (backward). Over the tree in queue order, one
// block per image, levels in turn: upward A[q] = in[q] + sum over children r
// (pulled in decreasing position, as two_pass_ord_t pushes them) of
// w[r] A[r], deepest level first; downward F[q] = A[q](1 - w_q^2) +
// w_q F[ppos[q]], root first. No atomics: a level reads only the level below
// (upward) or above (downward), finished before a __syncthreads. K3 runs on
// [x, 1], keeps A and F (C + 1 channels, for the backward) and writes
// y = F_x / F_1 in vertex order. K4 runs on [g/z, g*y/z] (2C channels) for
// dx = F_{g/z}; for a high tree (w = exp(-dist)) it then forms each edge's
// dL/d dist = -w dL/dw from the crossing-pair decomposition (in parallel over
// all vertices) and d embed by gathering, at each vertex, its own edge's term
// and its children's, so the scatter of filter_one becomes a deterministic
// pull. The low tree's guide gets no gradient. K4 computes in double (its
// passes, their scratch, dL/d dist and d embed) and rounds dx and d embed
// once: on the last tree of a chain, whose input has been filtered three
// times, d embed is ~1e-3 of the terms it is the difference of, and fp32
// passes put a few of its entries 1.3e-4 of its largest away from exact.
// Bound: bytes (the functions' own: K3 reads x and the tree, writes y,
// 64 MB for 12 images at 384^2: 0.02 ms; K4, the VJP, reads g, x, the tree
// and on a high tree the guide, writes dx and d embed: 117 MB a launch on
// average over a step's four, 0.035 ms); the design saves A and F for K4
// (57 MB written, then read) and is bound by the dependency chain of two
// passes over the levels, each level a few dependent L2 or DRAM loads (a
// vertex's children's loads are issued together) and a __syncthreads, and
// one block per image uses 12 of 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MST_THREADS = 1024;
constexpr int THREADS = 512;
constexpr int MAX_EMBED = 8;
constexpr int MAX_CHILDREN = 4;  // the root's; every other vertex has at most 3
constexpr int MAX_ROUNDS = 64;  // Boruvka needs at most ceil(log2 V) + 1
constexpr int MAX_JUMPS = 64;   // pointer jumping, at most ceil(log2 V) + 1
constexpr unsigned long long NO_EDGE = ~0ull;

struct Grid {
  int H, W, V, E, NV;  // NV = (H-1)*W vertical edges, numbered first
};

__host__ Grid make_grid(int H, int W) {
  Grid g;
  g.H = H;
  g.W = W;
  g.V = H * W;
  g.NV = (H - 1) * W;
  g.E = g.NV + H * (W - 1);
  return g;
}

__device__ __forceinline__ void edge_ends(const Grid& g, int e, int& u, int& v) {
  if (e < g.NV) {
    u = e;
    v = e + g.W;
  } else {
    int h = e - g.NV;
    int i = h / (g.W - 1);
    u = i * g.W + (h - i * (g.W - 1));
    v = u + 1;
  }
}

// Exclusive prefix sum of x over the block; *total gets the block's sum.
// Every thread of the block must call it. scratch holds 32 ints.
__device__ int block_exclusive_scan(int x, int* total, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    scratch[lane] = s;
  }
  __syncthreads();
  int out = (warp > 0 ? scratch[warp - 1] : 0) + incl - x;
  *total = scratch[nwarps - 1];
  __syncthreads();  // scratch is free again
  return out;
}

// ---- K1: Boruvka MST selection ------------------------------------------

__global__ void __launch_bounds__(MST_THREADS)
mst_kernel(const float* __restrict__ weights, unsigned char* sel_all, int* comp_all,
           int* hook_all, unsigned long long* best_all, Grid g) {
  const int b = blockIdx.x;
  const float* __restrict__ w = weights + (size_t)b * g.E;
  unsigned char* sel = sel_all + (size_t)b * g.E;
  int* comp = comp_all + (size_t)b * g.V;  // component label (a root vertex)
  int* hook = hook_all + (size_t)b * g.V;  // a root's parent in the hook forest
  unsigned long long* best = best_all + (size_t)b * g.V;

  for (int v = threadIdx.x; v < g.V; v += blockDim.x) {
    comp[v] = v;
    best[v] = NO_EDGE;
  }
  for (int e = threadIdx.x; e < g.E; e += blockDim.x) sel[e] = 0;
  __syncthreads();

  for (int round = 0; round < MAX_ROUNDS; ++round) {
    // each component's least outgoing edge under (weight, index)
    for (int e = threadIdx.x; e < g.E; e += blockDim.x) {
      int u, v;
      edge_ends(g, e, u, v);
      int cu = comp[u], cv = comp[v];
      if (cu != cv) {
        unsigned long long key =
            ((unsigned long long)__float_as_uint(w[e]) << 32) | (unsigned)e;
        atomicMin(&best[cu], key);
        atomicMin(&best[cv], key);
      }
    }
    __syncthreads();
    // hook each component across its edge; select the edge
    int hooked = 0;
    for (int c = threadIdx.x; c < g.V; c += blockDim.x) {
      if (comp[c] != c) continue;
      unsigned long long k = best[c];
      int to = c;
      if (k != NO_EDGE) {
        int e = (int)(k & 0xffffffffull);
        int u, v;
        edge_ends(g, e, u, v);
        int cu = comp[u], cv = comp[v];
        int other = cu == c ? cv : cu;
        // a mutual pair shares the edge: the smaller id stays root
        to = (best[other] == k && c < other) ? c : other;
        sel[e] = 1;
        hooked = 1;
      }
      hook[c] = to;
    }
    if (!__syncthreads_or(hooked)) break;
    // pointer jumping over the roots until every hook is a final root
    for (int jump = 0; jump < MAX_JUMPS; ++jump) {
      int changed = 0;
      for (int c = threadIdx.x; c < g.V; c += blockDim.x) {
        if (comp[c] != c) continue;
        int h = hook[c], hh = hook[h];
        if (hh != h) {
          hook[c] = hh;
          changed = 1;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
    for (int v = threadIdx.x; v < g.V; v += blockDim.x) {
      comp[v] = hook[comp[v]];
      best[v] = NO_EDGE;
    }
    __syncthreads();
  }
}

// ---- K2: BFS rooting at vertex 0 ----------------------------------------

__global__ void __launch_bounds__(THREADS)
root_kernel(const unsigned char* __restrict__ sel_all, const float* __restrict__ embed_all,
            int D, Grid g, int n_low, float inv_sigma_low, int* order_all, int* parent_all,
            int* ppos_all, int* cptr_all, int* level_all, int* nlev_all, float* w_all) {
  __shared__ int scratch[32];
  const int b = blockIdx.x;
  const unsigned char* __restrict__ sel = sel_all + (size_t)b * g.E;
  const float* __restrict__ embed = embed_all + (size_t)b * g.V * D;
  int* order = order_all + (size_t)b * g.V;
  int* parent = parent_all + (size_t)b * g.V;
  int* ppos = ppos_all + (size_t)b * g.V;
  int* cptr = cptr_all + (size_t)b * (g.V + 1);
  int* level = level_all + (size_t)b * (g.V + 1);
  float* w = w_all + (size_t)b * g.V;
  const int HE = g.NV;  // first horizontal edge

  if (threadIdx.x == 0) {
    order[0] = 0;
    parent[0] = 0;
    ppos[0] = 0;
    level[0] = 0;
    level[1] = 1;
  }
  __syncthreads();

  int start = 0, end = 1, nlev = 0;
  while (true) {
    int next = end;
    for (int base = start; base < end; base += blockDim.x) {
      const int p = base + threadIdx.x;
      // children in root_tree's order: right, left, down, up
      bool right = false, left = false, down = false, up = false;
      int u = 0;
      if (p < end) {
        u = order[p];
        const int pu = parent[u];
        const int i = u / g.W, j = u - i * g.W;
        const int row = HE + i * (g.W - 1);
        right = j + 1 < g.W && sel[row + j] && u + 1 != pu;
        left = j > 0 && sel[row + j - 1] && u - 1 != pu;
        down = i + 1 < g.H && sel[u] && u + g.W != pu;
        up = i > 0 && sel[u - g.W] && u - g.W != pu;
      }
      int total;
      const int off = block_exclusive_scan((int)right + (int)left + (int)down + (int)up,
                                           &total, scratch);
      if (p < end) {
        int q = next + off;
        cptr[p] = q;
        const int kids[4] = {u + 1, u - 1, u + g.W, u - g.W};
        const bool has[4] = {right, left, down, up};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!has[k] || q >= g.V) continue;  // q >= V only if sel holds a cycle
          order[q] = kids[k];
          parent[kids[k]] = u;
          ppos[q] = p;
          ++q;
        }
      }
      next += total;
    }
    ++nlev;
    if (next == end) break;  // the level just read had no children
    if (next > g.V) {        // sel holds a cycle: no tree (n_levels 0)
      nlev = 0;
      break;
    }
    if (threadIdx.x == 0) level[nlev + 1] = next;
    start = end;
    end = next;
    __syncthreads();  // the new level's queue entries are visible
  }
  if (threadIdx.x == 0) {
    nlev_all[b] = nlev;
    cptr[g.V] = g.V;
  }
  __syncthreads();

  // filter weights in queue order
  const float inv = b < n_low ? inv_sigma_low : 1.f;
  for (int q = threadIdx.x; q < g.V; q += blockDim.x) {
    float wq = 0.f;
    if (q > 0) {
      const int v = order[q], pv = parent[v];
      float s = 0.f;
      for (int d = 0; d < D; ++d) {
        const float df = __fsub_rn(embed[(size_t)v * D + d], embed[(size_t)pv * D + d]);
        s = __fmaf_rn(df, df, s);
      }
      wq = expf(-__fmul_rn(s, inv));
    }
    w[q] = wq;
  }
}

// ---- K3 / K4: the two passes ---------------------------------------------

struct Tree {
  const int* order;
  const int* parent;
  const int* ppos;
  const int* cptr;
  const int* level;
  const int* nlev;
  const float* w;
};

// Upward then downward pass over CH channels in queue order, for image b.
// load_in(q, v, vals) gives the input row of queue position q (vertex v);
// A, F are this image's [V, CH] rows; store_out(q, v, F row) runs once per
// position in the downward pass.
// T is the type of the sums and of A, F (float in K3, double in K4).
template <int CH, class T, class LoadIn, class StoreOut>
__device__ __forceinline__ void two_pass(const Tree& t, int V, T* A, T* F, LoadIn load_in,
                                         StoreOut store_out) {
  const int nlev = t.nlev[0];
  for (int L = nlev - 1; L >= 0; --L) {
    const int s = t.level[L], e = t.level[L + 1];
    for (int q = s + threadIdx.x; q < e; q += blockDim.x) {
      T acc[CH];
      load_in(q, t.order[q], acc);
      // children last to first: every child's loads are issued (predicated,
      // up to the most a vertex has) before the first is summed
      const int c0 = t.cptr[q], c1 = t.cptr[q + 1];
      T wk[MAX_CHILDREN], ak[MAX_CHILDREN][CH];
#pragma unroll
      for (int k = 0; k < MAX_CHILDREN; ++k) {
        const int r = c1 - 1 - k;
        const bool has = r >= c0;
        wk[k] = has ? T(t.w[r]) : T(0);
#pragma unroll
        for (int c = 0; c < CH; ++c) ak[k][c] = has ? A[(size_t)r * CH + c] : T(0);
      }
#pragma unroll
      for (int k = 0; k < MAX_CHILDREN; ++k) {
        if (c1 - 1 - k < c0) break;
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] += wk[k] * ak[k][c];
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) A[(size_t)q * CH + c] = acc[c];
    }
    __syncthreads();
  }
  for (int L = 0; L < nlev; ++L) {
    const int s = t.level[L], e = t.level[L + 1];
    for (int q = s + threadIdx.x; q < e; q += blockDim.x) {
      T f[CH];
      if (q == 0) {
#pragma unroll
        for (int c = 0; c < CH; ++c) f[c] = A[c];  // root: w = 0
      } else {
        const T wq = t.w[q];
        const T k = T(1) - wq * wq;
        const T* fp = F + (size_t)t.ppos[q] * CH;
#pragma unroll
        for (int c = 0; c < CH; ++c) f[c] = A[(size_t)q * CH + c] * k + wq * fp[c];
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) F[(size_t)q * CH + c] = f[c];
      store_out(q, t.order[q], f);
    }
    __syncthreads();
  }
}

__device__ Tree image_tree(const Tree& all, int b, int V) {
  Tree t;
  t.order = all.order + (size_t)b * V;
  t.parent = all.parent + (size_t)b * V;
  t.ppos = all.ppos + (size_t)b * V;
  t.cptr = all.cptr + (size_t)b * (V + 1);
  t.level = all.level + (size_t)b * (V + 1);
  t.nlev = all.nlev + b;
  t.w = all.w + (size_t)b * V;
  return t;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
filter_fwd_kernel(const float* __restrict__ x_all, Tree all, int V, float* A_all,
                  float* F_all, float* y_all) {
  constexpr int CH = C + 1;
  const int b = blockIdx.x;
  const Tree t = image_tree(all, b, V);
  const float* __restrict__ x = x_all + (size_t)b * V * C;
  float* y = y_all + (size_t)b * V * C;
  two_pass<CH, float>(
      t, V, A_all + (size_t)b * V * CH, F_all + (size_t)b * V * CH,
      [&](int q, int v, float* in) {
#pragma unroll
        for (int c = 0; c < C; ++c) in[c] = x[(size_t)v * C + c];
        in[C] = 1.f;
      },
      [&](int q, int v, const float* f) {
#pragma unroll
        for (int c = 0; c < C; ++c) y[(size_t)v * C + c] = f[c] / f[C];
      });
}

template <int C>
__global__ void __launch_bounds__(THREADS)
filter_bwd_kernel(const float* __restrict__ g_all, const float* __restrict__ y_all,
                  const float* __restrict__ A_all, const float* __restrict__ F_all, Tree all,
                  int V, const float* __restrict__ embed_all, int D,
                  double* Aa_all, double* Fa_all, double* dd_all, float* dx_all,
                  float* dembed_all) {
  constexpr int CH = C + 1, CH2 = 2 * C;
  const int b = blockIdx.x;
  const Tree t = image_tree(all, b, V);
  const float* __restrict__ gout = g_all + (size_t)b * V * C;
  const float* __restrict__ y = y_all + (size_t)b * V * C;
  const float* __restrict__ A = A_all + (size_t)b * V * CH;
  const float* __restrict__ F = F_all + (size_t)b * V * CH;
  double* Aa = Aa_all + (size_t)b * V * CH2;
  double* Fa = Fa_all + (size_t)b * V * CH2;
  float* dx = dx_all + (size_t)b * V * C;

  // dx = F_{g/z}: the filter's two passes on [g/z, g*y/z]
  two_pass<CH2, double>(
      t, V, Aa, Fa,
      [&](int q, int v, double* in) {
        const double z = F[(size_t)q * CH + C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const double gv = gout[(size_t)v * C + c];
          in[c] = gv / z;
          in[C + c] = gv * y[(size_t)v * C + c] / z;
        }
      },
      [&](int q, int v, const double* f) {
#pragma unroll
        for (int c = 0; c < C; ++c) dx[(size_t)v * C + c] = (float)f[c];
      });
  if (embed_all == nullptr) return;  // low tree: no gradient to its guide

  // dL/d dist of each edge (vertex at q to its parent), crossing pairs
  const float* __restrict__ embed = embed_all + (size_t)b * V * D;
  double* dd = dd_all + (size_t)b * V;
  float* dembed = dembed_all + (size_t)b * V * D;
  for (int q = threadIdx.x; q < V; q += blockDim.x) {
    double out = 0.0;
    if (q > 0) {
      const int pq = t.ppos[q];
      const double wv = t.w[q];
      const float* Av = A + (size_t)q * CH;
      const float* Fp = F + (size_t)pq * CH;
      const double* Aav = Aa + (size_t)q * CH2;
      const double* Fap = Fa + (size_t)pq * CH2;
      double s1 = 0.0, s2 = 0.0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s1 += Aav[c] * (Fp[c] - wv * Av[c]) + Av[c] * (Fap[c] - wv * Aav[c]);
        s2 += Aav[C + c] * (Fp[C] - wv * Av[C]) + Av[C] * (Fap[C + c] - wv * Aav[C + c]);
      }
      out = (s1 - s2) * -wv;  // a high tree's w = exp(-dist): dw/d dist = -w
    }
    dd[q] = out;
  }
  __syncthreads();
  // d embed(v) = 2 dd(v) (e_v - e_parent) - sum over children u of 2 dd(u) (e_u - e_v)
  for (int q = threadIdx.x; q < V; q += blockDim.x) {
    const int v = t.order[q];
    const float* ev = embed + (size_t)v * D;
    double acc[MAX_EMBED];
#pragma unroll
    for (int d = 0; d < MAX_EMBED; ++d) acc[d] = 0.0;
    if (q > 0) {
      const float* ep = embed + (size_t)t.parent[v] * D;
      const double k = dd[q] * 2.0;
#pragma unroll
      for (int d = 0; d < MAX_EMBED; ++d)
        if (d < D) acc[d] += k * ((double)ev[d] - ep[d]);
    }
    const int c0 = t.cptr[q], c1 = t.cptr[q + 1];
#pragma unroll
    for (int i = 0; i < MAX_CHILDREN; ++i) {
      const int r = c0 + i;
      if (r >= c1) break;
      const float* eu = embed + (size_t)t.order[r] * D;
      const double k = dd[r] * 2.0;
#pragma unroll
      for (int d = 0; d < MAX_EMBED; ++d)
        if (d < D) acc[d] -= k * ((double)eu[d] - ev[d]);
    }
#pragma unroll
    for (int d = 0; d < MAX_EMBED; ++d)
      if (d < D) dembed[(size_t)v * D + d] = (float)acc[d];
  }
}

Tree make_tree(const int* order, const int* parent, const int* ppos, const int* cptr,
               const int* level, const int* nlev, const float* w) {
  Tree t;
  t.order = order;
  t.parent = parent;
  t.ppos = ppos;
  t.cptr = cptr;
  t.level = level;
  t.nlev = nlev;
  t.w = w;
  return t;
}

}  // namespace

extern "C" {

// K1. weights [N, E] fp32 >= 0 -> sel [N, E] bytes 0/1; scratch comp, hook
// int32 [N, V] and best uint64 [N, V].
int tree_mst(const float* weights, unsigned char* sel, int* comp, int* hook,
             unsigned long long* best, int n, int H, int W, void* stream) {
  if (n < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  mst_kernel<<<n, MST_THREADS, 0, (cudaStream_t)stream>>>(weights, sel, comp, hook, best,
                                                          make_grid(H, W));
  return (int)cudaGetLastError();
}

// K2. sel [N, E]; embed [N, V, D] fp32; outputs order, parent, ppos, w
// [N, V], cptr, level [N, V + 1], nlev [N].
int tree_root(const unsigned char* sel, const float* embed, int D, int n, int H, int W,
              int n_low, float inv_sigma_low, int* order, int* parent, int* ppos, int* cptr,
              int* level, int* nlev, float* w, void* stream) {
  if (n < 1 || H < 1 || W < 1 || D < 1 || D > MAX_EMBED) return (int)cudaErrorInvalidValue;
  root_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(sel, embed, D, make_grid(H, W), n_low,
                                                       inv_sigma_low, order, parent, ppos, cptr,
                                                       level, nlev, w);
  return (int)cudaGetLastError();
}

// K3. x [B, V, C] fp32 (vertex order); tree arrays of these B images;
// outputs A, F [B, V, C + 1] (queue order), y [B, V, C] (vertex order).
int tree_filter_fwd(const float* x, const int* order, const int* parent, const int* ppos,
                    const int* cptr, const int* level, const int* nlev, const float* w,
                    float* A, float* F, float* y, int B, int V, int C, void* stream) {
  const Tree t = make_tree(order, parent, ppos, cptr, level, nlev, w);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: filter_fwd_kernel<1><<<B, THREADS, 0, s>>>(x, t, V, A, F, y); break;
    case 2: filter_fwd_kernel<2><<<B, THREADS, 0, s>>>(x, t, V, A, F, y); break;
    case 3: filter_fwd_kernel<3><<<B, THREADS, 0, s>>>(x, t, V, A, F, y); break;
    case 4: filter_fwd_kernel<4><<<B, THREADS, 0, s>>>(x, t, V, A, F, y); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4. g, y [B, V, C] (vertex order); A, F [B, V, C + 1] from K3; embed
// [B, V, D] or NULL (low tree); float64 scratch Aa, Fa [B, V, 2C], dd [B, V];
// outputs dx [B, V, C], dembed [B, V, D] (when embed).
int tree_filter_bwd(const float* g, const float* y, const float* A, const float* F,
                    const int* order, const int* parent, const int* ppos, const int* cptr,
                    const int* level, const int* nlev, const float* w, const float* embed,
                    int D, double* Aa, double* Fa, double* dd, float* dx,
                    float* dembed, int B, int V, int C, void* stream) {
  if (embed != nullptr && (D < 1 || D > MAX_EMBED)) return (int)cudaErrorInvalidValue;
  const Tree t = make_tree(order, parent, ppos, cptr, level, nlev, w);
  cudaStream_t s = (cudaStream_t)stream;
#define FEDICRA_TREE_BWD(CC)                                                              \
  filter_bwd_kernel<CC><<<B, THREADS, 0, s>>>(g, y, A, F, t, V, embed, D, Aa, Fa, \
                                              dd, dx, dembed)
  switch (C) {
    case 1: FEDICRA_TREE_BWD(1); break;
    case 2: FEDICRA_TREE_BWD(2); break;
    case 3: FEDICRA_TREE_BWD(3); break;
    case 4: FEDICRA_TREE_BWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FEDICRA_TREE_BWD
  return (int)cudaGetLastError();
}

}  // extern "C"
