// The tree-energy chain for sm_90a: MST selection, BFS rooting, the two-pass
// tree filter and its analytic backward (K1-K4, each a few launches).
//
// Replaces the native route of fedicra_tpu (host C++ there, one CPU thread
// per image):
//   K1 (MST)            <- native/boruvka.cpp boruvka_mst_batch (:93) and
//                          native/tree_filter_host.cpp mst_select (:78):
//                          mst_tile_kernel, mst_cross_kernel,
//                          mst_contract_kernel
//   K2 (rooting)        <- tree_filter_host.cpp root_tree (:131), finish_tree
//                          (:124) and build_level's weights (:434):
//                          tree_mask_kernel, tree_bfs_kernel, root_weights_kernel
//   K3 (filter forward) <- tree_filter_host.cpp two_pass_ord_t (:166) on
//                          [x, 1], y = F_x / F_1 (filter_one :230, :266-280,
//                          level_forward :468): fwd_gather_kernel,
//                          tree_pass_kernel, fwd_scatter_kernel
//   K4 (backward)       <- the same two passes on [g/z, g*y/z] for dx, then
//                          the crossing-pair edge gradient and d embed
//                          (filter_one :283-336, level_backward :489):
//                          bwd_gather_kernel, tree_pass_kernel,
//                          bwd_scatter_kernel, dembed_kernel
//
// Grids are 4-connected, H x W, V = H*W vertices, edges as ops/mst.py
// grid_edges lists them: vertical edges first, edge i*W + j joins (i, j) and
// (i+1, j); then horizontal edges, edge (H-1)*W + i*(W-1) + j joins (i, j)
// and (i, j+1). A vertex's four edges are found from its coordinates, so no
// kernel reads the grid's edge list or builds an adjacency list. Indices are
// int32.
//
// K1 (MST). Boruvka under the total order (weight, edge index): each edge
// packs its positive fp32 weight's bits (order-preserving as uint32) over its
// index into one uint64 key, so a minimum finds each component's least edge,
// ties broken toward the smaller index. The MST under a total order is
// unique, so the selection equals ops/mst.py boruvka_mst's and mst_select's
// bit for bit on the same weights, whatever the order of the rounds. Three
// launches a call:
//   K1a mst_tile_kernel     one block of 1,024 threads a tile of 32 x 32
//                           vertices (144 tiles an image of 384^2, on every
//                           SM): Boruvka rounds in shared memory, where a
//                           component hooks across its least edge only when
//                           that edge is the tile's own and waits when it
//                           leaves the tile (exact by the cut property); then
//                           each vertex's dense component label, the
//                           selection of the edges the tile owns, and each
//                           pair of its components that its edges join, once
//                           (a hash table in shared memory), with the least
//                           key;
//   K1b mst_cross_kernel    the edges between tiles with their endpoints'
//                           labels, a run of a warp's edges that joins the
//                           same pair once;
//   K1c mst_contract_kernel one block an image: Boruvka rounds on that
//                           contracted graph (up to ~6,700 components and
//                           ~18,000 edges an image at 384^2), dropping each
//                           round the edges that have come to lie inside one
//                           component; in shared memory (16-bit labels) once
//                           the graph fits, its first rounds on device memory
//                           until then, in the same kernel.
// Bound: the function reads the weights once and writes the mask once
// (5 bytes an edge): ~21 us for 48 images of 384^2 at 3.35 TB/s. The design
// reads each weight about twice and is bound instead by phase 1's rounds
// (each a handful of block barriers over every vertex of a tile) and by
// phase 2's, on 48 of the 132 SMs.
//
// K2 (rooting). A BFS from vertex 0 over the selected edges. When a vertex
// is dequeued root_tree appends its unvisited neighbours in the order its
// adjacency list holds them, decreasing edge index (it inserts at the list
// head), so the children of (i, j) come as right, left, down, up (the
// horizontal edges follow the vertical ones in the numbering). The next
// level is contiguous in the queue, ordered by parent position: the BFS
// queue of root_tree exactly. Outputs per image: order (queue position ->
// vertex), parent (by vertex), ppos (parent's queue position; the root's is
// 0), cptr (children of position q are positions cptr[q] .. cptr[q+1]-1),
// level (level L spans level[L] .. level[L+1]-1), the number of levels, and
// the filter weights in queue order, w = exp(-||embed(v) - embed(parent)||^2
// * inv_sigma) with inv_sigma = 1/sigma on the first n_low images (the low
// tree) and 1 on the rest, 0 at the root: the squared distance as a chain of
// fused multiply-adds in channel order (what g++ -O3 -march=native makes of
// the native code's s += df * df, and what the plain twin computes), times
// inv_sigma, negated, expf. Three launches a call:
//   K2a tree_mask_kernel    each vertex's selected edges as 4 bits in child
//                           order, two vertices a byte (73,728 bytes an
//                           image of 384^2), on every SM;
//   K2b tree_bfs_kernel     one block of 4 warps an image: the masks in
//                           shared memory (one bulk copy), the current and
//                           next level's entries (vertex, direction to the
//                           parent) in a shared ring; a vertex's children are
//                           its mask less its parent's bit, placed by three
//                           ballots of their counts' bits and one combine of
//                           the warps' sums at a barrier; order, ppos and
//                           cptr are stored as they come, the level offsets
//                           kept in shared memory. A level not written
//                           wholly to the ring reads its entries from device
//                           memory, and masks too large for shared memory
//                           are read from device memory, in the same kernel;
//   K2c root_weights_kernel the parents by vertex and the weights, on every
//                           SM.
// Bound: bytes (the function's own: the mask and the embeddings in; order,
// parent, ppos and w out, and the level offsets: ~0.064 ms for 48 images at
// 384^2; cptr is the design's); the design is bound by the dependency
// chain, one step per BFS level (2,379-3,377 levels for one step's trees at
// 384^2, tools/kernel_times.py's tree_root rows), each a few dependent shared
// loads, the ballots, two barriers and the level's stores.
//
// K3 (filter forward) and K4 (backward). The arithmetic is two passes over
// the tree in BFS queue order: upward A[q] = in[q] + sum over children r
// (pulled last to first, as two_pass_ord_t pushes them) of w[r] A[r],
// deepest level first; downward F[q] = A[q](1 - w_q^2) + w_q F[ppos[q]],
// root first. No atomics: a level reads only the level below (upward) or
// above (downward). K3 runs on [x, 1] (C + 1 channels) and gives
// y = F_x / F_1, A and F (kept for the backward); K4 runs on [g/z, g*y/z]
// (2C channels) for dx = F_{g/z} and, for a high tree (w = exp(-dist)),
// forms each edge's dL/d dist = -w dL/dw from the crossing-pair
// decomposition and d embed by gathering, at each vertex, its own edge's
// term and its children's: the scatter of filter_one becomes a
// deterministic pull. The low tree's guide gets no gradient. K4 computes in
// double (its passes, their scratch, dL/d dist and d embed) and rounds dx
// and d embed once: on the last tree of a chain, whose input has been
// filtered three times, d embed is ~1e-3 of the terms it is the difference
// of. Each is a few launches (in tree_filter_host.cpp):
//   K3a fwd_gather_kernel  <- filter_one's gather of [x, 1] into BFS order
//                             (:266-273), and each position's record (w,
//                             first child, end of children, ppos)
//   K3b, K4b tree_pass_kernel <- two_pass_ord_t (:166), level_forward (:468)
//                             and level_backward (:489): the two passes
//   K3c fwd_scatter_kernel <- filter_one :276-280: y = F_x / F_1 back to
//                             vertex order; A out of the padded scratch
//   K4a bwd_gather_kernel  <- filter_one :283-295: [g/z, g*y/z] in double,
//                             z = F_1, in queue order; the records
//   K4c bwd_scatter_kernel <- filter_one :298-301 (dx back to vertex order)
//                             and the crossing-pair sums (:306-320)
//   K4d dembed_kernel      <- filter_one :321-335 (its scatter to embed)
// (filter_one is :230; a, c and d run over all B x V positions, on every SM.)
// Bound: still bytes (the functions' own: K3 reads x and the tree, writes y,
// 64 MB for 12 images at 384^2: 0.0190 ms; K4, the VJP, reads g, x, the
// tree and on a high tree the guide, writes dx and d embed: 117 MB a launch
// on average over a step's four, 0.0349 ms). The design is bound instead by
// depth x the per-level floor: a pass is a chain of 2,379-3,377 dependent
// levels of ~50 vertices (at most ~300), one block an image. The passes'
// block keeps each level's dependent loads in shared memory and its
// per-level work small:
// - the queue is walked monotonically (upward from the last position to the
//   first, downward from the first), and the level a level reads is next
//   to it in the queue, so a window of NT tiles of TP positions (a ring:
//   position q in row q % (NT TP)) holds the inputs, the records and the A
//   (upward) or F (downward) just computed, written in place over the
//   inputs: a level's loads are ld.shared, issued together (a missing
//   child's predicated off, read as 0), and its sums explicit FMAs;
// - one producer warp keeps cp.async.bulk (TMA) loads of the next tiles in
//   flight, each completing on the tile's "full" mbarrier. Once the pass
//   has left a tile, the consumers fence their writes to it
//   (fence.proxy.async), and one of them sends its rows (A upward, F
//   downward) to device memory by a bulk store and frees the slot of the
//   tile before it on that slot's "empty" mbarrier when that tile's store
//   has read shared memory: no level stores to device memory. The scratch
//   is padded to PAD positions an image, so every tile is 16-byte aligned
//   whatever V is;
// - only the WARPS consumer warps wait at a level, on a named barrier
//   (bar.sync 1); the producer never does;
// - the level offsets are copied into shared memory when they fit
//   (LEVEL_CAP), else read 32 at a time into a warp's lanes, a batch ahead;
// - an image whose levels do not all fit the window (a level with the
//   level it reads spanning more than NT - 1 tiles) runs both passes on
//   device memory instead, in the same kernel; a path-shaped tree (V - 1
//   levels of one vertex) is the narrowest case of the window.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_EMBED = 8;
constexpr int MAX_CHILDREN = 4;  // the root's; every other vertex has at most 3
constexpr int PAR_THREADS = 256;  // the fully parallel kernels
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

// ---- Hopper helpers ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst,
// completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// bytes (a multiple of 16) from shared src to 16-byte aligned global dst, as
// a bulk group of its own
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the thread's bulk stores but the newest N have read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// the thread's bulk stores have all completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

int par_blocks(int B, int V) {
  const long long n = ((long long)B * V + PAR_THREADS - 1) / PAR_THREADS;
  return (int)(n < 65535 * 8 ? n : 65535 * 8);
}

// ---- K1: Boruvka MST selection, tile-local then contracted ----------------

constexpr int MST_TILE = 32;            // the main path's tile (64 measured: PERF.md section 6)
constexpr int SMALL_MST_TILE = 8;       // the tests' tile, with a small contracted store
constexpr int P1_ROUND_CAP = 64;        // phase 1 may stop after any round: phase 2 finishes
constexpr int CROSS_THREADS = 256;
constexpr int P2_THREADS = 1024;
constexpr int P2_SMEM = 200 * 1024;     // the contracted store of one image in shared memory
constexpr int SMALL_P2_SMEM = 1536;     // the tests': most images start on device memory
constexpr uint32_t EMPTY_PAIR = 0xffffffffu;
constexpr int MST_COUNTS = 5;           // counts= columns
constexpr int MST_STAMPS = 4;           // stamps= columns

constexpr uint32_t NO_BITS = 0xffffffffu;  // no edge: above every weight's bits (a NaN's)

__device__ __forceinline__ unsigned long long edge_key(const float* w, int e) {
  return ((unsigned long long)__float_as_uint(w[e]) << 32) | (unsigned)e;
}

// The indices of vertex (i, j)'s edges right, left, down, up; -1 where the
// grid has none.
__device__ __forceinline__ void tile_edges(const Grid& g, int i, int j, int (&idx)[4]) {
  const int row = g.NV + i * (g.W - 1), v = i * g.W + j;
  idx[0] = j + 1 < g.W ? row + j : -1;
  idx[1] = j > 0 ? row + j - 1 : -1;
  idx[2] = i + 1 < g.H ? v : -1;
  idx[3] = i > 0 ? v - g.W : -1;
}

// The least key of each run of lanes with the same label, on the run's last
// lane (other lanes get NO_EDGE): a segmented min-scan over the warp. Every
// lane of the warp calls it.
__device__ __forceinline__ unsigned long long run_min(long long label, unsigned long long key) {
  const int lane = threadIdx.x & 31;
  const long long prev = __shfl_up_sync(0xffffffffu, label, 1);
  int head = lane == 0 || prev != label;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long k = __shfl_up_sync(0xffffffffu, key, o);
    const int h = __shfl_up_sync(0xffffffffu, head, o);
    if (lane >= o && !head) {
      key = k < key ? k : key;
      head = h;
    }
  }
  const long long nxt = __shfl_down_sync(0xffffffffu, label, 1);
  return lane == 31 || nxt != label ? key : NO_EDGE;
}

template <int T>
struct TileShape {
  static constexpr int N = T * T;                 // local vertices, row stride T
  static constexpr int VPT = T == MST_TILE ? 1 : 2;  // vertices a thread
  static constexpr int THREADS = N / VPT;
  // two blocks of a vertex a thread on an SM: at most 32 registers a thread
  static constexpr int MIN_BLOCKS = VPT == 1 ? 2 : 1;
  static constexpr int LOG2N = T == MST_TILE ? 10 : 6;
  static_assert((1 << LOG2N) == N, "tiles of 8 or 32");
  // best (in the rounds its halves: the least keys' weight bits, then
  // their indices; after them the dedup table's keys), comp, hook (then the
  // roots' ranks), the dedup table's pairs, the selected right / down edges
  static constexpr size_t SMEM = (size_t)N * (8 + 4 + 4 + 4 + 1 + 1);
};

// Phase 1: one block a tile of T x T vertices of one image (blockIdx.y).
// Boruvka rounds in shared memory: each component takes its least edge over
// all edges at its vertices, the tile's own and those that leave it; one
// whose least edge is the tile's own hooks across it (the edge is the MST's,
// by the cut property), one whose least edge leaves the tile waits (others
// may still hook into it); rounds run until no component hooks. Then it
// writes the selection of the edges it owns (those leaving its vertices
// right and down; one that leaves the tile is 0 here), each vertex's
// component as a dense label of the image, and each pair of its components
// that its own edges join, once, with the least key of those edges
// (a hash table in shared memory; a pair it cannot place goes out as is).
template <int T>
__global__ void __launch_bounds__(TileShape<T>::THREADS, TileShape<T>::MIN_BLOCKS)
mst_tile_kernel(const float* __restrict__ weights, Grid g, int tiles_w, unsigned char* sel_all,
                int* lab_all, unsigned long long* key_all, int2* uv_all, int* ncomp, int* nedge,
                int* counts, unsigned long long* stamps) {
  using S = TileShape<T>;
  constexpr int N = S::N, VPT = S::VPT, NT = S::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[32];
  __shared__ int base_s[2];
  unsigned long long* best = reinterpret_cast<unsigned long long*>(smem);
  int* comp = reinterpret_cast<int*>(best + N);
  int* hook = comp + N;
  uint32_t* tpair = reinterpret_cast<uint32_t*>(hook + N);
  unsigned char* sel_r = reinterpret_cast<unsigned char*>(tpair + N);
  unsigned char* sel_d = sel_r + N;

  const int tid = threadIdx.x, b = blockIdx.y;
  const int ti = blockIdx.x / tiles_w, tj = blockIdx.x - ti * tiles_w;
  const int r0 = ti * T, c0 = tj * T;
  const int th = min(T, g.H - r0), tw = min(T, g.W - c0);
  const float* __restrict__ w = weights + (size_t)b * g.E;
  if (stamps && tid == 0) atomicMax(&stamps[b * MST_STAMPS], ~global_ns());  // the least start

  // each vertex's four weights' bits (right, left, down, up; NO_BITS where
  // the grid has no edge) stay in registers; a key's index comes from the
  // vertex's place
  uint32_t wb[VPT][4];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int l = tid + k * NT, li = l / T, lj = l % T;
    const bool valid = li < th && lj < tw;
    int idx[4];
    tile_edges(g, r0 + li, c0 + lj, idx);
#pragma unroll
    for (int d = 0; d < 4; ++d)
      wb[k][d] = valid && idx[d] >= 0 ? __float_as_uint(w[idx[d]]) : NO_BITS;
    comp[l] = valid ? l : -1;
    best[l] = NO_EDGE;
    sel_r[l] = sel_d[l] = 0;
  }
  __syncthreads();

  unsigned* best_hi = reinterpret_cast<unsigned*>(best);
  unsigned* best_lo = best_hi + N;
  const auto least = [&](int c) { return (unsigned long long)best_hi[c] << 32 | best_lo[c]; };
  unsigned long long mins[VPT];  // each vertex's least candidate key
  int dirs[VPT];                 // and its direction (right, left, down, up)
  int rounds = 0;
  for (int round = 0; round < P1_ROUND_CAP; ++round) {
    // each component's least key over its vertices' least candidates, by
    // two 32-bit atomicMins (the weight bits, then the index among the keys
    // with the least bits), each skipped where a read shows it cannot lower
    // the value (both faster than one 64-bit atomicMin: PERF.md section 6)
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int l = tid + k * NT, li = l / T, lj = l % T;
      const int c = comp[l];
      unsigned long long m = NO_EDGE;
      dirs[k] = 0;
      if (c >= 0) {
        const bool inside[4] = {lj + 1 < tw, lj > 0, li + 1 < th, li > 0};
        const int nb[4] = {l + 1, l - 1, l + T, l - T};
        int idx[4];
        tile_edges(g, r0 + li, c0 + lj, idx);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (wb[k][d] == NO_BITS) continue;
          const unsigned long long kd = (unsigned long long)wb[k][d] << 32 | (unsigned)idx[d];
          if (kd < m && (!inside[d] || comp[nb[d]] != c)) {
            m = kd;
            dirs[k] = d;
          }
        }
        if (c == l) hook[l] = l;  // a root stays one unless it hooks below
      }
      mins[k] = m;
      if (m != NO_EDGE && (unsigned)(m >> 32) < best_hi[c])
        atomicMin(&best_hi[c], (unsigned)(m >> 32));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = comp[tid + k * NT];
      const unsigned long long m = mins[k];
      if (m != NO_EDGE && (unsigned)(m >> 32) == best_hi[c] && (unsigned)m < best_lo[c])
        atomicMin(&best_lo[c], (unsigned)m);
    }
    __syncthreads();
    // the one vertex that holds its component's least key hooks the
    // component across that edge when the edge is the tile's own, and
    // leaves it waiting when the edge leaves the tile
    int hooked = 0;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int l = tid + k * NT, li = l / T, lj = l % T, d = dirs[k];
      const unsigned long long m = mins[k];
      if (m == NO_EDGE) continue;
      const int c = comp[l];
      const bool inside = d == 0 ? lj + 1 < tw : d == 1 ? lj > 0 : d == 2 ? li + 1 < th : li > 0;
      if (m != least(c) || !inside) continue;
      const int other = comp[d == 0 ? l + 1 : d == 1 ? l - 1 : d == 2 ? l + T : l - T];
      // a mutual pair shares the edge: the smaller id stays root
      hook[c] = (least(other) == m && c < other) ? c : other;
      // the edge's owner is its up / left end
      if (d < 2)
        sel_r[d == 0 ? l : l - 1] = 1;
      else
        sel_d[d == 2 ? l : l - T] = 1;
      hooked = 1;
    }
    if (!__syncthreads_or(hooked)) break;
    ++rounds;
    // pointer jumping over the roots until every hook is a final root
    for (;;) {
      int changed = 0;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int l = tid + k * NT;
        if (comp[l] != l) continue;
        const int h = hook[l], hh = hook[h];
        if (hh != h) {
          hook[l] = hh;
          changed = 1;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int l = tid + k * NT;
      const int c = comp[l];
      if (c >= 0) comp[l] = hook[c];
      best[l] = NO_EDGE;
    }
    __syncthreads();
  }

  // dense labels: the image's components numbered by tile, ranks in hook
  int nroot = 0;
#pragma unroll
  for (int k = 0; k < VPT; ++k) nroot += comp[tid + k * NT] == tid + k * NT;
  int total;
  int rank = block_exclusive_scan(nroot, &total, scratch);
  if (tid == 0) base_s[0] = atomicAdd(&ncomp[b], total);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int l = tid + k * NT;
    if (comp[l] == l) hook[l] = rank++;
    tpair[l] = EMPTY_PAIR;
    best[l] = NO_EDGE;  // the table's keys (the last round left its minima)
  }
  __syncthreads();
  const int cbase = base_s[0];
  unsigned char* sel = sel_all + (size_t)b * g.E;
  unsigned long long* lkey = key_all + (size_t)b * g.E;
  int2* luv = uv_all + (size_t)b * g.E;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int l = tid + k * NT, li = l / T, lj = l % T;
    const int c = comp[l];
    if (c < 0) continue;
    const int gi = r0 + li, gj = c0 + lj, gv = gi * g.W + gj;
    const int rc = hook[c];
    lab_all[(size_t)b * g.V + gv] = cbase + rc;
    if (gi + 1 < g.H) sel[gv] = li + 1 < th ? sel_d[l] : 0;
    if (gj + 1 < g.W) sel[g.NV + gi * (g.W - 1) + gj] = lj + 1 < tw ? sel_r[l] : 0;
    // this vertex's own edges inside the tile that join two components
#pragma unroll
    for (int d = 0; d < 3; d += 2) {  // right, down
      if (d == 0 ? lj + 1 >= tw : li + 1 >= th) continue;
      const int cn = comp[d == 0 ? l + 1 : l + T];
      if (cn == c) continue;
      const int rn = hook[cn];
      const uint32_t pair = (uint32_t)min(rc, rn) << 16 | (uint32_t)max(rc, rn);
      int idx[4];
      tile_edges(g, gi, gj, idx);
      const unsigned long long kd = (unsigned long long)wb[k][d] << 32 | (unsigned)idx[d];
      uint32_t h = (pair * 2654435761u) >> (32 - S::LOG2N);
      bool placed = false;
      for (int probe = 0; probe < N && !placed; ++probe, h = (h + 1) & (N - 1)) {
        const uint32_t old = atomicCAS(&tpair[h], EMPTY_PAIR, pair);
        if (old == EMPTY_PAIR || old == pair) {
          atomicMin(&best[h], kd);  // best is NO_EDGE after the last round
          placed = true;
        }
      }
      if (!placed) {
        const int pos = atomicAdd(&nedge[b], 1);
        lkey[pos] = kd;
        luv[pos] = make_int2(cbase + rc, cbase + rn);
      }
    }
  }
  __syncthreads();
  int npair = 0;
#pragma unroll
  for (int k = 0; k < VPT; ++k) npair += tpair[tid + k * NT] != EMPTY_PAIR;
  int pos = block_exclusive_scan(npair, &total, scratch);
  if (tid == 0) base_s[1] = total ? atomicAdd(&nedge[b], total) : 0;
  __syncthreads();
  pos += base_s[1];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int s = tid + k * NT;
    const uint32_t pair = tpair[s];
    if (pair == EMPTY_PAIR) continue;
    lkey[pos] = best[s];
    luv[pos] = make_int2(cbase + (int)(pair >> 16), cbase + (int)(pair & 0xffffu));
    ++pos;
  }
  if (tid == 0) {
    if (counts) atomicMax(&counts[b * MST_COUNTS], rounds);
    if (stamps) atomicMax(&stamps[b * MST_STAMPS + 1], global_ns());
  }
}

// Phase 1b: the edges between tiles (blockIdx.y the image), with their
// endpoints' labels; a run of a warp's lanes (consecutive edges along one
// tile border) that joins the same two components goes out once, with the
// least key of the run.
__global__ void __launch_bounds__(CROSS_THREADS)
mst_cross_kernel(const float* __restrict__ weights, Grid g, int T, const int* __restrict__ lab_all,
                 unsigned long long* key_all, int2* uv_all, int* nedge) {
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int nrow = (g.H - 1) / T * g.W;  // edges down from the tile rows' last rows, W a border
  const int n = nrow + (g.W - 1) / T * g.H;
  const float* __restrict__ w = weights + (size_t)b * g.E;
  const int* __restrict__ lab = lab_all + (size_t)b * g.V;
  for (int x0 = blockIdx.x * blockDim.x; x0 < n; x0 += gridDim.x * blockDim.x) {
    const int x = x0 + threadIdx.x;
    int lu = 0, lv = 0;
    unsigned long long key = NO_EDGE;
    long long pair = -1 - lane;  // a lane past the end is a run of its own, with no key
    if (x < n) {
      int u, v, e;
      if (x < nrow) {  // row i = kT - 1, along j
        const int k = x / g.W, j = x - k * g.W;
        u = ((k + 1) * T - 1) * g.W + j;
        v = u + g.W;
        e = u;
      } else {  // column j = kT - 1, along i
        const int x2 = x - nrow, k = x2 / g.H, i = x2 - k * g.H, j = (k + 1) * T - 1;
        u = i * g.W + j;
        v = u + 1;
        e = g.NV + i * (g.W - 1) + j;
      }
      lu = lab[u];
      lv = lab[v];
      key = edge_key(w, e);
      pair = (long long)min(lu, lv) << 32 | max(lu, lv);  // labels are below 2^31
    }
    key = run_min(pair, key);
    const bool out = key != NO_EDGE;
    const unsigned outs = __ballot_sync(0xffffffffu, out);
    int base = 0;
    if (lane == 0 && outs) base = atomicAdd(&nedge[b], __popc(outs));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (out) {
      const int p = base + __popc(outs & ((1u << lane) - 1));
      key_all[(size_t)b * g.E + p] = key;
      uv_all[(size_t)b * g.E + p] = make_int2(lu, lv);
    }
  }
}

// The contracted graph of one image: edges (key, label u, label v) and, per
// component label, its least edge's key and its hook. In shared memory the
// labels are 16 bits a side; on device memory int2.
struct SmemGraph {
  unsigned long long* key;
  uint32_t* uv;
  unsigned long long* best;
  int* hook;
  __device__ void get(int i, unsigned long long& k, int& u, int& v) const {
    k = key[i];
    const uint32_t p = uv[i];
    u = (int)(p & 0xffffu);
    v = (int)(p >> 16);
  }
  __device__ void put(int i, unsigned long long k, int u, int v) {
    key[i] = k;
    uv[i] = (uint32_t)u | (uint32_t)v << 16;
  }
};

struct GlobalGraph {
  unsigned long long* key;
  int2* uv;
  unsigned long long* best;
  int* hook;
  __device__ void get(int i, unsigned long long& k, int& u, int& v) const {
    k = key[i];
    const int2 p = uv[i];
    u = p.x;
    v = p.y;
  }
  __device__ void put(int i, unsigned long long k, int u, int v) {
    key[i] = k;
    uv[i] = make_int2(u, v);
  }
};

// one store of E edges and C components fits CAP bytes of shared memory
template <int CAP>
__device__ __forceinline__ bool fits_smem(int E, int C) {
  return C <= 65536 && 12ll * E + 12ll * C <= CAP;
}

// One Boruvka round over the graph's E edges (all of the block's threads):
// each root component's least edge, its hook (a mutual pair's smaller
// label stays root), the selected edges marked in sel, pointer jumping, and
// the edges that still join two components kept in place, relabelled to
// their roots (a stable compaction, one block scan a chunk). Returns the
// edges left.
template <class G>
__device__ int contract_round(G& g, int E, int C, unsigned char* sel, int* scratch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c = tid; c < C; c += nt)
    if (g.hook[c] == c) g.best[c] = NO_EDGE;
  __syncthreads();
  for (int i = tid; i < E; i += nt) {
    unsigned long long k;
    int u, v;
    g.get(i, k, u, v);
    atomicMin(&g.best[u], k);
    atomicMin(&g.best[v], k);
  }
  __syncthreads();
  for (int i = tid; i < E; i += nt) {
    unsigned long long k;
    int u, v;
    g.get(i, k, u, v);
    const unsigned long long bu = g.best[u], bv = g.best[v];
    if (k == bu) g.hook[u] = (bv == k && u < v) ? u : v;
    if (k == bv) g.hook[v] = (bu == k && v < u) ? v : u;
    if (k == bu || k == bv) sel[(unsigned)k] = 1;
  }
  __syncthreads();
  for (;;) {
    int changed = 0;
    for (int c = tid; c < C; c += nt) {
      const int h = g.hook[c], hh = g.hook[h];
      if (hh != h) {
        g.hook[c] = hh;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  int out = 0;
  for (int base = 0; base < E; base += nt) {
    const int i = base + tid;
    unsigned long long k = 0;
    int u = 0, v = 0, keep = 0;
    if (i < E) {
      g.get(i, k, u, v);
      u = g.hook[u];
      v = g.hook[v];
      keep = u != v;
    }
    int total;
    const int off = block_exclusive_scan(keep, &total, scratch);  // every read of the chunk is done
    if (keep) g.put(out + off, k, u, v);
    out += total;
  }
  __syncthreads();
  return out;
}

// Phase 2: the contracted graph of one image a block (blockIdx.x): the
// edges phase 1 and 1b left (lists of key_all / uv_all, nedge of them) over
// the ncomp components, in Boruvka rounds that drop each round the edges
// that have come to lie inside one component, until none is left; each
// selected edge keeps its index, the key's low 32 bits. A store that fits
// CAP bytes runs in shared memory; else the rounds run on device memory
// (best_all, hook_all; the list in place) until what is left fits, and the
// roots left are numbered anew as it moves into shared memory.
template <int CAP>
__global__ void __launch_bounds__(P2_THREADS)
mst_contract_kernel(Grid gr, unsigned long long* key_all, int2* uv_all, const int* ncomp,
                    const int* nedge, unsigned long long* best_all, int* hook_all,
                    unsigned char* sel_all, int* counts, unsigned long long* stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[32];
  const int tid = threadIdx.x, nt = blockDim.x, b = blockIdx.x;
  if (stamps && tid == 0) {
    stamps[b * MST_STAMPS] = ~stamps[b * MST_STAMPS];
    stamps[b * MST_STAMPS + 2] = global_ns();
  }
  int E = nedge[b], C = ncomp[b];
  if (counts && tid == 0) {
    counts[b * MST_COUNTS + 1] = C;
    counts[b * MST_COUNTS + 2] = E;
  }
  unsigned char* sel = sel_all + (size_t)b * gr.E;
  GlobalGraph dg{key_all + (size_t)b * gr.E, uv_all + (size_t)b * gr.E, best_all + (size_t)b * gr.V,
                 hook_all + (size_t)b * gr.V};
  int rounds = 0, dev_rounds = 0;
  const int* rank = nullptr;  // new labels of the roots, when the graph moved from device memory
  if (!fits_smem<CAP>(E, C)) {
    for (int c = tid; c < C; c += nt) dg.hook[c] = c;
    __syncthreads();
    for (;;) {
      E = contract_round(dg, E, C, sel, scratch);
      ++rounds;
      ++dev_rounds;
      if (E == 0) break;
      int roots = 0;
      for (int c = tid; c < C; c += nt) roots += dg.hook[c] == c;
      int R;
      block_exclusive_scan(roots, &R, scratch);
      if (!fits_smem<CAP>(E, R)) continue;
      // number the roots in label order; the ranks go where best was
      int* r = reinterpret_cast<int*>(dg.best);
      int base = 0;
      for (int c0 = 0; c0 < C; c0 += nt) {
        const int c = c0 + tid;
        const int root = c < C && dg.hook[c] == c;
        int total;
        const int off = block_exclusive_scan(root, &total, scratch);
        if (root) r[c] = base + off;
        base += total;
      }
      __syncthreads();
      rank = r;
      C = R;
      break;
    }
  }
  if (E > 0) {
    SmemGraph sg;
    sg.key = reinterpret_cast<unsigned long long*>(smem);
    sg.best = sg.key + E;
    sg.uv = reinterpret_cast<uint32_t*>(sg.best + C);
    sg.hook = reinterpret_cast<int*>(sg.uv + E);
    for (int i = tid; i < E; i += nt) {
      unsigned long long k;
      int u, v;
      dg.get(i, k, u, v);
      if (rank) {
        u = rank[u];
        v = rank[v];
      }
      sg.put(i, k, u, v);
    }
    for (int c = tid; c < C; c += nt) sg.hook[c] = c;
    __syncthreads();
    while (E > 0) {
      E = contract_round(sg, E, C, sel, scratch);
      ++rounds;
    }
  }
  if (tid == 0) {
    if (counts) {
      counts[b * MST_COUNTS + 3] = rounds;
      counts[b * MST_COUNTS + 4] = dev_rounds;
    }
    if (stamps) stamps[b * MST_STAMPS + 3] = global_ns();
  }
}

template <int T, int CAP>
cudaError_t mst_launch(const float* weights, unsigned char* sel, int* lab,
                       unsigned long long* keys, int2* uv, unsigned long long* best, int* hook,
                       int* ncomp, int* nedge, int* counts, unsigned long long* stamps, int n,
                       const Grid& g, cudaStream_t s) {
  using S = TileShape<T>;
  const int tiles_w = (g.W + T - 1) / T, tiles = (g.H + T - 1) / T * tiles_w;
  cudaError_t err = cudaFuncSetAttribute(mst_tile_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (err != cudaSuccess) return err;
  mst_tile_kernel<T><<<dim3(tiles, n), S::THREADS, S::SMEM, s>>>(
      weights, g, tiles_w, sel, lab, keys, uv, ncomp, nedge, counts, stamps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int cross = (g.H - 1) / T * g.W + (g.W - 1) / T * g.H;
  if (cross > 0) {
    const int blocks = min((cross + CROSS_THREADS - 1) / CROSS_THREADS, 64);
    mst_cross_kernel<<<dim3(blocks, n), CROSS_THREADS, 0, s>>>(weights, g, T, lab, keys, uv, nedge);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(mst_contract_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CAP);
  if (err != cudaSuccess) return err;
  mst_contract_kernel<CAP><<<n, P2_THREADS, CAP, s>>>(g, keys, uv, ncomp, nedge, best, hook, sel,
                                                      counts, stamps);
  return cudaGetLastError();
}

// ---- K2: BFS rooting at vertex 0 -----------------------------------------

constexpr int RING = 2048;          // queue entries held in shared memory: a level and the next
constexpr int SMALL_RING = 16;      // the tests': a level wider than it runs on device memory
constexpr int LEVEL_BUF = 4096;     // level offsets held in shared memory, flushed when full
constexpr int SMALL_LEVEL_BUF = 8;
constexpr int MASK_CAP = 160 * 1024;  // an image's masks in shared memory up to 327,680 vertices
constexpr int BFS_WARPS = 4;        // the BFS block's (1, 2 and 4 measured: PERF.md section 6)
constexpr int BFS_STAMPS = 2;       // stamps= columns
constexpr int MASK_THREADS = 256;

// Bytes of an image's packed masks: two vertices a byte, padded to 16.
__host__ __device__ __forceinline__ int mask_bytes(int V) { return ((V + 1) / 2 + 15) / 16 * 16; }

// Vertex u's selected edges in root_tree's child order: bit 0 right, 1
// left, 2 down, 3 up.
__device__ __forceinline__ int vertex_mask(const unsigned char* __restrict__ sel, const Grid& g,
                                           int u) {
  const int i = u / g.W, j = u - i * g.W, row = g.NV + i * (g.W - 1);
  return (j + 1 < g.W && sel[row + j]) | (j > 0 && sel[row + j - 1]) << 1 |
         (i + 1 < g.H && sel[u]) << 2 | (i > 0 && sel[u - g.W]) << 3;
}

// K2a: every image's masks, two vertices a byte (the even one low), on all SMs.
__global__ void __launch_bounds__(MASK_THREADS)
tree_mask_kernel(const unsigned char* __restrict__ sel_all, Grid g, int n, int MB,
                 unsigned char* masks_all) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)n * MB;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / MB), t = (int)(i - (size_t)b * MB);
    const unsigned char* sel = sel_all + (size_t)b * g.E;
    int m = 0;
    if (2 * t < g.V) m = vertex_mask(sel, g, 2 * t);
    if (2 * t + 1 < g.V) m |= vertex_mask(sel, g, 2 * t + 1) << 4;
    masks_all[i] = (unsigned char)m;
  }
}

// K2b: one block an image (blockIdx.x) of BFS_WARPS warps. A level's
// vertices take their children from their masks less the bit toward their
// parent, in bit order (right, left, down, up: root_tree's order); the next
// level is contiguous in the queue, ordered by parent position. Three
// ballots of the child counts' bits give each vertex its place in its warp,
// and one combine of the warps' sums at a barrier its place in the level.
// The current and next level's entries (vertex, direction to the parent)
// are in a ring of RING_N in shared memory: position q in slot q % RING_N,
// written while q is below the current level's start + RING_N (so it
// overwrites nothing not yet read); a level not written wholly there reads
// its vertices and their parents' from order and ppos, which this block
// wrote before. The masks are copied into shared memory by one bulk copy
// where mask_smem (else read from device memory). order, ppos and cptr go
// out as each level's stores; the level offsets collect in shared memory
// (LBUF, flushed when full and at the end).
template <int RING_N, int LBUF, bool MASK_SMEM>
__device__ __forceinline__ void bfs_levels(const unsigned char* __restrict__ mk, const Grid& g,
                                           int* ring, int* lbuf, int (*wsum)[BFS_WARPS], int* order,
                                           int* ppos, int* cptr, int* level, int* nlev_out,
                                           unsigned long long* stamp) {
  constexpr int NT = BFS_WARPS * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1;
  const int V = g.V, W = g.W;
  const int delta[4] = {1, -1, W, -W};
  int s = 0, e = 1, nlev = 0, lbase = 0, par = 0;
  bool ring_ok = true;
  for (;;) {
    int next = e;
    for (int base = s; base < e; base += NT) {
      const int p = base + tid;
      // the position's vertex and the bits to keep (all but the parent's)
      int u = 0, m = 0;
      if (ring_ok) {
        const int ent = ring[p & (RING_N - 1)];
        if (p < e) {
          u = ent >> 2;
          m = p > 0 ? 15 & ~(1 << (ent & 3)) : 15;
        }
      } else if (p < e) {
        u = order[p];
        const int d = order[ppos[p]] - u;
        m = 15 & ~(1 << (d == W ? 2 : d == -W ? 3 : d == 1 ? 0 : 1));
      }
      m &= (mk[u >> 1] >> ((u & 1) << 2)) & 15;
      const int cnt = __popc(m);
      const unsigned b0 = __ballot_sync(0xffffffffu, cnt & 1);
      const unsigned b1 = __ballot_sync(0xffffffffu, cnt & 2);
      const unsigned b2 = __ballot_sync(0xffffffffu, cnt & 4);
      int off = __popc(b0 & below) + 2 * __popc(b1 & below) + 4 * __popc(b2 & below);
      int total = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
      if (lane == 0) wsum[par][warp] = total;
      __syncthreads();
      total = 0;
#pragma unroll
      for (int k = 0; k < BFS_WARPS; ++k) {
        if (k == warp) off += total;
        total += wsum[par][k];
      }
      par ^= 1;
      if (p < e) {
        int q = next + off;
        cptr[p] = q;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (!((m >> d) & 1)) continue;
          const int c = u + delta[d];
          if (q < V) {  // q >= V only if sel holds a cycle
            order[q] = c;
            ppos[q] = p;
            if (q < s + RING_N) ring[q & (RING_N - 1)] = c << 2 | (d ^ 1);
          }
          ++q;
        }
      }
      next += total;
    }
    ++nlev;
    if (next == e) break;  // the level just read had no children
    if (next > V) {        // sel holds a cycle: no tree (n_levels 0)
      nlev = 0;
      break;
    }
    if (tid == 0) lbuf[nlev + 1 - lbase] = next;
    if (nlev + 1 - lbase == LBUF - 1) {  // full: flush all but the last offset
      __syncthreads();
      for (int i = tid; i < LBUF - 1; i += NT) level[lbase + i] = lbuf[i];
      __syncthreads();
      if (tid == 0) lbuf[0] = lbuf[LBUF - 1];
      lbase += LBUF - 1;
    }
    ring_ok = next <= s + RING_N;  // the new level [e, next) went wholly to the ring
    s = e;
    e = next;
    __syncthreads();  // the new level's entries are visible
  }
  __syncthreads();
  if (stamp && tid == 0) *stamp = global_ns();
  for (int i = tid; i <= max(nlev, 1) - lbase; i += NT) level[lbase + i] = lbuf[i];
  if (tid == 0) *nlev_out = nlev;
}

template <int RING_N, int LBUF>
__global__ void __launch_bounds__(BFS_WARPS * 32)
tree_bfs_kernel(const unsigned char* __restrict__ masks_all, int MB, bool mask_smem, Grid g,
                int* order_all, int* ppos_all, int* cptr_all, int* level_all, int* nlev_all,
                unsigned long long* stamps) {
  extern __shared__ __align__(16) unsigned char smask[];
  __shared__ int ring[RING_N];
  __shared__ int lbuf[LBUF];
  __shared__ int wsum[2][BFS_WARPS];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, b = blockIdx.x;
  const unsigned char* gmask = masks_all + (size_t)b * MB;
  int* order = order_all + (size_t)b * g.V;
  int* ppos = ppos_all + (size_t)b * g.V;
  int* cptr = cptr_all + (size_t)b * (g.V + 1);
  if (mask_smem) {
    if (tid == 0) {
      mbar_init(&bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(&bar, MB);
      bulk_load(smask, gmask, MB, &bar);
    }
    mbar_wait(&bar, 0);
  }
  if (tid == 0) {
    order[0] = 0;
    ppos[0] = 0;
    ring[0] = 0;  // vertex 0; the root has no parent bit to clear
    lbuf[0] = 0;
    lbuf[1] = 1;
    cptr[g.V] = g.V;
    if (stamps) stamps[b * BFS_STAMPS] = global_ns();
  }
  __syncthreads();
  int* level = level_all + (size_t)b * (g.V + 1);
  unsigned long long* stamp = stamps ? stamps + b * BFS_STAMPS + 1 : nullptr;
  if (mask_smem)
    bfs_levels<RING_N, LBUF, true>(smask, g, ring, lbuf, wsum, order, ppos, cptr, level,
                                   nlev_all + b, stamp);
  else
    bfs_levels<RING_N, LBUF, false>(gmask, g, ring, lbuf, wsum, order, ppos, cptr, level,
                                    nlev_all + b, stamp);
}

// K2c: parents by vertex and the filter weights in queue order, on all SMs:
// parent(order[q]) = order[ppos[q]], w = exp(-||embed(v) - embed(parent)||^2
// * inv_sigma), 1/sigma on the first n_low images and 1 on the rest, the
// root's 0.
__global__ void __launch_bounds__(PAR_THREADS)
root_weights_kernel(const float* __restrict__ embed_all, int D, Grid g, int n, int n_low,
                    float inv_sigma_low, const int* __restrict__ order_all,
                    const int* __restrict__ ppos_all, int* parent_all, float* w_all) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)n * g.V;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / g.V), q = (int)(i - (size_t)b * g.V);
    const int v = order_all[i], pp = ppos_all[i];
    float wq = 0.f;
    // a position the BFS did not reach (sel not a tree) holds no vertex
    if ((unsigned)v < (unsigned)g.V && (unsigned)pp < (unsigned)g.V) {
      const int pv = order_all[(size_t)b * g.V + pp];
      parent_all[(size_t)b * g.V + v] = pv;  // the root's: order[0] = 0
      if (q > 0 && (unsigned)pv < (unsigned)g.V) {
        const float* embed = embed_all + (size_t)b * g.V * D;
        const float inv = b < n_low ? inv_sigma_low : 1.f;
        float s = 0.f;
        for (int d = 0; d < D; ++d) {
          const float df = __fsub_rn(embed[(size_t)v * D + d], embed[(size_t)pv * D + d]);
          s = __fmaf_rn(df, df, s);
        }
        wq = expf(-__fmul_rn(s, inv));
      }
    }
    w_all[i] = wq;
  }
}

template <int RING_N, int LBUF>
cudaError_t bfs_launch(const unsigned char* masks, int MB, bool mask_smem, const Grid& g, int n,
                       int* order, int* ppos, int* cptr, int* level, int* nlev,
                       unsigned long long* stamps, cudaStream_t s) {
  auto kernel = tree_bfs_kernel<RING_N, LBUF>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MASK_CAP);
  if (err != cudaSuccess) return err;
  kernel<<<n, BFS_WARPS * 32, mask_smem ? MB : 0, s>>>(masks, MB, mask_smem, g, order, ppos, cptr,
                                                       level, nlev, stamps);
  return cudaGetLastError();
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

constexpr int PAD = 256;           // the scratch's positions an image: a multiple of PAD
constexpr int TILE = 256, TILES = 8;             // the main path's window: 2,048 positions
constexpr int SMALL_TILE = 16, SMALL_TILES = 4;  // a 64-position window, for the tests
constexpr int WARPS = 4;           // consumer warps (1, 2 and 4 measured: PERF.md section 6)
constexpr int CONSUMERS = WARPS * 32;
constexpr int LEVEL_CAP = 8192;    // level offsets kept in shared memory (else streamed)

__host__ __device__ __forceinline__ int padded(int V) { return (V + PAD - 1) / PAD * PAD; }

// level[k] for k = first, first + dir, ...: lane i of the warp holds
// level[k + dir * i] and the next batch of 32 is in flight behind it; 0 past
// either end. Every lane of the warp calls next() together.
struct LevelStream {
  const int* level;
  int last, dir, k, idx, cur, nxt;

  __device__ LevelStream(const int* lv, int n_levels, bool up)
      : level(lv), last(n_levels), dir(up ? -1 : 1), k(up ? n_levels : 0), idx(0) {
    const int lane = threadIdx.x & 31;
    cur = load(k + dir * lane);
    nxt = load(k + dir * (32 + lane));
  }
  __device__ int load(int i) const { return i >= 0 && i <= last ? __ldg(level + i) : 0; }
  __device__ int next() {
    const int v = __shfl_sync(0xffffffffu, cur, idx);
    if (++idx == 32) {
      idx = 0;
      cur = nxt;
      k += 32 * dir;
      nxt = load(k + dir * (32 + (threadIdx.x & 31)));
    }
    return v;
  }
};

// A row of CH values in device memory: 16-byte moves where the row's size
// allows (its address then allows them too: rows start at multiples of its
// size).
template <int CH, class T>
__device__ __forceinline__ void ld_row(const T* p, T (&v)[CH]) {
  constexpr int BYTES = CH * sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    uint4 u[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) u[i] = reinterpret_cast<const uint4*>(p)[i];
    memcpy(v, u, BYTES);
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c) v[c] = p[c];
  }
}

template <int CH, class T>
__device__ __forceinline__ void st_row(T* p, const T (&v)[CH]) {
  constexpr int BYTES = CH * sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    uint4 u[BYTES / 16];
    memcpy(u, v, BYTES);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) reinterpret_cast<uint4*>(p)[i] = u[i];
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c) p[c] = v[c];
  }
}

// Shared memory by its 32-bit address: explicit ld.shared / st.shared, kept
// in program order, so a level's loads all leave before the first use. A
// load where p is false moves no data and gives zeros (+0.0).
__device__ __forceinline__ uint32_t lds32(uint32_t a, bool p = true) {
  uint32_t v = 0;
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q ld.shared.u32 %0, [%1];\n}"
               : "+r"(v)
               : "r"(a), "r"((uint32_t)p)
               : "memory");
  return v;
}

__device__ __forceinline__ int4 lds128(uint32_t a, bool p = true) {
  int4 v = make_int4(0, 0, 0, 0);
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %5, 0;\n"
      " @q ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n}"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "r"(a), "r"((uint32_t)p)
      : "memory");
  return v;
}

template <int CH, class T>
__device__ __forceinline__ void lds_row(uint32_t a, T (&v)[CH], bool p = true) {
  constexpr int BYTES = CH * sizeof(T);
  uint32_t u[BYTES / 4];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const int4 w = lds128(a + 16 * i, p);
      u[4 * i] = w.x;
      u[4 * i + 1] = w.y;
      u[4 * i + 2] = w.z;
      u[4 * i + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) u[i] = lds32(a + 4 * i, p);
  }
  memcpy(v, u, BYTES);
}

template <int CH, class T>
__device__ __forceinline__ void sts_row(uint32_t a, const T (&v)[CH]) {
  constexpr int BYTES = CH * sizeof(T);
  uint32_t u[BYTES / 4];
  memcpy(u, v, BYTES);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a + 16 * i), "r"(u[4 * i]),
                   "r"(u[4 * i + 1]), "r"(u[4 * i + 2]), "r"(u[4 * i + 3])
                   : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i)
      asm volatile("st.shared.u32 [%0], %1;" ::"r"(a + 4 * i), "r"(u[i]) : "memory");
  }
}

// Level offsets from shared memory (a copy of the image's, when it fits),
// in the pass's order; 0 once all n_levels + 1 are read.
struct SmemLevels {
  uint32_t at;  // the address of the next offset
  int step;     // +4 or -4 bytes
  int left;     // offsets not yet read
  __device__ SmemLevels(uint32_t base, int n_levels, bool up)
      : at(base + 4 * (up ? n_levels : 0)), step(up ? -4 : 4), left(n_levels + 1) {}
  __device__ int next() {
    const int v = (int)lds32(at, left-- > 0);
    at += step;
    return v;
  }
};

// One image's two passes. ``A`` is the padded queue-order scratch [Vp, CH]
// (the pass's input, overwritten by A upward); ``M`` the padded records
// (w bits, first child, end of children, ppos); ``F`` the padded [Vp, CH]
// written downward. Warps 0..WARPS-1 compute, warp WARPS loads tiles.
//
// In the window (SMEM), position q is in ring row q % W of W = NT * TP, so
// tile t (positions t*TP ..) in ring slot t % NT. A pass takes its tiles in
// its own order (pass tile j is tile nt-1-j upward, j downward), and the
// j-th use of a slot is use j / NT of that slot's barriers (a pair each for
// the two passes). Without the window every row is read from and written to
// device memory.
template <int CH, class T, int TP, int NT>
struct Passes {
  static constexpr int W = TP * NT, ROW = CH * sizeof(T);
  static constexpr int RELEASER = CONSUMERS - 1;  // the thread least often busy in a level
  uint32_t sdata;   // shared address of the rows [W][CH]
  uint32_t smeta;   // shared address of the records [W]
  uint64_t* full;   // [2][NT]: the tile landed
  uint64_t* empty;  // [2][NT]: the tile's rows left and its slot is free
  T* A;             // global, this image's padded rows
  const int4* M;
  T* F;
  int nt;
  bool up;
  int waited, released;  // the pass's tiles [0, waited) waited on, [0, released) stored

  __device__ static uint32_t row_off(int q) { return (uint32_t)(q & (W - 1)); }
  __device__ uint32_t row_at(int q) const { return sdata + row_off(q) * ROW; }
  __device__ uint32_t meta_at(int q) const { return smeta + row_off(q) * 16; }
  __device__ static int tile(int q) { return (int)((unsigned)q / TP); }  // q >= 0
  __device__ int tile_of(int j) const { return up ? nt - 1 - j : j; }
  __device__ int bar(int j) const { return (up ? 0 : NT) + (int)((unsigned)tile_of(j) % NT); }

  // every consumer waits for the pass's tiles [waited, j_end)
  __device__ void acquire(int j_end) {
    for (; waited < j_end; ++waited) mbar_wait(&full[bar(waited)], ((unsigned)waited / NT) & 1);
  }

  // after a level: the pass's tiles [released, j_end) hold final rows (A
  // upward, F downward) that no later level reads. Each consumer fences its
  // writes to them (the async proxy reads them next); past the consumers'
  // barrier one thread sends each tile to device memory by a bulk store and
  // frees the slot of the tile before it once that tile's store has read
  // its rows. So one slot stays held: a level with the level it reads may
  // span NT - 1 tiles (tree_pass_kernel's test).
  __device__ void level_done(int j_end) {
    const bool rel = j_end > released;
    if (rel) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumer_sync();
    if (!rel) return;
    if (threadIdx.x == RELEASER) {
      T* out = up ? A : F;
      for (int j = released; j < j_end; ++j) {
        const int t = tile_of(j);
        bulk_store(out + (size_t)t * TP * CH, sdata + (uint32_t)(t % NT) * TP * ROW, TP * ROW);
        bulk_wait_read<1>();
        if (j > 0) mbar_arrive(&empty[bar(j - 1)]);
      }
    }
    released = j_end;
  }

  __device__ static void consumer_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  }

  // A row, a child's weight and a child's row, from the window or device
  // memory; a missing child's are zeros
  __device__ void load_row(int q, T (&v)[CH], bool smem) const {
    if (smem)
      lds_row<CH>(row_at(q), v);
    else
      ld_row<CH>(A + (size_t)q * CH, v);
  }

  __device__ T child_w(bool smem, bool has, int r) const {
    return T(__int_as_float(smem ? (int)lds32(meta_at(r), has) : (has ? M[r].x : 0)));
  }

  __device__ void child_row(bool smem, bool has, int r, T (&v)[CH]) const {
    if (smem) {
      lds_row<CH>(row_at(r), v, has);
    } else if (has) {
      ld_row<CH>(A + (size_t)r * CH, v);
    } else {
#pragma unroll
      for (int c = 0; c < CH; ++c) v[c] = T(0);
    }
  }

  // acc += w * a over the children, last to first, as fused multiply-adds
  // (a missing child's w and a are +0, which adds an exact zero)
  __device__ static void pull(T (&acc)[CH], const T (&wk)[MAX_CHILDREN],
                              const T (&ak)[MAX_CHILDREN][CH]) {
#pragma unroll
    for (int k = 0; k < MAX_CHILDREN; ++k) {
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = fma(wk[k], ak[k][c], acc[c]);
    }
  }

  // F = A (1 - w^2) + w F_parent, as one rounding order everywhere
  __device__ static void push(T (&f)[CH], const T (&a)[CH], T w, const T (&fp)[CH]) {
    const T k = fma(-w, w, T(1));
#pragma unroll
    for (int c = 0; c < CH; ++c) f[c] = fma(w, fp[c], a[c] * k);
  }

  // upward over positions [s, e): every child's weight and row is loaded
  // before the first is summed
  template <bool SMEM>
  __device__ void up_level(int s, int e) {
    for (int q = s + (int)threadIdx.x; q < e; q += CONSUMERS) {
      const int4 m = SMEM ? lds128(meta_at(q)) : M[q];
      T acc[CH], wk[MAX_CHILDREN], ak[MAX_CHILDREN][CH];
      load_row(q, acc, SMEM);
#pragma unroll
      for (int k = 0; k < MAX_CHILDREN; ++k) {
        const int r = m.z - 1 - k;
        wk[k] = child_w(SMEM, r >= m.y, r);
        child_row(SMEM, r >= m.y, r, ak[k]);
      }
      pull(acc, wk, ak);
      if (SMEM)
        sts_row<CH>(row_at(q), acc);
      else
        st_row<CH>(A + (size_t)q * CH, acc);
    }
  }

  // downward over positions [s, e)
  template <bool SMEM>
  __device__ void down_level(int s, int e) {
    for (int q = s + (int)threadIdx.x; q < e; q += CONSUMERS) {
      const int4 m = SMEM ? lds128(meta_at(q)) : M[q];
      T a[CH], f[CH], fp[CH];
      load_row(q, a, SMEM);
      if (SMEM)
        lds_row<CH>(row_at(m.w), fp);
      else
        ld_row<CH>(F + (size_t)m.w * CH, fp);
      if (q == 0) {
#pragma unroll
        for (int c = 0; c < CH; ++c) f[c] = a[c];  // root: w = 0
      } else {
        push(f, a, T(__int_as_float(m.x)), fp);
      }
      if (SMEM)
        sts_row<CH>(row_at(q), f);
      else
        st_row<CH>(F + (size_t)q * CH, f);
    }
  }

  // deepest level first; level L spans [s, e) and reads its children in the
  // level after it, whose tiles it waited for. The next level's offset is
  // read before this level's barrier.
  template <bool SMEM, class Levels>
  __device__ void upward(Levels ls, int n_levels) {
    up = true;
    waited = released = 0;
    int e = ls.next();  // level[n_levels] == V
    int s = ls.next();
    for (int L = n_levels - 1; L >= 0; --L) {
      if (SMEM) acquire(nt - tile(s));
      up_level<SMEM>(s, e);
      const int s_next = ls.next();
      if (SMEM)
        level_done(L > 0 ? nt - 1 - tile(e - 1) : nt);
      else
        consumer_sync();
      e = s;
      s = s_next;
    }
  }

  // root first; level L spans [s, e) and reads its parents in the level
  // before it
  template <bool SMEM, class Levels>
  __device__ void downward(Levels ls, int n_levels) {
    up = false;
    waited = released = 0;
    int s = ls.next();  // level[0] == 0
    int e = ls.next();
    for (int L = 0; L < n_levels; ++L) {
      if (SMEM) acquire(tile(e - 1) + 1);
      down_level<SMEM>(s, e);
      const int e_next = ls.next();
      if (SMEM)
        level_done(L + 1 < n_levels ? tile(s) : nt);
      else
        consumer_sync();
      s = e;
      e = e_next;
    }
  }

  // the releaser's stores have landed (device memory is read next)
  __device__ void flush() const {
    if (threadIdx.x == RELEASER) bulk_wait_all();
  }
};

template <int CH, class T, int TP, int NT>
constexpr size_t pass_smem_bytes() {
  return (size_t)NT * TP * (CH * sizeof(T) + sizeof(int4)) + 4 * NT * sizeof(uint64_t) +
         LEVEL_CAP * sizeof(int);
}

// K3b / K4b: one block an image (WARPS consumer warps and one producer).
// data [B, Vp, CH] in, A out in place; meta [B, Vp]; F [B, Vp, CH] out;
// stamps [B, 3] (or NULL): %globaltimer at the start, between the passes and
// at the end.
//
// An image takes the window when every level, with the level it reads,
// spans at most NT - 1 tiles; else (a level wider than the window) both its
// passes read and write device memory, in this kernel.
template <int CH, class T, int TP, int NT>
__global__ void __launch_bounds__((WARPS + 1) * 32)
tree_pass_kernel(T* data, const int4* __restrict__ meta, const int* __restrict__ level_all,
                 const int* __restrict__ nlev_all, int V, T* F_all,
                 unsigned long long* stamps) {
  static_assert((TP & (TP - 1)) == 0 && (NT & (NT - 1)) == 0 && PAD % TP == 0 && NT >= 2,
                "tiles and slots are powers of two, tiles divide the padding");
  static_assert((TP * CH * sizeof(T)) % 16 == 0, "tiles must be 16-byte aligned");
  extern __shared__ __align__(16) unsigned char smem[];
  using P = Passes<CH, T, TP, NT>;
  constexpr size_t rows = (size_t)NT * TP * CH * sizeof(T), metas = (size_t)NT * TP * sizeof(int4);
  P p;
  p.sdata = smem_addr(smem);
  p.smeta = p.sdata + rows;
  p.full = reinterpret_cast<uint64_t*>(smem + rows + metas);
  p.empty = p.full + 2 * NT;
  int* slevel = reinterpret_cast<int*>(p.empty + 2 * NT);
  const int b = blockIdx.x, Vp = padded(V);
  p.A = data + (size_t)b * Vp * CH;
  p.M = meta + (size_t)b * Vp;
  p.F = F_all + (size_t)b * Vp * CH;
  p.nt = (V + TP - 1) / TP;
  const int* level = level_all + (size_t)b * (V + 1);
  const int n_levels = nlev_all[b];
  const bool levels_in_smem = n_levels < LEVEL_CAP;  // n_levels + 1 offsets

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * NT; ++i) {
      mbar_init(&p.full[i], 1);
      mbar_init(&p.empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (stamps) stamps[b * 3] = global_ns();
  }
  int wide = 0;
  for (int i = threadIdx.x; i <= n_levels; i += blockDim.x) {
    if (levels_in_smem) slevel[i] = level[i];
    if (i < n_levels)  // level i with the next: tiles tile(level[i]) .. tile(end - 1)
      wide |= (level[min(i + 2, n_levels)] - 1) / TP - level[i] / TP >= NT - 1;
  }
  const bool any_wide = __syncthreads_or(wide);
  const bool window = n_levels > 0 && !any_wide;  // n_levels 0: no tree, nothing to do

  if (threadIdx.x >= CONSUMERS) {
    if (!window) return;
    // the producer: the upward pass's tiles from the last to the first, then
    // (once the upward pass has stored all of A) the downward pass's in order
    constexpr uint32_t bytes = TP * CH * sizeof(T) + TP * sizeof(int4);
    for (int pass = 0; pass < 2; ++pass) {
      p.up = pass == 0;
      if (threadIdx.x == CONSUMERS) {
        for (int j = 0; j < p.nt; ++j) {
          const int t = p.tile_of(j), sl = t % NT, bi = p.bar(j);
          if (j >= NT) mbar_wait(&p.empty[bi], (j / NT - 1) & 1);
          mbar_expect_tx(&p.full[bi], bytes);
          bulk_load(smem + (size_t)sl * TP * CH * sizeof(T), p.A + (size_t)t * TP * CH,
                    TP * CH * sizeof(T), &p.full[bi]);
          bulk_load(smem + rows + (size_t)sl * TP * sizeof(int4), p.M + (size_t)t * TP,
                    TP * sizeof(int4), &p.full[bi]);
        }
      }
      __syncwarp();
      if (pass == 0) __syncthreads();
    }
    return;
  }
  const uint32_t lv = smem_addr(slevel);
  if (window) {
    if (levels_in_smem)
      p.template upward<true>(SmemLevels(lv, n_levels, true), n_levels);
    else
      p.template upward<true>(LevelStream(level, n_levels, true), n_levels);
    p.flush();
    // A (device memory) is read next by the producer's bulk loads
    asm volatile("fence.proxy.async;" ::: "memory");
    __syncthreads();
  } else {
    if (levels_in_smem)
      p.template upward<false>(SmemLevels(lv, n_levels, true), n_levels);
    else
      p.template upward<false>(LevelStream(level, n_levels, true), n_levels);
  }
  if (stamps && threadIdx.x == 0) stamps[b * 3 + 1] = global_ns();
  if (window) {
    if (levels_in_smem)
      p.template downward<true>(SmemLevels(lv, n_levels, false), n_levels);
    else
      p.template downward<true>(LevelStream(level, n_levels, false), n_levels);
    p.flush();
  } else {
    if (levels_in_smem)
      p.template downward<false>(SmemLevels(lv, n_levels, false), n_levels);
    else
      p.template downward<false>(LevelStream(level, n_levels, false), n_levels);
  }
  if (stamps && threadIdx.x == 0) stamps[b * 3 + 2] = global_ns();
}

// a position's record in the padded scratch: (w bits, first child, end of
// children, ppos)
__device__ __forceinline__ int4 position_record(const Tree& t, int q) {
  return make_int4(__float_as_int(t.w[q]), t.cptr[q], t.cptr[q + 1], t.ppos[q]);
}

// K3a: [x[order[q]], 1] and the records in queue order
template <int C>
__global__ void __launch_bounds__(PAR_THREADS)
fwd_gather_kernel(const float* __restrict__ x_all, Tree all, int B, int V, float* data,
                  int4* meta) {
  constexpr int CH = C + 1;
  const int Vp = padded(V);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)B * V;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / V), q = (int)(i - (size_t)b * V);
    const Tree t = image_tree(all, b, V);
    const int v = t.order[q];
    const float* xv = x_all + ((size_t)b * V + v) * C;
    float* d = data + ((size_t)b * Vp + q) * CH;
#pragma unroll
    for (int c = 0; c < C; ++c) d[c] = xv[c];
    d[C] = 1.f;
    meta[(size_t)b * Vp + q] = position_record(t, q);
  }
}

// K3c: y = F_x / F_1 in vertex order; A and F out of the padded scratch
template <int C>
__global__ void __launch_bounds__(PAR_THREADS)
fwd_scatter_kernel(const float* __restrict__ data, const float* __restrict__ fdata, Tree all,
                   int B, int V, float* A, float* F, float* y) {
  constexpr int CH = C + 1;
  const int Vp = padded(V);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)B * V;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / V), q = (int)(i - (size_t)b * V);
    const int v = all.order[i];
    const size_t pq = ((size_t)b * Vp + q) * CH;
    const float* f = fdata + pq;
    float* yv = y + ((size_t)b * V + v) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) yv[c] = f[c] / f[C];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      A[i * CH + c] = data[pq + c];
      F[i * CH + c] = f[c];
    }
  }
}

// K4a: [g/z, g*y/z] in double, z = F_1, in queue order; the records
template <int C>
__global__ void __launch_bounds__(PAR_THREADS)
bwd_gather_kernel(const float* __restrict__ g_all, const float* __restrict__ y_all,
                  const float* __restrict__ F_all, Tree all, int B, int V, double* data,
                  int4* meta) {
  constexpr int CH = C + 1, CH2 = 2 * C;
  const int Vp = padded(V);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)B * V;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / V), q = (int)(i - (size_t)b * V);
    const Tree t = image_tree(all, b, V);
    const int v = t.order[q];
    const double z = F_all[i * CH + C];
    const float* gv = g_all + ((size_t)b * V + v) * C;
    const float* yv = y_all + ((size_t)b * V + v) * C;
    double* d = data + ((size_t)b * Vp + q) * CH2;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const double gc = gv[c];
      d[c] = gc / z;
      d[C + c] = gc * yv[c] / z;
    }
    meta[(size_t)b * Vp + q] = position_record(t, q);
  }
}

// K4c: dx = F_{g/z} back to vertex order; on a high tree (dd non-NULL) each
// position's dL/d dist of its edge to its parent, by crossing pairs
template <int C>
__global__ void __launch_bounds__(PAR_THREADS)
bwd_scatter_kernel(const double* __restrict__ Aa_all, const double* __restrict__ Fa_all,
                   const float* __restrict__ A_all, const float* __restrict__ F_all, Tree all,
                   int B, int V, float* dx, double* dd) {
  constexpr int CH = C + 1, CH2 = 2 * C;
  const int Vp = padded(V);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)B * V;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / V), q = (int)(i - (size_t)b * V);
    const double* Fav = Fa_all + ((size_t)b * Vp + q) * CH2;
    float* dxv = dx + ((size_t)b * V + all.order[i]) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dxv[c] = (float)Fav[c];
    if (dd == nullptr) continue;
    double out = 0.0;
    if (q > 0) {
      const int pp = all.ppos[i];
      const double wv = all.w[i];
      const float* Av = A_all + i * CH;
      const float* Fp = F_all + ((size_t)b * V + pp) * CH;
      const double* Aav = Aa_all + ((size_t)b * Vp + q) * CH2;
      const double* Fap = Fa_all + ((size_t)b * Vp + pp) * CH2;
      double s1 = 0.0, s2 = 0.0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s1 += Aav[c] * (Fp[c] - wv * Av[c]) + Av[c] * (Fap[c] - wv * Aav[c]);
        s2 += Aav[C + c] * (Fp[C] - wv * Av[C]) + Av[C] * (Fap[C + c] - wv * Aav[C + c]);
      }
      out = (s1 - s2) * -wv;  // a high tree's w = exp(-dist): dw/d dist = -w
    }
    dd[i] = out;
  }
}

// K4d: d embed(v) = 2 dd(v) (e_v - e_parent) - sum over children u of
// 2 dd(u) (e_u - e_v)
__global__ void __launch_bounds__(PAR_THREADS)
dembed_kernel(const double* __restrict__ dd_all, const float* __restrict__ embed_all, int D,
              Tree all, int B, int V, float* dembed_all) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)B * V;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / V), q = (int)(i - (size_t)b * V);
    const Tree t = image_tree(all, b, V);
    const float* embed = embed_all + (size_t)b * V * D;
    const double* dd = dd_all + (size_t)b * V;
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
    for (int j = 0; j < MAX_CHILDREN; ++j) {
      const int r = c0 + j;
      if (r >= c1) break;
      const float* eu = embed + (size_t)t.order[r] * D;
      const double k = dd[r] * 2.0;
#pragma unroll
      for (int d = 0; d < MAX_EMBED; ++d)
        if (d < D) acc[d] -= k * ((double)eu[d] - ev[d]);
    }
    float* de = dembed_all + ((size_t)b * V + v) * D;
#pragma unroll
    for (int d = 0; d < MAX_EMBED; ++d)
      if (d < D) de[d] = (float)acc[d];
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

template <int CH, class T, int TP, int NT>
cudaError_t launch_passes(T* data, const int4* meta, const Tree& t, int B, int V, T* F,
                          unsigned long long* stamps, cudaStream_t s) {
  auto kernel = tree_pass_kernel<CH, T, TP, NT>;
  constexpr size_t bytes = pass_smem_bytes<CH, T, TP, NT>();
  static_assert(bytes <= 232448, "the window exceeds a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, (WARPS + 1) * 32, bytes, s>>>(data, meta, t.level, t.nlev, V, F, stamps);
  return cudaGetLastError();
}

// the passes' instance by its window's positions: the main path's, or the
// tests' small one
template <int CH, class T>
cudaError_t passes(int window, T* data, const int4* meta, const Tree& t, int B, int V, T* F,
                   unsigned long long* stamps, cudaStream_t s) {
  if (window == TILE * TILES)
    return launch_passes<CH, T, TILE, TILES>(data, meta, t, B, V, F, stamps, s);
  if (window == SMALL_TILE * SMALL_TILES)
    return launch_passes<CH, T, SMALL_TILE, SMALL_TILES>(data, meta, t, B, V, F, stamps, s);
  return cudaErrorInvalidValue;
}

template <int C>
int filter_fwd(const float* x, const Tree& t, float* A, float* F, float* y, float* data,
               float* fdata, int4* meta, unsigned long long* stamps, int B, int V, int window,
               cudaStream_t s) {
  const int blocks = par_blocks(B, V);
  fwd_gather_kernel<C><<<blocks, PAR_THREADS, 0, s>>>(x, t, B, V, data, meta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = passes<C + 1, float>(window, data, meta, t, B, V, fdata, stamps, s);
  if (err != cudaSuccess) return (int)err;
  fwd_scatter_kernel<C><<<blocks, PAR_THREADS, 0, s>>>(data, fdata, t, B, V, A, F, y);
  return (int)cudaGetLastError();
}

template <int C>
int filter_bwd(const float* g, const float* y, const float* A, const float* F, const Tree& t,
               const float* embed, int D, double* Aa, double* Fa, double* dd, int4* meta,
               float* dx, float* dembed, unsigned long long* stamps, int B, int V, int window,
               cudaStream_t s) {
  const int blocks = par_blocks(B, V);
  bwd_gather_kernel<C><<<blocks, PAR_THREADS, 0, s>>>(g, y, F, t, B, V, Aa, meta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = passes<2 * C, double>(window, Aa, meta, t, B, V, Fa, stamps, s);
  if (err != cudaSuccess) return (int)err;
  bwd_scatter_kernel<C><<<blocks, PAR_THREADS, 0, s>>>(Aa, Fa, A, F, t, B, V, dx,
                                                      embed != nullptr ? dd : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || embed == nullptr) return (int)err;
  dembed_kernel<<<blocks, PAR_THREADS, 0, s>>>(dd, embed, D, t, B, V, dembed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. weights [N, E] fp32 >= 0 -> sel [N, E] bytes 0/1. Scratch: lab int32
// [N, V], the contracted edges' keys uint64 [N, E] and labels int32
// [N, E, 2], best uint64 [N, V], hook int32 [N, V], counters int32 [N, 2].
// counts int32 [N, 5] (phase 1's rounds, then the components and edges it
// left, phase 2's rounds and those on device memory) and stamps uint64
// [N, 4] (%globaltimer: phase 1's first start and last end over the image's
// tiles, phase 2's start and end), each or NULL. tile: MST_TILE, or
// SMALL_MST_TILE (with a small contracted store).
int tree_mst(const float* weights, unsigned char* sel, int* lab, unsigned long long* keys, int* uv,
             unsigned long long* best, int* hook, int* counters, int* counts,
             unsigned long long* stamps, int n, int H, int W, int tile, void* stream) {
  if (n < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Grid g = make_grid(H, W);
  cudaError_t err = cudaMemsetAsync(counters, 0, sizeof(int) * 2 * n, s);
  if (err == cudaSuccess && counts)
    err = cudaMemsetAsync(counts, 0, sizeof(int) * MST_COUNTS * n, s);
  if (err == cudaSuccess && stamps)
    err = cudaMemsetAsync(stamps, 0, sizeof(unsigned long long) * MST_STAMPS * n, s);
  if (err != cudaSuccess) return (int)err;
  int2* uv2 = reinterpret_cast<int2*>(uv);
  int* ncomp = counters;
  int* nedge = counters + n;
  switch (tile) {
    case MST_TILE:
      return (int)mst_launch<MST_TILE, P2_SMEM>(weights, sel, lab, keys, uv2, best, hook, ncomp,
                                                nedge, counts, stamps, n, g, s);
    case SMALL_MST_TILE:
      return (int)mst_launch<SMALL_MST_TILE, SMALL_P2_SMEM>(weights, sel, lab, keys, uv2, best,
                                                            hook, ncomp, nedge, counts, stamps, n,
                                                            g, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K2. sel [N, E]; embed [N, V, D] fp32; scratch masks [N, tree_root_mask_bytes(V)];
// outputs order, parent, ppos, w [N, V], cptr, level [N, V + 1], nlev [N];
// stamps uint64 [N, 2] (%globaltimer at the BFS's start and end) or NULL;
// ring RING, or SMALL_RING (it reads the masks from device memory and
// flushes the level offsets every few levels).
int tree_root(const unsigned char* sel, const float* embed, int D, int n, int H, int W,
              int n_low, float inv_sigma_low, unsigned char* masks, int* order, int* parent,
              int* ppos, int* cptr, int* level, int* nlev, float* w, unsigned long long* stamps,
              int ring, void* stream) {
  if (n < 1 || H < 1 || W < 1 || D < 1 || D > MAX_EMBED) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Grid g = make_grid(H, W);
  const int MB = mask_bytes(g.V);
  const int blocks = par_blocks(n, MB);
  tree_mask_kernel<<<blocks, MASK_THREADS, 0, s>>>(sel, g, n, MB, masks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool mask_smem = MB <= MASK_CAP;
  if (ring == RING)
    err = bfs_launch<RING, LEVEL_BUF>(masks, MB, mask_smem, g, n, order, ppos, cptr, level, nlev,
                                      stamps, s);
  else if (ring == SMALL_RING)
    err = bfs_launch<SMALL_RING, SMALL_LEVEL_BUF>(masks, MB, false, g, n, order, ppos, cptr, level,
                                                  nlev, stamps, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  root_weights_kernel<<<par_blocks(n, g.V), PAR_THREADS, 0, s>>>(embed, D, g, n, n_low,
                                                                 inv_sigma_low, order, ppos, parent,
                                                                 w);
  return (int)cudaGetLastError();
}

// K1's phase-1 kernel at the main path's tile as built: registers a thread
// in out[0], local memory bytes a thread (spills) in out[1].
int tree_mst_tile_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, mst_tile_kernel<MST_TILE>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}

// Bytes an image of K2's mask scratch.
int tree_root_mask_bytes(int V) { return mask_bytes(V); }

// Positions an image of the filters' padded scratch (a multiple of 256).
int tree_filter_padded(int V) { return padded(V); }

// The passes' consumer warps.
int tree_filter_consumer_warps() { return WARPS; }

// K3. x [B, V, C] fp32 (vertex order); tree arrays of these B images;
// outputs A, F [B, V, C + 1] (queue order), y [B, V, C] (vertex order);
// scratch data, fdata [B, Vp, C + 1] fp32 and meta [B, Vp, 4] int32 (Vp =
// tree_filter_padded(V)); stamps [B, 3] uint64 or NULL; the passes' window
// (positions).
int tree_filter_fwd(const float* x, const int* order, const int* parent, const int* ppos,
                    const int* cptr, const int* level, const int* nlev, const float* w,
                    float* A, float* F, float* y, float* data, float* fdata, int* meta,
                    unsigned long long* stamps, int B, int V, int C, int window, void* stream) {
  if (B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const Tree t = make_tree(order, parent, ppos, cptr, level, nlev, w);
  cudaStream_t s = (cudaStream_t)stream;
  int4* m = reinterpret_cast<int4*>(meta);
  switch (C) {
    case 1: return filter_fwd<1>(x, t, A, F, y, data, fdata, m, stamps, B, V, window, s);
    case 2: return filter_fwd<2>(x, t, A, F, y, data, fdata, m, stamps, B, V, window, s);
    case 3: return filter_fwd<3>(x, t, A, F, y, data, fdata, m, stamps, B, V, window, s);
    case 4: return filter_fwd<4>(x, t, A, F, y, data, fdata, m, stamps, B, V, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4. g, y [B, V, C] (vertex order); A, F [B, V, C + 1] from K3; embed
// [B, V, D] or NULL (low tree); float64 scratch Aa, Fa [B, Vp, 2C], dd
// [B, V]; meta [B, Vp, 4] int32; outputs dx [B, V, C], dembed [B, V, D]
// (when embed); stamps and the window as K3's.
int tree_filter_bwd(const float* g, const float* y, const float* A, const float* F,
                    const int* order, const int* parent, const int* ppos, const int* cptr,
                    const int* level, const int* nlev, const float* w, const float* embed,
                    int D, double* Aa, double* Fa, double* dd, int* meta, float* dx,
                    float* dembed, unsigned long long* stamps, int B, int V, int C, int window,
                    void* stream) {
  if (B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  if (embed != nullptr && (D < 1 || D > MAX_EMBED)) return (int)cudaErrorInvalidValue;
  const Tree t = make_tree(order, parent, ppos, cptr, level, nlev, w);
  cudaStream_t s = (cudaStream_t)stream;
  int4* m = reinterpret_cast<int4*>(meta);
  switch (C) {
    case 1: return filter_bwd<1>(g, y, A, F, t, embed, D, Aa, Fa, dd, m, dx, dembed, stamps, B, V,
                                 window, s);
    case 2: return filter_bwd<2>(g, y, A, F, t, embed, D, Aa, Fa, dd, m, dx, dembed, stamps, B, V,
                                 window, s);
    case 3: return filter_bwd<3>(g, y, A, F, t, embed, D, Aa, Fa, dd, m, dx, dembed, stamps, B, V,
                                 window, s);
    case 4: return filter_bwd<4>(g, y, A, F, t, embed, D, Aa, Fa, dd, m, dx, dembed, stamps, B, V,
                                 window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
