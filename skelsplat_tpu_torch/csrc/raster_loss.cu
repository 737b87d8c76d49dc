// Fused splat render + closed-form GT heatmap + masked loss, with the
// analytic gradient w.r.t. the screen-space splat quantities.
//
// Replaces skelsplat_tpu/ops/pallas_raster.py::_bwd_kernel (K1, this
// kernel with WITH_GRAD) and ::_fwd_kernel (K2, WITH_GRAD = false).
//
// What bounds it on an H100: neither bytes nor operations. Per view it reads
// N slot records and the N x (H + W) GT profiles (~0.5 MB for four
// 1002x1000 views) and writes a few hundred floats. A (pixel, slot) pair in
// a tile the splat's rect covers needs 72 f32 operations and one expf, and
// 7 a pair only the GT support reaches (tools/roofline.py, PAIR_OPS);
// ~4x10^4 and ~10^4 such pairs per view for a 17-joint skeleton, in ~4% of
// the view's 16x16 tiles. Both bounds are well under a microsecond, so what
// costs is a fixed cost per launch and per tile, and the latency of a
// tile's walk over its slots. Two launches per call:
//   * live_tiles, one block per view, builds the view's list of live tiles
//     in ascending tile order: a tile is live when some slot's rect covers
//     it (render work) or its GT support meets it (GT-only terms). Each
//     test splits into a column test and a row test, so a tile's 64-bit
//     slot mask is col_mask[bx] & row_mask[by] (bit i: slot i renders
//     there; bit 32 + i: its GT support meets it), and a block-wide prefix
//     sum of the live counts places each live tile in the list. A view
//     with no live tile gets S = C = dg = 0 here. A dead tile costs one AND
//     of two masks, and the count of live tiles never reaches the host.
//   * raster_loss_live runs a persistent grid (the resident blocks of every
//     SM, 4 of 256 threads each) over runs of R consecutive entries of one
//     view's list (the last run of a view may be shorter; R comes from the
//     host, ops/cuda_raster.py::run_length, by the call's shape alone). One
//     thread per pixel of the 16x16 tile (the reference's tile, so the rect
//     gate is uniform over a block). A run stages the view's slot records
//     and the run's list records in shared memory once; then, entry by
//     entry, the 16 rows of p1 and 16 columns of p2 of each flagged slot
//     arrive by cp.async in a ring of STAGES buffers, the next entry's
//     rows in flight while the block computes the current one. The block
//     walks only the slots the entry's mask flags: front to back over its
//     render and GT slots (pass 1: S, C, and per render slot the T before
//     it and its live alpha, kept in per-thread arrays by the slot's
//     ordinal among the entry's render slots), then back to front over its
//     render slots (pass 2: the gradient, recomputing gt, the mask and
//     slot_alpha, each slot's six components folded across the warp in 8
//     shuffles).
//     Each entry writes its S and C at its list position and, per slot
//     whose rect covers it, the six dg components at the tile's position
//     in the slot's rect. A run takes one ticket of its
//     view (a per-view counter of finished runs in the call's own buffers,
//     zeroed by live_tiles, one fence and one atomic a run); the block
//     that takes a view's last ticket sums the view: S and C over its list
//     by a block-wide tree, each slot's dg over its rect (~10-50 tiles) by
//     one warp, so no thread walks the list serially. Which run a block
//     takes next comes from the list lengths of a window of 256 views read
//     once into shared memory.
//     No float atomics and fixed orders: every entry's partials and every
//     view's sum are the same for every R, so two runs on the same inputs,
//     at any R, give bitwise-equal results. Every call has its own
//     buffers, so calls on different streams may overlap.
//
// Why runs: at R = 1 an entry costs a block ~8.6 us in the batch; its
// ticket (fence, atomic, the barriers around them) with the view's sum
// that the last ticket starts are half of that, its slot-pack reload and
// profile rows' round trip 7%, and the slot walk, its barriers and
// partial stores the rest (PERF.md, section 6). A run pays the ticket, the pack and its list
// records once, and the prefetch hides the rows' round trip behind the
// previous entry's walk. What bounds a run is then the slot walk, an
// entry at a time; and, in a call with few entries a block, the run's
// first round trips and the view's sum at the end.
//
// Why the walk is over flagged slots: a live tile flags ~1.4-1.6 of the N
// slots (render or GT) and ~0.8-1 render slot, at most 7, and a third of
// the entries flag no render slot at all (the cells' calls,
// tools/k1_variants.py --slots). A walk that tested every slot of a
// compile-time bound, in code unrolled over it, spent its time on the
// slots it skipped. The loops over the mask's set bits (ascending for
// pass 1, descending for pass 2) cost per flagged slot and keep each
// slot's arithmetic and the order of every sum, so the results are the
// bits of a walk over all N; a tile that flags all N walks all N. The
// per-slot T and alpha sit in local memory (indexed by a run-time
// ordinal), which was faster than shared memory and than recomputing the
// alpha in pass 2.
//
// The tile kernel is held to 4 resident blocks per SM (64 registers): with
// the walk's loops no longer unrolled, 4 blocks took the batch's call 11%
// below 3 (80 registers) and the chains' within 1%; 5 (48 registers) lost
// 6% at H36M's call (PERF.md, section 6).
#include <cuda_runtime.h>

#include "raster_math.cuh"

namespace skelsplat {

constexpr int THREADS = TILE * TILE;  // one thread per pixel of the tile
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;         // resident tile-kernel blocks per SM
constexpr int LIST_THREADS = 1024;    // live_tiles: one block per view
constexpr int MAX_RUN = 64;           // longest run of list entries a block takes
constexpr int STAGES = 2;             // entries whose profile rows are staged at once
constexpr int GT_BIT = 32;            // mask bit GT_BIT + i: slot i's GT support
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_SLOTS * N_GRAD <= THREADS,
              "an entry's dg partials take one pass of the block");

typedef unsigned long long Mask;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// Component of a slot's gradient whose warp sum warp_sum6 leaves in `lane`
// (-1: none). Lanes 0, 4, 8, 16, 20 and 24 hold components 0-5.
__device__ __forceinline__ int sum6_component(int lane) {
  const int q = (lane >> 2) & 3;
  return q == 3 ? -1 : 3 * ((lane >> 4) & 1) + q;
}

// The six gradient components summed over the warp in 8 shuffles instead of
// six 5-step butterflies: each xor step halves the components a lane
// carries (offset 16: 6 -> 3, 8: 3 -> 2 with one zero pad, 4: 2 -> 1), then
// offsets 2 and 1 finish the sum. Every lane of a group of 4 returns the
// sum of component sum6_component(lane).
__device__ __forceinline__ float warp_sum6(const float (&g)[N_GRAD],
                                           int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float a[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a[c] = (h16 ? g[3 + c] : g[c]) +
           __shfl_xor_sync(FULL, h16 ? g[c] : g[3 + c], 16);
  const float b0 = (h8 ? a[2] : a[0]) + __shfl_xor_sync(FULL, h8 ? a[0] : a[2], 8);
  const float b1 = (h8 ? 0.f : a[1]) + __shfl_xor_sync(FULL, h8 ? a[1] : 0.f, 8);
  float s = (h4 ? b1 : b0) + __shfl_xor_sync(FULL, h4 ? b0 : b1, 4);
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

// 4 bytes from global `src` to shared `dst` without passing through
// registers; with `fill` false nothing is read and dst gets 0.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool fill) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `PENDING` of this thread's committed groups are
// still in flight.
template <int PENDING>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// One block per view: the view's live tiles in ascending tile order,
// live_idx[v][0, live_n[v]) with their slot masks live_mask[v][...], and
// the view's counter of finished runs view_done[v] = 0. A view with no
// live tile gets S = C = dg = 0.
__global__ void __launch_bounds__(LIST_THREADS)
    live_tiles(const float* __restrict__ pack, int N, int n_tx, int n_ty,
               int* __restrict__ live_idx, Mask* __restrict__ live_mask,
               int* __restrict__ live_n, unsigned* __restrict__ view_done,
               int with_grad, float* __restrict__ S, int* __restrict__ C,
               float* __restrict__ dg) {
  extern __shared__ Mask s_axis[];  // n_tx column masks, then n_ty row masks
  __shared__ float s_pack[MAX_SLOTS * PACK];
  __shared__ int s_warp[LIST_THREADS / 32];
  const int v = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_tiles = n_tx * n_ty;

  const float* pk = pack + (size_t)v * N * PACK;
  for (int q = t; q < N * PACK; q += LIST_THREADS) s_pack[q] = pk[q];
  __syncthreads();
  // the tile tests, split by axis: render needs opa > 0 and bx in
  // [rx0, rx1) (column) and by in [ry0, ry1) (row); GT needs the support's
  // columns and rows to meet the tile's. One thread per (axis line, slot),
  // OR-ed into the line's mask (OR is exact in any order).
  const int n_axis = n_tx + n_ty;
  for (int a = t; a < n_axis; a += LIST_THREADS) s_axis[a] = 0;
  __syncthreads();
  for (int q = t; q < n_axis * N; q += LIST_THREADS) {
    const int a = q / N, i = q % N;
    const float* s = &s_pack[i * PACK];
    Mask m = 0;
    if (a < n_tx) {
      const float bx = (float)a, x0 = (float)(a * TILE);
      if (s[IDX_OPA] > 0.f && bx >= s[IDX_RX0] && bx < s[IDX_RX1])
        m |= 1ull << i;
      if (s[IDX_GX0] < x0 + TILE && s[IDX_GX1] > x0) m |= 1ull << (GT_BIT + i);
    } else {
      const float by = (float)(a - n_tx), y0 = (float)((a - n_tx) * TILE);
      if (by >= s[IDX_RY0] && by < s[IDX_RY1]) m |= 1ull << i;
      if (s[IDX_GY0] < y0 + TILE && s[IDX_GY1] > y0) m |= 1ull << (GT_BIT + i);
    }
    if (m) atomicOr(&s_axis[a], m);
  }
  __syncthreads();

  // each thread owns a run of consecutive tiles, so an exclusive prefix sum
  // of the runs' live counts gives every live tile its list position
  const int per = (n_tiles + LIST_THREADS - 1) / LIST_THREADS;
  const int t0 = min(t * per, n_tiles), t1 = min(t0 + per, n_tiles);
  const int bx0 = t0 % n_tx, by0 = t0 / n_tx;
  int cnt = 0;
  for (int tile = t0, bx = bx0, by = by0; tile < t1; ++tile) {
    cnt += (s_axis[bx] & s_axis[n_tx + by]) != 0;
    if (++bx == n_tx) bx = 0, ++by;
  }
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int pos = incl - cnt + (warp > 0 ? s_warp[warp - 1] : 0);
  const size_t row = (size_t)v * n_tiles;
  for (int tile = t0, bx = bx0, by = by0; tile < t1; ++tile) {
    const Mask m = s_axis[bx] & s_axis[n_tx + by];
    if (m) {
      live_idx[row + pos] = tile;
      live_mask[row + pos] = m;
      ++pos;
    }
    if (++bx == n_tx) bx = 0, ++by;
  }
  const int total = s_warp[LIST_THREADS / 32 - 1];
  if (t == 0) {
    live_n[v] = total;
    view_done[v] = 0;
  }
  if (total == 0) {  // no tile kernel block visits the view
    if (t == 0) {
      S[v] = 0.f;
      C[v] = 0;
    }
    if (with_grad)
      for (int q = t; q < N * N_GRAD; q += LIST_THREADS)
        dg[(size_t)v * N * N_GRAD + q] = 0.f;
  }
}

// The tiles [x0, x0 + w) x [y0, y0 + h) of an n_tx x n_ty grid where slot
// record s renders: those the kernel's float compares flag (opa > 0,
// b >= r0 and b < r1 on each axis, which for an integer b is
// ceil(r0) <= b < ceil(r1)); empty when a bound is NaN or opa <= 0.
struct RectSpan {
  int x0, y0, w, h;
};

__device__ __forceinline__ RectSpan rect_span(const float* s, int n_tx,
                                              int n_ty) {
  RectSpan r = {0, 0, 0, 0};
  const float rx0 = s[IDX_RX0], rx1 = s[IDX_RX1], ry0 = s[IDX_RY0],
              ry1 = s[IDX_RY1];
  if (!(s[IDX_OPA] > 0.f) || rx0 != rx0 || rx1 != rx1 || ry0 != ry0 ||
      ry1 != ry1)  // NaN
    return r;
  const float fx = (float)n_tx, fy = (float)n_ty;
  r.x0 = (int)fminf(fmaxf(ceilf(rx0), 0.f), fx);
  r.y0 = (int)fminf(fmaxf(ceilf(ry0), 0.f), fy);
  r.w = max((int)fminf(fmaxf(ceilf(rx1), 0.f), fx) - r.x0, 0);
  r.h = max((int)fminf(fmaxf(ceilf(ry1), 0.f), fy) - r.y0, 0);
  return r;
}

// Sums view v's partials, reading through L2 (other blocks wrote them), in
// an order fixed by N and the view's list and slot rects: S and C over the
// first L list rows, thread t taking rows t, t + 256, ... and a fixed tree
// adding the threads; with a gradient, dg[v][i] over slot i's rect
// positions, warp i % 8 taking slot i, lane l positions l, l + 32, ... and
// warp_sum6 adding the lanes.
template <bool WITH_GRAD>
__device__ void reduce_view(int v, int L, int N, int n_tx, int n_ty,
                            const float* s_pack, const float* part_s,
                            const int* part_c, const float* part_dg, float* S,
                            int* C, float* dg, float* s_rf, int* s_rc) {
  const int n_tiles = n_tx * n_ty;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row0 = (size_t)v * n_tiles;
  float sf = 0.f;
  int sc = 0;
  for (int j = t; j < L; j += THREADS) {
    sf += __ldcg(&part_s[row0 + j]);
    sc += __ldcg(&part_c[row0 + j]);
  }
  s_rf[t] = sf;
  s_rc[t] = sc;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (t < o) {
      s_rf[t] += s_rf[t + o];
      s_rc[t] += s_rc[t + o];
    }
    __syncthreads();
  }
  if (t == 0) {
    S[v] = s_rf[0];
    C[v] = s_rc[0];
  }
  if constexpr (WITH_GRAD) {
    const int comp = sum6_component(lane);
    for (int i = warp; i < N; i += WARPS) {
      const RectSpan rs = rect_span(&s_pack[i * PACK], n_tx, n_ty);
      const float* src = part_dg + ((size_t)v * N + i) * n_tiles * N_GRAD;
      float g[N_GRAD] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int p = lane; p < rs.w * rs.h; p += 32)
#pragma unroll
        for (int c = 0; c < N_GRAD; ++c) g[c] += __ldcg(&src[p * N_GRAD + c]);
      const float w = warp_sum6(g, lane);
      if ((lane & 3) == 0 && comp >= 0)
        dg[((size_t)v * N + i) * N_GRAD + comp] = w;
    }
  }
}

// Views [w0, w0 + THREADS) of the call: s_n[t] the list length of view
// w0 + t (0 past V), s_cum[t] the runs of R entries of views w0 .. w0 + t.
// Returns the window's runs. Block-wide; every thread calls it.
__device__ int load_window(int w0, int V, int R, const int* live_n, int* s_n,
                           int* s_cum, int* s_wsum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = w0 + t < V ? live_n[w0 + t] : 0;
  int incl = (n + R - 1) / R;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();  // the previous window is read
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += s_wsum[w];
  s_n[t] = n;
  s_cum[t] = incl;
  __syncthreads();
  return s_cum[THREADS - 1];
}

// Position of the k-th set bit (from 0, ascending) of m, which has more
// than k set bits.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  for (; k > 0; --k) m &= m - 1u;
  return __ffs(m) - 1;
}

// The profile rows of run entry j (list record s_tile[j], s_mask[j]) into
// ring buffer `stage`: for each slot the entry flags, its 16 rows of p1
// and 16 columns of p2 (0 past the grid's edge), thread q copying row
// q % 16 of the (q / 16)-th flagged slot.
template <int NS>
__device__ __forceinline__ void stage_rows(int j, int stage, int H, int W,
                                           int n_tx, const int* s_tile,
                                           const Mask* s_mask,
                                           const float* p1v, const float* p2v,
                                           float (*s_p1)[NS * TILE],
                                           float (*s_p2)[NS * TILE]) {
  const int tile = s_tile[j];
  const Mask mask = s_mask[j];
  const unsigned work = (unsigned)(mask | (mask >> GT_BIT));
  const int by = tile / n_tx, bx = tile - by * n_tx;
  for (int q = threadIdx.x; q < __popc(work) * TILE; q += THREADS) {
    const int i = nth_bit(work, q / TILE), o = q % TILE;
    const int yy = by * TILE + o, xx = bx * TILE + o;
    copy_async(&s_p1[stage][i * TILE + o], p1v + (size_t)i * H + min(yy, H - 1),
               yy < H);
    copy_async(&s_p2[stage][i * TILE + o], p2v + (size_t)i * W + min(xx, W - 1),
               xx < W);
  }
}

// part_s, part_c: (V, n_tiles), row j of view v is the view's list entry
// j; part_dg: (V, N, n_tiles, 6), position p of slot i is the tile at
// (x0 + p % w, y0 + p / w) of the slot's rect_span. Run k of the call is
// the k-th run in view order; block b takes runs b, b + gridDim.x, ...
template <bool WITH_GRAD, bool L1, int NS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    raster_loss_live(const float* __restrict__ pack,
                     const float* __restrict__ p1,
                     const float* __restrict__ p2,
                     const float* __restrict__ img, int V, int N, int H, int W,
                     int n_tx, int R, const int* __restrict__ live_idx,
                     const Mask* __restrict__ live_mask,
                     const int* __restrict__ live_n,
                     unsigned* __restrict__ view_done,
                     float* __restrict__ part_s,
                     int* __restrict__ part_c, float* __restrict__ part_dg,
                     float* __restrict__ S, int* __restrict__ C,
                     float* __restrict__ dg) {
  __shared__ float s_pack[NS * PACK];
  // the ring of entries' tile rows and columns
  __shared__ float s_p1[STAGES][NS * TILE], s_p2[STAGES][NS * TILE];
  __shared__ int s_tile[MAX_RUN];
  __shared__ Mask s_mask[MAX_RUN];
  __shared__ int s_n[THREADS], s_cum[THREADS], s_wsum[WARPS];
  __shared__ float s_S[WARPS];
  __shared__ int s_C[WARPS];
  __shared__ float s_dg[WITH_GRAD ? WARPS * NS * N_GRAD : 1];
  __shared__ float s_rf[THREADS];
  __shared__ int s_rc[THREADS];
  __shared__ int s_last;

  const int n_ty = (H + TILE - 1) / TILE, n_tiles = n_tx * n_ty;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
  const int comp = sum6_component(lane);

  // the window of views [w0, w0 + THREADS) and the runs before it
  int w0 = -THREADS, rbase = 0, wruns = 0;
  for (int k = blockIdx.x;; k += gridDim.x) {
    while (k - rbase >= wruns) {
      if (w0 + THREADS >= V) return;
      rbase += wruns;
      w0 += THREADS;
      wruns = load_window(w0, V, R, live_n, s_n, s_cum, s_wsum);
    }
    // the run's view: the views of the window whose runs all come before
    // it (the barrier also ends the previous run's use of shared memory)
    const int rr = k - rbase;
    const int off = __syncthreads_count(s_cum[threadIdx.x] <= rr);
    const int v = w0 + off, L = s_n[off];
    const int j0 = (rr - (off > 0 ? s_cum[off - 1] : 0)) * R;
    const int n_run = min(R, L - j0);
    const size_t e0 = (size_t)v * n_tiles + j0;
    const float* p1v = p1 + (size_t)v * N * H;
    const float* p2v = p2 + (size_t)v * N * W;

    const float* pk = pack + (size_t)v * N * PACK;
    for (int q = threadIdx.x; q < N * PACK; q += THREADS) s_pack[q] = pk[q];
    if (threadIdx.x < n_run) {
      s_tile[threadIdx.x] = live_idx[e0 + threadIdx.x];
      s_mask[threadIdx.x] = live_mask[e0 + threadIdx.x];
    }
    const float img_w = img[2 * v], img_h = img[2 * v + 1];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < n_run)
        stage_rows<NS>(j, j, H, W, n_tx, s_tile, s_mask, p1v, p2v, s_p1,
                       s_p2);
      copy_async_commit();
    }

    for (int j = 0; j < n_run; ++j) {
      const int jn = j + STAGES - 1;
      if (jn < n_run)
        stage_rows<NS>(jn, jn % STAGES, H, W, n_tx, s_tile, s_mask, p1v,
                       p2v, s_p1, s_p2);
      copy_async_commit();
      copy_async_wait<STAGES - 1>();
      // entry j's rows have arrived from every thread's copies, and the
      // previous entry's partials are written
      __syncthreads();
      const float* q1 = s_p1[j % STAGES];
      const float* q2 = s_p2[j % STAGES];
      const size_t e = e0 + j;
      const int tile = s_tile[j];
      const Mask mask = s_mask[j];
      const int by = tile / n_tx, bx = tile - by * n_tx;

      const int x = bx * TILE + tx, y = by * TILE + ty;
      const bool in_grid = x < W && y < H;
      const float xf = (float)x, yf = (float)y;
      const bool in_img = in_grid && xf < img_w && yf < img_h;

      // the entry's flagged slots: render bits, and render or GT bits
      const unsigned rend = (unsigned)mask;
      const unsigned work = rend | (unsigned)(mask >> GT_BIT);

      // pass 1: front to back over the flagged slots
      float T = 1.f;  // T == 0 encodes the T_MIN early-out
      float S_acc = 0.f;
      int C_acc = 0;
      // per render slot, by its ordinal among the entry's render slots: T
      // before it and its live-masked alpha
      constexpr int NA = WITH_GRAD ? MAX_SLOTS : 1;
      float Tv[NA], Av[NA];
      int nr = 0;
      for (unsigned f = work; f != 0u; f &= f - 1u) {
        const int i = __ffs(f) - 1;
        const float* s = &s_pack[i * PACK];
        const float gt =
            in_grid ? q1[i * TILE + ty] * q2[i * TILE + tx] + s[IDX_B] : 0.f;
        if ((rend >> i) & 1u) {
          const SlotEval ev = slot_alpha(s, xf, yf);
          const bool gate = ev.power <= 0.f && ev.alpha >= ALPHA_MIN;
          const float a_i = gate ? ev.alpha : 0.f;
          const float test = T * (1.f - a_i);
          const bool ge = test >= T_MIN;
          const bool live = gate && ge;
          const float contrib = live ? a_i * T : 0.f;
          const float r = fminf(fmaxf(contrib, 0.f), 1.f);
          const bool m = (gt > 0.f || r > 0.f) && in_img;
          if (m) {
            S_acc += err_of<L1>(r - gt);
            C_acc += 1;
          }
          if constexpr (WITH_GRAD) {
            Tv[nr] = T;
            Av[nr++] = live ? a_i : 0.f;
          }
          if (gate) T = ge ? test : 0.f;
        } else if (gt > 0.f && in_img) {  // GT-only terms of a slot off this tile
          S_acc += err_of<L1>(gt);
          C_acc += 1;
        }
      }
      {
        const float ws = warp_sum(S_acc);
        const int wc = warp_sum(C_acc);
        if (lane == 0) {
          s_S[warp] = ws;
          s_C[warp] = wc;
        }
      }

      if constexpr (WITH_GRAD) {
        // pass 2: back to front over the render slots; sfx = sum over later
        // slots of alpha*T*ghat
        float sfx = 0.f;
        for (unsigned f = rend; f != 0u;) {
          const int i = 31 - __clz(f);
          f ^= 1u << i;
          const float* s = &s_pack[i * PACK];
          --nr;
          const float T_i = Tv[nr], a_i = Av[nr];
          const bool live = a_i > 0.f;
          // pass 2 recomputes gt, the mask and slot_alpha
          const float r = fminf(fmaxf(a_i * T_i, 0.f), 1.f);
          const float gt =
              in_grid ? q1[i * TILE + ty] * q2[i * TILE + tx] + s[IDX_B]
                      : 0.f;
          const bool m = (gt > 0.f || r > 0.f) && in_img;
          const float ghat = (m && live) ? derr_of<L1>(r - gt) : 0.f;
          const SlotEval ev = slot_alpha(s, xf, yf);
          const float E = ev.E, oE = s[IDX_OPA] * E, dx = ev.dx, dy = ev.dy;
          const float dalpha = live ? T_i * ghat - sfx / (1.f - a_i) : 0.f;
          // the reference chains through the alpha clamp unconditionally:
          // dalpha/dpower is the unclamped opa * E
          const float dpower = dalpha * oE;
          float g[N_GRAD];
          g[0] = dpower * (-s[IDX_CA] * dx - s[IDX_CB] * dy);
          g[1] = dpower * (-s[IDX_CC] * dy - s[IDX_CB] * dx);
          g[2] = dpower * (-0.5f * dx * dx);
          g[3] = dpower * (-dx * dy);
          g[4] = dpower * (-0.5f * dy * dy);
          g[5] = dalpha * E;
          const float w = warp_sum6(g, lane);
          if ((lane & 3) == 0 && comp >= 0)
            s_dg[(warp * NS + i) * N_GRAD + comp] = w;
          sfx = sfx + a_i * T_i * ghat;
        }
      }
      __syncthreads();

      // the entry's partials: S and C at its list position, each render
      // slot's six dg components at the tile's position in the slot's rect
      // (thread q: component q % 6 of the (q / 6)-th render slot)
      if (threadIdx.x == 0) {
        float Sb = 0.f;
        int Cb = 0;
        for (int w = 0; w < WARPS; ++w) {
          Sb += s_S[w];
          Cb += s_C[w];
        }
        part_s[e] = Sb;
        part_c[e] = Cb;
      }
      if constexpr (WITH_GRAD) {
        const int q = threadIdx.x;
        if (q < __popc(rend) * N_GRAD) {
          const int i = nth_bit(rend, q / N_GRAD), c = q % N_GRAD;
          const RectSpan rs = rect_span(&s_pack[i * PACK], n_tx, n_ty);
          const int pos = (by - rs.y0) * rs.w + (bx - rs.x0);
          float acc = 0.f;
          for (int w = 0; w < WARPS; ++w)
            acc += s_dg[(w * NS + i) * N_GRAD + c];
          part_dg[(((size_t)v * N + i) * n_tiles + pos) * N_GRAD + c] = acc;
        }
      }
    }

    // one ticket a run: the block that finishes the view's last run sums
    // the view
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(&view_done[v], 1u) + 1u == (unsigned)((L + R - 1) / R);
    __syncthreads();
    if (s_last) {
      __threadfence();
      reduce_view<WITH_GRAD>(v, L, N, n_tx, n_ty, s_pack, part_s, part_c,
                             part_dg, S, C, dg, s_rf, s_rc);
    }
  }
}

typedef void (*TileKernel)(const float*, const float*, const float*,
                           const float*, int, int, int, int, int, int,
                           const int*, const Mask*, const int*, unsigned*,
                           float*, int*, float*, float*, int*, float*);

// K1 sizes its shared slot records, profile rows and dg partials by a slot
// bound from N; K2 takes the largest.
int slot_bound(int N, bool with_grad) {
  if (!with_grad || N > 24) return MAX_SLOTS;
  return N > 16 ? 24 : 16;
}

// The instantiation for (with_grad, l1, ns) and its cache slot, or null.
TileKernel pick(bool with_grad, bool l1, int ns, int* slot) {
  const int b = ns == 16 ? 0 : ns == 24 ? 1 : 2;
  *slot = (with_grad * 2 + l1) * 3 + b;
  if (!with_grad) {
    if (ns != MAX_SLOTS) return nullptr;
    return l1 ? raster_loss_live<false, true, MAX_SLOTS>
              : raster_loss_live<false, false, MAX_SLOTS>;
  }
  switch (ns) {
    case 16: return l1 ? raster_loss_live<true, true, 16> : raster_loss_live<true, false, 16>;
    case 24: return l1 ? raster_loss_live<true, true, 24> : raster_loss_live<true, false, 24>;
    case 32: return l1 ? raster_loss_live<true, true, 32> : raster_loss_live<true, false, 32>;
  }
  return nullptr;
}

// Resident blocks of kernel `k` on the whole card (the persistent grid),
// computed once per instantiation.
int persistent_grid(TileKernel k, int slot) {
  static int cache[12] = {0};
  if (cache[slot] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, 0);
    cache[slot] = sms * per_sm;
  }
  return cache[slot];
}

}  // namespace skelsplat

// C interface, bound with ctypes (ops/cuda_raster.py). All pointers are
// device pointers of contiguous tensors; the caller allocates live_idx
// (V * n_tiles int32), live_mask (V * n_tiles int64), live_n (V int32),
// view_done (V uint32), part_s (V * n_tiles float32), part_c (V * n_tiles
// int32), with with_grad part_dg (V * N * n_tiles * 6 float32), S (V), C
// (V) and, with with_grad, dg (V * N * 6), with n_tiles the 16x16 tiles
// of the H x W grid. `run` is the tile kernel's run length R, 1 to
// MAX_RUN; the results do not depend on it. Two launches on `stream`, no
// host synchronisation; the call's state lives in these buffers alone.
// Returns the cudaError_t of the launches.
extern "C" int skelsplat_raster_loss(const float* pack, const float* p1,
                                     const float* p2, const float* img, int V,
                                     int N, int H, int W, int l1,
                                     int with_grad, int run, int* live_idx,
                                     unsigned long long* live_mask,
                                     int* live_n, unsigned* view_done,
                                     float* part_s, int* part_c,
                                     float* part_dg, float* S, int* C,
                                     float* dg, void* stream_ptr) {
  using namespace skelsplat;
  if (V < 1 || N < 1 || N > MAX_SLOTS || H < 1 || W < 1 || run < 1 ||
      run > MAX_RUN)
    return (int)cudaErrorInvalidValue;
  const int n_tx = (W + TILE - 1) / TILE, n_ty = (H + TILE - 1) / TILE;
  const size_t axis_bytes = (size_t)(n_tx + n_ty) * sizeof(Mask);
  if (axis_bytes > 32 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int slot = 0;
  TileKernel k = pick(with_grad != 0, l1 != 0, slot_bound(N, with_grad != 0), &slot);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  live_tiles<<<V, LIST_THREADS, axis_bytes, stream>>>(
      pack, N, n_tx, n_ty, live_idx, live_mask, live_n, view_done, with_grad,
      S, C, dg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // at most this many runs: every tile of every view live
  const long long runs = (long long)V * ((n_tx * n_ty + run - 1) / run);
  const int grid = (int)(runs < persistent_grid(k, slot)
                             ? runs : persistent_grid(k, slot));
  k<<<grid, THREADS, 0, stream>>>(pack, p1, p2, img, V, N, H, W, n_tx, run,
                                  live_idx, live_mask, live_n, view_done,
                                  part_s, part_c, part_dg, S, C, dg);
  return (int)cudaGetLastError();
}

// Registers per thread, local (spill) bytes per thread and resident blocks
// per SM of the tile kernel instantiation for (with_grad, l1, ns); ns is
// 16, 24 or 32 with a gradient and 32 without. Returns a cudaError_t.
extern "C" int skelsplat_raster_loss_occupancy(int with_grad, int l1, int ns,
                                               int* out) {
  using namespace skelsplat;
  int slot = 0;
  TileKernel k = pick(with_grad != 0, l1 != 0, ns, &slot);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  return (int)err;
}

// The slot bound of the tile kernel a call with N slots launches.
extern "C" int skelsplat_raster_loss_slot_bound(int N, int with_grad) {
  return skelsplat::slot_bound(N, with_grad != 0);
}

extern "C" const char* skelsplat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
