// Fused splat render + closed-form GT heatmap + masked loss, with the
// analytic gradient w.r.t. the screen-space splat quantities.
//
// Replaces skelsplat_tpu/ops/pallas_raster.py::_bwd_kernel (K1, this
// kernel with WITH_GRAD) and ::_fwd_kernel (K2, WITH_GRAD = false).
//
// What bounds it on an H100: neither bytes nor operations. Per view it reads
// N slot records and the N x (H + W) GT profiles (~0.5 MB for four
// 1002x1000 views) and writes a few hundred floats. A (pixel, slot) pair in
// a tile the splat's rect covers needs 72 f32 operations and one expf; this
// kernel issues 122 and two (pass 2 recomputes pass 1), and 7 per pair only
// the GT support reaches (tools/roofline.py, PAIR_OPS and PAIR_OPS_ISSUED),
// ~4x10^4 and ~10^4 such pairs per view for a 17-joint skeleton.
// Both bounds are well under a microsecond, so launch latency and the
// per-block fixed cost dominate (tools/kernel_probe.py --dead measures the
// floor). The design keeps that fixed cost small and does only the work
// the data needs:
//   * one block per 16x16 pixel tile (the reference's tile, so the splat
//     rect gate is uniform over a block) and one thread per pixel; grid
//     (ceil(W/16), ceil(H/16), V), so one launch covers every view;
//   * the block loads the view's depth-sorted slot records into shared
//     memory and flags, per slot, whether its rect covers the tile (render
//     work) and whether its GT support meets the tile (GT-only terms); a
//     tile with no flagged slot writes zero partials and exits;
//   * per-slot live alpha and T stay in registers (N <= MAX_SLOTS), so the
//     reverse pass needs no scratch memory;
//   * S, the integer count C and the 6N gradient sums reduce by warp
//     shuffles and shared memory into per-block partials, which a second,
//     deterministic kernel sums per view. No float atomics: two runs on the
//     same inputs give bitwise-equal results.
#include <cuda_runtime.h>

#include "raster_math.cuh"

namespace skelsplat {

constexpr int THREADS = TILE * TILE;  // one thread per pixel of the tile
constexpr int WARPS = THREADS / 32;
constexpr int REDUCE_THREADS = 256;

constexpr int SLOT_REND = 1;  // splat rect covers the tile
constexpr int SLOT_GT = 2;    // GT support [gy0,gy1) x [gx0,gx1) meets it

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// part_f: (V, n_f, n_tiles) with n_f = 1 + 6N (S, then dg slot-major) or 1
// part_c: (V, n_tiles)
template <bool WITH_GRAD, bool L1>
__global__ void __launch_bounds__(THREADS)
    raster_loss_tiles(const float* __restrict__ pack,
                      const float* __restrict__ p1,
                      const float* __restrict__ p2,
                      const float* __restrict__ img, int N, int H, int W,
                      float* __restrict__ part_f, int* __restrict__ part_c) {
  __shared__ float s_pack[MAX_SLOTS * PACK];
  __shared__ int s_flags[MAX_SLOTS];
  __shared__ float s_S[WARPS];
  __shared__ int s_C[WARPS];
  __shared__ float s_dg[WITH_GRAD ? WARPS * MAX_SLOTS * N_GRAD : 1];

  const int v = blockIdx.z;
  const int n_tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_f = 1 + (WITH_GRAD ? N * N_GRAD : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* out_f = part_f + (size_t)v * n_f * n_tiles + tile;

  const float* pk = pack + (size_t)v * N * PACK;
  for (int k = threadIdx.x; k < N * PACK; k += THREADS) s_pack[k] = pk[k];
  __syncthreads();
  if (threadIdx.x < N) {
    const float* s = &s_pack[threadIdx.x * PACK];
    const float bx = (float)blockIdx.x, by = (float)blockIdx.y;
    const float x0 = (float)(blockIdx.x * TILE), y0 = (float)(blockIdx.y * TILE);
    int f = 0;
    // opa > 0 is implied by the gate alpha >= 1/255, so a splat with zero
    // opacity (culled in the preprocess) does no render work anywhere
    if (s[IDX_OPA] > 0.f && bx >= s[IDX_RX0] && bx < s[IDX_RX1] &&
        by >= s[IDX_RY0] && by < s[IDX_RY1])
      f |= SLOT_REND;
    if (s[IDX_GY0] < y0 + TILE && s[IDX_GY1] > y0 && s[IDX_GX0] < x0 + TILE &&
        s[IDX_GX1] > x0)
      f |= SLOT_GT;
    s_flags[threadIdx.x] = f;
  }
  __syncthreads();
  int any = 0;
  for (int i = 0; i < N; ++i) any |= s_flags[i];
  if (!any) {
    for (int q = threadIdx.x; q < n_f; q += THREADS) out_f[(size_t)q * n_tiles] = 0.f;
    if (threadIdx.x == 0) part_c[(size_t)v * n_tiles + tile] = 0;
    return;
  }

  const int x = blockIdx.x * TILE + (threadIdx.x % TILE);
  const int y = blockIdx.y * TILE + (threadIdx.x / TILE);
  const bool in_grid = x < W && y < H;
  const float xf = (float)x, yf = (float)y;
  const bool in_img = in_grid && xf < img[2 * v] && yf < img[2 * v + 1];
  const float* p1v = p1 + (size_t)v * N * H;
  const float* p2v = p2 + (size_t)v * N * W;

  // pass 1: front to back
  float T = 1.f;  // T == 0 encodes the T_MIN early-out
  float S_acc = 0.f;
  int C_acc = 0;
  float al[MAX_SLOTS], Tv[MAX_SLOTS];  // live-masked alpha, T before slot
#pragma unroll
  for (int i = 0; i < MAX_SLOTS; ++i) {
    al[i] = 0.f;
    Tv[i] = 0.f;
    if (i >= N) continue;
    const int f = s_flags[i];
    if (!f) continue;
    const float* s = &s_pack[i * PACK];
    const float gt =
        in_grid ? p1v[(size_t)i * H + y] * p2v[(size_t)i * W + x] + s[IDX_B]
                : 0.f;
    if (f & SLOT_REND) {
      const SlotEval e = slot_alpha(s, xf, yf);
      const bool gate = e.power <= 0.f && e.alpha >= ALPHA_MIN;
      const float a_i = gate ? e.alpha : 0.f;
      const float test = T * (1.f - a_i);
      const bool ge = test >= T_MIN;
      const bool live = gate && ge;
      const float contrib = live ? a_i * T : 0.f;
      const float r = fminf(fmaxf(contrib, 0.f), 1.f);
      if ((gt > 0.f || r > 0.f) && in_img) {
        S_acc += err_of<L1>(r - gt);
        C_acc += 1;
      }
      al[i] = live ? a_i : 0.f;
      Tv[i] = T;
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

  if (WITH_GRAD) {
    // pass 2: back to front; sfx = sum over later slots of alpha*T*ghat
    float sfx = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SLOTS; ++j) {
      const int i = MAX_SLOTS - 1 - j;
      if (i >= N || !(s_flags[i] & SLOT_REND)) continue;
      const float* s = &s_pack[i * PACK];
      const float a_i = al[i], T_i = Tv[i];
      const bool live = a_i > 0.f;
      const float r = fminf(fmaxf(a_i * T_i, 0.f), 1.f);
      const float gt =
          in_grid ? p1v[(size_t)i * H + y] * p2v[(size_t)i * W + x] + s[IDX_B]
                  : 0.f;
      const bool mask = (gt > 0.f || r > 0.f) && in_img;
      const float ghat = (mask && live) ? derr_of<L1>(r - gt) : 0.f;
      const SlotEval e = slot_alpha(s, xf, yf);
      const float dalpha = live ? T_i * ghat - sfx / (1.f - a_i) : 0.f;
      // the reference chains through the alpha clamp unconditionally:
      // dalpha/dpower is the unclamped opa * E
      const float dpower = dalpha * (s[IDX_OPA] * e.E);
      float g[N_GRAD];
      g[0] = dpower * (-s[IDX_CA] * e.dx - s[IDX_CB] * e.dy);
      g[1] = dpower * (-s[IDX_CC] * e.dy - s[IDX_CB] * e.dx);
      g[2] = dpower * (-0.5f * e.dx * e.dx);
      g[3] = dpower * (-e.dx * e.dy);
      g[4] = dpower * (-0.5f * e.dy * e.dy);
      g[5] = dalpha * e.E;
#pragma unroll
      for (int k = 0; k < N_GRAD; ++k) {
        const float w = warp_sum(g[k]);
        if (lane == 0) s_dg[(warp * MAX_SLOTS + i) * N_GRAD + k] = w;
      }
      sfx = sfx + a_i * T_i * ghat;
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    float S = 0.f;
    int C = 0;
    for (int w = 0; w < WARPS; ++w) {
      S += s_S[w];
      C += s_C[w];
    }
    out_f[0] = S;
    part_c[(size_t)v * n_tiles + tile] = C;
  }
  if (WITH_GRAD) {
    for (int q = threadIdx.x; q < N * N_GRAD; q += THREADS) {
      const int i = q / N_GRAD, k = q % N_GRAD;
      float acc = 0.f;
      if (s_flags[i] & SLOT_REND)
        for (int w = 0; w < WARPS; ++w)
          acc += s_dg[(w * MAX_SLOTS + i) * N_GRAD + k];
      out_f[(size_t)(1 + q) * n_tiles] = acc;
    }
  }
}

// Sums the per-tile partials of one (quantity, view) in a fixed order:
// blockIdx.x < n_f is a float quantity (0 = S, 1 + 6i + k = dg[i][k]),
// blockIdx.x == n_f the count C.
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_tiles(const float* __restrict__ part_f,
                 const int* __restrict__ part_c, int n_f, int n_tiles,
                 float* __restrict__ S, int* __restrict__ C,
                 float* __restrict__ dg) {
  __shared__ float s_f[REDUCE_THREADS];
  __shared__ int s_c[REDUCE_THREADS];
  const int q = blockIdx.x, v = blockIdx.y, t = threadIdx.x;
  if (q < n_f) {
    const float* src = part_f + ((size_t)v * n_f + q) * n_tiles;
    float acc = 0.f;
    for (int k = t; k < n_tiles; k += REDUCE_THREADS) acc += src[k];
    s_f[t] = acc;
    __syncthreads();
    for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
      if (t < stride) s_f[t] += s_f[t + stride];
      __syncthreads();
    }
    if (t == 0) {
      if (q == 0)
        S[v] = s_f[0];
      else
        dg[(size_t)v * (n_f - 1) + (q - 1)] = s_f[0];
    }
  } else {
    const int* src = part_c + (size_t)v * n_tiles;
    int acc = 0;
    for (int k = t; k < n_tiles; k += REDUCE_THREADS) acc += src[k];
    s_c[t] = acc;
    __syncthreads();
    for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
      if (t < stride) s_c[t] += s_c[t + stride];
      __syncthreads();
    }
    if (t == 0) C[v] = s_c[0];
  }
}

template <bool WITH_GRAD, bool L1>
void launch_tiles(dim3 grid, cudaStream_t stream, const float* pack,
                  const float* p1, const float* p2, const float* img, int N,
                  int H, int W, float* part_f, int* part_c) {
  raster_loss_tiles<WITH_GRAD, L1><<<grid, THREADS, 0, stream>>>(
      pack, p1, p2, img, N, H, W, part_f, part_c);
}

}  // namespace skelsplat

// C interface, bound with ctypes (ops/cuda_raster.py). All pointers are
// device pointers of contiguous float32/int32 tensors; the caller allocates
// part_f (V * n_f * n_tiles), part_c (V * n_tiles), S (V), C (V) and, with
// with_grad, dg (V * N * 6). Returns the cudaError_t of the launches.
extern "C" int skelsplat_raster_loss(const float* pack, const float* p1,
                                     const float* p2, const float* img, int V,
                                     int N, int H, int W, int l1,
                                     int with_grad, float* part_f,
                                     int* part_c, float* S, int* C, float* dg,
                                     void* stream_ptr) {
  using namespace skelsplat;
  if (V < 1 || N < 1 || N > MAX_SLOTS || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, V);
  if (with_grad) {
    if (l1)
      launch_tiles<true, true>(grid, stream, pack, p1, p2, img, N, H, W, part_f, part_c);
    else
      launch_tiles<true, false>(grid, stream, pack, p1, p2, img, N, H, W, part_f, part_c);
  } else {
    if (l1)
      launch_tiles<false, true>(grid, stream, pack, p1, p2, img, N, H, W, part_f, part_c);
    else
      launch_tiles<false, false>(grid, stream, pack, p1, p2, img, N, H, W, part_f, part_c);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_f = 1 + (with_grad ? N * N_GRAD : 0);
  const int n_tiles = grid.x * grid.y;
  reduce_tiles<<<dim3(n_f + 1, V), REDUCE_THREADS, 0, stream>>>(
      part_f, part_c, n_f, n_tiles, S, C, dg);
  return (int)cudaGetLastError();
}

extern "C" const char* skelsplat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
