// The "cuda" renderer's macro step around K1: the EWA preprocess, depth
// sort and slot pack of every visited view (kernel A, preprocess_pack) and
// their backward with the limb-length prior (kernel B, preprocess_grad).
//
// Replaces no TPU kernel: the JAX package leaves the preprocess and its
// autodiff to XLA. In the port they were PyTorch's elementwise kernels and
// autograd, ~1,077 of a macro step's ~1,194 launches (per-view parameter
// copies, the preprocess, the sort, the pack, the limb prior and their
// backward; PERF.md section 5), each a graph node of ~1.1 us for a few
// floats of work.
//
// What bounds it on an H100: launch latency. A view is N <= 32 Gaussians
// of closed-form math, a few thousand f32 operations and a few kilobytes,
// so the floor is one launch each way. The one bulk task is kernel A's
// gather of the GT profile rows into slot order, N x (H + W) floats a
// view each way (~117 MB each way for 512 views of 1920x1080), bound by
// bytes.
//
// Design: lane j of a warp is Gaussian j of one view (N <= MAX_SLOTS =
// 32), so the stable depth rank is a count over the warp's shuffled keys
// and the limb prior's endpoints are shuffles. Each view reads its scene's
// parameters (scene v / A) directly: no copies. Kernel A runs a (view,
// chunk) grid of 256-thread blocks: each block's first warp computes its
// view's preprocess and rank, the chunk-0 block writes the view's slot
// records and order, and every thread of the block copies its share of
// the view's profile rows in slot order, so the copy spreads over the
// card at every view count (chunks per view from the SM count). Kernel B
// runs one warp per view; it recomputes the forward in registers (only
// the order passes between the kernels), takes K1's slot gradients back
// through the order, the conic, the pixel centre and the opacity to the
// parameters, adds lambda x d(limb prior)/d(xyz), and writes each view's
// gradients and loss.
//
// Numerics: float32 throughout, compiled with --fmad=false, IEEE division
// and square root and the accurate expf, each expression in the port's
// operation order (core/geometry.py, ops/rasterizer.py), so kernel A's
// records are bitwise the plain forward's on the card. Kernel B's formulas
// are those of ops/cuda_preprocess.py::preprocess_grad_plain; where
// autograd of the forward is finite they follow its conventions (a clamp
// passes the gradient at its edges; where(det != 0, 1/det, 0), ceil,
// trunc and the integer rect pass none; the sigmoid's derivative is
// s(1 - s); |x|'s is 0 at 0).
#include <cuda_runtime.h>

#include "raster_math.cuh"

namespace skelsplat {
namespace {

// the port's constants, as float32 (Python doubles rounded to f32)
constexpr float NEAR_Z = (float)0.2;
constexpr float H_VAR = (float)0.3;
constexpr float DISC_MIN = (float)0.1;
constexpr float AA_MIN = (float)0.000025;
constexpr float W_EPS = (float)1.0e-7;
constexpr float FOV_CLAMP = (float)1.3;

constexpr int PACK_THREADS = 256;  // kernel A: a block per (view, chunk)
constexpr int GRAD_WARPS = 4;      // kernel B: a warp per view
constexpr int MIN_CHUNK = 1024;    // profile floats a block copies, at least
constexpr unsigned ALL = 0xffffffffu;

struct Params {
  const float *xyz, *log_scales, *quats, *logit;  // (S, N, 3 / 3 / 4 / 1)
};

struct Cams {
  const float *view4, *full4;  // (V, 4, 4) row-major
  const float *fx, *fy, *tanx, *tany, *width, *height;  // (V,)
};

// torch's NaN-propagating clamp, clamp_min and maximum
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float max_t(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// C's truncating division of a pixel coordinate by the tile size (as
// geometry.tile_rect: trunc, then a saturating cast)
__device__ __forceinline__ int tile_of(float a) {
  return (int)truncf(a / (float)TILE);
}

// Gaussian j of view v: the forward's values the pack and the backward read
struct Splat {
  float xyz[3], sc[3], q[4], nrm, qn[4], R[9], L[9], cov[6], op;
  float t[3], hom0, hom1, w, px, py;
  float lim[2], u[2], uc[2], s[4], b0[3], b1[3], c[3];
  float cx, cy, cz, det, di, ca, cb, cc, ratio, h, oe;
  int rect[4];
  bool valid;
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// u^T Sigma v of the packed covariance, in ewa_cov2d_render's order
__device__ __forceinline__ float quad(const float* u, const float* v,
                                      const float* cv) {
  return u[0] * v[0] * cv[0] + u[1] * v[1] * cv[3] + u[2] * v[2] * cv[5] +
         (u[0] * v[1] + u[1] * v[0]) * cv[1] +
         (u[0] * v[2] + u[2] * v[0]) * cv[2] +
         (u[1] * v[2] + u[2] * v[1]) * cv[4];
}

template <bool AA>
__device__ void forward(Splat& g, const Params& P, const Cams& cam, int v,
                        int s, int j, int N, int W, int H) {
  const size_t pj = (size_t)s * N + j;
  for (int k = 0; k < 3; ++k) g.xyz[k] = P.xyz[pj * 3 + k];
  for (int k = 0; k < 3; ++k) g.sc[k] = expf(P.log_scales[pj * 3 + k]);
  for (int k = 0; k < 4; ++k) g.q[k] = P.quats[pj * 4 + k];
  // quat_to_rotmat
  g.nrm = sqrtf(g.q[0] * g.q[0] + g.q[1] * g.q[1] + g.q[2] * g.q[2] +
                g.q[3] * g.q[3]);
  for (int k = 0; k < 4; ++k) g.qn[k] = g.q[k] / g.nrm;
  const float r = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  g.R[0] = 1.f - 2.f * (y * y + z * z);
  g.R[1] = 2.f * (x * y - r * z);
  g.R[2] = 2.f * (x * z + r * y);
  g.R[3] = 2.f * (x * y + r * z);
  g.R[4] = 1.f - 2.f * (x * x + z * z);
  g.R[5] = 2.f * (y * z - r * x);
  g.R[6] = 2.f * (x * z - r * y);
  g.R[7] = 2.f * (y * z + r * x);
  g.R[8] = 1.f - 2.f * (x * x + y * y);
  // build_cov3d: L = R diag(s), Sigma = L L^T
  for (int k = 0; k < 9; ++k) g.L[k] = g.R[k] * g.sc[k % 3];
  g.cov[0] = dot3(g.L, g.L);
  g.cov[1] = dot3(g.L, g.L + 3);
  g.cov[2] = dot3(g.L, g.L + 6);
  g.cov[3] = dot3(g.L + 3, g.L + 3);
  g.cov[4] = dot3(g.L + 3, g.L + 6);
  g.cov[5] = dot3(g.L + 6, g.L + 6);
  g.op = 1.f / (1.f + expf(-P.logit[pj]));

  // view transform, projection, ndc2pix
  const float* Vm = cam.view4 + (size_t)v * 16;
  const float* F = cam.full4 + (size_t)v * 16;
  for (int row = 0; row < 3; ++row)
    g.t[row] = g.xyz[0] * Vm[4 * row] + g.xyz[1] * Vm[4 * row + 1] +
               g.xyz[2] * Vm[4 * row + 2] + Vm[4 * row + 3];
  g.hom0 = g.xyz[0] * F[0] + g.xyz[1] * F[1] + g.xyz[2] * F[2] + F[3];
  g.hom1 = g.xyz[0] * F[4] + g.xyz[1] * F[5] + g.xyz[2] * F[6] + F[7];
  const float hom3 =
      g.xyz[0] * F[12] + g.xyz[1] * F[13] + g.xyz[2] * F[14] + F[15];
  g.w = 1.f / (hom3 + W_EPS);
  g.px = ((g.hom0 * g.w + 1.f) * cam.width[v] - 1.f) * 0.5f;
  g.py = ((g.hom1 * g.w + 1.f) * cam.height[v] - 1.f) * 0.5f;

  // ewa_cov2d_render with the 1.3 tan(fov/2) clamp
  const float tz = g.t[2];
  const float fx = cam.fx[v], fy = cam.fy[v];
  g.lim[0] = FOV_CLAMP * cam.tanx[v];
  g.lim[1] = FOV_CLAMP * cam.tany[v];
  for (int a = 0; a < 2; ++a) {
    g.u[a] = g.t[a] / tz;
    g.uc[a] = clamp_t(g.u[a], -g.lim[a], g.lim[a]);
  }
  const float tx = g.uc[0] * tz, ty = g.uc[1] * tz;
  g.s[0] = fx / tz;
  g.s[1] = -(fx * tx) / (tz * tz);
  g.s[2] = fy / tz;
  g.s[3] = -(fy * ty) / (tz * tz);
  for (int k = 0; k < 3; ++k) {
    g.b0[k] = g.s[0] * Vm[k] + g.s[1] * Vm[8 + k];
    g.b1[k] = g.s[2] * Vm[4 + k] + g.s[3] * Vm[8 + k];
  }
  g.c[0] = quad(g.b0, g.b0, g.cov);
  g.c[1] = quad(g.b0, g.b1, g.cov);
  g.c[2] = quad(g.b1, g.b1, g.cov);

  // cov2d_to_conic_radius
  g.cx = g.c[0] + H_VAR;
  g.cy = g.c[1];
  g.cz = g.c[2] + H_VAR;
  g.det = g.cx * g.cz - g.cy * g.cy;
  g.di = g.det != 0.f ? 1.f / g.det : 0.f;
  g.ca = g.cz * g.di;
  g.cb = (-g.cy) * g.di;
  g.cc = g.cx * g.di;
  const float mid = 0.5f * (g.cx + g.cz);
  const float disc = sqrtf(clamp_min_t(mid * mid - g.det, DISC_MIN));
  const float radius = ceilf(3.f * sqrtf(max_t(mid + disc, mid - disc)));
  if (AA) {
    g.ratio = (g.c[0] * g.c[2] - g.c[1] * g.c[1]) / g.det;
    g.h = sqrtf(clamp_min_t(g.ratio, AA_MIN));
    g.oe = g.op * g.h;
  } else {
    g.oe = g.op;
  }

  // tile_rect and the culls
  const int gx = (W + TILE - 1) / TILE, gy = (H + TILE - 1) / TILE;
  g.rect[0] = clamp_i(tile_of(g.px - radius), 0, gx);
  g.rect[1] = clamp_i(tile_of(g.py - radius), 0, gy);
  g.rect[2] = clamp_i(tile_of(g.px + radius + (float)TILE - 1.f), 0, gx);
  g.rect[3] = clamp_i(tile_of(g.py + radius + (float)TILE - 1.f), 0, gy);
  const int area = (g.rect[2] - g.rect[0]) * (g.rect[3] - g.rect[1]);
  g.valid = tz > NEAR_Z && g.det != 0.f && area > 0;
}

// Kernel A. Grid (V, chunks), PACK_THREADS threads.
template <bool AA>
__global__ void __launch_bounds__(PACK_THREADS)
    preprocess_pack(Params P, Cams cam, const float* B, const float* spans,
                    const float* p1, const float* p2, int A, int N, int H,
                    int W, float* pack, int* order, float* p1s, float* p2s) {
  __shared__ int s_order[MAX_SLOTS];
  const int v = blockIdx.x;
  if (threadIdx.x < 32) {
    const int j = threadIdx.x;
    Splat g;
    float key = __int_as_float(0x7f800000);  // +inf: invalid splats last
    if (j < N) {
      forward<AA>(g, P, cam, v, v / A, j, N, W, H);
      if (g.valid) key = g.t[2];
    }
    int rank = 0;  // stable: ties keep the Gaussians' order
    for (int k = 0; k < N; ++k) {
      const float other = __shfl_sync(ALL, key, k);
      rank += other < key || (other == key && k < j);
    }
    if (j < N) {
      s_order[rank] = j;
      if (blockIdx.y == 0) {
        const size_t vj = (size_t)v * N + j;
        const float* sp = spans + vj * 4;
        float4* out = reinterpret_cast<float4*>(pack) +
                      ((size_t)v * N + rank) * (PACK / 4);
        out[0] = make_float4(g.px, g.py, g.ca, g.cb);
        out[1] = make_float4(g.cc, g.valid ? g.oe : 0.f, (float)g.rect[0],
                             (float)g.rect[1]);
        out[2] = make_float4((float)g.rect[2], (float)g.rect[3], B[vj], sp[0]);
        out[3] = make_float4(sp[1], sp[2], sp[3], 0.f);
        order[(size_t)v * N + rank] = j;
      }
    }
  }
  __syncthreads();
  // this block's share [lo, hi) of the view's N rows of H + W profile
  // floats (row i: slot i's p1 row, then its p2 row)
  const int row = H + W, total = row * N;
  const int per = (total + gridDim.y - 1) / gridDim.y;
  const int lo = per * blockIdx.y, hi = min(lo + per, total);
  for (int i = lo / row; i < N && i * row < hi; ++i) {
    const size_t dst = (size_t)v * N + i, src = (size_t)v * N + s_order[i];
    const int e0 = max(lo - i * row, 0), e1 = min(hi - i * row, row);
#pragma unroll 4
    for (int e = e0 + threadIdx.x; e < min(e1, H); e += PACK_THREADS)
      p1s[dst * H + e] = p1[src * H + e];
#pragma unroll 4
    for (int e = max(e0, H) + threadIdx.x; e < e1; e += PACK_THREADS)
      p2s[dst * W + (e - H)] = p2[src * W + (e - H)];
  }
}

struct Limbs {
  int on;        // 0: no prior
  int a[4], b[4];  // left arm, right arm, left leg, right leg
};

// Kernel B. ceil(V / GRAD_WARPS) blocks of GRAD_WARPS warps.
template <bool AA>
__global__ void __launch_bounds__(GRAD_WARPS * 32)
    preprocess_grad(Params P, Cams cam, const int* order, const float* S,
                    const int* C, const float* dg, int V, int A, int N, int H,
                    int W, Limbs limbs, float lambda, float* losses,
                    float* g_xyz, float* g_ls, float* g_q, float* g_logit) {
  __shared__ int s_slot[GRAD_WARPS][MAX_SLOTS];
  const int wp = threadIdx.x >> 5, j = threadIdx.x & 31;
  const int v = blockIdx.x * GRAD_WARPS + wp;
  if (v >= V) return;  // the whole warp
  const bool live = j < N;
  if (live) s_slot[wp][order[(size_t)v * N + j]] = j;
  __syncwarp();
  Splat g;
  if (live) forward<AA>(g, P, cam, v, v / A, j, N, W, H);

  // the limb prior and its gradient (every lane takes part in the shuffles)
  float lx = live ? g.xyz[0] : 0.f, ly = live ? g.xyz[1] : 0.f,
        lz = live ? g.xyz[2] : 0.f;
  float cons = 0.f, gl[3] = {0.f, 0.f, 0.f};
  if (limbs.on) {
    float d[4][3], len[4];
    for (int p = 0; p < 4; ++p) {
      const int a = limbs.a[p], b = limbs.b[p];
      d[p][0] = __shfl_sync(ALL, lx, a) - __shfl_sync(ALL, lx, b);
      d[p][1] = __shfl_sync(ALL, ly, a) - __shfl_sync(ALL, ly, b);
      d[p][2] = __shfl_sync(ALL, lz, a) - __shfl_sync(ALL, lz, b);
      len[p] = sqrtf(d[p][0] * d[p][0] + d[p][1] * d[p][1] +
                     d[p][2] * d[p][2]);
    }
    cons = fabsf(len[0] - len[1]) + fabsf(len[2] - len[3]);
    for (int p = 0; p < 4; p += 2) {
      const float diff = len[p] - len[p + 1];
      const float g_p = lambda * (diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f));
      for (int e = 0; e < 2; ++e) {
        const int q = p + e;
        const float g_len = e == 0 ? g_p : -g_p;
        const float g_ss = g_len / (2.f * len[q]);
        for (int k = 0; k < 3; ++k) {
          const float g_d = g_ss * d[q][k] + g_ss * d[q][k];
          if (j == limbs.a[q]) gl[k] += g_d;
          if (j == limbs.b[q]) gl[k] -= g_d;
        }
      }
    }
  }
  const float cf = (float)max(C[v], 1);
  if (j == 0) losses[v] = S[v] / cf + cons * lambda;
  if (!live) return;

  // K1's slot cotangents, back in Gaussian order, times dL/dS = 1/max(C,1)
  const float gS = 1.f / cf;
  const float* dgs = dg + ((size_t)v * N + s_slot[wp][j]) * N_GRAD;
  float gd[N_GRAD];
  for (int k = 0; k < N_GRAD; ++k) gd[k] = dgs[k] * gS;

  // opacity: opa = where(valid, op h, 0), op = sigmoid(logit)
  const float g_oe = g.valid ? gd[IDX_OPA] : 0.f;
  const float g_op = AA ? g_oe * g.h : g_oe;
  const size_t vj = (size_t)v * N + j;
  g_logit[vj] = (g_op * (1.f - g.op)) * g.op;

  // pixel centre: ((hom w + 1) size - 1) / 2, w = 1 / (hom3 + 1e-7)
  const float* F = cam.full4 + (size_t)v * 16;
  const float g_p0 = (gd[IDX_PX] * 0.5f) * cam.width[v];
  const float g_p1 = (gd[IDX_PY] * 0.5f) * cam.height[v];
  const float g_hom0 = g_p0 * g.w, g_hom1 = g_p1 * g.w;
  const float g_w = g_p0 * g.hom0 + g_p1 * g.hom1;
  const float g_hom3 = -g_w * (g.w * g.w);
  float gx[3];
  for (int k = 0; k < 3; ++k)
    gx[k] = g_hom0 * F[k] + g_hom1 * F[4 + k] + g_hom3 * F[12 + k];

  // conic = [cz, -cy, cx] di, di = where(det != 0, 1/det, 0)
  const float g_ca = gd[IDX_CA], g_cb = gd[IDX_CB], g_cc = gd[IDX_CC];
  const float g_di = g_ca * g.cz + g_cb * (-g.cy) + g_cc * g.cx;
  float g_cx = g_cc * g.di, g_cy = -(g_cb * g.di), g_cz = g_ca * g.di;
  float g_det = g.det != 0.f ? -g_di * (g.di * g.di) : 0.f;
  float g_det_cov = 0.f;
  if (AA) {  // h = sqrt(clamp(det_cov / det, min = 2.5e-5))
    const float g_h = g_oe * g.op;
    const float g_ratio = g.ratio >= AA_MIN ? g_h / (2.f * g.h) : 0.f;
    g_det_cov = g_ratio / g.det;
    g_det = g_det + -g_ratio * (g.ratio / g.det);
  }
  g_cx = g_cx + g_det * g.cz;
  g_cz = g_cz + g_det * g.cx;
  g_cy = g_cy + ((-g_det) * g.cy + (-g_det) * g.cy);
  float g_c0 = g_cx, g_c1 = g_cy, g_c2 = g_cz;
  if (AA) {  // det_cov = c0 c2 - c1^2
    g_c0 = g_c0 + g_det_cov * g.c[2];
    g_c2 = g_c2 + g_det_cov * g.c[0];
    g_c1 = g_c1 + (-g_det_cov) * (2.f * g.c[1]);
  }

  // cov2d = [b0' S b0, b0' S b1, b1' S b1]
  const float* cv = g.cov;
  const float *b0 = g.b0, *b1 = g.b1;
  float e0[3], e1[3];
  e0[0] = cv[0] * b0[0] + cv[1] * b0[1] + cv[2] * b0[2];
  e0[1] = cv[1] * b0[0] + cv[3] * b0[1] + cv[4] * b0[2];
  e0[2] = cv[2] * b0[0] + cv[4] * b0[1] + cv[5] * b0[2];
  e1[0] = cv[0] * b1[0] + cv[1] * b1[1] + cv[2] * b1[2];
  e1[1] = cv[1] * b1[0] + cv[3] * b1[1] + cv[4] * b1[2];
  e1[2] = cv[2] * b1[0] + cv[4] * b1[1] + cv[5] * b1[2];
  float g_b0[3], g_b1[3];
  for (int k = 0; k < 3; ++k) {
    g_b0[k] = (g_c0 + g_c0) * e0[k] + g_c1 * e1[k];
    g_b1[k] = g_c1 * e0[k] + (g_c2 + g_c2) * e1[k];
  }
  // d/d of the packed covariance entries xx xy xz yy yz zz
  const int KK[6] = {0, 0, 0, 1, 1, 2}, LL[6] = {0, 1, 2, 1, 2, 2};
  float g_cov[6];
  for (int m = 0; m < 6; ++m) {
    const int k = KK[m], l = LL[m];
    g_cov[m] = k == l
                   ? g_c0 * (b0[k] * b0[k]) + g_c1 * (b0[k] * b1[k]) +
                         g_c2 * (b1[k] * b1[k])
                   : g_c0 * (b0[k] * b0[l] + b0[l] * b0[k]) +
                         g_c1 * (b0[k] * b1[l] + b0[l] * b1[k]) +
                         g_c2 * (b1[k] * b1[l] + b1[l] * b1[k]);
  }

  // b0 = s0 W0 + s1 W2, b1 = s2 W1 + s3 W2 (W the view rotation's rows)
  const float* Vm = cam.view4 + (size_t)v * 16;
  const float g_s0 = g_b0[0] * Vm[0] + g_b0[1] * Vm[1] + g_b0[2] * Vm[2];
  const float g_s1 = g_b0[0] * Vm[8] + g_b0[1] * Vm[9] + g_b0[2] * Vm[10];
  const float g_s2 = g_b1[0] * Vm[4] + g_b1[1] * Vm[5] + g_b1[2] * Vm[6];
  const float g_s3 = g_b1[0] * Vm[8] + g_b1[1] * Vm[9] + g_b1[2] * Vm[10];
  const float tz = g.t[2], dd = tz * tz;
  float g_tz = -g_s0 * (g.s[0] / tz) + -g_s2 * (g.s[2] / tz);
  // s1 = -(fx tx) / tz^2, s3 = -(fy ty) / tz^2
  const float g_dd = -g_s1 * (g.s[1] / dd) + -g_s3 * (g.s[3] / dd);
  const float g_tc[2] = {(-(g_s1 / dd)) * cam.fx[v],
                         (-(g_s3 / dd)) * cam.fy[v]};
  g_tz = g_tz + (g_dd * tz + g_dd * tz);
  // t_xy = clamp(t_xy / tz, +-1.3 tan(fov/2)) tz
  float g_t[3];
  for (int a = 0; a < 2; ++a) {
    g_tz = g_tz + g_tc[a] * g.uc[a];
    const float g_u = g.u[a] >= -g.lim[a] && g.u[a] <= g.lim[a]
                          ? g_tc[a] * tz : 0.f;
    g_t[a] = g_u / tz;
    g_tz = g_tz + -g_u * (g.u[a] / tz);
  }
  g_t[2] = g_tz;
  for (int k = 0; k < 3; ++k)
    gx[k] = gx[k] + (g_t[0] * Vm[k] + g_t[1] * Vm[4 + k] + g_t[2] * Vm[8 + k]);
  for (int k = 0; k < 3; ++k) g_xyz[vj * 3 + k] = gx[k] + gl[k];

  // Sigma = L L^T, L = R diag(s), s = exp(log_scales)
  const float* L = g.L;
  float g_r[9];
  for (int k = 0; k < 3; ++k) {
    g_r[k] = (g_cov[0] + g_cov[0]) * L[k] + g_cov[1] * L[3 + k] +
             g_cov[2] * L[6 + k];
    g_r[3 + k] = g_cov[1] * L[k] + (g_cov[3] + g_cov[3]) * L[3 + k] +
                 g_cov[4] * L[6 + k];
    g_r[6 + k] = g_cov[2] * L[k] + g_cov[4] * L[3 + k] +
                 (g_cov[5] + g_cov[5]) * L[6 + k];
  }
  float gR[9];
  for (int m = 0; m < 9; ++m) gR[m] = g_r[m] * g.sc[m % 3];
  for (int k = 0; k < 3; ++k)
    g_ls[vj * 3 + k] =
        (g_r[k] * g.R[k] + g_r[3 + k] * g.R[3 + k] + g_r[6 + k] * g.R[6 + k]) *
        g.sc[k];

  // R of the normalized quaternion (r, x, y, z)
  const float r = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  float g_qn[4];
  g_qn[0] = 2.f * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5] -
                   y * gR[6] + x * gR[7]);
  g_qn[1] = 2.f * (y * gR[1] + z * gR[2] + y * gR[3] - 2.f * x * gR[4] -
                   r * gR[5] + z * gR[6] + r * gR[7] - 2.f * x * gR[8]);
  g_qn[2] = 2.f * (-2.f * y * gR[0] + x * gR[1] + r * gR[2] + x * gR[3] +
                   z * gR[5] - r * gR[6] + z * gR[7] - 2.f * y * gR[8]);
  g_qn[3] = 2.f * (-2.f * z * gR[0] - r * gR[1] + x * gR[2] + r * gR[3] -
                   2.f * z * gR[4] + y * gR[5] + x * gR[6] + y * gR[7]);
  // qn = q / |q|
  const float g_nrm =
      -(g_qn[0] * (g.qn[0] / g.nrm) + g_qn[1] * (g.qn[1] / g.nrm) +
        g_qn[2] * (g.qn[2] / g.nrm) + g_qn[3] * (g.qn[3] / g.nrm));
  const float g_ss = g_nrm / (2.f * g.nrm);
  for (int k = 0; k < 4; ++k)
    g_q[vj * 4 + k] = g_qn[k] / g.nrm + (g_ss * g.q[k] + g_ss * g.q[k]);
}

// Kernel A's chunks per view: blocks enough to fill a card of `sms` SMs
// (8 resident blocks of PACK_THREADS an SM), each copying at least
// MIN_CHUNK profile floats.
int pack_chunks(int V, long long per_view, int sms) {
  const long long want = (8LL * sms + V - 1) / V;
  const long long most = (per_view + MIN_CHUNK - 1) / MIN_CHUNK;
  const long long c = want < most ? want : most;
  return c < 1 ? 1 : (int)c;
}

}  // namespace
}  // namespace skelsplat

using skelsplat::Cams;
using skelsplat::Params;

// C interface, bound with ctypes (ops/cuda_preprocess.py). All pointers are
// device pointers of contiguous float32 (int32: order, C) tensors. Scene
// parameters xyz, log_scales (S, N, 3), quats (S, N, 4), logit (S, N, 1)
// with S = V / A; cameras view4, full4 (V, 4, 4), focal_x, focal_y,
// tan_fovx, tan_fovy, width, height (V,). One launch on `stream`, no host
// synchronisation. Each returns the cudaError_t of its launch.

// Kernel A: B (V, N), spans (V, N, 4), p1 (V, N, H), p2 (V, N, W) in
// Gaussian order -> pack (V, N, 16), order (V, N), p1s, p2s in slot order.
// `sms` is the launching device's SM count, which sizes the grid.
extern "C" int skelsplat_preprocess_pack(
    const float* xyz, const float* log_scales, const float* quats,
    const float* logit, const float* view4, const float* full4,
    const float* focal_x, const float* focal_y, const float* tan_fovx,
    const float* tan_fovy, const float* width, const float* height,
    const float* B, const float* spans, const float* p1, const float* p2,
    int V, int A, int N, int H, int W, int antialiasing, int sms,
    float* pack, int* order, float* p1s, float* p2s, void* stream_ptr) {
  using namespace skelsplat;
  if (V < 1 || A < 1 || V % A != 0 || N < 1 || N > MAX_SLOTS || H < 1 ||
      W < 1 || sms < 1 || (long long)(H + W) * N > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Params P{xyz, log_scales, quats, logit};
  const Cams cam{view4, full4, focal_x, focal_y, tan_fovx, tan_fovy, width,
                 height};
  const dim3 grid(V, pack_chunks(V, (long long)N * (H + W), sms));
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (antialiasing)
    preprocess_pack<true><<<grid, PACK_THREADS, 0, stream>>>(
        P, cam, B, spans, p1, p2, A, N, H, W, pack, order, p1s, p2s);
  else
    preprocess_pack<false><<<grid, PACK_THREADS, 0, stream>>>(
        P, cam, B, spans, p1, p2, A, N, H, W, pack, order, p1s, p2s);
  return (int)cudaGetLastError();
}

// Kernel B: order (V, N) from kernel A, K1's S (V), C (V), dg (V, N, 6)
// in slot order; the limb pairs (la0, la1, ra0, ra1, ll0, ll1, rl0, rl1)
// when `limbs` -> losses (V), g_xyz, g_ls (V, N, 3), g_q (V, N, 4),
// g_logit (V, N, 1) in Gaussian order.
extern "C" int skelsplat_preprocess_grad(
    const float* xyz, const float* log_scales, const float* quats,
    const float* logit, const float* view4, const float* full4,
    const float* focal_x, const float* focal_y, const float* tan_fovx,
    const float* tan_fovy, const float* width, const float* height,
    const int* order, const float* S, const int* C, const float* dg, int V,
    int A, int N, int H, int W, int antialiasing, int limbs, int la0,
    int la1, int ra0, int ra1, int ll0, int ll1, int rl0, int rl1,
    float lambda, float* losses, float* g_xyz, float* g_ls, float* g_q,
    float* g_logit, void* stream_ptr) {
  using namespace skelsplat;
  if (V < 1 || A < 1 || V % A != 0 || N < 1 || N > MAX_SLOTS || H < 1 ||
      W < 1)
    return (int)cudaErrorInvalidValue;
  const Params P{xyz, log_scales, quats, logit};
  const Cams cam{view4, full4, focal_x, focal_y, tan_fovx, tan_fovy, width,
                 height};
  const Limbs lb{limbs != 0, {la0, ra0, ll0, rl0}, {la1, ra1, ll1, rl1}};
  for (int p = 0; p < 4; ++p)
    if (lb.on && (lb.a[p] < 0 || lb.a[p] >= N || lb.b[p] < 0 || lb.b[p] >= N))
      return (int)cudaErrorInvalidValue;
  const int grid = (V + GRAD_WARPS - 1) / GRAD_WARPS;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (antialiasing)
    preprocess_grad<true><<<grid, GRAD_WARPS * 32, 0, stream>>>(
        P, cam, order, S, C, dg, V, A, N, H, W, lb, lambda, losses, g_xyz,
        g_ls, g_q, g_logit);
  else
    preprocess_grad<false><<<grid, GRAD_WARPS * 32, 0, stream>>>(
        P, cam, order, S, C, dg, V, A, N, H, W, lb, lambda, losses, g_xyz,
        g_ls, g_q, g_logit);
  return (int)cudaGetLastError();
}
