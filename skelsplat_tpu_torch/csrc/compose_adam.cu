// Kernel C, compose_adam: the macro step after kernel B, from the visited
// views' gradients to the updated parameters and the loop state.
//
// Replaces no TPU kernel: the JAX package leaves the gradient composition,
// Adam and its history writes to XLA. In the port they were 131 of a
// macro step's 135 device operations (PERF.md section 5): the xyz mean
// over the views, the last view's gather for the other groups, the xyz LR
// schedule, Adam's bias corrections and updates of four groups, the
// no-stop selects and the copies of the carry and the history, each a
// graph node of ~1.1 us for a few floats of work.
//
// What bounds it on an H100: launch latency. A scene is N <= 32 Gaussians
// of 11 floats, each read and written with its two moments once; even a
// batch of 512 scenes is under 2 MB each way. So each scene is one block,
// which needs nothing of another: the blocks of a batch run side by side
// on the SMs, and a launch takes about as long at 128 scenes as at one.
// The one value they share is the step counter, which every block reads
// and the launch advances. A block counts itself done in the counter's
// high 32 bits (an atomic add, after its own read of the counter); the
// block that counts last knows every read is done and writes k + 1, which
// clears the count (a launch of one scene writes k + 1 at once). So the
// count lives in the caller's own counter, and launches with counters of
// their own may run side by side.
//
// Numerics: float32, compiled with --fmad=false, IEEE division and square
// root, and every expression in torch's operation order on the card, so
// the parameters and moments are bitwise the torch composite's there:
// engine/trainer.py::compose_macro's mean fusion (torch.mean's four lane
// accumulators, then their sum, times 1/A), engine/optim.py's
// AdamGroups.step and core/geometry.py's expon_lr (a division by a Python
// number is torch's multiplication by its float reciprocal). The
// telemetry norms follow torch's two-lane reduction of three components.
#include <cuda_runtime.h>

namespace skelsplat {
namespace {

constexpr int MAX_THREADS = 1024;
constexpr int LANES = 4;  // torch.mean's accumulators a thread (vt0)

struct Groups {
  float *xyz, *log_scales, *quats, *logit;  // (S, N, 3 / 3 / 4 / 1)
};

struct Grads {
  const float *xyz, *log_scales, *quats, *logit;  // (S, A, N, 3 / 3 / 4 / 1)
};

struct Schedule {
  float lr_init, lr_final;        // the xyz LR's endpoints
  int max_steps, delay_steps;
  float delay_mult, one_minus_delay_mult, half_pi;
  float lr[3];                    // log_scales, quats, logit
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

struct History {
  float* losses;           // (S, rows, A)
  float *err, *err_rel;    // (S, rows, N) unless lean
  int rows;                // 1 when lean (row 0), else K (row k)
};

// torch's NaN-propagating clamp
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// core/geometry.py's expon_lr at a float iteration, before the extent
__device__ float expon_lr(float step, const Schedule& c) {
  if (c.lr_init == 0.f && c.lr_final == 0.f) return 0.f;
  float delay_rate = 1.f;
  if (c.delay_steps > 0) {
    const float r = clamp_t(step * (1.f / (float)c.delay_steps), 0.f, 1.f);
    delay_rate = c.one_minus_delay_mult * sinf(c.half_pi * r) + c.delay_mult;
  }
  const float t = clamp_t(step * (1.f / (float)c.max_steps), 0.f, 1.f);
  const float log_lerp =
      expf(logf(c.lr_init) * (1.f - t) + logf(c.lr_final) * t);
  return step < 0.f ? 0.f : delay_rate * log_lerp;
}

// ||a - b|| of three components in torch's order: lanes {0, 2} and {1}
__device__ __forceinline__ float norm3(float d0, float d1, float d2) {
  return sqrtf((d0 * d0 + d2 * d2) + d1 * d1);
}

__global__ void __launch_bounds__(MAX_THREADS)
    compose_adam(Groups p, Groups m, Groups v, int* t, long long* step,
                 const float* losses_v, Grads g, const float* extent,
                 const float* gt, History h, Schedule c, int A, int N) {
  __shared__ long long k_shared;
  unsigned long long* counter = reinterpret_cast<unsigned long long*>(step);
  if (threadIdx.x == 0)  // the low half: k; the high half: blocks done
    k_shared = (long long)(*(volatile unsigned long long*)counter &
                           0xffffffffull);
  __syncthreads();
  const long long k = k_shared;
  const float iteration = (float)(k * A + A);
  const float base_lr = expon_lr(iteration, c);
  const int s = blockIdx.x;  // this block's scene
  const int per_scene = 11 * N;
  const int n = blockDim.x;
  const float tf = (float)(t[s] + 1);
  const float bc1 = 1.f - powf(c.beta1, tf);
  const float bc2 = 1.f - powf(c.beta2, tf);

  for (int r = threadIdx.x; r < per_scene; r += n) {
    float *pp, *mp, *vp;
    float grad, lr;
    if (r < 3 * N) {  // xyz: the mean over the A views
      const int i = s * 3 * N + r;
      pp = p.xyz + i, mp = m.xyz + i, vp = v.xyz + i;
      const float* gs = g.xyz + (size_t)s * A * 3 * N + r;
      float acc[LANES] = {0.f, 0.f, 0.f, 0.f};
      for (int a0 = 0; a0 < A; a0 += LANES)
#pragma unroll
        for (int l = 0; l < LANES; ++l)
          if (a0 + l < A) acc[l] = acc[l] + gs[(size_t)(a0 + l) * 3 * N];
      float sum = acc[0];
      for (int l = 1; l < LANES; ++l) sum = sum + acc[l];
      grad = sum * (1.f / (float)A);
      lr = extent[s] * base_lr;
    } else {  // the last view's gradient
      const float* gf;
      int w, q = r - 3 * N;
      if (q < 3 * N) {
        w = 3, gf = g.log_scales, lr = c.lr[0];
        pp = p.log_scales, mp = m.log_scales, vp = v.log_scales;
      } else if ((q -= 3 * N) < 4 * N) {
        w = 4, gf = g.quats, lr = c.lr[1];
        pp = p.quats, mp = m.quats, vp = v.quats;
      } else {
        q -= 4 * N;
        w = 1, gf = g.logit, lr = c.lr[2];
        pp = p.logit, mp = m.logit, vp = v.logit;
      }
      const int i = s * w * N + q;
      pp += i, mp += i, vp += i;
      grad = gf[((size_t)s * A + A - 1) * w * N + q];
    }
    const float m1 = c.beta1 * *mp + c.one_minus_beta1 * grad;
    const float v1 = c.beta2 * *vp + c.one_minus_beta2 * grad * grad;
    const float denom = sqrtf(v1 / bc2) + c.eps;
    *pp = *pp - lr * (m1 / bc1) / denom;
    *mp = m1;
    *vp = v1;
  }
  // a full history's row k, which a step past its K rows does not have
  const long long row = h.err == nullptr ? 0 : k;
  const bool in_rows = row >= 0 && row < h.rows;
  for (int a = threadIdx.x; in_rows && a < A; a += n)
    h.losses[((size_t)s * h.rows + row) * A + a] =
        losses_v[(size_t)s * A + a];
  __syncthreads();  // the scene's reads of t done, its xyz written

  if (h.err != nullptr && in_rows) {
    const float* x0 = p.xyz + (size_t)s * N * 3;
    const float* y0 = gt + (size_t)s * N * 3;
    for (int j = threadIdx.x; j < N; j += n) {
      const float* x = x0 + (size_t)j * 3;
      const float* y = y0 + (size_t)j * 3;
      const size_t out = ((size_t)s * h.rows + k) * N + j;
      h.err[out] = norm3(x[0] - y[0], x[1] - y[1], x[2] - y[2]);
      h.err_rel[out] = norm3((x[0] - x0[0]) - (y[0] - y0[0]),
                             (x[1] - x0[1]) - (y[1] - y0[1]),
                             (x[2] - x0[2]) - (y[2] - y0[2]));
    }
  }
  if (threadIdx.x == 0) {
    t[s] = t[s] + 1;
    // this block's read of the counter came before its count, in the same
    // thread on the same word; the last to count writes k + 1. A launch of
    // one block writes it at once, without the atomic's round trip.
    if (gridDim.x == 1 ||
        atomicAdd(counter, 1ull << 32) >> 32 == gridDim.x - 1)
      *counter = (unsigned long long)k + 1;
  }
}

}  // namespace
}  // namespace skelsplat

// C interface, bound with ctypes (ops/compose_adam.py). All pointers are
// device pointers of contiguous tensors: float32 but t (int32) and step
// (int64). S scenes of N Gaussians seen by A views each: parameters and
// Adam's moments xyz, log_scales (S, N, 3), quats (S, N, 4), logit
// (S, N, 1), updated in place; t (S) Adam's step counts and step () the
// macro step counter, both advanced; losses_v (S, A) and the gradients
// (S, A, N, 3 / 3 / 4 / 1) of the visited views in visit order; extent
// (S); gt (S, N, 3). losses_out (S, rows, A) takes losses_v at row 0 when
// err_out is null (lean), else at row k with the telemetry norms in
// err_out and err_rel_out (S, rows, N); a step k past the rows writes no
// row. One launch on `stream`, a block a scene, no host synchronisation;
// the counter must lie in [0, 2^32) and no other launch may use it at the
// same time. Returns the cudaError_t of the launch.
extern "C" int skelsplat_compose_adam(
    float* xyz, float* log_scales, float* quats, float* logit, float* m_xyz,
    float* m_ls, float* m_q, float* m_logit, float* v_xyz, float* v_ls,
    float* v_q, float* v_logit, int* t, long long* step,
    const float* losses_v, const float* g_xyz, const float* g_ls,
    const float* g_q, const float* g_logit, const float* extent,
    const float* gt, float* losses_out, float* err_out, float* err_rel_out,
    int S, int A, int N, int rows, float lr_init, float lr_final,
    int max_steps, int delay_steps, float delay_mult,
    float one_minus_delay_mult, float half_pi, float scaling_lr,
    float rotation_lr, float opacity_lr, float beta1, float one_minus_beta1,
    float beta2, float one_minus_beta2, float eps, void* stream_ptr) {
  using namespace skelsplat;
  if (S < 1 || A < 1 || N < 1 || rows < 1 || max_steps < 1 ||
      (long long)S * 11 * N > 0x7fffffff ||
      ((err_out == nullptr) != (err_rel_out == nullptr)) ||
      (err_out != nullptr && gt == nullptr))
    return (int)cudaErrorInvalidValue;
  const Groups p{xyz, log_scales, quats, logit};
  const Groups m{m_xyz, m_ls, m_q, m_logit};
  const Groups v{v_xyz, v_ls, v_q, v_logit};
  const Grads g{g_xyz, g_ls, g_q, g_logit};
  const History h{losses_out, err_out, err_rel_out, rows};
  const Schedule c{lr_init, lr_final, max_steps, delay_steps, delay_mult,
                   one_minus_delay_mult, half_pi,
                   {scaling_lr, rotation_lr, opacity_lr}, beta1,
                   one_minus_beta1, beta2, one_minus_beta2, eps};
  const int work = 11 * N;
  const int threads =
      work >= MAX_THREADS ? MAX_THREADS : (work + 31) / 32 * 32;
  compose_adam<<<S, threads, 0, (cudaStream_t)stream_ptr>>>(
      p, m, v, t, step, losses_v, g, extent, gt, h, c, A, N);
  return (int)cudaGetLastError();
}
