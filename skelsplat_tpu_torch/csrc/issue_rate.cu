// Issue-rate probe: dependent chains of one f32 operation per element, to
// measure how fast the card issues the kind of instruction stream the
// raster-loss kernel (csrc/raster_loss.cu) is made of.
//
// Replaces skelsplat_tpu/tools/roofline.py::_probe_issue_rate.<kernel> (K3).
// Per element e it computes what the TPU kernel computes: `chains` chains
// start at x[e] * (1 + 1e-6 c); together they run k_steps dependent steps
// of the op, k_steps / chains each, interleaved one step per chain at a
// time; out[e] is the chains' sum, left to right. The steps
// (roofline.py:192-209):
//   mul: x * 1.0000001
//   fma: x * 1.0000001 + 1e-9                 (FMUL then FADD)
//   exp: expf(x) * 1e-7 - 1e-7                (exactly 0 from step 3 on)
//   mix: d = x - 0.5; p = d * d; q = p * 0.25 + x * 0.5;
//        (p <= 0.26) & (x >= 1e-3) ? q : x    (9 operations)
// The TPU's carry of the block from one grid program to the next only
// serialised its grid and is dropped: one thread per element, blocks
// independent.
//
// What bounds it on an H100: operations, by construction. It reads and
// writes 8 bytes per element and does k_steps x (1 for mul, 2 for fma, 9
// for mix) f32 operations per element, counting an FMUL, FADD, compare,
// predicate and or select as 1 (an FFMA would count 2; none is emitted),
// and an accurate expf as whatever the exp probe measures it to cost. The
// design keeps the chain from being folded away or hidden:
//   * built with the library's flags (--fmad=false, accurate expf), so the
//     fma and mix steps are separate FMUL/FADD instructions and exp is the
//     same expf sequence as in the raster-loss kernel;
//   * the constants come in as a kernel argument, so nvcc cannot fold
//     x * c * c ... or precompute anything;
//   * the step loop is fully unrolled in groups of UNROLL steps (as the
//     TPU's was), leaving one loop branch per group;
//   * one template instantiation per (op, chains), with chains in
//     {1, 2, 4}, so the independent chains are interleaved in registers;
//     the probe times each one.
// For x in [0, 1) an exp chain gives <= 1.7e-7 after one step, ~1e-14
// after two, and from the third step on expf rounds to 1 and the chain is
// exactly 0: its output checks that the chain is built, and the SASS count
// (one MUFU per step, chip_smoke.py) checks that expf's body is there.
// The probe's grid holds several resident 256-thread blocks per SM
// (tools/roofline.py::probe_issue_rate sizes it).
#include <cuda_runtime.h>

namespace skelsplat {

constexpr int ISSUE_THREADS = 256;
constexpr int UNROLL = 64;  // steps per unrolled group; k_steps % UNROLL == 0

enum IssueOp { OP_MUL = 0, OP_FMA = 1, OP_EXP = 2, OP_MIX = 3 };

// The TPU kernel's constants: Python doubles rounded to f32
struct IssueConsts {
  float mul, add, scale, half, quarter, p_max, x_min;
};

template <int OP>
__device__ __forceinline__ float issue_step(float x, const IssueConsts& k) {
  if (OP == OP_MUL) return x * k.mul;
  if (OP == OP_FMA) return x * k.mul + k.add;
  if (OP == OP_EXP) return expf(x) * k.scale - k.scale;
  const float d = x - k.half;
  const float p = d * d;
  const float q = p * k.quarter + x * k.half;
  const bool m = (p <= k.p_max) & (x >= k.x_min);
  return m ? q : x;
}

template <int OP, int CHAINS>
__global__ void __launch_bounds__(ISSUE_THREADS)
    issue_rate_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int n, int groups, IssueConsts k) {
  const int e = blockIdx.x * ISSUE_THREADS + threadIdx.x;
  if (e >= n) return;
  const float x0 = x[e];
  float v[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) v[c] = x0 * (float)(1.0 + 1e-6 * c);
#pragma unroll 1
  for (int g = 0; g < groups; ++g) {
#pragma unroll
    for (int s = 0; s < UNROLL / CHAINS; ++s) {
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) v[c] = issue_step<OP>(v[c], k);
    }
  }
  float acc = v[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) acc = acc + v[c];
  out[e] = acc;
}

template <int OP>
cudaError_t launch_issue(const float* x, float* out, int n, int groups,
                         int chains, const IssueConsts& k,
                         cudaStream_t stream) {
  const int blocks = (n + ISSUE_THREADS - 1) / ISSUE_THREADS;
  switch (chains) {
    case 1:
      issue_rate_kernel<OP, 1><<<blocks, ISSUE_THREADS, 0, stream>>>(x, out, n, groups, k);
      break;
    case 2:
      issue_rate_kernel<OP, 2><<<blocks, ISSUE_THREADS, 0, stream>>>(x, out, n, groups, k);
      break;
    case 4:
      issue_rate_kernel<OP, 4><<<blocks, ISSUE_THREADS, 0, stream>>>(x, out, n, groups, k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace skelsplat

// C interface, bound with ctypes (tools/roofline.py). x and out are device
// pointers of contiguous float32 arrays of n elements; op is 0 mul, 1 fma,
// 2 exp, 3 mix. Returns the cudaError_t of the launch.
extern "C" int skelsplat_issue_rate(const float* x, float* out, int n,
                                    int k_steps, int chains, int op,
                                    void* stream_ptr) {
  using namespace skelsplat;
  if (n < 1 || k_steps < UNROLL || k_steps % UNROLL != 0)
    return (int)cudaErrorInvalidValue;
  const IssueConsts k = {(float)1.0000001, (float)1e-9, (float)1e-7, 0.5f,
                         0.25f, (float)0.26, (float)1e-3};
  const int groups = k_steps / UNROLL;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (op) {
    case OP_MUL: return (int)launch_issue<OP_MUL>(x, out, n, groups, chains, k, stream);
    case OP_FMA: return (int)launch_issue<OP_FMA>(x, out, n, groups, chains, k, stream);
    case OP_EXP: return (int)launch_issue<OP_EXP>(x, out, n, groups, chains, k, stream);
    case OP_MIX: return (int)launch_issue<OP_MIX>(x, out, n, groups, chains, k, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
