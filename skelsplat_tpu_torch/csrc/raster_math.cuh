// Per-pixel math of the raster-loss kernel (csrc/raster_loss.cu).
//
// Every expression keeps the operation order of the reference
// (skelsplat_tpu/ops/pallas_raster.py::_slot_alpha, _bwd_kernel) and of the
// plain PyTorch version (ops/cuda_raster.py::_raster_loss_plain). The file
// is compiled with --fmad=false and without fast math, so each product and
// sum rounds on its own and expf is the accurate exponential: the T_MIN
// early-out sits at a representability edge ((1-0.99)^2 < 1e-4 in f32) and
// exp feeds the alpha >= 1/255 gate.
#pragma once

namespace skelsplat {

// slot record layout (ops/cuda_raster.py, PACK)
constexpr int PACK = 16;
constexpr int IDX_PX = 0, IDX_PY = 1, IDX_CA = 2, IDX_CB = 3, IDX_CC = 4,
              IDX_OPA = 5;
constexpr int IDX_RX0 = 6, IDX_RY0 = 7, IDX_RX1 = 8, IDX_RY1 = 9;
constexpr int IDX_B = 10;
constexpr int IDX_GY0 = 11, IDX_GY1 = 12, IDX_GX0 = 13, IDX_GX1 = 14;
constexpr int N_GRAD = 6;

constexpr int TILE = 16;        // reference rasterizer BLOCK_X = BLOCK_Y
constexpr int MAX_SLOTS = 32;   // per-slot alpha and T live in registers

// The reference compares f32 values against Python doubles rounded to f32.
constexpr float ALPHA_MAX = (float)0.99;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_MIN = (float)1.0e-4;

struct SlotEval {
  float dx, dy, power, E, alpha;
};

// alpha = min(0.99, opa * exp(power)) of slot record `s` at pixel (x, y).
__device__ __forceinline__ SlotEval slot_alpha(const float* s, float x,
                                               float y) {
  SlotEval r;
  r.dx = s[IDX_PX] - x;
  r.dy = s[IDX_PY] - y;
  r.power = -0.5f * (s[IDX_CA] * r.dx * r.dx + s[IDX_CC] * r.dy * r.dy) -
            s[IDX_CB] * r.dx * r.dy;
  r.E = expf(r.power);
  const float v = s[IDX_OPA] * r.E;
  r.alpha = v > ALPHA_MAX ? ALPHA_MAX : v;  // NaN stays NaN, as in min()
  return r;
}

// per-pixel error term and its derivative w.r.t. the render:
// |d| and sign(d) for the l1 family, d^2 and 2d for l2_gaussian
template <bool L1>
__device__ __forceinline__ float err_of(float d) {
  return L1 ? fabsf(d) : d * d;
}

template <bool L1>
__device__ __forceinline__ float derr_of(float d) {
  if (L1) return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
  return 2.0f * d;
}

}  // namespace skelsplat
