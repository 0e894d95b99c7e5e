// The squared distance and its SPH weight, shared by the dense (interp.cu)
// and the cell-grid (binned_interp.cu) interpolation kernels, so that both
// give the same weight to the same pair. The two-hinge form of the TPU kernels'
// _kernel_w (tpugan_tpu/ops/pallas/interp_kernel.py):
//   u = max(d2 / cutoff^2, 0), q = sqrt(u)
//   bicubic / spline1: k1 (1-q)_+^3 - k2 (1/2-q)_+^3
//   linear:            (1-q)_+
//   exponential:       u <= 1 ? k1 exp(-u) : 0
// Every kind is 0 for u > 1. The constants (1 / cutoff^2, k1, k2) come from
// the wrapper (ops/kernels/interp.py : kernel_constants).
#pragma once

enum SphKind { kBicubic = 0, kSpline1 = 1, kLinear = 2, kExponential = 3 };

// d2 = ((dx*dx + dy*dy) + dz*dz) + bias, each operation rounded on its own
// (no FMA contraction), as the plain versions form it
// (ops/kernels/interp.py : sq_dist): near the cutoff the weight's (1-q)^3
// turns one ulp of d2 into a relative change of order 1e-4, which a query
// with only fringe neighbours (a grid point outside the fluid) shows.
__device__ __forceinline__ float sph_d2(float dx, float dy, float dz,
                                        float bias) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz)),
                   bias);
}

__device__ __forceinline__ float sph_weight(float d2, float inv_c2, float k1,
                                            float k2, int kind) {
  const float u = fmaxf(d2 * inv_c2, 0.f);
  const float q = sqrtf(u);
  if (kind == kLinear) return fmaxf(1.f - q, 0.f);
  if (kind == kExponential) return u <= 1.f ? k1 * expf(-u) : 0.f;
  const float s1 = fmaxf(1.f - q, 0.f), s2 = fmaxf(0.5f - q, 0.f);
  return k1 * (s1 * s1 * s1) - k2 * (s2 * s2 * s2);
}
