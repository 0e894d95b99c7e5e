// Dense SPH-kernel interpolation over every candidate (no candidate cap).
//
// Replaces tpugan_tpu/ops/pallas/interp_kernel.py : kernel_interp_pallas
// (_interp_kernel), and with it the candidate chunks of
// binned_interp_kernel.py : chunked_dense_interp, which exist only for the
// TPU's VMEM: here one launch covers any candidate count.
//
// Contract: query [B,Nq,3], cand [B,M,3], values [B,M,C] (C <= 8),
// bias [B,M] (0 valid, 1e10 invalid), all f32 ->
//   d2  = dx*dx + dy*dy + dz*dz + bias        (direct differences)
//   w   = W(d2) in the two-hinge form of the TPU kernel's _kernel_w:
//         u = max(d2 / cutoff^2, 0), q = sqrt(u)
//         bicubic / spline1: k1 (1-q)_+^3 - k2 (1/2-q)_+^3
//         linear:            (1-q)_+
//         exponential:       u <= 1 ? k1 exp(-u) : 0
//   den = sum_c w + 1e-6,  out = sum_c w * values / den
// -> out [B,Nq,C], den [B,Nq]. The constants (1 / cutoff^2, k1, k2) come
// from the wrapper, computed as the JAX package computes them.
//
// What bounds it on the H100: operations. The train step's call (12 rows,
// 9,216 queries over 9,216 candidates, C = 3) is 1.0e9 pairs of about 20
// f32 operations and a square root each, against 1.3 MB of input.
//
// Design: one thread per query, 256 queries per block. Candidate tiles of
// 512 (x, y, z, bias) float4 rows and their values stream through shared
// memory, read by every lane as a broadcast; numerator and denominator
// stay in registers and sum in candidate order.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 512;    // 8 KB of rows + 16 KB of values
constexpr int MAX_C = 8;

enum Kind { kBicubic = 0, kSpline1 = 1, kLinear = 2, kExponential = 3 };

__device__ __forceinline__ float weight(float d2, float inv_c2, float k1,
                                        float k2, int kind) {
  const float u = fmaxf(d2 * inv_c2, 0.f);
  const float q = sqrtf(u);
  if (kind == kLinear) return fmaxf(1.f - q, 0.f);
  if (kind == kExponential) return u <= 1.f ? k1 * expf(-u) : 0.f;
  const float s1 = fmaxf(1.f - q, 0.f), s2 = fmaxf(0.5f - q, 0.f);
  return k1 * (s1 * s1 * s1) - k2 * (s2 * s2 * s2);
}

__global__ void __launch_bounds__(THREADS)
interp_kernel(const float* __restrict__ query, const float* __restrict__ cand,
              const float* __restrict__ values, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ den_out, int Nq,
              int M, int C, float inv_c2, float k1, float k2, int kind) {
  __shared__ float4 ct[TILE];
  __shared__ float vt[TILE * MAX_C];

  const int b = blockIdx.y;
  const int qi = blockIdx.x * THREADS + threadIdx.x;
  const float* qr = query + ((size_t)b * Nq + min(qi, Nq - 1)) * 3;
  const float qx = qr[0], qy = qr[1], qz = qr[2];
  float num[MAX_C];
#pragma unroll
  for (int j = 0; j < MAX_C; ++j) num[j] = 0.f;
  float den = 0.f;

  const float* cb = cand + (size_t)b * M * 3;
  const float* vb = values + (size_t)b * M * C;
  const float* bb = bias + (size_t)b * M;
  for (int t0 = 0; t0 < M; t0 += TILE) {
    const int nt = min(TILE, M - t0);
    __syncthreads();                         // the previous tile is read
    for (int i = threadIdx.x; i < nt; i += THREADS) {
      const float* cr = cb + (size_t)(t0 + i) * 3;
      ct[i] = make_float4(cr[0], cr[1], cr[2], bb[t0 + i]);
    }
    for (int i = threadIdx.x; i < nt * C; i += THREADS)
      vt[i] = vb[(size_t)t0 * C + i];
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      const float4 c = ct[i];
      const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
      const float w = weight(dx * dx + dy * dy + dz * dz + c.w, inv_c2, k1, k2,
                             kind);
      den += w;
#pragma unroll
      for (int j = 0; j < MAX_C; ++j)
        if (j < C) num[j] = fmaf(w, vt[i * C + j], num[j]);
    }
  }
  if (qi < Nq) {
    den += 1e-6f;
#pragma unroll
    for (int j = 0; j < MAX_C; ++j)
      if (j < C) out[((size_t)b * Nq + qi) * C + j] = num[j] / den;
    den_out[(size_t)b * Nq + qi] = den;
  }
}

}  // namespace

// Shapes the wrapper (ops/kernels/interp.py) admits: Nq >= 1, M >= 1,
// 1 <= C <= 8, all tensors contiguous on one device.
extern "C" int interp_f32(const void* query, const void* cand,
                          const void* values, const void* bias, void* out,
                          void* den, int B, int Nq, int M, int C, float inv_c2,
                          float k1, float k2, int kind, void* stream) {
  const dim3 grid((Nq + THREADS - 1) / THREADS, B);
  interp_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(cand),
      static_cast<const float*>(values), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(den), Nq, M, C, inv_c2, k1,
      k2, kind);
  return static_cast<int>(cudaGetLastError());
}
