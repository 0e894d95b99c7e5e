// Exact all-in-radius SPH interpolation over a uniform cell grid.
//
// Replaces tpugan_tpu/ops/pallas/binned_interp_kernel.py :
// binned_interp_pallas (_binned_kernel, _binned_pallas_call). The TPU
// kernel prunes candidates with Morton-sorted blocks, AABB block selection,
// a top_k of blocks as scalar prefetch and a dense fallback when a tile
// needs more than max_blocks blocks. None of that is the contract; the
// contract is the dense kernel's exact sum (interp_kernel.py), and here a
// fixed-radius cell grid gives it with no block budget, so there is no
// overflow and no fallback.
//
// Contract: query [B,Nq,3], cand [B,M,3], values [B,M,C] (C <= 8),
// bias [B,M] (0 valid, 1e10 invalid), f32 ->
//   den = sum_c w + 1e-6,  out = sum_c w * values / den
// over every candidate c within the cutoff, with w = sph_weight(d2) and
//   d2 = ((dx*dx + dy*dy) + dz*dz) + bias   (direct differences, sph_d2)
// -> out [B,Nq,C], den [B,Nq]: the function of interp.cu, whose weight code
// (sph_weight.cuh) this kernel shares.
//
// The grid (built by the wrapper, ops/kernels/binned_interp.py, in plain
// PyTorch on the card): cells of side >= cutoff * 1.001 over the valid
// candidates' bounding box, the side enlarged where needed so that the
// grid holds at most 2^22 cells; candidates sorted by (batch, cell) as
// float4 rows (x, y, z, bias) with their values, a CSR table of each cell's
// [start, end); candidates whose bias reaches cutoff^2 are left out (their
// weight is 0). A candidate within the cutoff of a query lies in the
// query's cell or one of its 26 neighbours, so the walk below is exact.
//
// Design: one thread per query, queries taken in the order of their cells
// (a permutation from the wrapper) so that a warp's lanes walk nearby
// ranges. The 27 cells are walked as 9 contiguous ranges: the three cells
// x-1..x+1 of one (y, z) row are consecutive in the CSR order. Numerator and
// denominator stay in registers; nothing is shared between threads.
//
// What bounds it on the H100: operations. The function needs the pairs
// within the cutoff, about 20 f32 operations and a square root each,
// against a few MB of queries, candidates, values and outputs. The walk
// evaluates every pair the 27 cells hold: a sphere of radius cutoff fills
// at most 4.19 / 27 of them, so it evaluates 6.4x or more the pairs the
// function needs. It reads the pairs' candidate rows from L2 and L1 (the
// sorted candidates of neighbouring queries overlap); making it fast
// (shared-memory staging of a cell block's candidates, smaller cells with
// a tighter walk, a warp per query for dense cells) is later work.
#include "common.cuh"
#include "sph_weight.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 8;

__device__ __forceinline__ int cell_coord(float p, float lo, float inv_side,
                                          int n) {
  // clamped to [-2, n + 1]: a cell outside the grid has no candidates, and
  // the clamp keeps far-away queries (the 999 sentinel) from overflowing
  const float f = floorf((p - lo) * inv_side);
  return static_cast<int>(fminf(fmaxf(f, -2.f), static_cast<float>(n + 1)));
}

__global__ void __launch_bounds__(THREADS)
binned_interp_kernel(const float* __restrict__ query,
                     const float4* __restrict__ pts,
                     const float* __restrict__ values,
                     const int* __restrict__ cell_off,
                     const int* __restrict__ qorder, float* __restrict__ out,
                     float* __restrict__ den_out, int total, int Nq, int C,
                     int nx, int ny, int nz, float lox, float loy, float loz,
                     float inv_side, float inv_c2, float k1, float k2,
                     int kind) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int gq = __ldg(qorder + t);        // row b * Nq + i of the query
  const int b = gq / Nq;
  const float qx = __ldg(query + 3 * (size_t)gq);
  const float qy = __ldg(query + 3 * (size_t)gq + 1);
  const float qz = __ldg(query + 3 * (size_t)gq + 2);
  const int cx = cell_coord(qx, lox, inv_side, nx);
  const int cy = cell_coord(qy, loy, inv_side, ny);
  const int cz = cell_coord(qz, loz, inv_side, nz);
  const int x0 = max(cx - 1, 0), x1 = min(cx + 1, nx - 1);

  float num[MAX_C];
#pragma unroll
  for (int j = 0; j < MAX_C; ++j) num[j] = 0.f;
  float den = 0.f;

  if (x0 <= x1) {
    const int* off = cell_off + (size_t)b * nx * ny * nz;
    for (int z = max(cz - 1, 0); z <= min(cz + 1, nz - 1); ++z) {
      for (int y = max(cy - 1, 0); y <= min(cy + 1, ny - 1); ++y) {
        const int row = (z * ny + y) * nx;
        const int s = __ldg(off + row + x0);
        const int e = __ldg(off + row + x1 + 1);
        for (int i = s; i < e; ++i) {
          const float4 c = __ldg(pts + i);
          const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
          const float w = sph_weight(sph_d2(dx, dy, dz, c.w), inv_c2, k1,
                                     k2, kind);
          den += w;
          const float* v = values + (size_t)i * C;
#pragma unroll
          for (int j = 0; j < MAX_C; ++j)
            if (j < C) num[j] = fmaf(w, __ldg(v + j), num[j]);
        }
      }
    }
  }
  den += 1e-6f;
#pragma unroll
  for (int j = 0; j < MAX_C; ++j)
    if (j < C) out[(size_t)gq * C + j] = num[j] / den;
  den_out[gq] = den;
}

}  // namespace

// Shapes the wrapper (ops/kernels/binned_interp.py) admits: B * Nq >= 1,
// 1 <= C <= 8, B * nx * ny * nz <= 2^22, B * M < 2^31, all tensors
// contiguous on one device; pts / values / cell_off are the sorted grid.
extern "C" int binned_interp_f32(const void* query, const void* pts,
                                 const void* values, const void* cell_off,
                                 const void* qorder, void* out, void* den,
                                 int B, int Nq, int C, int nx, int ny, int nz,
                                 float lox, float loy, float loz,
                                 float inv_side, float inv_c2, float k1,
                                 float k2, int kind, void* stream) {
  const int total = B * Nq;
  const dim3 grid((total + THREADS - 1) / THREADS);
  binned_interp_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float4*>(pts),
      static_cast<const float*>(values), static_cast<const int*>(cell_off),
      static_cast<const int*>(qorder), static_cast<float*>(out),
      static_cast<float*>(den), total, Nq, C, nx, ny, nz, lox, loy, loz,
      inv_side, inv_c2, k1, k2, kind);
  return static_cast<int>(cudaGetLastError());
}
