// Dense SPH-kernel interpolation over every candidate (no candidate cap).
//
// Replaces tpugan_tpu/ops/pallas/interp_kernel.py : kernel_interp_pallas
// (_interp_kernel), and with it the candidate chunks of
// binned_interp_kernel.py : chunked_dense_interp, which exist only for the
// TPU's VMEM: here one launch covers any candidate count.
//
// Contract: query [B,Nq,3], cand [B,M,3], values [B,M,C] (C <= 8),
// bias [B,M] (0 valid, 1e10 invalid), all f32 ->
//   d2  = ((dx*dx + dy*dy) + dz*dz) + bias    (direct differences, each
//                                              operation rounded on its own)
//   w   = W(d2) in the two-hinge form of the TPU kernel's _kernel_w:
//         u = max(d2 / cutoff^2, 0), q = sqrt(u)
//         bicubic / spline1: k1 (1-q)_+^3 - k2 (1/2-q)_+^3
//         linear:            (1-q)_+
//         exponential:       u <= 1 ? k1 exp(-u) : 0
//   den = sum_c w + 1e-6,  out = sum_c w * values / den
// -> out [B,Nq,C], den [B,Nq]. The constants (1 / cutoff^2, k1, k2) come
// from the wrapper, computed as the JAX package computes them.
//
// What bounds it on the H100: operations. Every pair needs its distance
// and the test u <= 1 (about 9 f32 operations); only the pairs within the
// cutoff need the weight, a square root and the sums (about 20).
// The train step's call (12 rows, 9,216 queries over 9,216 candidates,
// C = 3) is 1.0e9 pairs against 1.3 MB of input.
//
// Design (ops/kernels/interp.py : interp_plan picks the shape):
// - Register tiles. A thread owns QPT = 2 queries (2 beat 1 and 4 on the
//   card), query g * QB + u * threads + t for slot u; candidate tiles of (x, y, z, bias) float4 rows and their
//   values (one or two float4 a candidate) stream through shared memory,
//   read by every lane as a broadcast.
// - Zero weights skipped, exactly. Beyond the cutoff (u > 1) every kind's
//   weight is +0, and adding +0 to a sum, or an FMA with a +0 weight,
//   leaves the sum bit for bit as it was (the sums start at +0 and never
//   become -0; the values are finite). So a thread forms each pair's d2 as
//   sph_d2 does and tests it against d2_max, the largest d2 whose u, as
//   sph_weight rounds d2 / cutoff^2, is at most 1 (the wrapper's
//   d2_threshold); a bit a pair marks the pairs within the cutoff of a
//   group of GROUP candidates, and each slot then sums its marked pairs in
//   candidate order, one a turn of a per-lane loop. Divergence serialises
//   the loop over the warp, so a lane pays for the weights, square roots
//   included, of the warp's fullest lane, not of every pair.
// - Candidate splits. Block (b, s, g) sums candidates [s * span, (s + 1) *
//   span) into a partial (num[C], den) in device memory; interp_finish
//   adds the partials in split order, then 1e-6, and divides: no float
//   atomics, so a launch repeats bit for bit.
#include "common.cuh"
#include "sph_weight.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int TILE = 512;    // 8 KB of rows + up to 16 KB of values
constexpr int GROUP = 32;    // candidates a thread tests before it sums
constexpr int MAX_C = 8;
constexpr int QPT = 2;       // queries a thread

template <int NC>
__global__ void __launch_bounds__(MAX_THREADS)
interp_split_kernel(const float* __restrict__ query,
                    const float* __restrict__ cand,
                    const float* __restrict__ values,
                    const float* __restrict__ bias,
                    float* __restrict__ partial, int B, int Nq, int M,
                    int q_blocks, int splits, int span, float d2_max,
                    float inv_c2, float k1, float k2, int kind) {
  constexpr int CV = (NC + 3) / 4;   // float4 of values a candidate
  __shared__ float4 ct[TILE];
  __shared__ float4 vt[TILE * CV];

  const int threads = blockDim.x;
  const int g = blockIdx.x % q_blocks;
  const int s = (blockIdx.x / q_blocks) % splits;
  const int b = blockIdx.x / (q_blocks * splits);
  const int c_begin = s * span, c_end = min(M, c_begin + span);
  const int q0 = g * threads * QPT + threadIdx.x;

  float qx[QPT], qy[QPT], qz[QPT], den[QPT], num[QPT][NC];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const float* qr = query + ((size_t)b * Nq + min(q0 + u * threads, Nq - 1)) * 3;
    qx[u] = qr[0];
    qy[u] = qr[1];
    qz[u] = qr[2];
    den[u] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) num[u][j] = 0.f;
  }

  const float* cb = cand + (size_t)b * M * 3;
  const float* vb = values + (size_t)b * M * NC;
  const float* bb = bias + (size_t)b * M;
  for (int t0 = c_begin; t0 < c_end; t0 += TILE) {
    const int nt = min(TILE, c_end - t0);
    const int padded = (nt + GROUP - 1) / GROUP * GROUP;
    __syncthreads();                         // the previous tile is read
    for (int i = threadIdx.x; i < padded; i += threads) {
      if (i >= nt) {                         // past the tile: masked off
        ct[i] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
        continue;
      }
      const float* cr = cb + (size_t)(t0 + i) * 3;
      ct[i] = make_float4(cr[0], cr[1], cr[2], bb[t0 + i]);
      const float* vr = vb + (size_t)(t0 + i) * NC;
      float v[CV * 4];
#pragma unroll
      for (int j = 0; j < CV * 4; ++j) v[j] = j < NC ? vr[j] : 0.f;
#pragma unroll
      for (int k = 0; k < CV; ++k)
        vt[i * CV + k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                     v[4 * k + 3]);
    }
    __syncthreads();
    for (int g0 = 0; g0 < padded; g0 += GROUP) {
      // Bit j of near[u]: candidate g0 + j within the cutoff of slot u's
      // query. d2 <= d2_max is u = max(d2 / cutoff^2, 0) <= 1 as sph_weight
      // rounds it (a NaN d2 counts as near: its weight is not skipped).
      unsigned near[QPT];
#pragma unroll
      for (int u = 0; u < QPT; ++u) near[u] = 0u;
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const float4 c = ct[g0 + j];
#pragma unroll
        for (int u = 0; u < QPT; ++u) {
          const float d2 = sph_d2(qx[u] - c.x, qy[u] - c.y, qz[u] - c.z, c.w);
          if (!(d2 > d2_max)) near[u] |= 1u << j;
        }
      }
      const int ng = min(GROUP, nt - g0);
      const unsigned live = ng >= GROUP ? ~0u : (1u << ng) - 1u;
#pragma unroll
      for (int u = 0; u < QPT; ++u) near[u] &= live;
      // Each slot's near pairs in candidate order, one a turn.
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        while (near[u]) {
          const int i = g0 + __ffs(near[u]) - 1;
          near[u] &= near[u] - 1;
          const float4 c = ct[i];
          const float w = sph_weight(
              sph_d2(qx[u] - c.x, qy[u] - c.y, qz[u] - c.z, c.w), inv_c2, k1,
              k2, kind);
          den[u] += w;
          float v[CV * 4];
#pragma unroll
          for (int k = 0; k < CV; ++k) {
            const float4 t = vt[i * CV + k];
            v[4 * k] = t.x;
            v[4 * k + 1] = t.y;
            v[4 * k + 2] = t.z;
            v[4 * k + 3] = t.w;
          }
#pragma unroll
          for (int j = 0; j < NC; ++j) num[u][j] = fmaf(w, v[j], num[u][j]);
        }
      }
    }
  }

  float* pb = partial + ((size_t)s * B + b) * Nq * (NC + 1);
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = q0 + u * threads;
    if (qi >= Nq) continue;
    float* p = pb + (size_t)qi * (NC + 1);
#pragma unroll
    for (int j = 0; j < NC; ++j) p[j] = num[u][j];
    p[NC] = den[u];
  }
}

// partial [splits, B * Nq, C + 1] -> out [B * Nq, C], den [B * Nq]: the
// splits' sums added in split order.
template <int NC>
__global__ void interp_finish(const float* __restrict__ partial,
                              float* __restrict__ out,
                              float* __restrict__ den_out, size_t n,
                              int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float num[NC], den;
  const float* p = partial + i * (NC + 1);
#pragma unroll
  for (int j = 0; j < NC; ++j) num[j] = p[j];
  den = p[NC];
  for (int s = 1; s < splits; ++s) {
    p += n * (NC + 1);
#pragma unroll
    for (int j = 0; j < NC; ++j) num[j] += p[j];
    den += p[NC];
  }
  den += 1e-6f;
#pragma unroll
  for (int j = 0; j < NC; ++j) out[i * NC + j] = num[j] / den;
  den_out[i] = den;
}

struct Args {
  const float *q, *c, *v, *bias;
  float *partial, *out, *den;
  int B, Nq, M, threads, splits, span;
  float d2_max, inv_c2, k1, k2;
  int kind;
  cudaStream_t st;
};

template <int NC>
void launch(const Args& a) {
  const int q_blocks = (a.Nq + a.threads * QPT - 1) / (a.threads * QPT);
  const unsigned grid = (unsigned)((size_t)a.B * a.splits * q_blocks);
  interp_split_kernel<NC><<<grid, a.threads, 0, a.st>>>(
      a.q, a.c, a.v, a.bias, a.partial, a.B, a.Nq, a.M, q_blocks, a.splits,
      a.span, a.d2_max, a.inv_c2, a.k1, a.k2, a.kind);
  const size_t n = (size_t)a.B * a.Nq;
  interp_finish<NC><<<(unsigned)((n + 255) / 256), 256, 0, a.st>>>(
      a.partial, a.out, a.den, n, a.splits);
}

}  // namespace

// Shapes the wrapper (ops/kernels/interp.py : InterpPlan.admits) admits:
// B, Nq, M >= 1; 1 <= C <= 8; threads a multiple of 32 up to 256; every
// split holding at least one candidate; partial holds splits * B * Nq *
// (C + 1) floats; all tensors contiguous on one device.
extern "C" int interp_f32(const void* query, const void* cand,
                          const void* values, const void* bias, void* partial,
                          void* out, void* den, int B, int Nq, int M, int C,
                          int threads, int splits, int span,
                          float d2_max, float inv_c2, float k1, float k2,
                          int kind, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || C < 1 || C > MAX_C || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || splits < 1 || span < 1 ||
      (long long)(splits - 1) * span >= M || (long long)splits * span < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(query), static_cast<const float*>(cand),
               static_cast<const float*>(values), static_cast<const float*>(bias),
               static_cast<float*>(partial), static_cast<float*>(out),
               static_cast<float*>(den), B, Nq, M, threads, splits, span,
               d2_max, inv_c2, k1, k2, kind, static_cast<cudaStream_t>(stream)};
  switch (C) {
    case 1: launch<1>(a); break;
    case 2: launch<2>(a); break;
    case 3: launch<3>(a); break;
    case 4: launch<4>(a); break;
    case 5: launch<5>(a); break;
    case 6: launch<6>(a); break;
    case 7: launch<7>(a); break;
    case 8: launch<8>(a); break;
  }
  return static_cast<int>(cudaGetLastError());
}
