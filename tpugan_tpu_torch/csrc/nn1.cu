// Streaming single nearest neighbour (the Chamfer backbone).
//
// Replaces tpugan_tpu/ops/pallas/nn1_kernel.py : nn1_pallas (_nn1_kernel).
//
// Contract: query [B,Nq,3] f32, cand [B,M,3] f32, bias [B,M] f32 (0 valid,
// 1e10 invalid) -> d2 [B,Nq] f32, idx [B,Nq] int64, where
//   d2 = min_c max(|q|^2 + |c|^2 - 2 q.c, 0) + bias[c]
// and idx is the lowest index that attains it.
//
// What bounds it on the H100: operations. Every (query, candidate) pair
// costs about ten f32 operations and the inputs are a few MB (81,920 x
// 81,920 is 6.7e9 pairs against 2.6 MB), so the SMs' f32 rate is the limit.
//
// Design: the distance matrix exists nowhere, in device memory or in shared
// memory; this also removes the TPU kernel's 1,048,576-candidate cap. A
// thread owns two queries (two independent dependency chains per candidate
// read), a block 512 queries. Candidate tiles of 1024 stream through shared
// memory as (x, y, z, |c|^2) float4 rows that every lane reads as a
// broadcast. Each thread keeps a running (min, argmin) and scans candidates
// in ascending index order with strict <, so ties keep the lower index.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QPT = 2;                    // queries per thread
constexpr int QB = THREADS * QPT;         // queries per block
constexpr int TILE = 1024;                // candidates per shared-memory tile

__global__ void __launch_bounds__(THREADS)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ cand,
           const float* __restrict__ bias, float* __restrict__ out_d,
           long long* __restrict__ out_i, int Nq, int M) {
  __shared__ float4 ct[TILE];
  __shared__ float bs[TILE];

  const int b = blockIdx.y;
  float qx[QPT], qy[QPT], qz[QPT], q2[QPT], best[QPT];
  int arg[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = blockIdx.x * QB + u * THREADS + threadIdx.x;
    const float* qr = query + ((size_t)b * Nq + min(qi, Nq - 1)) * 3;
    qx[u] = __ldg(qr);
    qy[u] = __ldg(qr + 1);
    qz[u] = __ldg(qr + 2);
    q2[u] = qx[u] * qx[u] + qy[u] * qy[u] + qz[u] * qz[u];
    best[u] = CUDART_INF_F;
    arg[u] = 0;
  }

  const float* cb = cand + (size_t)b * M * 3;
  const float* vb = bias + (size_t)b * M;
  for (int t0 = 0; t0 < M; t0 += TILE) {
    const int nt = min(TILE, M - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int ci = threadIdx.x; ci < TILE; ci += THREADS) {
      if (ci < nt) {
        const float* cr = cb + (size_t)(t0 + ci) * 3;
        const float x = __ldg(cr), y = __ldg(cr + 1), z = __ldg(cr + 2);
        ct[ci] = make_float4(x, y, z, x * x + y * y + z * z);
        bs[ci] = __ldg(vb + t0 + ci);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int ci = 0; ci < nt; ++ci) {
      const float4 c = ct[ci];
      const float v = bs[ci];
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        const float dot = fmaf(qx[u], c.x, fmaf(qy[u], c.y, qz[u] * c.z));
        const float d = fmaxf(q2[u] + c.w - 2.f * dot, 0.f) + v;
        if (d < best[u]) {
          best[u] = d;
          arg[u] = t0 + ci;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = blockIdx.x * QB + u * THREADS + threadIdx.x;
    if (qi < Nq) {
      out_d[(size_t)b * Nq + qi] = best[u];
      out_i[(size_t)b * Nq + qi] = arg[u];
    }
  }
}

}  // namespace

// Shapes the wrapper (ops/kernels/nn1.py) admits: Nq >= 1, M >= 1, all
// tensors contiguous on one device.
extern "C" int nn1_f32(const void* query, const void* cand, const void* bias,
                       void* d2, void* idx, int B, int Nq, int M,
                       void* stream) {
  const dim3 grid((Nq + QB - 1) / QB, B);
  nn1_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(cand),
      static_cast<const float*>(bias), static_cast<float*>(d2),
      static_cast<long long*>(idx), Nq, M);
  return static_cast<int>(cudaGetLastError());
}
