// Exact k-nearest-neighbour search.
//
// Replaces tpugan_tpu/ops/pallas/knn_kernel.py : knn_pallas (the plain peel
// _knn_kernel_plain and the chunked fold-peel _knn_chunked_kernel).
//
// Contract: query [B,Nq,D] f32, cand [B,Nc,D] f32, bias [B,Nc] f32 (0 for a
// valid candidate, 1e10 for an invalid one), k <= Nc
//   -> d2 [B,Nq,k] f32 ascending, idx [B,Nq,k] int64, with
//      d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) + bias
// (the formula of the TPU kernel's _compute_d2 and of pairwise_sqdist), and
// equal distances ordered by lower candidate index, as a stable argsort.
//
// What bounds it on the H100: operations. A call does Nq*Nc*(2D+3) f32
// operations plus one compare per pair, against inputs and outputs of a few
// MB (N=10240, D=64, k=20: 13.7 GFLOP against 5.6 MB), so the f32 rate of
// the SMs, not memory, is the limit.
//
// Design: no [Nq, Nc] distance block exists anywhere, so the TPU kernel's
// 24,576-candidate cap is gone. A block owns 32 queries (one per lane of
// each warp) and has 8 warps. Candidate tiles of 128 stream through shared
// memory; warp w scores candidates w*16 .. w*16+15 of every tile, so the 8
// warps split the candidate set and a 10,240-point cloud keeps 2,560 warps
// in flight where one thread per query would give 320. Each thread keeps a
// sorted top-K list in registers (K = k rounded up to a compiled bucket:
// 4, 8, 12, 16, 20, 32, and 64 for D <= 4;
// one compare-and-swap pass per accepted candidate, strict < so that an
// equal distance stays behind the lower index it met first). Query vectors
// live in registers, zero-padded to a power of two DP; the candidate row is
// read from shared memory as float4 broadcasts. At the end the 8 partial
// lists of a query are merged into warp 0's list by (d2, index), which
// restores the lower-index rule across warps.
#include "common.cuh"

namespace {

constexpr int QB = 32;                  // queries per block (one per lane)
constexpr int WARPS = 8;
constexpr int THREADS = QB * WARPS;
constexpr int TILE = 128;               // candidates per shared-memory tile
constexpr int PER_WARP = TILE / WARPS;  // candidates of a tile per warp

template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int i) {
  // candidates arrive in ascending index order: strict < keeps ties stable
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (d < bd[s]) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

template <int K>
__device__ __forceinline__ void insert_lex(float (&bd)[K], int (&bi)[K],
                                          float d, int i) {
  // merge of lists from other warps: order by (distance, index)
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (d < bd[s] || (d == bd[s] && i < bi[s])) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = d;
      bi[s] = i;
      d = td;
      i = ti;
    }
  }
}

template <int DP, int K>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const float* __restrict__ query, const float* __restrict__ cand,
           const float* __restrict__ bias, float* __restrict__ out_d,
           long long* __restrict__ out_i, int Nq, int Nc, int D, int k) {
  __shared__ __align__(16) float tile[TILE * DP];
  __shared__ float c2s[TILE];
  __shared__ float bs[TILE];
  __shared__ float md[K * QB];
  __shared__ int mi[K * QB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * QB + lane;
  const bool qvalid = qi < Nq;

  float qv[DP];
  float q2 = 0.f;
  const float* qrow = query + ((size_t)b * Nq + (qvalid ? qi : 0)) * D;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qv[d] = (qvalid && d < D) ? __ldg(qrow + d) : 0.f;
    q2 = fmaf(qv[d], qv[d], q2);
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0x7fffffff;
  }

  const float* cb = cand + (size_t)b * Nc * D;
  const float* vb = bias + (size_t)b * Nc;
  for (int t0 = 0; t0 < Nc; t0 += TILE) {
    const int nt = min(TILE, Nc - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < TILE * DP; e += THREADS) {
      const int ci = e / DP;
      const int d = e - ci * DP;
      tile[e] = (ci < nt && d < D) ? __ldg(cb + (size_t)(t0 + ci) * D + d) : 0.f;
    }
    __syncthreads();
    // |c|^2 of the warp's own 16 candidates: lanes stride over the row
    // (conflict-free) and the warp sums with shuffles
    for (int j = 0; j < PER_WARP; ++j) {
      const int ci = warp * PER_WARP + j;
      float s = 0.f;
      for (int d = lane; d < DP; d += 32) s = fmaf(tile[ci * DP + d], tile[ci * DP + d], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        // padding past Nc scores +inf and is never accepted
        c2s[ci] = ci < nt ? s : CUDART_INF_F;
        bs[ci] = ci < nt ? __ldg(vb + t0 + ci) : 0.f;
      }
    }
    __syncwarp();  // each warp reads only the c2s / bs entries it wrote
    if (qvalid) {
#pragma unroll 4
      for (int j = 0; j < PER_WARP; ++j) {
        const int ci = warp * PER_WARP + j;
        const float4* row = reinterpret_cast<const float4*>(tile + ci * DP);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DP / 4; ++d4) {
          const float4 v = row[d4];
          a0 = fmaf(qv[4 * d4 + 0], v.x, a0);
          a1 = fmaf(qv[4 * d4 + 1], v.y, a1);
          a2 = fmaf(qv[4 * d4 + 2], v.z, a2);
          a3 = fmaf(qv[4 * d4 + 3], v.w, a3);
        }
        const float dot = (a0 + a1) + (a2 + a3);
        const float dd = fmaxf(q2 + c2s[ci] - 2.f * dot, 0.f) + bs[ci];
        if (dd < bd[K - 1]) insert_sorted<K>(bd, bi, dd, t0 + ci);
      }
    }
  }

  // merge the other warps' lists into warp 0's, one warp at a time
  for (int w = 1; w < WARPS; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        md[s * QB + lane] = bd[s];
        mi[s * QB + lane] = bi[s];
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int s = 0; s < K; ++s) {
        const float d = md[s * QB + lane];
        const int i = mi[s * QB + lane];
        if (d > bd[K - 1]) break;  // the list is sorted: nothing later fits
        insert_lex<K>(bd, bi, d, i);
      }
    }
  }
  if (warp == 0 && qvalid) {
    float* od = out_d + ((size_t)b * Nq + qi) * k;
    long long* oi = out_i + ((size_t)b * Nq + qi) * k;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        od[s] = bd[s];
        oi[s] = bi[s];
      }
    }
  }
}

template <int DP, int K>
int launch(const float* q, const float* c, const float* bias, float* d2,
           long long* idx, int B, int Nq, int Nc, int D, int k,
           cudaStream_t stream) {
  const dim3 grid((Nq + QB - 1) / QB, B);
  knn_kernel<DP, K><<<grid, THREADS, 0, stream>>>(q, c, bias, d2, idx, Nq, Nc, D, k);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dispatch_k(const float* q, const float* c, const float* bias, float* d2,
               long long* idx, int B, int Nq, int Nc, int D, int k,
               cudaStream_t s) {
  if (k <= 4) return launch<DP, 4>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  if (k <= 8) return launch<DP, 8>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  if (k <= 12) return launch<DP, 12>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  if (k <= 16) return launch<DP, 16>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  if (k <= 20) return launch<DP, 20>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  if (k <= 32) return launch<DP, 32>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  // k = 64 (the capped particle density's radius kNN) only for points
  // (D <= 4): 128 registers of list beside a 4-wide query vector
  if constexpr (DP == 4) {
    if (k <= 64) return launch<DP, 64>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shapes the wrapper (ops/kernels/knn.py) admits: D <= 64, 1 <= k <= 32
// (k <= 64 for D <= 4), k <= Nc, all tensors contiguous on one device.
extern "C" int knn_f32(const void* query, const void* cand, const void* bias,
                       void* d2, void* idx, int B, int Nq, int Nc, int D,
                       int k, void* stream) {
  const auto* q = static_cast<const float*>(query);
  const auto* c = static_cast<const float*>(cand);
  const auto* v = static_cast<const float*>(bias);
  auto* od = static_cast<float*>(d2);
  auto* oi = static_cast<long long*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 4) return dispatch_k<4>(q, c, v, od, oi, B, Nq, Nc, D, k, s);
  if (D <= 8) return dispatch_k<8>(q, c, v, od, oi, B, Nq, Nc, D, k, s);
  if (D <= 16) return dispatch_k<16>(q, c, v, od, oi, B, Nq, Nc, D, k, s);
  if (D <= 32) return dispatch_k<32>(q, c, v, od, oi, B, Nq, Nc, D, k, s);
  if (D <= 64) return dispatch_k<64>(q, c, v, od, oi, B, Nq, Nc, D, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
