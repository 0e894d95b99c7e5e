// Streaming single nearest neighbour (the Chamfer backbone).
//
// Replaces tpugan_tpu/ops/pallas/nn1_kernel.py : nn1_pallas (_nn1_kernel).
//
// Contract: query [B,Nq,3] f32, cand [B,M,3] f32, bias [B,M] f32 (0 valid,
// 1e10 invalid) -> d2 [B,Nq] f32, idx [B,Nq] int64, where
//   d2 = min_c max(|q|^2 + |c|^2 - 2 q.c, 0) + bias[c]
// and idx is the lowest index that attains it.
//
// What bounds it on the H100: operations. The least work of a pair is three
// FMAs and a min, 7 flops (81,920 x 81,920 is 6.7e9 pairs against 2.6 MB),
// so the SMs' f32 issue rate is the limit.
//
// Design (ops/kernels/nn1.py : nn1_plan picks the shape):
// - Candidate splits. Block (b, s, g) takes the queries of block g of row b
//   against the candidates [s * span, (s + 1) * span), so that rows of 9,216
//   queries fill the card. The splits merge through a 64-bit atomicMin on
//   (order bits of d2) << 32 | index, set to all ones before the launch:
//   the least d2 and, on a tie, the lowest index, in any order of arrival.
// - Register tiles. A thread owns QPT = 4 queries (4 beat 8 on the card),
//   query g * QB + u * threads + t for slot u. A candidate is stored once a tile as (-2x, -2y, -2z,
//   |c|^2 + bias), so one broadcast LDS.128 serves QPT queries and a pair is
//   three FMAs (pair_value) and one fminf; |q|^2 is not needed to rank.
// - Argmin per chunk of CHUNK candidates, not per pair. A query whose
//   running minimum fell strictly inside a chunk notes that chunk. At the
//   end the thread rescans it (through the same cand_row and pair_value,
//   so the values are bit for bit those of the main pass) for the lowest
//   index that attains the minimum: an earlier chunk holding the same
//   value would have kept the minimum from falling. A chunk of the last
//   tile is read back from shared memory, where the rows of a split no
//   longer than a tile all stay. A query whose minimum never fell below
//   +inf (a NaN coordinate makes every pair NaN, which fminf passes over)
//   takes the split's first candidate, so every index lies in [0, M).
// - The output is the winner's d2 by the contract's formula (winner_d2),
//   NaN for a NaN query as in the plain version.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int CHUNK = 32;     // candidates between two argmin records
constexpr int TILE = 1024;    // candidates a shared-memory tile (16 KB)
constexpr int RESCAN = 8;     // rows a step of the rescan
constexpr int QPT = 4;        // queries a thread

// (-2x, -2y, -2z, |c|^2 + bias): every operation rounded on its own, so the
// main pass and the rescan form the same row.
__device__ __forceinline__ float4 cand_row(const float* c, float bias) {
  const float x = __ldg(c), y = __ldg(c + 1), z = __ldg(c + 2);
  const float c2 = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
  return make_float4(__fmul_rn(-2.f, x), __fmul_rn(-2.f, y),
                     __fmul_rn(-2.f, z), __fadd_rn(c2, bias));
}

// |c|^2 + bias - 2 q.c, the pair's rank (d2 less |q|^2, before the clamp).
__device__ __forceinline__ float pair_value(float qx, float qy, float qz,
                                            float4 c) {
  return __fmaf_rn(c.x, qx, __fmaf_rn(c.y, qy, __fmaf_rn(c.z, qz, c.w)));
}

// max(|q|^2 + |c|^2 - 2 q.c, 0) + bias of one pair; a NaN stays NaN.
__device__ __forceinline__ float winner_d2(float qx, float qy, float qz,
                                           const float* c, float bias) {
  const float x = __ldg(c), y = __ldg(c + 1), z = __ldg(c + 2);
  const float q2 = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, __fmul_rn(qx, qx)));
  const float c2 = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
  const float dot = __fmaf_rn(qx, x, __fmaf_rn(qy, y, __fmul_rn(qz, z)));
  const float d = __fmaf_rn(-2.f, dot, __fadd_rn(q2, c2));
  return __fadd_rn(d < 0.f ? 0.f : d, bias);
}

// Unsigned key whose order is (d2, index)'s: the float's order bits above
// the index; a NaN after every number.
__device__ __forceinline__ unsigned long long merge_key(float d, int idx) {
  unsigned int bits = __float_as_uint(d);
  bits = isnan(d) ? 0xffffffffu
                  : (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return (static_cast<unsigned long long>(bits) << 32) |
         static_cast<unsigned int>(idx);
}

__global__ void __launch_bounds__(MAX_THREADS)
nn1_split_kernel(const float* __restrict__ query,
                 const float* __restrict__ cand,
                 const float* __restrict__ bias,
                 unsigned long long* __restrict__ keys, int Nq, int M,
                 int q_blocks, int splits, int span) {
  __shared__ float4 ct[TILE];

  const int threads = blockDim.x;
  const int g = blockIdx.x % q_blocks;
  const int s = (blockIdx.x / q_blocks) % splits;
  const int b = blockIdx.x / (q_blocks * splits);
  const int c_begin = s * span, c_end = min(M, c_begin + span);
  const int q0 = g * threads * QPT + threadIdx.x;

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int chunk[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const float* qr = query + ((size_t)b * Nq + min(q0 + u * threads, Nq - 1)) * 3;
    qx[u] = __ldg(qr);
    qy[u] = __ldg(qr + 1);
    qz[u] = __ldg(qr + 2);
    best[u] = CUDART_INF_F;
    chunk[u] = -1;
  }

  const float* cb = cand + (size_t)b * M * 3;
  const float* vb = bias + (size_t)b * M;
  for (int t0 = c_begin; t0 < c_end; t0 += TILE) {
    const int nt = min(TILE, c_end - t0);
    const int padded = (nt + CHUNK - 1) / CHUNK * CHUNK;
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < padded; i += threads)
      ct[i] = i < nt ? cand_row(cb + (size_t)(t0 + i) * 3, __ldg(vb + t0 + i))
                     : make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    __syncthreads();
    for (int c0 = 0; c0 < padded; c0 += CHUNK) {
      float before[QPT];
#pragma unroll
      for (int u = 0; u < QPT; ++u) before[u] = best[u];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float4 c = ct[c0 + j];
#pragma unroll
        for (int u = 0; u < QPT; ++u)
          best[u] = fminf(best[u], pair_value(qx[u], qy[u], qz[u], c));
      }
#pragma unroll
      for (int u = 0; u < QPT; ++u)
        if (best[u] < before[u]) chunk[u] = t0 + c0;
    }
  }

  // The last tile is still in shared memory: a chunk there is rescanned
  // from it, an earlier one from device memory; RESCAN rows at a time, with
  // independent loads, the first equal value winning.
  const int last = c_begin + (c_end - 1 - c_begin) / TILE * TILE;
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = q0 + u * threads;
    if (qi >= Nq) continue;
    const bool resident = chunk[u] >= last;
    int win = chunk[u] < 0 ? c_begin : -1;
    for (int j0 = 0; j0 < CHUNK && win < 0; j0 += RESCAN) {
#pragma unroll
      for (int j = RESCAN - 1; j >= 0; --j) {
        const int ci = chunk[u] + j0 + j;
        if (ci >= c_end) continue;
        const float4 c = resident ? ct[ci - last]
                                  : cand_row(cb + (size_t)ci * 3, __ldg(vb + ci));
        if (pair_value(qx[u], qy[u], qz[u], c) == best[u]) win = ci;
      }
    }
    const float d = winner_d2(qx[u], qy[u], qz[u], cb + (size_t)win * 3,
                              __ldg(vb + win));
    atomicMin(keys + (size_t)b * Nq + qi, merge_key(d, win));
  }
}

// keys (the int64 index output) -> d2 and index, in place.
__global__ void nn1_finish(unsigned long long* __restrict__ keys,
                           float* __restrict__ out_d, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  unsigned int bits = static_cast<unsigned int>(key >> 32);
  bits = (bits & 0x80000000u) ? (bits & 0x7fffffffu) : ~bits;
  out_d[i] = __uint_as_float(bits);
  keys[i] = key & 0xffffffffull;
}

}  // namespace

// Shapes the wrapper (ops/kernels/nn1.py : Nn1Plan.admits) admits: B, Nq,
// M >= 1; threads a multiple of 32 up to 256; span a multiple of CHUNK, every split holding at least one candidate; all
// tensors contiguous on one device.
extern "C" int nn1_f32(const void* query, const void* cand, const void* bias,
                       void* d2, void* idx, int B, int Nq, int M, int threads,
                       int splits, int span, void* stream) {
  if (B < 1 || Nq < 1 || M < 1 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 || splits < 1 || span < 1 || span % CHUNK ||
      (long long)(splits - 1) * span >= M || (long long)splits * span < M)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(query);
  const auto* c = static_cast<const float*>(cand);
  const auto* v = static_cast<const float*>(bias);
  auto* keys = static_cast<unsigned long long*>(idx);
  const size_t n = (size_t)B * Nq;
  cudaMemsetAsync(keys, 0xff, n * sizeof(unsigned long long), st);
  const int q_blocks = (Nq + threads * QPT - 1) / (threads * QPT);
  nn1_split_kernel<<<(unsigned)((size_t)B * splits * q_blocks), threads, 0,
                     st>>>(q, c, v, keys, Nq, M, q_blocks, splits, span);
  nn1_finish<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      keys, static_cast<float*>(d2), n);
  return static_cast<int>(cudaGetLastError());
}
