// Ball query in candidate-index order (pointnet2 semantics).
//
// Replaces tpugan_tpu/ops/pallas/ball_query_kernel.py : ball_query_pallas
// (_ball_kernel).
//
// Contract: query [B,Nq,3] f32, cand [B,Nc,3] f32, bias [B,Nc] f32 (0 valid,
// >= 1 invalid), r2 = radius^2 -> idx [B,Nq,ns] int64: the first ns
// candidates in index order with
//   d2 = (|q|^2 + |c|^2) - 2 q.c < r2   and   bias < 1,
// the squares and the dot product summed as (x + y) + z in round-to-
// nearest f32 with no fused multiply-add (the plain version's order);
// slots past the hits repeat the first hit, or hold 0 when the ball is
// empty.
//
// What bounds it on the H100: operations, and the early exit makes them
// depend on the data. A query scans candidates until it has ns hits; the
// spatial critic's first stage (4 x 1,024 queries over 9,216 candidates,
// r 0.15) stops after a fraction of the cloud, so the scanned pairs, not
// Nq x Nc, are the work (chip_smoke.py counts them for the bound).
//
// Design: one warp per query, eight queries per block. The warp reads 32
// consecutive candidates at a time (coalesced), each lane tests one;
// __ballot_sync gives the hit mask, __popc of the lanes below a lane gives
// its slot, so hits land in index order without a sort. The warp stops
// as soon as ns slots are filled.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(THREADS)
ball_query_kernel(const float* __restrict__ query,
                  const float* __restrict__ cand,
                  const float* __restrict__ bias, long long* __restrict__ out,
                  int Nq, int Nc, int ns, float r2) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (qi >= Nq) return;                     // the whole warp leaves together

  const float* qr = query + ((size_t)b * Nq + qi) * 3;
  const float qx = qr[0], qy = qr[1], qz = qr[2];
  const float q2 = dot3(qx, qy, qz, qx, qy, qz);
  const float* cb = cand + (size_t)b * Nc * 3;
  const float* vb = bias + (size_t)b * Nc;
  long long* o = out + ((size_t)b * Nq + qi) * ns;

  int count = 0;
  int first = -1;
  for (int c0 = 0; c0 < Nc && count < ns; c0 += 32) {
    const int c = c0 + lane;
    bool hit = false;
    if (c < Nc) {
      const float cx = cb[3 * c], cy = cb[3 * c + 1], cz = cb[3 * c + 2];
      const float d2 = __fsub_rn(__fadd_rn(q2, dot3(cx, cy, cz, cx, cy, cz)),
                                 __fmul_rn(2.f, dot3(qx, qy, qz, cx, cy, cz)));
      hit = d2 < r2 && vb[c] < 1.f;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0u) continue;
    if (first < 0) first = c0 + __ffs(mask) - 1;
    const int slot = count + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < ns) o[slot] = c;
    count += __popc(mask);
  }
  const long long pad = first < 0 ? 0 : first;
  for (int s = min(count, ns) + lane; s < ns; s += 32) o[s] = pad;
}

}  // namespace

// Shapes the wrapper (ops/kernels/ball_query.py) admits: Nq >= 1, Nc >= 1,
// ns >= 1, all tensors contiguous on one device.
extern "C" int ball_query_f32(const void* query, const void* cand,
                              const void* bias, void* idx, int B, int Nq,
                              int Nc, int ns, float r2, void* stream) {
  const dim3 grid((Nq + WARPS - 1) / WARPS, B);
  ball_query_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(cand),
      static_cast<const float*>(bias), static_cast<long long*>(idx), Nq, Nc,
      ns, r2);
  return static_cast<int>(cudaGetLastError());
}
