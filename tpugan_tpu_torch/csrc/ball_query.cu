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
// Nq x Nc, are the work (chip_smoke.py counts them for the bound): about 8
// f32 operations a pair, a few microseconds at any train stage. A kernel
// that reads each candidate from device memory on the query's own
// dependent trip (one warp a query, 32 candidates a trip) pays the memory
// latency trip after trip instead.
//
// Design.
// - A block owns WARPS = 8 queries of one batch row, one a warp.
// - Candidate tiles of TILE = 4 x 256 points are staged in shared memory as
//   float4 (x, y, z, |c|^2), |c|^2 by the dot3 of the test so the bits are
//   the same, and +inf for a masked candidate (bias >= 1, or NaN) and for
//   the rows past Nc: d2 = (|q|^2 + inf) - 2 q.c is then +inf or NaN, never
//   below r2, so the mask costs no test of its own. Two tile buffers: the
//   next tile's values are read into registers while this tile is
//   scanned, so their latency hides behind the scan and one barrier a tile
//   suffices.
// - A warp's trip: 4 chunks of 32 candidates, 4 independent float4 loads,
//   one ballot a chunk; __popc of the lanes below a lane gives its slot, so
//   hits land in index order without a sort. count < ns is tested once a
//   trip and slot < ns guards the writes inside it.
// - A warp stops scanning when its ball is full, and the block leaves the
//   tile loop when all its warps have (__syncthreads_or).
// - 8 warps a block: at every train stage the fastest block shape, or
//   within 1.1% of it, of 1 to 8 warps and 1, 2 or 4 queries a warp (a
//   sweep on an H100 SXM, PERF.md); grids of 64 to 512 blocks.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;                               // queries a block
constexpr int THREADS = 32 * WARPS;
constexpr int PER_THREAD = 4;                          // points a thread stages
constexpr int TILE = PER_THREAD * THREADS;             // a multiple of 32 UNROLL
constexpr int UNROLL = 4;                              // chunks of 32 a trip

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
  __shared__ __align__(16) float4 tiles[2][TILE];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int qi = blockIdx.x * WARPS + (tid >> 5);
  const bool live = qi < Nq;
  const float* cb = cand + (size_t)b * Nc * 3;
  const float* vb = bias + (size_t)b * Nc;
  long long* o = out + ((size_t)b * Nq + qi) * ns;
  unsigned below = (1u << lane) - 1u;  // the lanes under this one
  // opaque to the compiler, so held in registers: it would recompute both
  // at every chunk with a hit instead (7% of the device time, PERF.md)
  asm("" : "+l"(o), "+r"(below));

  const float* qr = query + ((size_t)b * Nq + (live ? qi : 0)) * 3;
  const float qx = live ? qr[0] : 0.f, qy = live ? qr[1] : 0.f, qz = live ? qr[2] : 0.f;
  const float q2 = dot3(qx, qy, qz, qx, qy, qz);
  int count = live ? 0 : ns;  // a warp past Nq counts as a full ball
  int first = -1;

  // the next tile's points, in registers until its buffer is free
  float rx[PER_THREAD], ry[PER_THREAD], rz[PER_THREAD];
  bool ok[PER_THREAD];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int c = t0 + tid + j * THREADS;
      ok[j] = c < Nc && __ldg(vb + c) < 1.f;
      rx[j] = c < Nc ? __ldg(cb + 3 * c) : 0.f;
      ry[j] = c < Nc ? __ldg(cb + 3 * c + 1) : 0.f;
      rz[j] = c < Nc ? __ldg(cb + 3 * c + 2) : 0.f;
    }
  };
  auto store = [&](float4* dst) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      dst[tid + j * THREADS] = make_float4(
          rx[j], ry[j], rz[j],
          ok[j] ? dot3(rx[j], ry[j], rz[j], rx[j], ry[j], rz[j]) : CUDART_INF_F);
  };

  load(0);
  store(tiles[0]);
  if (TILE < Nc) load(TILE);
  __syncthreads();
  for (int t0 = 0, it = 0;; t0 += TILE, ++it) {
    const float4* ts = tiles[it & 1];
    const int span = min(TILE, Nc - t0);
    for (int c0 = 0; c0 < span && count < ns; c0 += 32 * UNROLL) {  // warp-uniform
      float4 v[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) v[j] = ts[c0 + 32 * j + lane];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const float d2 = __fsub_rn(__fadd_rn(q2, v[j].w),
                                   __fmul_rn(2.f, dot3(qx, qy, qz, v[j].x, v[j].y, v[j].z)));
        const bool hit = d2 < r2;
        const unsigned mask = __ballot_sync(FULL, hit);
        if (mask == 0u) continue;
        const int c = t0 + c0 + 32 * j;
        if (count == 0) first = c + __ffs(mask) - 1;
        const int slot = count + __popc(mask & below);
        if (hit && slot < ns) o[slot] = c + lane;
        count += __popc(mask);
      }
    }
    if (t0 + TILE >= Nc) break;
    store(tiles[(it + 1) & 1]);  // its buffer was last read before the barrier
    if (t0 + 2 * TILE < Nc) load(t0 + 2 * TILE);
    if (!__syncthreads_or(count < ns)) break;  // every ball of the block is full
  }

  if (!live) return;
  const long long pad = first < 0 ? 0 : first;
  for (int s = min(count, ns) + lane; s < ns; s += 32) o[s] = pad;
}

}  // namespace

// Shapes the wrapper (ops/kernels/ball_query.py) admits: Nq >= 1, Nc >= 1,
// ns >= 1, B <= 65535, all tensors contiguous on one device.
extern "C" int ball_query_f32(const void* query, const void* cand,
                              const void* bias, void* idx, int B, int Nq,
                              int Nc, int ns, float r2, void* stream) {
  if (Nq < 1 || Nc < 1 || ns < 1 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Nq + WARPS - 1) / WARPS, B);
  ball_query_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(cand),
      static_cast<const float*>(bias), static_cast<long long*>(idx), Nq, Nc,
      ns, r2);
  return static_cast<int>(cudaGetLastError());
}
