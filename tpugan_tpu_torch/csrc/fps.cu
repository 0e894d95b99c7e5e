// Farthest point sampling over a padded batch.
//
// Replaces tpugan_tpu/ops/pallas/fps_kernel.py : fps_pallas and
// fps_pallas_batched (_fps_kernel, _fps_batched_kernel).
//
// Contract: pos [B,N,3] f32, penalty [B,N] f32 (0 valid, -1e10 invalid),
// start [B] int64 -> idx [B,m] int64. idx[:,0] = start; then each round
//   mind = min(mind, |p - p_sel|^2 + penalty)   (mind starts at the start's)
//   next = argmax(mind), the lowest index on a tie.
// The distance is the direct difference ((dx*dx + dy*dy) + dz*dz) in round-
// to-nearest f32 with no fused multiply-add, the order of the JAX package's
// fps (neighbors.py) and of the plain version, so the selections agree
// index for index.
//
// What bounds it on the H100: neither bytes nor operations but latency. The
// m rounds are sequential, each a pass over N points and a block-wide
// argmax with two barriers, and only one block per row runs: B to 3B
// blocks (4 to 12 here) of the card's 132 SMs. The train step's largest
// call (12 rows, 9,216 -> 1,024) does 113 M distance updates, about 10 us
// of the f32 rate, and takes far longer. Spreading a row over a cluster
// of blocks, or running several rows per SM, is later work.
//
// Design: one block of 1024 threads per row. The row's points sit in
// shared memory as (x, y, z, penalty) float4 (9,216 points are 147 KB);
// thread t owns points t, t + 1024, ... and keeps their mind in registers.
// A round is a per-thread argmax over its points (ascending index, strict
// >, so a tie keeps the lowest), a warp butterfly of (value, index) pairs,
// and one warp's butterfly over the 32 warp winners.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float sqdist3(float4 p, float sx, float sy, float sz) {
  const float dx = __fsub_rn(p.x, sx), dy = __fsub_rn(p.y, sy),
              dz = __fsub_rn(p.z, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) <- the larger value of the two, the lower index on a tie
__device__ __forceinline__ void keep_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    keep_max(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ pos, const float* __restrict__ penalty,
           const long long* __restrict__ start, long long* __restrict__ out,
           int N, int m) {
  extern __shared__ float4 pts[];          // [N] (x, y, z, penalty)
  __shared__ float wv[WARPS];
  __shared__ int wi[WARPS];
  __shared__ int sel;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* pb = pos + (size_t)b * N * 3;
  const float* qb = penalty + (size_t)b * N;
  long long* ob = out + (size_t)b * m;

  for (int i = t; i < N; i += THREADS)
    pts[i] = make_float4(pb[3 * i], pb[3 * i + 1], pb[3 * i + 2], qb[i]);
  if (t == 0) {
    sel = (int)start[b];
    ob[0] = sel;
  }
  __syncthreads();

  float mind[PPT];
  {
    const float4 s = pts[sel];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = t + k * THREADS;
      mind[k] = i < N ? __fadd_rn(sqdist3(pts[i], s.x, s.y, s.z), pts[i].w)
                      : -CUDART_INF_F;     // never the argmax
    }
  }

  for (int r = 1; r < m; ++r) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (mind[k] > bv) {
        bv = mind[k];
        bi = t + k * THREADS;
      }
    }
    warp_argmax(bv, bi);
    if ((t & 31) == 0) {
      wv[t >> 5] = bv;
      wi[t >> 5] = bi;
    }
    __syncthreads();
    if (t < 32) {
      bv = wv[t];
      bi = wi[t];
      warp_argmax(bv, bi);
      if (t == 0) {
        sel = bi;
        ob[r] = bi;
      }
    }
    __syncthreads();
    const float4 s = pts[sel];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = t + k * THREADS;
      if (i < N)
        mind[k] = fminf(mind[k],
                        __fadd_rn(sqdist3(pts[i], s.x, s.y, s.z), pts[i].w));
    }
  }
}

template <int PPT>
cudaError_t launch(const float* pos, const float* penalty,
                   const long long* start, long long* out, int B, int N,
                   int m, cudaStream_t stream) {
  const size_t smem = (size_t)N * sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  fps_kernel<PPT><<<B, THREADS, smem, stream>>>(pos, penalty, start, out, N, m);
  return cudaGetLastError();
}

}  // namespace

// Points a row may hold: shared memory (227 KB) less the kernel's statics.
extern "C" int fps_max_points() { return 14336; }

// Shapes the wrapper (ops/kernels/fps.py) admits: 1 <= N <= fps_max_points(),
// m >= 1, start in [0, N), all tensors contiguous on one device.
extern "C" int fps_f32(const void* pos, const void* penalty, const void* start,
                       void* idx, int B, int N, int m, void* stream) {
  auto p = static_cast<const float*>(pos);
  auto q = static_cast<const float*>(penalty);
  auto s = static_cast<const long long*>(start);
  auto o = static_cast<long long*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  const int ppt = (N + THREADS - 1) / THREADS;
  cudaError_t e;
  if (ppt <= 1) e = launch<1>(p, q, s, o, B, N, m, st);
  else if (ppt <= 2) e = launch<2>(p, q, s, o, B, N, m, st);
  else if (ppt <= 4) e = launch<4>(p, q, s, o, B, N, m, st);
  else if (ppt <= 8) e = launch<8>(p, q, s, o, B, N, m, st);
  else e = launch<16>(p, q, s, o, B, N, m, st);
  return static_cast<int>(e);
}
