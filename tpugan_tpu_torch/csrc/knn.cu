// k-nearest-neighbour search: exact (knn_f32) and approximate bf16
// (knn_approx_bf16).
//
// Replaces tpugan_tpu/ops/pallas/knn_kernel.py : knn_pallas (the plain peel
// _knn_kernel_plain and the chunked fold-peel _knn_chunked_kernel, with the
// distance of _compute_d2), knn_f32 its exact mode and knn_approx_bf16 its
// approx=True mode (the note at knn_approx_kernel below).
//
// Contract: query [B,Nq,D] f32, cand [B,Nc,D] f32, bias [B,Nc] f32 (0 for a
// valid candidate, 1e10 for an invalid one), k <= Nc
//   -> d2 [B,Nq,k] f32 ascending, idx [B,Nq,k] int64, with
//      d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) + bias
// (the formula of the TPU kernel's _compute_d2 and of pairwise_sqdist), and
// equal distances ordered by lower candidate index, as a stable argsort.
//
// What bounds it on the H100. The distance product is Nq*Nc*(2D+3) f32
// operations against inputs and outputs of a few MB (N=10240, D=64, k=20:
// 13.7 GFLOP against 5.6 MB), so at D >= 32 the bound is the SMs' f32 FMA
// rate. At D=3 the product is 4 FMAs a pair and the top-k selection is the
// work: one compare per pair and about k(1 + ln(Nc/k)) list insertions per
// query, each a chain of warp shuffles.
//
// Design. No [Nq, Nc] distance block exists anywhere, so the TPU kernel's
// 24,576-candidate cap is gone. Everything is f32 FMA: TF32 or bf16 tensor
// cores would break the exact contract.
// - A block owns 32 queries of one batch row (8 warps of 4) and loops over
//   candidate tiles of 128. The query tile sits in shared memory transposed,
//   [DP][32] (DP: D rounded up to a power of two, zero-padded). Candidate
//   tiles are double-buffered, row-major [128][DP] with the float4 chunks of
//   each row swizzled, and copied with cp.async (16-byte chunks when D % 4
//   == 0), so the copy of tile t+1 runs while tile t is scored. |q|^2 is
//   formed once per block, |c|^2 once per candidate and tile.
// - Distance tile: warp w scores its own 4 queries against the 128
//   candidates, lane l the candidates l, l+32, l+64, l+96. Per 4 features
//   that is 4 float4 loads of candidate chunks (conflict-free by the
//   swizzle), 4 broadcast float4 loads of the query values and 64 FMAs into
//   a 4 x 4 register tile. The distances stay in registers: the warp that
//   computes a query's distances is the warp that selects them.
// - Selection: one top-k list per query, spread over its warp: lane s holds
//   entry s (and entry 32+s for k > 32). Candidates arrive in index order
//   (tile, then chunk of 32, then lane), so every candidate has a higher
//   index than the list's entries, and the stable order needs distances
//   alone: a candidate enters when its distance is below entry k-1's. One
//   vote per query and tile skips the tile when no lane enters (the common
//   case once the list has filled); else, per chunk of 32, a ballot finds
//   the candidates that enter, and each of them, lowest lane first, takes
//   the place popc(ballot(entry <= d)) gives, the entries behind it move up
//   one lane (__shfl_up_sync), and the warp ballots again against the new
//   entry k-1. No lane diverges, and no list is merged with another.
// - At the end lane s writes entry s of each of its queries: the stores of
//   a row are coalesced.
// - 80 registers (launch bounds of 3 blocks an SM) and 75 KB of shared
//   memory at D=64 keep 3 blocks on each SM, so a 10,240-point frame's 320
//   blocks run in one wave.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int QW = 4;                 // queries per warp
constexpr int THREADS = 256;
constexpr int QB = QW * THREADS / 32; // queries per block
constexpr int TILE = 128;             // candidates per tile
constexpr int CPL = TILE / 32;        // candidates per lane in a tile

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (DP * QB + 2 * (DP * TILE + TILE) + QB + TILE);
}

// Candidate row r of a tile holds its DP / 4 float4 chunks in the order
// c ^ swizzle(r): the 8 lanes of a 16-byte load phase, which read 8
// consecutive rows, then hit 8 different bank groups.
template <int DP>
__device__ __forceinline__ int swizzle(int r) {
  constexpr int C4 = DP / 4;
  if constexpr (C4 >= 8) return r & 7;
  else return (r >> (C4 == 4 ? 1 : C4 == 2 ? 2 : 0)) & (C4 - 1);
}

// 16-byte asynchronous copy of src[i .. i+3] to shared dst, as cp_async4
__device__ __forceinline__ void cp_async16(float* dst, const float* src, size_t i,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src + (pred ? i : 0)), "r"(pred ? 16 : 0));
}

// 4-byte asynchronous copy of src[i] to shared dst; zero-fills, and reads
// nothing, when !pred
__device__ __forceinline__ void cp_async4(float* dst, const float* src, size_t i,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src + (pred ? i : 0)), "r"(pred ? 4 : 0));
}

// Copy of one candidate tile (rows past Nc and features past D zero-filled)
// into buf: [TILE][DP] swizzled rows, then [TILE] biases.
template <int DP>
__device__ __forceinline__ void fetch_tile(float* buf, const float* cb,
                                           const float* vb, int t0, int Nc,
                                           int D, bool vec, int tid) {
  constexpr int C4 = DP / 4;
  const int nt = min(TILE, Nc - t0);
  if (vec) {  // D % 4 == 0 and 16-byte aligned rows: whole chunks
#pragma unroll
    for (int e = tid; e < TILE * C4; e += THREADS) {
      const int ci = e / C4;
      const int c = e - ci * C4;
      cp_async16(buf + ci * DP + 4 * (c ^ swizzle<DP>(ci)), cb,
                 (size_t)(t0 + ci) * D + 4 * c, ci < nt && 4 * c < D);
    }
  } else {
#pragma unroll
    for (int e = tid; e < TILE * DP; e += THREADS) {
      const int ci = e / DP;
      const int d = e - ci * DP;
      cp_async4(buf + ci * DP + 4 * ((d >> 2) ^ swizzle<DP>(ci)) + (d & 3), cb,
                (size_t)(t0 + ci) * D + d, ci < nt && d < D);
    }
  }
  if (tid < TILE) cp_async4(buf + DP * TILE + tid, vb, t0 + tid, tid < nt);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Query tile of the block, transposed and zero-padded: qs[d * QB + q].
template <int DP>
__device__ __forceinline__ void load_queries(float* qs, const float* qb, int q0,
                                             int Nq, int D, int tid) {
  for (int e = tid; e < DP * QB; e += THREADS) {
    const int q = e / DP;
    const int d = e - q * DP;
    qs[d * QB + q] = (q0 + q < Nq && d < D) ? __ldg(qb + (size_t)(q0 + q) * D + d) : 0.f;
  }
}

// acc[q][j] = q.c for the warp's 4 queries and the lane's candidates
// 32 j + lane of the tile cs (per 4 features: 4 float4 candidate loads,
// conflict-free by the swizzle, 4 broadcast float4 query loads, 64 FMAs).
template <int DP>
__device__ __forceinline__ void dot_tile(float (&acc)[QW][CPL], const float* qs,
                                         const float* cs, int warp, int lane) {
  constexpr int C4 = DP / 4;
#pragma unroll
  for (int q = 0; q < QW; ++q)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[q][j] = 0.f;
  const int sw = swizzle<DP>(lane);  // = swizzle(32 j + lane)
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    float cv[CPL][4];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(
          cs + (32 * j + lane) * DP + 4 * (c ^ sw));
      cv[j][0] = v.x;
      cv[j][1] = v.y;
      cv[j][2] = v.z;
      cv[j][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float qv[QW];
      const float4 v = *reinterpret_cast<const float4*>(qs + (4 * c + u) * QB + QW * warp);
      qv[0] = v.x;
      qv[1] = v.y;
      qv[2] = v.z;
      qv[3] = v.w;
#pragma unroll
      for (int q = 0; q < QW; ++q)
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[q][j] = fmaf(qv[q], cv[j][u], acc[q][j]);
    }
  }
}

// |c|^2 of candidate row r of the tile cs, in feature order (the order of
// |q|^2, so that a point's exact distance to itself is 0)
template <int DP>
__device__ __forceinline__ float row_sqnorm(const float* cs, int r) {
  const int swz = swizzle<DP>(r);
  float s2 = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(cs + r * DP + 4 * (c ^ swz));
    s2 = fmaf(v.x, v.x, s2);
    s2 = fmaf(v.y, v.y, s2);
    s2 = fmaf(v.z, v.z, s2);
    s2 = fmaf(v.w, v.w, s2);
  }
  return s2;
}

// The same for the approximate kernel, which then rounds the row to bf16
// in place (the float4 chunks in the swizzled order row_sqnorm reads them
// in, so 8 consecutive rows of a load phase hit 8 bank groups).
template <int DP>
__device__ __forceinline__ float row_sqnorm_to_bf16(float* cs, int r) {
  const int swz = swizzle<DP>(r);
  float s2 = 0.f;
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) {
    float4* p = reinterpret_cast<float4*>(cs + r * DP + 4 * (c ^ swz));
    float4 v = *p;
    s2 = fmaf(v.x, v.x, s2);
    s2 = fmaf(v.y, v.y, s2);
    s2 = fmaf(v.z, v.z, s2);
    s2 = fmaf(v.w, v.w, s2);
    v.x = __bfloat162float(__float2bfloat16_rn(v.x));
    v.y = __bfloat162float(__float2bfloat16_rn(v.y));
    v.z = __bfloat162float(__float2bfloat16_rn(v.z));
    v.w = __bfloat162float(__float2bfloat16_rn(v.w));
    *p = v;
  }
  return s2;
}

// Insert (d, i), with d below entry k-1, into the list held by the warp
// (entry 32 s + lane in ld[s], li[s]); entries behind it move up by one.
// Candidates arrive in index order, so i exceeds every index in the list:
// it goes behind the entries of equal distance.
template <int S>
__device__ __forceinline__ void insert(float (&ld)[S], int (&li)[S], float d,
                                       int i, int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) pos += __popc(__ballot_sync(FULL, ld[s] <= d));
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    float ud = __shfl_up_sync(FULL, ld[s], 1);
    int ui = __shfl_up_sync(FULL, li[s], 1);
    if (s > 0) {  // lane 0 takes the last entry of the slot below
      const float pd = __shfl_sync(FULL, ld[s > 0 ? s - 1 : 0], 31);
      const int pi = __shfl_sync(FULL, li[s > 0 ? s - 1 : 0], 31);
      if (lane == 0) {
        ud = pd;
        ui = pi;
      }
    }
    const int e = 32 * s + lane;
    if (e == pos) {
      ld[s] = d;
      li[s] = i;
    } else if (e > pos) {
      ld[s] = ud;
      li[s] = ui;
    }
  }
}

// The distance of entry k-1 of the list, on every lane.
template <int S>
__device__ __forceinline__ float last_entry(const float (&ld)[S], int kslot, int klane) {
  float d = ld[0];
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (kslot == s) d = ld[s];
  return __shfl_sync(FULL, d, klane);
}

template <int DP, int S>
__global__ void __launch_bounds__(THREADS, 3)
knn_kernel(const float* __restrict__ query, const float* __restrict__ cand,
           const float* __restrict__ bias, float* __restrict__ out_d,
           long long* __restrict__ out_i, int Nq, int Nc, int D, int k,
           bool vec) {
  constexpr int CT = DP * TILE + TILE;  // floats of one tile buffer
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [DP][QB]
  float* q2s = qs + DP * QB;        // [QB]
  float* c2s = q2s + QB;            // [TILE]
  float* tiles = c2s + TILE;        // 2 x ([TILE][DP] candidates, [TILE] bias)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const float* qb = query + (size_t)b * Nq * D;
  const float* cb = cand + (size_t)b * Nc * D;
  const float* vb = bias + (size_t)b * Nc;

  // query tile, transposed and zero-padded; |q|^2 in the order of the dots
  load_queries<DP>(qs, qb, q0, Nq, D, tid);
  __syncthreads();
  if (tid < QB) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) s = fmaf(qs[d * QB + tid], qs[d * QB + tid], s);
    q2s[tid] = s;
  }

  float ld[QW][S], td[QW];  // the lists, and the distance of entry k-1
  int li[QW][S];
#pragma unroll
  for (int q = 0; q < QW; ++q) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ld[q][s] = CUDART_INF_F;
      li[q][s] = 0x7fffffff;
    }
    td[q] = CUDART_INF_F;
  }
  const int kslot = (k - 1) >> 5;
  const int klane = (k - 1) & 31;
  const int qw = q0 + QW * warp;  // the warp's first query

  fetch_tile<DP>(tiles, cb, vb, 0, Nc, D, vec, tid);

  for (int t0 = 0, it = 0; t0 < Nc; t0 += TILE, ++it) {
    const int nt = min(TILE, Nc - t0);
    const float* cs = tiles + (it & 1) * CT;
    const float* bs = cs + DP * TILE;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t is in; tile t-1's buffer is no longer read
    if (t0 + TILE < Nc)
      fetch_tile<DP>(tiles + ((it + 1) & 1) * CT, cb, vb, t0 + TILE, Nc, D, vec, tid);
    // |c|^2 once per candidate, in the order of |q|^2, so that a point's
    // distance to itself is exactly 0
    if (tid < TILE) c2s[tid] = row_sqnorm<DP>(cs, tid);

    // the 4 x 4 tile of dots
    float acc[QW][CPL];
    dot_tile<DP>(acc, qs, cs, warp, lane);

    // selection: a candidate enters when its distance is below entry k-1's
    // (an equal distance stays out: the entry has the lower index)
    __syncthreads();  // |c|^2 is in
    float c2[CPL], bv[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      c2[j] = c2s[32 * j + lane];
      bv[j] = 32 * j + lane < nt ? bs[32 * j + lane] : CUDART_NAN_F;  // padding never enters
    }
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      if (qw + q >= Nq) continue;  // warp-uniform
      const float q2 = q2s[QW * warp + q];
      float dd[CPL];
      bool any = false;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        dd[j] = fmaxf(q2 + c2[j] - 2.f * acc[q][j], 0.f) + bv[j];
        any |= dd[j] < td[q];
      }
      if (!__any_sync(FULL, any)) continue;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        unsigned m = __ballot_sync(FULL, dd[j] < td[q]);
        while (m) {
          const int src = __ffs(m) - 1;
          insert<S>(ld[q], li[q], __shfl_sync(FULL, dd[j], src), t0 + 32 * j + src, lane);
          td[q] = last_entry<S>(ld[q], kslot, klane);
          m = __ballot_sync(FULL, lane > src && dd[j] < td[q]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < QW; ++q) {
    if (qw + q >= Nq) continue;
    const size_t row = ((size_t)b * Nq + qw + q) * k;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = 32 * s + lane;
      if (e < k) {
        out_d[row + e] = ld[q][s];
        out_i[row + e] = li[q][s];
      }
    }
  }
}

template <int DP, int S>
int launch(const float* q, const float* c, const float* bias, float* d2,
           long long* idx, int B, int Nq, int Nc, int D, int k,
           cudaStream_t stream) {
  const dim3 grid((Nq + QB - 1) / QB, B);
  if constexpr (smem_bytes<DP>() > 48 * 1024)
    cudaFuncSetAttribute(knn_kernel<DP, S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem_bytes<DP>()));
  knn_kernel<DP, S><<<grid, THREADS, smem_bytes<DP>(), stream>>>(
      q, c, bias, d2, idx, Nq, Nc, D, k,
      D % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dispatch_k(const float* q, const float* c, const float* bias, float* d2,
               long long* idx, int B, int Nq, int Nc, int D, int k,
               cudaStream_t s) {
  if (k <= 32) return launch<DP, 1>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  // k <= 64 (the capped particle density's radius kNN) only for points
  if constexpr (DP == 4) {
    if (k <= 64) return launch<DP, 2>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------ approximate
//
// knn_approx_bf16: the approx=True mode of the TPU kernel (_compute_d2 with
// approx, the bf16 scratch, _chunk_kp_approx folds, no certificate). Its
// contract (ops/kernels/knn.py): each candidate c of query q gets the key
//   bits(bf16(max(|q|^2 + |c|^2 - 2 bf16(q).bf16(c), 0) + bias)) << 16 | c,
// non-negative bf16 bits ordering as their values and Nc < 2^16; per lane
// column (c = l mod 128) the KP smallest keys are kept, and of those 128 KP
// keys the k smallest are the result (d2 the bf16 value, idx the low half).
//
// Design: the exact kernel's block layout (32 queries a block, 4 a warp,
// double-buffered 128-candidate tiles, the 4 x 4 FFMA dot tile). A tile is
// one row of the TPU's lane columns: lane l scores the candidates l, l+32,
// l+64, l+96 of every tile, so it owns 4 whole columns and keeps their
// lists alone, with no exchange between lanes until the end.
// - Operands: |q|^2 and |c|^2 are summed from the f32 values, then the
//   thread that summed a row rounds it to bf16 in place in shared memory
//   (__float2bfloat16_rn, as XLA's astype), in the swizzled float4 order
//   that keeps a load phase free of bank conflicts (a plain element loop
//   over a row is a 32-way conflict at D=64 and made the kernel 5x slower
//   than the exact one), so the dot tile multiplies bf16 values in f32:
//   every product is exact and the sums are f32.
// - Per query and column, a sorted list of KP (2 or 3) keys in registers,
//   updated by a min / max network (keys are unique, so no tie rule).
// - At the end, per query, k rounds of __reduce_min_sync over the lanes'
//   column heads; the lane that holds the minimum pops it, and lane r % 32
//   writes entry r.
// 4 queries x 4 columns x 3 keys are 48 registers beside the 16 dots, so
// the kernel asks for 2 blocks an SM (128 registers) instead of 3.

// (a0 < a1 < ... ) <- the KP smallest of the list and x
template <int KP>
__device__ __forceinline__ void insert_key(unsigned (&a)[KP], unsigned x) {
#pragma unroll
  for (int s = KP - 1; s > 0; --s) a[s] = min(a[s], max(a[s - 1], x));
  a[0] = min(a[0], x);
}

template <int DP, int KP>
__global__ void __launch_bounds__(THREADS, 2)
knn_approx_kernel(const float* __restrict__ query, const float* __restrict__ cand,
                  const float* __restrict__ bias, float* __restrict__ out_d,
                  long long* __restrict__ out_i, int Nq, int Nc, int D, int k,
                  bool vec) {
  constexpr int CT = DP * TILE + TILE;
  constexpr unsigned NONE = 0xffffffffu;  // above every key
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [DP][QB], bf16 values after the norms
  float* q2s = qs + DP * QB;        // [QB]
  float* c2s = q2s + QB;            // [TILE]
  float* tiles = c2s + TILE;        // 2 x ([TILE][DP] candidates, [TILE] bias)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const float* qb = query + (size_t)b * Nq * D;
  const float* cb = cand + (size_t)b * Nc * D;
  const float* vb = bias + (size_t)b * Nc;

  load_queries<DP>(qs, qb, q0, Nq, D, tid);
  __syncthreads();
  if (tid < QB) {  // |q|^2 from f32, then the query's values to bf16
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) s = fmaf(qs[d * QB + tid], qs[d * QB + tid], s);
    q2s[tid] = s;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      qs[d * QB + tid] = __bfloat162float(__float2bfloat16_rn(qs[d * QB + tid]));
  }

  unsigned key[QW][CPL][KP];
#pragma unroll
  for (int q = 0; q < QW; ++q)
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int s = 0; s < KP; ++s) key[q][j][s] = NONE;
  const int qw = q0 + QW * warp;

  fetch_tile<DP>(tiles, cb, vb, 0, Nc, D, vec, tid);

  for (int t0 = 0, it = 0; t0 < Nc; t0 += TILE, ++it) {  // Nc % TILE == 0
    float* cs = tiles + (it & 1) * CT;
    const float* bs = cs + DP * TILE;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t is in; tile t-1's buffer is no longer read
    if (t0 + TILE < Nc)
      fetch_tile<DP>(tiles + ((it + 1) & 1) * CT, cb, vb, t0 + TILE, Nc, D, vec, tid);
    // |c|^2 from f32, then the row to bf16 in place
    if (tid < TILE) c2s[tid] = row_sqnorm_to_bf16<DP>(cs, tid);
    __syncthreads();  // rounded rows and |c|^2 are in

    float acc[QW][CPL];
    dot_tile<DP>(acc, qs, cs, warp, lane);

    float c2[CPL], bv[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      c2[j] = c2s[32 * j + lane];
      bv[j] = bs[32 * j + lane];
    }
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      const float q2 = q2s[QW * warp + q];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float dd = fmaxf(q2 + c2[j] - 2.f * acc[q][j], 0.f) + bv[j];
        const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(dd));
        insert_key<KP>(key[q][j], (bits << 16) | (t0 + 32 * j + lane));
      }
    }
  }

#pragma unroll
  for (int q = 0; q < QW; ++q) {
    if (qw + q >= Nq) continue;  // warp-uniform
    const size_t row = ((size_t)b * Nq + qw + q) * k;
    for (int r = 0; r < k; ++r) {
      unsigned m = key[q][0][0];
#pragma unroll
      for (int j = 1; j < CPL; ++j) m = min(m, key[q][j][0]);
      m = __reduce_min_sync(FULL, m);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (key[q][j][0] == m) {  // one column of one lane: keys are unique
#pragma unroll
          for (int s = 0; s + 1 < KP; ++s) key[q][j][s] = key[q][j][s + 1];
          key[q][j][KP - 1] = NONE;
        }
      }
      if (lane == (r & 31)) {
        out_d[row + r] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(m >> 16)));
        out_i[row + r] = m & 0xffffu;
      }
    }
  }
}

template <int DP, int KP>
int launch_approx(const float* q, const float* c, const float* bias, float* d2,
                  long long* idx, int B, int Nq, int Nc, int D, int k,
                  cudaStream_t stream) {
  const dim3 grid((Nq + QB - 1) / QB, B);
  if constexpr (smem_bytes<DP>() > 48 * 1024)
    cudaFuncSetAttribute(knn_approx_kernel<DP, KP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem_bytes<DP>()));
  knn_approx_kernel<DP, KP><<<grid, THREADS, smem_bytes<DP>(), stream>>>(
      q, c, bias, d2, idx, Nq, Nc, D, k,
      D % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dispatch_kp(const float* q, const float* c, const float* bias, float* d2,
                long long* idx, int B, int Nq, int Nc, int D, int k, int kp,
                cudaStream_t s) {
  if (kp == 2) return launch_approx<DP, 2>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  if (kp == 3) return launch_approx<DP, 3>(q, c, bias, d2, idx, B, Nq, Nc, D, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shapes the wrapper (ops/kernels/knn.py : knn_approx_kernel) admits: D <=
// 64, Nc a multiple of 128 in [4096, 65536), 3 <= k <= 128 kp, kp = 2 or 3
// (chunk_kp_approx(k)), all tensors contiguous on one device.
extern "C" int knn_approx_bf16(const void* query, const void* cand,
                               const void* bias, void* d2, void* idx, int B,
                               int Nq, int Nc, int D, int k, int kp,
                               void* stream) {
  const auto* q = static_cast<const float*>(query);
  const auto* c = static_cast<const float*>(cand);
  const auto* v = static_cast<const float*>(bias);
  auto* od = static_cast<float*>(d2);
  auto* oi = static_cast<long long*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (Nc % TILE != 0 || Nc >= (1 << 16) || k > TILE * kp)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 4) return dispatch_kp<4>(q, c, v, od, oi, B, Nq, Nc, D, k, kp, s);
  if (D <= 8) return dispatch_kp<8>(q, c, v, od, oi, B, Nq, Nc, D, k, kp, s);
  if (D <= 16) return dispatch_kp<16>(q, c, v, od, oi, B, Nq, Nc, D, k, kp, s);
  if (D <= 32) return dispatch_kp<32>(q, c, v, od, oi, B, Nq, Nc, D, k, kp, s);
  if (D <= 64) return dispatch_kp<64>(q, c, v, od, oi, B, Nq, Nc, D, k, kp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
