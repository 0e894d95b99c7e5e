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
// What bounds it on the H100. The cross term is 2 D bf16 operations a pair
// (13.4 GFLOP for a 10,240-point graph at D = 64, 14 us on the tensor
// cores). What is left is the per-pair epilogue on the f32, integer and
// conversion pipes: the norms' sum, the -2 acc fma, the clamp and the bias
// (4 f32), half a bf16x2 conversion, the key (1.5 integer) and one compare
// with its column's KP-th key; a column of Nc / 128 candidates admits
// about KP (1 + ln(Nc / 128 / KP)) of them (random order), each a 2 KP - 1
// min / max insert. chip_smoke.py counts that bound: about 0.024 ms at a
// 10,240-point graph, issue-bound. This kernel inserts every pair (2 KP - 1
// min / max, branch-free), so it does about twice the integer work the
// function needs; it is 4-5x that bound (PERF.md).
//
// Design.
// - approx_prep, once per launch: every query and candidate row to bf16
//   (cvt.rn.bf16x2, round to nearest even as XLA's astype) zero-padded to
//   DK = 16, 32 or 64 features, and its |p|^2 summed from the f32 values in
//   feature order (fmaf, the exact kernel's order); a candidate's |c|^2
//   beside its bias as a float2. A self graph prepares its rows once. The
//   main kernel never rounds a row.
// - approx_kernel: a block owns 16 WQ queries of one batch row: WQ query
//   tiles of 16 rows (one mma m16 tile a warp) times 4 warps across the 128
//   lane columns (32 columns a warp). A warp's A fragments (its 16 queries,
//   all DK features) stay in registers for the whole candidate loop.
//   Candidate tiles of 128 rows (one row of lane columns) and their (|c|^2,
//   bias) are double-buffered in shared memory by cp.async, rows at a pitch
//   of DK + 8 bf16 so that an ldmatrix phase reads 8 bank groups.
// - Per tile a warp takes its 4 n8 slices one at a time: B fragments by
//   ldmatrix, DK / 16 mma.sync.m16n8k16 (bf16 in, f32 accumulate), and the
//   accumulator fragment straight into keys. A thread holds rows g and g + 8
//   and columns 2t, 2t + 1 of every slice, so over its warp's 4 slices it
//   owns the same 16 (query, lane column) cells on every tile, and keeps
//   their KP-deep sorted key lists in registers (a min / max network; keys
//   are unique, so no tie rule). The two columns of a row round to bf16 in
//   one cvt.rn.bf16x2.f32.
// - At the end the lists go to shared memory ([query][KP][128 columns]) and
//   one warp per query takes the k smallest keys: k rounds of
//   __reduce_min_sync over the heads of the columns l, l + 32, l + 64,
//   l + 96 that lane l reads; lane r % 32 writes entry r. A round costs
//   0.41-0.48 us of the kernel at a 10,240-point graph (a warp's 4 queries
//   one after another): 9-10% of it at k = 20, 5% at k = 12 (an H100 SXM,
//   tools/knn_approx_sweep_torch.py).
// - Registers bound the queries an SM holds: 8 threads a query, each with
//   16 x KP keys. The instances WQ = 2 and 5 keep 2 and 1 blocks on an SM
//   (at most 128 and 96 registers a thread; 64 and 80 queries an SM).
//   knn_approx_plan (ops/kernels/knn.py) picks WQ from the card's SM count:
//   on 132 SMs a 10,240- or 10,112-point graph takes WQ = 5 (128 or 127
//   blocks, one wave), a 4,096-point graph WQ = 2 (128 blocks, one wave);
//   fewer, larger blocks read the candidate rows from L2 fewer times. Both
//   were the fastest instance at their shapes on an H100 SXM
//   (tools/knn_approx_sweep_torch.py, PERF.md); a WQ = 1 instance (5 blocks
//   an SM) was slower at every shape and is not built.
// - D = 3 pads K to 16 all the same: an FFMA product of the 4 padded
//   features in the same fragment layout was slower at the 10,240-point
//   graph, WQ = 5 (kernel 0.1035 against 0.0958 ms; 0.1101 against 0.1025
//   with the row preparation; one sweep on an H100 SXM, PERF.md), so there
//   is one product.
// - The shared-memory attribute is set once per instance, not per launch.
namespace approx {

using bf16 = __nv_bfloat16;

constexpr int TILE = 128;             // candidates a tile: one row of lane columns
constexpr int WC = 4;                 // warps across the lane columns
constexpr int NT = TILE / WC / 8;     // n8 slices a warp
constexpr int CELLS = 2 * NT;         // lane columns a thread holds in each of its rows
constexpr unsigned NONE = 0xffffffffu;  // above every key

__host__ __device__ constexpr int pitch(int dk) { return dk + 8; }
// one tile buffer: [TILE][DK + 8] bf16 rows, then [TILE] float2 (|c|^2, bias)
__host__ __device__ constexpr int tile_bytes(int dk) { return TILE * pitch(dk) * 2 + TILE * 8; }
// the lists at the end: [16 WQ][KP][TILE] keys, rows 8 words apart
__host__ __device__ constexpr int list_pitch(int kp) { return kp * TILE + 8; }
__host__ __device__ constexpr size_t smem_bytes(int dk, int kp, int wq) {
  return 2 * tile_bytes(dk) > 16 * wq * list_pitch(kp) * 4
             ? 2 * tile_bytes(dk) : 16 * wq * list_pitch(kp) * 4;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// bf16x2 of (lo, hi), round to nearest even: lo in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Rows [0, nq) of query and [0, nc) of cand (nq = 0 for a self graph):
// bf16 copies zero-padded to DK features, |p|^2 from the f32 values. A
// block stages PREP_ROWS rows through shared memory (a warp reads a row's
// features together, all its rows' loads in flight at once), then thread i
// converts row i (an odd pitch: no bank conflict).
constexpr int PREP_ROWS = 128;

template <int DK>
__global__ void __launch_bounds__(PREP_ROWS)
approx_prep(const float* __restrict__ query, const float* __restrict__ cand,
            const float* __restrict__ bias, int nq, int nc, int D,
            bf16* __restrict__ qh, float* __restrict__ q2,
            bf16* __restrict__ ch, float2* __restrict__ cn) {
  __shared__ float rows[PREP_ROWS][DK + 1];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * PREP_ROWS;
  const int n = min(PREP_ROWS, nq + nc - i0);
#pragma unroll
  for (int j = 0; j < PREP_ROWS / 4; ++j) {  // warp w: rows w, w + 4, ...
    const int r = (tid >> 5) + 4 * j;
    const int i = i0 + r;
    const float* src = i < nq ? query + (size_t)i * D : cand + (size_t)(i - nq) * D;
#pragma unroll
    for (int d = tid & 31; d < DK; d += 32)
      if (r < n) rows[r][d] = d < D ? __ldg(src + d) : 0.f;
  }
  __syncthreads();
  const int i = i0 + tid;
  if (i >= nq + nc) return;
  const bool is_q = i < nq;
  const int r = is_q ? i : i - nq;
  uint4* dst = reinterpret_cast<uint4*>((is_q ? qh : ch) + (size_t)r * DK);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DK / 8; ++c) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = rows[tid][8 * c + 2 * j];
      const float hi = rows[tid][8 * c + 2 * j + 1];
      s = fmaf(lo, lo, s);
      s = fmaf(hi, hi, s);
      w[j] = pack_bf16x2(lo, hi);
    }
    dst[c] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (is_q) q2[r] = s;
  else cn[r] = make_float2(s, __ldg(bias + r));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

// Candidate rows [t0, t0 + TILE) and their (|c|^2, bias) into buffer dst
// (a rolled loop: unrolled, its hoisted addresses cost registers).
template <int DK, int THREADS>
__device__ __forceinline__ void fetch(unsigned char* dst, const bf16* cb,
                                      const float2* nb, int t0, int tid) {
  constexpr int CH = DK / 8;  // 16-byte chunks a row
  constexpr int ROWS = TILE * CH;
#pragma unroll 1
  for (int e = tid; e < ROWS + TILE / 2; e += THREADS) {
    if (e < ROWS) {
      const int r = e / CH;
      const int c = e - r * CH;
      cp_async_16(dst + 2 * (r * pitch(DK) + 8 * c), cb + ((t0 + r) * DK + 8 * c));
    } else {
      const int j = e - ROWS;
      cp_async_16(dst + 2 * TILE * pitch(DK) + 16 * j, nb + t0 + 2 * j);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// B fragments of candidates n0 .. n0 + 7 (the slice's n8 columns) at every
// k16 step: bf[ks] = {features 16 ks + 2t, +1 ; 16 ks + 8 + 2t, +1} of
// candidate n0 + g.
template <int KS>
__device__ __forceinline__ void load_b(const bf16* tile, int n0, int lane,
                                       unsigned (&bf)[KS][2]) {
  constexpr int P = pitch(16 * KS);
  if constexpr (KS == 1) {
    const unsigned a = smem_u32(tile + (n0 + (lane & 7)) * P + 8 * ((lane >> 3) & 1));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(bf[0][0]), "=r"(bf[0][1]) : "r"(a));
  } else {
#pragma unroll
    for (int j = 0; j < KS / 2; ++j) {
      const unsigned a = smem_u32(tile + (n0 + (lane & 7)) * P + 32 * j + 8 * (lane >> 3));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(bf[2 * j][0]), "=r"(bf[2 * j][1]), "=r"(bf[2 * j + 1][0]),
                     "=r"(bf[2 * j + 1][1])
                   : "r"(a));
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// max(|q|^2 + |c|^2 - 2 acc, 0) + bias, in the contract's order (2 acc is
// exact, so the fma rounds as the subtraction does)
__device__ __forceinline__ float dist(float q2, float c2, float bias, float acc) {
  return __fadd_rn(fmaxf(fmaf(-2.f, acc, __fadd_rn(q2, c2)), 0.f), bias);
}

// (a0 < a1 < ... ) <- the KP smallest of the list and x
template <int KP>
__device__ __forceinline__ void insert_key(unsigned (&a)[KP], unsigned x) {
#pragma unroll
  for (int s = KP - 1; s > 0; --s) a[s] = min(a[s], max(a[s - 1], x));
  a[0] = min(a[0], x);
}

__device__ __forceinline__ unsigned ld_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

template <int DK, int KP, int WQ>
__global__ void __launch_bounds__(128 * WQ, WQ == 2 ? 2 : 1)
approx_kernel(const bf16* __restrict__ qh, const float* __restrict__ q2, int q2_stride,
              const bf16* __restrict__ ch, const float2* __restrict__ cn,
              float* __restrict__ out_d, long long* __restrict__ out_i, int Nq,
              int Nc, int k) {
  constexpr int THREADS = 128 * WQ, WARPS = 4 * WQ, QB = 16 * WQ;
  constexpr int KS = DK / 16, LP = list_pitch(KP), TB = tile_bytes(DK);
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wq = warp / WC;
  const int wc = warp - wq * WC;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const bf16* cb = ch + (size_t)b * Nc * DK;
  const float2* nb = cn + (size_t)b * Nc;

  // the warp's query tile: A fragments and |q|^2 of rows g and g + 8
  const int ra = q0 + 16 * wq + g;
  const int rb = ra + 8;
  const bf16* qb = qh + (size_t)b * Nq * DK;
  unsigned af[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int f = 16 * ks + 2 * t;
    af[ks][0] = ra < Nq ? ld_u32(qb + (size_t)ra * DK + f) : 0u;
    af[ks][1] = rb < Nq ? ld_u32(qb + (size_t)rb * DK + f) : 0u;
    af[ks][2] = ra < Nq ? ld_u32(qb + (size_t)ra * DK + f + 8) : 0u;
    af[ks][3] = rb < Nq ? ld_u32(qb + (size_t)rb * DK + f + 8) : 0u;
  }
  const float qa2 = ra < Nq ? __ldg(q2 + ((size_t)b * Nq + ra) * q2_stride) : 0.f;
  const float qb2 = rb < Nq ? __ldg(q2 + ((size_t)b * Nq + rb) * q2_stride) : 0.f;

  unsigned key[2][CELLS][KP];  // rows g, g + 8 x the thread's 8 lane columns
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < CELLS; ++c)
#pragma unroll
      for (int s = 0; s < KP; ++s) key[h][c][s] = NONE;

  fetch<DK, THREADS>(smem, cb, nb, 0, tid);
  for (int t0 = 0, it = 0; t0 < Nc; t0 += TILE, ++it) {  // Nc % TILE == 0
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t is in; tile t-1's buffer is no longer read
    if (t0 + TILE < Nc) fetch<DK, THREADS>(smem + ((it + 1) & 1) * TB, cb, nb, t0 + TILE, tid);
    const bf16* cs = reinterpret_cast<const bf16*>(smem + (it & 1) * TB);
    const float* ns = reinterpret_cast<const float*>(smem + (it & 1) * TB + 2 * TILE * pitch(DK));
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      const int n0 = 32 * wc + 8 * s;
      unsigned bf[KS][2];
      load_b<KS>(cs, n0, lane, bf);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma_bf16(acc, af[ks], bf[ks][0], bf[ks][1]);
      // (|c|^2, bias) of columns n0 + 2t and n0 + 2t + 1
      const float4 cv = *reinterpret_cast<const float4*>(ns + 2 * (n0 + 2 * t));
      const unsigned c0 = t0 + n0 + 2 * t;
      const unsigned pa = pack_bf16x2(dist(qa2, cv.x, cv.y, acc[0]), dist(qa2, cv.z, cv.w, acc[1]));
      const unsigned pb = pack_bf16x2(dist(qb2, cv.x, cv.y, acc[2]), dist(qb2, cv.z, cv.w, acc[3]));
      insert_key<KP>(key[0][2 * s], (pa << 16) | c0);
      insert_key<KP>(key[0][2 * s + 1], (pa & 0xffff0000u) | (c0 + 1));
      insert_key<KP>(key[1][2 * s], (pb << 16) | c0);
      insert_key<KP>(key[1][2 * s + 1], (pb & 0xffff0000u) | (c0 + 1));
    }
  }

  // the lists into shared memory, over the tile buffers
  __syncthreads();  // every warp is done with the last tile
  unsigned* lists = reinterpret_cast<unsigned*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < CELLS; ++c)
#pragma unroll
      for (int s = 0; s < KP; ++s)
        lists[(16 * wq + g + 8 * h) * LP + s * TILE + 32 * wc + 8 * (c >> 1) + 2 * t + (c & 1)] =
            key[h][c][s];
  __syncthreads();

  // one warp a query: the k smallest of its 128 KP keys
  for (int rr = warp; rr < QB && q0 + rr < Nq; rr += WARPS) {  // warp-uniform
    unsigned kk[4][KP];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int s = 0; s < KP; ++s) kk[j][s] = lists[rr * LP + s * TILE + 32 * j + lane];
    const size_t row = ((size_t)b * Nq + q0 + rr) * k;
    for (int r = 0; r < k; ++r) {
      unsigned m = min(min(kk[0][0], kk[1][0]), min(kk[2][0], kk[3][0]));
      m = __reduce_min_sync(FULL, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kk[j][0] == m) {  // one column of one lane: keys are unique
#pragma unroll
          for (int s = 0; s + 1 < KP; ++s) kk[j][s] = kk[j][s + 1];
          kk[j][KP - 1] = NONE;
        }
      }
      if (lane == (r & 31)) {
        out_d[row + r] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(m >> 16)));
        out_i[row + r] = m & 0xffffu;
      }
    }
  }
}

// scratch: ch [B Nc DK] bf16, cn [B Nc] float2, then for a graph that is
// not its own candidate set qh [B Nq DK] bf16 and q2 [B Nq] f32, each from
// a 16-byte boundary (ops/kernels/knn.py : approx_scratch_bytes)
__host__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

template <int DK, int KP, int WQ>
int launch(const float* q, const float* c, const float* bias, float* d2,
           long long* idx, unsigned char* scratch, long long scratch_bytes, int B,
           int Nq, int Nc, int D, int k, cudaStream_t stream) {
  constexpr size_t SMEM = smem_bytes(DK, KP, WQ);
  static const cudaError_t attr = cudaFuncSetAttribute(
      approx_kernel<DK, KP, WQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool self = q == c && Nq == Nc;
  const size_t nq = self ? 0 : (size_t)B * Nq, nc = (size_t)B * Nc;
  bf16* ch = reinterpret_cast<bf16*>(scratch);
  float2* cn = reinterpret_cast<float2*>(scratch + align16(nc * DK * 2));
  unsigned char* rest = reinterpret_cast<unsigned char*>(cn) + align16(nc * 8);
  bf16* qh = self ? ch : reinterpret_cast<bf16*>(rest);
  float* q2 = self ? &cn->x : reinterpret_cast<float*>(rest + align16(nq * DK * 2));
  const size_t need = (rest - scratch) + (self ? 0 : align16(nq * DK * 2) + align16(nq * 4));
  if ((size_t)scratch_bytes < need || nq + nc >= (size_t)1 << 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>(nq + nc);
  approx_prep<DK><<<(rows + PREP_ROWS - 1) / PREP_ROWS, PREP_ROWS, 0, stream>>>(
      q, c, bias, static_cast<int>(nq), static_cast<int>(nc), D, qh, q2, ch, cn);
  const dim3 grid((Nq + 16 * WQ - 1) / (16 * WQ), B);
  approx_kernel<DK, KP, WQ><<<grid, 128 * WQ, SMEM, stream>>>(
      qh, q2, self ? 2 : 1, ch, cn, d2, idx, Nq, Nc, k);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int KP>
int dispatch_wq(int wq, const float* q, const float* c, const float* bias, float* d2,
                long long* idx, unsigned char* scratch, long long bytes, int B, int Nq,
                int Nc, int D, int k, cudaStream_t s) {
  if (wq == 2) return launch<DK, KP, 2>(q, c, bias, d2, idx, scratch, bytes, B, Nq, Nc, D, k, s);
  if (wq == 5) return launch<DK, KP, 5>(q, c, bias, d2, idx, scratch, bytes, B, Nq, Nc, D, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DK>
int dispatch_kp(int kp, int wq, const float* q, const float* c, const float* bias,
                float* d2, long long* idx, unsigned char* scratch, long long bytes, int B,
                int Nq, int Nc, int D, int k, cudaStream_t s) {
  if (kp == 2) return dispatch_wq<DK, 2>(wq, q, c, bias, d2, idx, scratch, bytes, B, Nq, Nc, D, k, s);
  if (kp == 3) return dispatch_wq<DK, 3>(wq, q, c, bias, d2, idx, scratch, bytes, B, Nq, Nc, D, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace approx
}  // namespace

// Shapes the wrapper (ops/kernels/knn.py : knn_approx_kernel) admits: D <=
// 64, Nc a multiple of 128 in [4096, 65536), 3 <= k <= 128 kp, kp = 2 or 3
// (chunk_kp_approx(k)), B <= 65535, all tensors contiguous on one device;
// wq = 2 or 5 (knn_approx_plan); scratch of approx_scratch_bytes.
extern "C" int knn_approx_bf16(const void* query, const void* cand,
                               const void* bias, void* d2, void* idx,
                               void* scratch, long long scratch_bytes, int B,
                               int Nq, int Nc, int D, int k, int kp, int wq,
                               void* stream) {
  const auto* q = static_cast<const float*>(query);
  const auto* c = static_cast<const float*>(cand);
  const auto* v = static_cast<const float*>(bias);
  auto* od = static_cast<float*>(d2);
  auto* oi = static_cast<long long*>(idx);
  auto* sc = static_cast<unsigned char*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (Nc % approx::TILE != 0 || Nc >= (1 << 16) || k < 1 || k > approx::TILE * kp ||
      Nq < 1 || B < 1 || B > 65535 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 16) return approx::dispatch_kp<16>(kp, wq, q, c, v, od, oi, sc, scratch_bytes, B, Nq, Nc, D, k, s);
  if (D <= 32) return approx::dispatch_kp<32>(kp, wq, q, c, v, od, oi, sc, scratch_bytes, B, Nq, Nc, D, k, s);
  if (D <= 64) return approx::dispatch_kp<64>(kp, wq, q, c, v, od, oi, sc, scratch_bytes, B, Nq, Nc, D, k, s);
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
