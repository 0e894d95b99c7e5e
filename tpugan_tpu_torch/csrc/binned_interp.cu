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
// query's cell or one of its 26 neighbours (9 contiguous CSR ranges: the
// cells x-1..x+1 of one (y, z) row are consecutive), so the walk is exact.
//
// What bounds it on the H100: operations. The function needs the pairs
// within the cutoff, about 20 f32 operations and a square root each,
// against a few MB of queries, candidates, values and outputs. Any walk of
// the 27 cells also meets the pairs they hold beyond the cutoff: a sphere
// of radius cutoff fills at most 4.19 / 27 of them, and on the eval path's
// frame a query's 27 cells hold 5.5x the candidates it has within the
// cutoff (chip_smoke.py reports the walked, tested and in-radius pairs).
//
// Design (the wrapper's binned_plan and tested_pairs mirror it):
// - Queries grouped by cell, neighbours together. query_keys gives each
//   query its walk cell's key (batch row and cell coordinates clamped to
//   [-2, n + 1]) and, in its low bits, the Morton code of the quarter of
//   the cell it lies in; the wrapper sorts the keys (a stable sort);
//   make_tiles cuts the sorted queries into tiles: runs of one cell within
//   one aligned block of 32 sorted positions, so a tile holds 1..32
//   queries that walk the same 9 ranges and lie close together. Only
//   occupied cells make tiles.
// - A warp a tile, lanes split by occupancy. A tile of n queries takes
//   L = 32 / next_pow2(n) lanes a query: a full tile (the frame's cells
//   hold about 60 queries) gives each query one lane; a lone query spreads
//   its candidates over 32 lanes, lane l taking every 32nd, and the lanes'
//   sums are added by a shuffle butterfly. Every sum has a fixed order (no
//   float atomics), so a launch repeats bit for bit.
// - Only candidates near the tile kept, in a spread order. The 9 ranges,
//   one after another, make the tile's window of W rows (their bounds read
//   by 9 lanes at once); lane l stages window rows nb l, nb l + 1, ...
//   (nb = W / 32 rounded up), one a batch, so a batch of 32 rows samples
//   the whole window. Of each batch the warp keeps, in lane order (a
//   ballot), the rows within d2_max of the box of its queries, in a ring in
//   shared memory with their values, and walks each 32 kept rows as a
//   chunk (broadcast reads for one lane a query). A chunk spread over the
//   window is near some of every query's rows rather than all of a few
//   queries' rows, and the weight loop waits for a chunk's fullest lane.
//   The box's d2, formed as sph_d2 forms a pair's from differences no
//   larger, never exceeds a query's (rounding is monotone), so a row it
//   drops weighs +0 for every query of the tile.
// - Out-of-radius pairs skipped exactly, near pairs queued. Beyond the
//   cutoff (u > 1) every kind's weight is +0, and adding +0 (or an FMA with
//   a +0 weight) leaves a sum as it was (sums start at +0 and never become
//   -0; the values are finite). A lane tests GROUP kept candidates against
//   d2_max (the wrapper's d2_threshold, the largest d2 whose u is at most
//   1 as sph_weight rounds it), stores each d2 in its own column of shared
//   memory and marks the near ones in a word, then weighs the marked ones
//   in order, with the kind a template argument: the weight loop reads no
//   candidate row.
// - The card filled. Blocks of WARPS warps, as many as fit on every SM;
//   a warp's first tile is its own index, the rest come from a counter.
//   One value channel is kept as a float, more in passes of 4 channels.
#include "common.cuh"
#include "sph_weight.cuh"

namespace {

constexpr int WARPS = 4;          // warps a block, each on tiles of its own
constexpr int THREADS = 32 * WARPS;
constexpr int CH = 64;            // a warp's ring of kept candidates
constexpr int GROUP = 32;         // a lane's candidates tested before it sums
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float cell_f(float p, float lo, float inv_side) {
  return (p - lo) * inv_side;
}

__device__ __forceinline__ int cell_coord(float f, int n) {
  // clamped to [-2, n + 1]: a cell outside the grid has no candidates, and
  // the clamp keeps far-away queries (the 999 sentinel) from overflowing
  return static_cast<int>(fminf(fmaxf(floorf(f), -2.f), static_cast<float>(n + 1)));
}

// 0..3: the quarter of its cell that f's fraction falls in
__device__ __forceinline__ int quarter(float f) {
  return min(static_cast<int>((f - floorf(f)) * 4.f), 3) & 3;
}

struct Grid {
  int nx, ny, nz;
  float lox, loy, loz, inv_side;
};

// keys[t] = (cell key << sub_bits) | sub for query row t = b Nq + i: the
// cell key ((b (nz + 4) + cz + 2) (ny + 4) + cy + 2) (nx + 4) + cx + 2 of
// its cell (cx, cy, cz) clamped to [-2, n + 1], and sub the Morton code of
// the quarters its position falls in along x, y, z (sub_bits 6), their
// halves (3) or nothing (0), so that sorted queries of one cell lie close.
__global__ void query_keys(const float* __restrict__ query, int total, int Nq,
                           Grid g, int sub_bits, int* __restrict__ keys,
                           int* __restrict__ ctr) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < 2) ctr[t] = 0;                   // make_tiles' and the walk's counts
  if (t >= total) return;
  const float* q = query + 3 * (size_t)t;
  const float fx = cell_f(q[0], g.lox, g.inv_side);
  const float fy = cell_f(q[1], g.loy, g.inv_side);
  const float fz = cell_f(q[2], g.loz, g.inv_side);
  const int cell = (((t / Nq) * (g.nz + 4) + cell_coord(fz, g.nz) + 2) *
                        (g.ny + 4) + cell_coord(fy, g.ny) + 2) *
                       (g.nx + 4) + cell_coord(fx, g.nx) + 2;
  const int qx = quarter(fx), qy = quarter(fy), qz = quarter(fz);
  // bits (x1 y1 z1 x0 y0 z0), the high bit of each quarter first
  const int sub = ((qx >> 1) << 5) | ((qy >> 1) << 4) | ((qz >> 1) << 3) |
                  ((qx & 1) << 2) | ((qy & 1) << 1) | (qz & 1);
  keys[t] = (cell << sub_bits) | (sub >> (6 - sub_bits));
}

// Over the sorted keys: a tile starts at every position p that begins a
// cell or an aligned block of 32 positions, and runs to the next such
// position. tiles[k] = (cell key, p, queries n, lanes a query 32 /
// next_pow2(n)) in no particular order; ctr[0] counts them.
__global__ void make_tiles(const int* __restrict__ keys, int total,
                           int sub_bits, int4* __restrict__ tiles,
                           int* __restrict__ ctr) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int k = keys[p] >> sub_bits;
  if (p % 32 != 0 && (keys[p - 1] >> sub_bits) == k) return;
  const int lim = min(total, (p / 32 + 1) * 32);
  int e = p + 1;
  while (e < lim && (keys[e] >> sub_bits) == k) ++e;
  const int n = e - p;
  const int g = n == 1 ? 1 : 1 << (32 - __clz(n - 1));
  tiles[atomicAdd(ctr, 1)] = make_int4(k, p, n, 32 / g);
}

struct Walk {
  const float* query;
  const float4* pts;
  const float* values;
  const int* cell_off;
  const long long* order;   // sorted position -> query row b Nq + i
  const int4* tiles;
  int* ctr;                 // [0] tiles made, [1] tiles taken
  float* out;
  float* den;
  int C, nx, ny, nz;
  float d2_max, inv_c2, k1, k2;
};

// A warp's shared memory: the ring of kept candidates' rows and NV values,
// each lane's d2 of one chunk, column by lane, the tile's sums [slot]
// [NV + 1], and the tile's window of rows.
template <int NV>
struct Stage {
  float4 pts[CH];
  float val[CH * NV];
  float qd[GROUP][32];
  float res[32 * (NV + 1)];
  int rs[9];                // the 9 rows' first CSR rows
  int wo[10];               // their offsets in the window, then its size
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// One chunk of n <= 32 kept candidates at ring positions hb .. hb + n - 1
// (hb is 0 or 32: chunks start on multiples of 32 and the ring holds 64):
// the lane takes chunk positions sub, sub + L, ... (32 is a multiple of
// L, so over the kept rows its positions are those = sub mod L, in order).
// It stores each d2 as sph_d2 forms it in its column of shared memory and
// marks the pairs within the cutoff (a NaN d2 counts as near: its weight
// is not skipped), then weighs the marked ones in order.
template <int KIND, int NV>
__device__ __forceinline__ void walk_chunk(const Walk& a, Stage<NV>& S,
                                           int hb, int n, int sub, int L,
                                           int lane, bool live, float qx,
                                           float qy, float qz,
                                           float (&num)[NV], float& den) {
  unsigned near = 0u;
  if (L == 1) {
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const float4 c = S.pts[hb + j];
      const float d2 = sph_d2(qx - c.x, qy - c.y, qz - c.z, c.w);
      S.qd[j][lane] = d2;
      near |= !(d2 > a.d2_max) ? 1u << j : 0u;
    }
  } else {
    for (int t = 0, j = sub; j < GROUP; ++t, j += L) {
      const float4 c = S.pts[hb + j];
      const float d2 = sph_d2(qx - c.x, qy - c.y, qz - c.z, c.w);
      S.qd[t][lane] = d2;
      near |= !(d2 > a.d2_max) ? 1u << t : 0u;
    }
  }
  // the chunk's rows past n, and a dead lane's, are not summed
  const int mine = live && sub < n ? (n - 1 - sub) / L + 1 : 0;
  near &= mine >= GROUP ? ~0u : (1u << mine) - 1u;
  while (near) {
    const int t = __ffs(near) - 1;
    near &= near - 1u;
    const float w = sph_weight(S.qd[t][lane], a.inv_c2, a.k1, a.k2, KIND);
    const int i = hb + sub + L * t;
    den += w;
#pragma unroll
    for (int j = 0; j < NV; ++j) num[j] = fmaf(w, S.val[i * NV + j], num[j]);
  }
}

// One tile on one warp, value channels cg .. cg + NV - 1 (den with every
// pass, the same sums each time).
template <int KIND, int NV>
__device__ __forceinline__ void walk_tile(const Walk& a, int4 tile,
                                          Stage<NV>& S, int lane, int cg) {
  const int L = tile.w, slot = lane / L, sub = lane & (L - 1);
  const bool live = slot < tile.z;
  const long long gq = a.order[tile.y + (live ? slot : 0)];
  int key = tile.x;
  const int cx = key % (a.nx + 4) - 2;
  key /= a.nx + 4;
  const int cy = key % (a.ny + 4) - 2;
  key /= a.ny + 4;
  const int cz = key % (a.nz + 4) - 2;
  const int b = key / (a.nz + 4);
  const float qx = a.query[3 * gq], qy = a.query[3 * gq + 1];
  const float qz = a.query[3 * gq + 2];
  // lane r < 9 reads the range of row r of the 3 x 3 (z, y) rows: cells
  // x-1 .. x+1 of that row (empty outside the grid)
  int rs = 0, re = 0;
  {
    const int z = cz - 1 + lane / 3, y = cy - 1 + lane % 3;
    const int x0 = max(cx - 1, 0), x1 = min(cx + 1, a.nx - 1);
    if (lane < 9 && x0 <= x1 && z >= 0 && z < a.nz && y >= 0 && y < a.ny) {
      const int* off = a.cell_off + (size_t)b * a.nx * a.ny * a.nz +
                       (z * a.ny + y) * a.nx;
      rs = __ldg(off + x0);
      re = __ldg(off + x1 + 1);
    }
  }
  __syncwarp();                            // the last tile's reads are done
  // the tile's box: every query's d2 to a candidate is at least the box's
  // (the same operations on differences no larger, and rounding is
  // monotone), so a candidate beyond d2_max of the box has the weight +0
  // for every query of the tile and is not kept
  const float bx0 = warp_min(qx), bx1 = warp_max(qx);
  const float by0 = warp_min(qy), by1 = warp_max(qy);
  const float bz0 = warp_min(qz), bz1 = warp_max(qz);

  float num[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) num[j] = 0.f;
  float den = 0.f;
  const int nv = min(NV, a.C - cg);
  // the window: the 9 rows' ranges one after another, W rows. Lane l
  // stages window positions nb l .. nb l + nb - 1, one a batch, so each
  // batch of 32 spans the whole window and a chunk mixes near and far
  // rows for every query alike (the weight loop waits for a chunk's
  // fullest lane)
  int incl = rs < re ? re - rs : 0;
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const int W = __shfl_sync(FULL, incl, 8);
  if (lane < 9) {
    S.rs[lane] = rs;
    S.wo[lane] = incl - (rs < re ? re - rs : 0);
  }
  if (lane == 0) S.wo[9] = W;
  __syncwarp();
  const int nb = (W + 31) >> 5;
  int wp = nb * lane, r = 0;
  while (r < 8 && wp >= S.wo[r + 1]) ++r;
  // the kept rows in a ring of CH: [head, tail), walked 32 at a time
  int head = 0, tail = 0;
  for (int bt = 0; bt < nb; ++bt, ++wp) {
    while (r < 8 && wp >= S.wo[r + 1]) ++r;
    {
      const bool in = wp < W;
      const int i = in ? S.rs[r] + (wp - S.wo[r]) : 0;
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
      float v[NV] = {};
      bool keep = false;
      if (in) {
        p = __ldg(a.pts + i);
        const float* vr = a.values + (size_t)i * a.C + cg;
#pragma unroll
        for (int j = 0; j < NV; ++j) v[j] = j < nv ? __ldg(vr + j) : 0.f;
        const float tx = fmaxf(fmaxf(bx0 - p.x, p.x - bx1), 0.f);
        const float ty = fmaxf(fmaxf(by0 - p.y, p.y - by1), 0.f);
        const float tz = fmaxf(fmaxf(bz0 - p.z, p.z - bz1), 0.f);
        keep = !(sph_d2(tx, ty, tz, p.w) > a.d2_max);
      }
      const unsigned bal = __ballot_sync(FULL, keep);
      if (keep) {
        // kept rows in the batch's lane order
        const int dst = (tail + __popc(bal & ((1u << lane) - 1u))) & (CH - 1);
        S.pts[dst] = p;
#pragma unroll
        for (int j = 0; j < NV; ++j) S.val[dst * NV + j] = v[j];
      }
      tail += __popc(bal);
      if (tail - head >= GROUP) {
        __syncwarp();
        walk_chunk<KIND, NV>(a, S, head & (CH - 1), GROUP, sub, L, lane, live,
                             qx, qy, qz, num, den);
        head += GROUP;
        __syncwarp();                      // the chunk is read
      }
    }
  }
  __syncwarp();
  if (tail > head)
    walk_chunk<KIND, NV>(a, S, head & (CH - 1), tail - head, sub, L, lane,
                         live, qx, qy, qz, num, den);
  // a split query's L lanes: lane l adds lane l ^ o's sums, o = L/2 .. 1
  for (int o = L >> 1; o > 0; o >>= 1) {
    den += __shfl_xor_sync(FULL, den, o);
#pragma unroll
    for (int j = 0; j < NV; ++j) num[j] += __shfl_xor_sync(FULL, num[j], o);
  }
  // the tile's sums to shared memory; then its lanes divide the (query,
  // channel) pairs in turn, so no lane divides with its sums live (a
  // division's slow path is a call), and the writes of a query's channels
  // are contiguous
  float* const res = S.res;
  __syncwarp();
  if (live && sub == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) res[slot * (NV + 1) + j] = num[j];
    res[slot * (NV + 1) + NV] = den + 1e-6f;
  }
  __syncwarp();
  for (int i = lane; i < tile.z * nv; i += 32) {
    const int s = i / nv, j = i % nv;
    a.out[a.order[tile.y + s] * a.C + cg + j] =
        res[s * (NV + 1) + j] / res[s * (NV + 1) + NV];
  }
  if (cg == 0)
    for (int s = lane; s < tile.z; s += 32)
      a.den[a.order[tile.y + s]] = res[s * (NV + 1) + NV];
  __syncwarp();                            // res is read
}

// NV = 1 for one value channel, else 4 a pass (two passes for C > 4). A
// warp's first tile is its own index, the rest come from a counter.
template <int KIND, int NV>
__global__ void __launch_bounds__(THREADS) binned_walk(Walk a) {
  __shared__ Stage<NV> stage[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = a.ctr[0];
  for (int t = blockIdx.x * WARPS + warp; t < n_tiles;) {
    const int4 tile = a.tiles[t];
    for (int cg = 0; cg < a.C; cg += NV)
      walk_tile<KIND, NV>(a, tile, stage[warp], lane, cg);
    if (lane == 0) t = atomicAdd(a.ctr + 1, 1) + gridDim.x * WARPS;
    t = __shfl_sync(FULL, t, 0);
  }
}

template <int KIND, int NV>
cudaError_t walk(const Walk& a, int total, cudaStream_t st) {
  static int fill = 0;
  if (fill == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, binned_walk<KIND, NV>, THREADS, 0);
    fill = sms * (per_sm > 0 ? per_sm : 1);
  }
  // every tile holds a query: at most total tiles
  const int blocks = min(fill, (total + WARPS - 1) / WARPS);
  binned_walk<KIND, NV><<<blocks, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <int NV>
cudaError_t walk_kind(const Walk& a, int total, int kind, cudaStream_t st) {
  switch (kind) {
    case kBicubic: return walk<kBicubic, NV>(a, total, st);
    case kSpline1: return walk<kSpline1, NV>(a, total, st);
    case kLinear: return walk<kLinear, NV>(a, total, st);
    default: return walk<kExponential, NV>(a, total, st);
  }
}

}  // namespace

// Each query's walk-cell key (query_keys): keys [B * Nq] int32; zeroes ctr
// [2] int32 for binned_interp_f32.
extern "C" int binned_keys(const void* query, void* keys, void* ctr, int B,
                           int Nq, int nx, int ny, int nz, float lox,
                           float loy, float loz, float inv_side, int sub_bits,
                           void* stream) {
  const int total = B * Nq;
  const Grid g = {nx, ny, nz, lox, loy, loz, inv_side};
  query_keys<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), total, Nq, g, sub_bits,
      static_cast<int*>(keys), static_cast<int*>(ctr));
  return static_cast<int>(cudaGetLastError());
}

// Shapes the wrapper (ops/kernels/binned_interp.py) admits: B * Nq >= 1,
// 1 <= C <= 8, B * (nx + 4) (ny + 4) (nz + 4) 2^sub_bits < 2^31, B * M <
// 2^31, all tensors contiguous on one device; pts / values / cell_off are
// the sorted grid, keys the binned_keys keys (the same sub_bits) sorted
// (stable), order the sort's permutation (int64). Scratch: tiles [B * Nq]
// int4, ctr [2] int32 as binned_keys left it (zeroes).
extern "C" int binned_interp_f32(const void* query, const void* pts,
                                 const void* values, const void* cell_off,
                                 const void* order, const void* keys,
                                 void* tiles, void* ctr, void* out, void* den,
                                 int B, int Nq, int C, int nx, int ny, int nz,
                                 int sub_bits, float d2_max, float inv_c2,
                                 float k1, float k2, int kind, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int total = B * Nq;
  make_tiles<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const int*>(keys), total, sub_bits,
      static_cast<int4*>(tiles), static_cast<int*>(ctr));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Walk a = {static_cast<const float*>(query),
                  static_cast<const float4*>(pts),
                  static_cast<const float*>(values),
                  static_cast<const int*>(cell_off),
                  static_cast<const long long*>(order),
                  static_cast<const int4*>(tiles), static_cast<int*>(ctr),
                  static_cast<float*>(out), static_cast<float*>(den), C, nx,
                  ny, nz, d2_max, inv_c2, k1, k2};
  e = C == 1 ? walk_kind<1>(a, total, kind, st) : walk_kind<4>(a, total, kind, st);
  return static_cast<int>(e);
}
