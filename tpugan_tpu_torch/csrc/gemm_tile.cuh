// A register-tiled f32 GEMM block for the H100, and the split-K product
// of weight gradients built on it: what csrc/pooled_mlp.cu and
// csrc/edgeconv.cu share (each .cu builds into a library of its own, so
// each holds its own instances of these templates).
//
// A block of THREADS threads owns a BM x BN output tile, each thread an
// (BM / 16) x (BN / 16) register tile, and walks the depth in slabs of BK,
// STAGES in flight through cp.async (product()); an operand may be
// transformed where it lands (Src, Slab). dw_gemm sums A^T B over a fixed
// range of rows into one partial per block; sum_cols adds such partials in
// a fixed order. No float atomics: every sum repeats from run to run.
#pragma once

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // every block of the sources that include this

__device__ __forceinline__ float act(float pre, float slope) {
  return pre >= 0.f ? pre : __fmul_rn(slope, pre);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The largest dynamic shared memory a block may ask for.
constexpr int SMEM_LIMIT = 232448;

constexpr int BK = 8;          // depth of a slab
constexpr int STAGES = 3;      // slabs in flight
constexpr int PAD = 4;         // floats past each slab row in shared memory

enum SrcKind { kPlain = 0, kAct = 1, kDz = 2 };

// A row-major [rows, chans] operand read at (row, chan) through a
// per-channel transform, 0 at row >= lim (lim <= rows) or chan >= chans:
//   kPlain  p[row, chan];
//   kAct    act(fmaf(p, v0, v1))                 (p = z of the layer below);
//   kDz     v0 (p - v3 ninv - (z - v1) v2 v4 ninv)  (p = dpre, v = a, mu,
//           ivar, S1, S2 of the layer).
// The kind is a template argument of the kernels (KIND below), so a slab's
// loads carry no branch on the values they fetch.
struct Src {
  const float* p;
  const float* z;
  const float* v[5];
  int rows, chans;
  float slope, ninv;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One BK-deep slab of an operand: X entries along the tile's own axis by BK
// along the depth, in shared memory as [BK][X + PAD] (kDz: a second such
// array holds the raw z). KCH: the depth is the operand's channel axis (a
// [X, BK] block of a row-major matrix, read along the channels and stored
// transposed); else its row axis. copy() issues this thread's PER
// asynchronous 4-byte copies (zero-filled outside), transform() applies the
// transform to the same elements once they have arrived, in place: no
// thread reads another's elements before the barrier that follows.
template <int X, bool KCH, int KIND>
struct Slab {
  static constexpr int PER = BK * X / THREADS;
  static constexpr int LD = X + PAD;
  static constexpr int FLOATS = (KIND == kDz ? 2 : 1) * BK * LD;

  __device__ __forceinline__ static void at(int i, int idx0, int k0, int& ix,
                                            int& kk, int& row, int& ch) {
    const int e = threadIdx.x + i * THREADS;
    if (KCH) {
      ix = e / BK;
      kk = e % BK;
      row = idx0 + ix;
      ch = k0 + kk;
    } else {
      kk = e / X;
      ix = e % X;
      row = k0 + kk;
      ch = idx0 + ix;
    }
  }
  __device__ __forceinline__ static void copy(const Src& s, int lim, int idx0,
                                              int k0, float* S) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int ix, kk, row, ch;
      at(i, idx0, k0, ix, kk, row, ch);
      const bool in = row < lim && ch < s.chans;
      const int o = in ? row * s.chans + ch : 0;   // rows * chans < 2^31
      cp_async4(S + kk * LD + ix, s.p + o, in);
      if (KIND == kDz) cp_async4(S + (BK + kk) * LD + ix, s.z + o, in);
    }
  }
  __device__ __forceinline__ static void transform(const Src& s, int lim,
                                                   int idx0, int k0, float* S) {
#pragma unroll
    for (int i = 0; i < (KIND == kPlain ? 0 : PER); ++i) {
      int ix, kk, row, ch;
      at(i, idx0, k0, ix, kk, row, ch);
      if (row >= lim || ch >= s.chans) continue;      // stays 0
      float& v = S[kk * LD + ix];
      if (KIND == kAct) {
        v = act(fmaf(v, __ldg(s.v[0] + ch), __ldg(s.v[1] + ch)), s.slope);
      } else {
        const float zhat =
            (S[(BK + kk) * LD + ix] - __ldg(s.v[1] + ch)) * __ldg(s.v[2] + ch);
        v = __ldg(s.v[0] + ch) * (v - __ldg(s.v[3] + ch) * s.ninv -
                                  zhat * (__ldg(s.v[4] + ch) * s.ninv));
      }
    }
  }
};

// A BM x BN tile over 256 threads: thread (ty, tx) = (t / 16, t % 16) owns
// rows (i / 4) 64 + 4 ty + i % 4 and columns (j / 4) 64 + 4 tx + j % 4.
template <int BM, int BN>
struct Tile {
  static constexpr int TM = BM / 16, TN = BN / 16;
  __device__ static __forceinline__ int row(int i) {
    return (i / 4) * 64 + (threadIdx.x / 16) * 4 + i % 4;
  }
  __device__ static __forceinline__ int col(int j) {
    return (j / 4) * 64 + (threadIdx.x % 16) * 4 + j % 4;
  }
};

// Shared memory of product(), in floats: STAGES slabs of A and B.
template <int BM, int BN, bool AK, bool BKC, int AKIND, int BKIND>
__host__ __device__ constexpr int pipe_floats() {
  return STAGES * (Slab<BM, AK, AKIND>::FLOATS + Slab<BN, BKC, BKIND>::FLOATS);
}

// acc = sum over k0 <= k < k1 of A(m0 + row, k) B(k, n0 + col): one fmaf
// chain per element, k ascending; A's and B's rows end at a_lim and b_lim.
// AK / BKC: the depth is A's / B's channel axis, AKIND / BKIND their
// transforms (Slab). STAGES slabs are in flight: slab k + STAGES - 1 is
// copied while slab k computes, so the copies take no registers and no
// instruction waits on them but the wait for slab k itself. One barrier a
// slab: it publishes slab k's transformed elements and tells that every
// thread has finished slab k - 1, whose buffer the next copy takes. The
// operands are read in place (kernel parameters), not copied: a copy would
// hold a Src in registers beside the 64 accumulators. Uses pipe_floats()
// floats at sm; starts and ends on a barrier, so the caller may reuse them
// before and after. ZERO false: the chains continue from the values in acc
// (a product whose depth runs over two operand pairs).
template <int BM, int BN, bool AK, bool BKC, int AKIND, int BKIND,
          bool ZERO = true>
__device__ __forceinline__ void product(const Src& A, int a_lim, int m0,
                                        const Src& B, int b_lim, int n0, int k0,
                                        int k1, float* sm,
                                        float (&acc)[BM / 16][BN / 16]) {
  using SA = Slab<BM, AK, AKIND>;
  using SB = Slab<BN, BKC, BKIND>;
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int STAGE = SA::FLOATS + SB::FLOATS;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int nk = (k1 - k0 + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (ZERO) acc[i][j] = 0.f;
  __syncthreads();
#pragma unroll 1
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) {
      SA::copy(A, a_lim, m0, k0 + st * BK, sm + st * STAGE);
      SB::copy(B, b_lim, n0, k0 + st * BK, sm + st * STAGE + SA::FLOATS);
    }
    cp_commit();
  }
  for (int it = 0; it < nk; ++it) {
    float* const sa = sm + (it % STAGES) * STAGE;
    float* const sb = sa + SA::FLOATS;
    const int k = k0 + it * BK;
    cp_wait<STAGES - 2>();
    SA::transform(A, a_lim, m0, k, sa);
    SB::transform(B, b_lim, n0, k, sb);
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < nk) {
      float* const na = sm + (nx % STAGES) * STAGE;
      SA::copy(A, a_lim, m0, k0 + nx * BK, na);
      SB::copy(B, b_lim, n0, k0 + nx * BK, na + SA::FLOATS);
    }
    cp_commit();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int j = 0; j < TM / 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(sa + kk * SA::LD + j * 64 + ty * 4);
        a[4 * j] = v.x;
        a[4 * j + 1] = v.y;
        a[4 * j + 2] = v.z;
        a[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(sb + kk * SB::LD + j * 64 + tx * 4);
        b[4 * j] = v.x;
        b[4 * j + 1] = v.y;
        b[4 * j + 2] = v.z;
        b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// part [split, M, N] = sum over the split's rows r of A(r, m) B(r, n):
// A = x [R, M], B = dz [R, N] (their transforms AKIND, BKIND); a split
// holds split_rows rows.
struct DwArgs {
  Src A, B;
  int R, M, N, split_rows;
  float* part;
};

template <int BM, int BN, int AKIND, int BKIND>
__global__ void __launch_bounds__(THREADS, 2) dw_gemm(DwArgs P) {
  using T = Tile<BM, BN>;
  extern __shared__ float sm[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int r0 = s * P.split_rows, r1 = min(P.R, r0 + P.split_rows);
  float acc[T::TM][T::TN];
  product<BM, BN, false, false, AKIND, BKIND>(P.A, r1, m0, P.B, r1, n0, r0,
                                              r1, sm, acc);
  float* out = P.part + (size_t)s * P.M * P.N;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + T::row(i);
    if (m >= P.M) continue;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      const int n = n0 + g * 64 + tx * 4;
      float* const o = out + (size_t)m * P.N + n;
      if (P.N % 4 == 0 && n + 3 < P.N) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n + u < P.N) o[u] = acc[i][4 * g + u];
      }
    }
  }
}

// Sums over the rows of per-tile partials [nblk, n] in a fixed order: block
// (RX, RY) takes RX columns; lane y adds partials y, y + RY, ... in double,
// then lane 0 adds the lanes in order.
constexpr int RX = 32, RY = 16;

__device__ __forceinline__ double col_sum(const float* __restrict__ part,
                                          int nblk, int n,
                                          double (*red)[RX]) {
  const int i = blockIdx.x * RX + threadIdx.x;
  double s = 0.0;
  if (i < n)
    for (int k = threadIdx.y; k < nblk; k += RY) s += part[(size_t)k * n + i];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0)
    for (int y = 1; y < RY; ++y) s += red[y][threadIdx.x];
  __syncthreads();
  return s;
}

// out = the column sums of part [nblk, n].
__global__ void __launch_bounds__(RX * RY)
sum_cols(const float* __restrict__ part, int nblk, int n,
         float* __restrict__ out) {
  __shared__ double red[RY][RX];
  const double s = col_sum(part, nblk, n, red);
  const int i = blockIdx.x * RX + threadIdx.x;
  if (threadIdx.y == 0 && i < n) out[i] = (float)s;
}

void sum_cols_launch(const float* part, int nblk, int n, float* out,
                     cudaStream_t st) {
  sum_cols<<<(n + RX - 1) / RX, dim3(RX, RY), 0, st>>>(part, nblk, n, out);
}

}  // namespace
