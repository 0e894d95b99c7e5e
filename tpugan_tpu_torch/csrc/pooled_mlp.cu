// Grouped SharedMLP with train-mode BatchNorm and a neighbourhood max-pool,
// forward and backward; and the same stack with given affines (the eval-mode
// and norm-free form).
//
// Replaces tpugan_tpu/ops/pallas/pooled_mlp_kernel.py : pooled_mlp_bn_train
// and its custom VJP: the forward _bn_train_impl (passes _stats_kernel and
// _final_kernel) and the backward _bwd_pallas_bn (_tie_count_kernel,
// _bwd_stats_kernel, _bwd_apply_kernel). pooled_mlp_affine's forward (the
// final pass with given affines) and its backward _bwd_pallas_affine are
// the affine form below.
//
// Contract: table [R, C0] f32, R = B*M*ns rows, row r in neighbourhood
// r / ns; L <= 4 layers W_l [C_l, C_{l+1}]; slope s >= 0 of the leaky ReLU
// (0: ReLU). Per-channel vectors of every layer (a, b, mu, var, ivar, S1,
// S2) are packed one layer after another.
//   forward, train: for p = 0..L-1 over all R rows
//     z_p = x_p W_p, mu_p = E[z_p], var_p = E[z_p^2] - mu_p^2 (biased),
//     a_p = gamma_p / sqrt(max(var_p, 0) + eps), b_p = beta_p - mu_p a_p,
//     x_{p+1} = act(z_p a_p + b_p);  pooled = max over ns of x_L.
//   backward of pooled (cotangent g): the cotangent goes to every row that
//     equals the pooled value, split evenly over the ties (cnt). Then top
//     down, dpre_p = dx_{p+1} act'(pre_p), zhat_p = (z_p - mu_p) ivar_p,
//     S1_p = sum dpre_p = dbeta_p, S2_p = sum dpre_p zhat_p = dgamma_p,
//     dz_p = a_p (dpre_p - S1_p / R - zhat_p S2_p / R),
//     dW_p = x_p^T dz_p, dx_p = dz_p W_p^T, dtable = dx_0.
//   affine form: the forward's final pass with a_p, b_p given; its
//     backward dz_p = a_p dpre_p, da_p = sum dpre_p z_p, db_p = sum dpre_p,
//     dW_p and dx_p as above.
//
// What bounds the batch-norm form on the H100: operations. The spatial
// critic's first stage (4 x 1024 x 32 rows, 6 -> 64 -> 128) does 2 R mac
// = 2.25 GFLOP forward, 34 us at the 67 TFLOP/s of f32 FFMA (TF32 stays
// off), against a 3 MB table. Its layer outputs are larger (z_1: 67 MB,
// 20 us at 3.35 TB/s) but cost less to keep than to recompute: the TPU
// kernel never wrote an intermediate, recomputing the stack in each of its
// 2 L + 1 passes (and twice that in the backward) out of VMEM.
//
// Design of the batch-norm form: each layer's product is computed once in
// the forward and twice in the backward (dW and dx), on one register-tiled
// f32 GEMM block (product(), csrc/gemm_tile.cuh): a block owns a BM x BN output tile, 256
// threads each an (BM / 16) x (BN / 16) register tile (8 x 8 at 128 x 128),
// and walks the depth in slabs of 8, three in flight: cp.async copies slab
// k + 2 into shared memory (rows padded by 4 floats against bank
// conflicts) while slab k feeds 4 float4 reads per 64 FMAs a thread, so
// the copies hold no registers beside the accumulators. A is transformed
// where it lands (Src, Slab::transform): the forward's x_p = act(fmaf(
// z_{p-1}, a, b)), the backward's dz formula; each thread transforms the
// elements it copied, before the slab's one barrier. The stages take 25-38
// KB of shared memory per block whatever the depth (W at sa_pooling is
// 259 x 256, 265 KB). The epilogue goes through a shared product tile, so
// its global reads and writes are float4 and coalesced along the rows.
// Measured on the card (PERF.md): with the loads in registers and a
// runtime kind, each transform waited on its own loads in turn and the
// products ran at 8-20 TFLOP/s; slab depths of 4-32 and 1 or 2 blocks an
// SM moved nothing; the pipeline above brought every kernel to 0 spills at
// 2 blocks an SM.
//   forward (pmlp_bn_forward): pass p computes z_p once (rows_gemm), writes
//     it (the backward reads it), and adds each tile's column sums and sums
//     of squares into one partial per tile; bn_stats adds the partials in
//     a fixed order (col_sum). The last pass also keeps each neighbourhood's
//     max and min of z_{L-1}: a row tile holds whole neighbourhoods. act
//     and fmaf(., a, b) are non-decreasing in z for a >= 0 and
//     non-increasing for a < 0 (slope >= 0, rounding is monotone), so
//     max over ns of act(fmaf(z, a, b)) = act(fmaf(max z, a, b)) for a >= 0
//     and act(fmaf(min z, a, b)) for a < 0, bit for bit; pool_extremes
//     forms pooled once a, b are known. No pass recomputes the stack.
//   backward (pmlp_bn_backward): top_kernel counts the ties from the saved
//     z_{L-1} through the same act(fmaf(z, a, b)) expression that produced
//     pooled (so the extreme row always finds itself), and writes dpre_{L-1}
//     and its S1, S2 partials. Then per layer from the top: dW_q = x_q^T dz_q
//     (dw_gemm, fixed row ranges, one partial per block, added in block
//     order), dx_q = dz_q W_q^T (rows_gemm, W read transposed) whose
//     epilogue forms dpre_{q-1} and its S1, S2 partials; dz is the
//     prologue of both products.
//   Reductions over rows never use float atomics, whose order changes from
//   run to run: every partial sum has one owner and a fixed order.
//
// The affine form keeps the TPU kernel's recompute design (no path users
// run launches it): a block works on tiles of 32 rows (16 in the backward),
// each layer a [rows, Cin] x [Cin, Cout] product in which thread t owns
// column t % Cout, reading activations from shared memory and weights
// through L2; the tie pass and the apply pass recompute the stack through
// the same device function, so the tie mask (y == pooled) agrees.
#include "gemm_tile.cuh"
#include "reduce.cuh"

namespace {

constexpr int MAXL = 4;

__device__ __forceinline__ float act_grad(float pre, float slope) {
  return pre >= 0.f ? 1.f : slope;
}

// ------------------------------------------------------ batch-norm form

constexpr int ROW_TILE = 128;  // rows of a row-major product's tile

enum Epi { kStore = 0, kStats = 1, kDpre = 2 };

// out [R, N] = A [R, K] B [K, N] over row tiles of tile_rows rows (chunks of
// ROW_TILE), by epilogue:
//   kStore  out = the product (dtable);
//   kStats  out = z; part_u / part_v [tiles, N] = the tile's sums of z and
//           z^2; with zmax: each neighbourhood's max and min of z
//           ([R / ns, N]), tile_rows a multiple of ns;
//   kDpre   out = dpre = product * act'(fmaf(zp, a, b)) with zp, a, b (and
//           mu, ivar for zhat) of the layer below; parts: sums of dpre and
//           dpre zhat (S1, S2).
struct RowsArgs {
  Src A, B;
  int R, K, N, tile_rows, ns, epi;
  float* out;
  float* part_u;
  float* part_v;
  float* zmax;
  float* zmin;
  const float* zp;
  const float* pv[4];   // kDpre: a, b, mu, ivar of the layer below
  float slope;
};

// Shared memory of rows_gemm, in floats: the pipeline, over which a chunk's
// product tile [BM][BN + PAD] lies; then the column sums [2][RGS][BN];
// then the running extremes [2][nbh][BN] (ext).
template <int BN, bool BKC, int AKIND>
__host__ __device__ constexpr int rows_head() {
  return pipe_floats<ROW_TILE, BN, true, BKC, AKIND, kPlain>() >
                 ROW_TILE * (BN + PAD)
             ? pipe_floats<ROW_TILE, BN, true, BKC, AKIND, kPlain>()
             : ROW_TILE * (BN + PAD);
}

template <int BN, bool BKC, int AKIND>
__global__ void __launch_bounds__(THREADS, 2) rows_gemm(RowsArgs P) {
  constexpr int BM = ROW_TILE;
  using T = Tile<BM, BN>;
  constexpr int TM = T::TM, TN = T::TN, ZLD = BN + PAD;
  // the epilogue: thread (rg, cq) takes columns 4 cq .. 4 cq + 3 of the
  // tile's rows rg RG .. rg RG + RG - 1, so its accumulators are dead and
  // each global access is a float4, coalesced along the row
  constexpr int CQ = BN / 4, RGS = THREADS / CQ, RG = BM / RGS;
  extern __shared__ float sm[];
  const int tid = threadIdx.x, tx = tid % 16;
  const int tile = blockIdx.x, n0 = blockIdx.y * BN;
  const int t0 = tile * P.tile_rows, t1 = min(P.R, t0 + P.tile_rows);
  const bool ext = P.zmax != nullptr;
  const int nbh = ext ? P.tile_rows / P.ns : 0;
  float* const zt = sm;                    // [BM][ZLD]: a chunk's product
  float* const red = sm + rows_head<BN, BKC, AKIND>();   // [2][RGS][BN]
  float* const run = red + 2 * RGS * BN;   // [2][nbh][BN]: running max, min
  for (int i = tid; i < nbh * BN; i += THREADS) {
    run[i] = -CUDART_INF_F;
    run[nbh * BN + i] = CUDART_INF_F;
  }
  float tot_u = 0.f, tot_v = 0.f;          // thread t < BN: column n0 + t
  for (int c0 = t0; c0 < t1; c0 += BM) {
    {
      float acc[TM][TN];
      product<BM, BN, true, BKC, AKIND, kPlain>(P.A, t1, c0, P.B, P.B.rows, n0,
                                                0, P.K, sm, acc);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int g = 0; g < TN / 4; ++g)
          *reinterpret_cast<float4*>(zt + T::row(i) * ZLD + g * 64 + tx * 4) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]);
    }
    __syncthreads();
    // read here, not before the product, where they would hold registers
    const int cq = tid % CQ, rg = tid / CQ;
    const int n = n0 + 4 * cq;             // the epilogue's first column
    const bool full = P.N % 4 == 0 && n + 3 < P.N;
    float pa[4], pb[4], pm[4], pi[4];      // kDpre: the layer below's a, b, mu, ivar
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = P.epi == kDpre && n + u < P.N;
      pa[u] = in ? P.pv[0][n + u] : 0.f;
      pb[u] = in ? P.pv[1][n + u] : 0.f;
      pm[u] = in ? P.pv[2][n + u] : 0.f;
      pi[u] = in ? P.pv[3][n + u] : 0.f;
    }
    float su[4] = {0.f, 0.f, 0.f, 0.f}, sv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int rr = 0; rr < RG; ++rr) {
      const int lr = rg * RG + rr, r = c0 + lr;
      if (r >= t1) break;
      const float4 y4 = *reinterpret_cast<const float4*>(zt + lr * ZLD + 4 * cq);
      float y[4] = {y4.x, y4.y, y4.z, y4.w};
      const size_t o = (size_t)r * P.N + n;
      float zp[4] = {0.f, 0.f, 0.f, 0.f};
      if (P.epi == kDpre) {
        if (full) {
          const float4 v = *reinterpret_cast<const float4*>(P.zp + o);
          zp[0] = v.x;
          zp[1] = v.y;
          zp[2] = v.z;
          zp[3] = v.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) zp[u] = n + u < P.N ? P.zp[o + u] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (P.epi == kDpre) {
          y[u] *= act_grad(fmaf(zp[u], pa[u], pb[u]), P.slope);
          su[u] += y[u];
          sv[u] = fmaf(y[u], (zp[u] - pm[u]) * pi[u], sv[u]);
        } else if (P.epi == kStats) {
          su[u] += y[u];
          sv[u] = fmaf(y[u], y[u], sv[u]);
        }
      }
      if (full) {
        *reinterpret_cast<float4*>(P.out + o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n + u < P.N) P.out[o + u] = y[u];
      }
    }
    if (P.epi != kStore) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        red[rg * BN + 4 * cq + u] = su[u];
        red[(RGS + rg) * BN + 4 * cq + u] = sv[u];
      }
    }
    __syncthreads();
    if (P.epi != kStore && tid < BN)
      for (int y = 0; y < RGS; ++y) {
        tot_u += red[y * BN + tid];
        tot_v += red[(RGS + y) * BN + tid];
      }
    if (ext) {
      const int c1 = min(t1, c0 + BM);
      const int j0 = (c0 - t0) / P.ns, j1 = (c1 - 1 - t0) / P.ns;
      for (int p = tid; p < (j1 - j0 + 1) * BN; p += THREADS) {
        const int j = j0 + p / BN, col = p % BN;
        const int lo = max(c0, t0 + j * P.ns), hi = min(c1, t0 + (j + 1) * P.ns);
        float mx = run[j * BN + col], mn = run[(nbh + j) * BN + col];
        for (int r = lo; r < hi; ++r) {
          const float v = zt[(r - c0) * ZLD + col];
          mx = fmaxf(mx, v);
          mn = fminf(mn, v);
        }
        run[j * BN + col] = mx;
        run[(nbh + j) * BN + col] = mn;
      }
    }
    __syncthreads();                       // red and zt are read
  }
  if (ext) {
    const int ctr0 = t0 / P.ns, nc = (t1 - t0) / P.ns;
    for (int p = tid; p < nc * BN; p += THREADS) {
      const int j = p / BN, c = n0 + p % BN;
      if (c >= P.N) continue;
      P.zmax[(size_t)(ctr0 + j) * P.N + c] = run[p];
      P.zmin[(size_t)(ctr0 + j) * P.N + c] = run[nbh * BN + p];
    }
  }
  if (P.epi != kStore && tid < BN && n0 + tid < P.N) {
    P.part_u[(size_t)tile * P.N + n0 + tid] = tot_u;
    P.part_v[(size_t)tile * P.N + n0 + tid] = tot_v;
  }
}

// pooled = act(fmaf(a >= 0 ? zmax : zmin, a, b)) over [n_out / N, N].
__global__ void pool_extremes(const float* __restrict__ zmax,
                              const float* __restrict__ zmin,
                              const float* __restrict__ a,
                              const float* __restrict__ b, int n_out, int N,
                              float slope, float* __restrict__ pooled) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int c = i % N;
  const float av = a[c];
  pooled[i] = act(fmaf(av >= 0.f ? zmax[i] : zmin[i], av, b[c]), slope);
}

// The top layer's dpre from the saved z [R, N] and its S1, S2 partials per
// row tile of tile_rows rows (whole neighbourhoods). Thread t works on
// column t % N of every (256 / N)-th neighbourhood of the tile.
struct TopArgs {
  const float* z;
  const float* a;
  const float* b;
  const float* mu;
  const float* ivar;
  const float* pooled;
  const float* g;
  float* dpre;
  float* part_u;
  float* part_v;
  int R, ns, N, tile_rows;
  float slope;
};

__global__ void __launch_bounds__(THREADS) top_kernel(TopArgs P) {
  __shared__ float red[2 * THREADS];
  const int G = THREADS / P.N, g = threadIdx.x / P.N, c = threadIdx.x % P.N;
  const int tile = blockIdx.x, t0 = tile * P.tile_rows;
  const int t1 = min(P.R, t0 + P.tile_rows);
  const int ctr0 = t0 / P.ns, nc = (t1 - t0) / P.ns;
  float su = 0.f, sv = 0.f;
  if (g < G) {
    const float a = P.a[c], b = P.b[c], mu = P.mu[c], iv = P.ivar[c];
    for (int j = g; j < nc; j += G) {
      const size_t k = (size_t)(ctr0 + j) * P.N + c;
      const float ref = P.pooled[k];
      const int r0 = t0 + j * P.ns, r1 = r0 + P.ns;
      float cnt = 0.f;
      for (int r = r0; r < r1; ++r)
        cnt += act(fmaf(P.z[(size_t)r * P.N + c], a, b), P.slope) == ref ? 1.f
                                                                       : 0.f;
      const float share = P.g[k] / cnt;
      for (int r = r0; r < r1; ++r) {
        const size_t o = (size_t)r * P.N + c;
        const float z = P.z[o];
        const float pre = fmaf(z, a, b);
        const float d =
            act(pre, P.slope) == ref ? share * act_grad(pre, P.slope) : 0.f;
        su += d;
        sv = fmaf(d, (z - mu) * iv, sv);
        P.dpre[o] = d;
      }
    }
  }
  red[threadIdx.x] = su;
  red[THREADS + threadIdx.x] = sv;
  __syncthreads();
  if (threadIdx.x < P.N) {
    float u = 0.f, v = 0.f;
    for (int y = 0; y < G; ++y) {
      u += red[y * P.N + threadIdx.x];
      v += red[THREADS + y * P.N + threadIdx.x];
    }
    P.part_u[(size_t)tile * P.N + threadIdx.x] = u;
    P.part_v[(size_t)tile * P.N + threadIdx.x] = v;
  }
}

// Columns of a product's tile for an output width n: 64 or 128, whichever
// pads n less (128 on a tie). launch_plan in ops/kernels/pooled_mlp.py
// mirrors this rule and the shared-memory sizes below.
int tile_width(int n) {
  const int p64 = (n + 63) / 64 * 64, p128 = (n + 127) / 128 * 128;
  return n <= 64 || p64 < p128 ? 64 : 128;
}

template <int BN, bool BKC, int AKIND>
cudaError_t rows_go(const RowsArgs& P, dim3 grid, cudaStream_t st) {
  const int rgs = THREADS / (BN / 4);
  const size_t floats = rows_head<BN, BKC, AKIND>() + 2 * rgs * BN +
                        (P.zmax != nullptr ? 2 * (P.tile_rows / P.ns) * BN : 0);
  const size_t smem = floats * sizeof(float);
  static const cudaError_t e = allow_smem(rows_gemm<BN, BKC, AKIND>, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  rows_gemm<BN, BKC, AKIND><<<grid, THREADS, smem, st>>>(P);
  return cudaGetLastError();
}

// The forward's products (A: the table, or act of the layer below's z; B:
// W) or, with bkc, the backward's dx = dz W^T (A: dz; B: W read
// transposed).
cudaError_t rows_launch(const RowsArgs& P, bool bkc, int akind,
                        cudaStream_t st) {
  const int bn = tile_width(P.N);
  const dim3 grid((P.R + P.tile_rows - 1) / P.tile_rows, (P.N + bn - 1) / bn);
  if (bkc)
    return bn == 64 ? rows_go<64, true, kDz>(P, grid, st)
                    : rows_go<128, true, kDz>(P, grid, st);
  if (akind == kAct)
    return bn == 64 ? rows_go<64, false, kAct>(P, grid, st)
                    : rows_go<128, false, kAct>(P, grid, st);
  return bn == 64 ? rows_go<64, false, kPlain>(P, grid, st)
                  : rows_go<128, false, kPlain>(P, grid, st);
}

template <int BM, int BN, int AKIND>
cudaError_t dw_go(const DwArgs& P, dim3 grid, cudaStream_t st) {
  const size_t smem =
      pipe_floats<BM, BN, false, false, AKIND, kDz>() * sizeof(float);
  static const cudaError_t e = allow_smem(dw_gemm<BM, BN, AKIND, kDz>, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  dw_gemm<BM, BN, AKIND, kDz><<<grid, THREADS, smem, st>>>(P);
  return cudaGetLastError();
}

template <int AKIND>
cudaError_t dw_tiles(const DwArgs& P, cudaStream_t st) {
  const int bm = tile_width(P.M), bn = tile_width(P.N);
  const dim3 grid((P.M + bm - 1) / bm, (P.N + bn - 1) / bn,
                  (P.R + P.split_rows - 1) / P.split_rows);
  if (bm == 64)
    return bn == 64 ? dw_go<64, 64, AKIND>(P, grid, st)
                    : dw_go<64, 128, AKIND>(P, grid, st);
  return bn == 64 ? dw_go<128, 64, AKIND>(P, grid, st)
                  : dw_go<128, 128, AKIND>(P, grid, st);
}

// dW partials (A: the table, or act of the layer below's z; B: dz).
cudaError_t dw_launch(const DwArgs& P, int akind, cudaStream_t st) {
  return akind == kAct ? dw_tiles<kAct>(P, st) : dw_tiles<kPlain>(P, st);
}

Src plain_src(const void* p, int rows, int chans) {
  Src s = {};
  s.p = static_cast<const float*>(p);
  s.rows = rows;
  s.chans = chans;
  return s;
}

// Layer l's input: the table (kPlain) for l == 0, else act(fmaf(z, a, b))
// of layer l - 1's z (kAct).
Src input_src(int l, const void* table, const void* const* z, const float* a,
              const float* b, int rows, int chans, float slope) {
  Src s = plain_src(l == 0 ? table : z[l - 1], rows, chans);
  s.v[0] = a;
  s.v[1] = b;
  s.slope = slope;
  return s;
}

// mu, var, ivar, a, b of one layer from per-tile sums and sums of squares.
__global__ void __launch_bounds__(RX * RY)
bn_stats(const float* __restrict__ part_s, const float* __restrict__ part_q,
         int nblk, int n, double count, const float* __restrict__ gamma,
         const float* __restrict__ beta, float eps, float* mu, float* var,
         float* ivar, float* a, float* b) {
  __shared__ double red[RY][RX];
  const double s = col_sum(part_s, nblk, n, red);
  const double q = col_sum(part_q, nblk, n, red);
  const int o = blockIdx.x * RX + threadIdx.x;
  if (threadIdx.y != 0 || o >= n) return;
  const double m = s / count;
  const float mf = (float)m;
  const float vf = (float)(q / count - m * m);
  const float iv = 1.f / sqrtf(fmaxf(vf, 0.f) + eps);
  const float af = gamma[o] * iv;
  mu[o] = mf;
  var[o] = vf;
  ivar[o] = iv;
  a[o] = af;
  b[o] = beta[o] - mf * af;
}

struct Layers {
  int tot;
  int hoff[MAXL];     // offset of layer l's channels in a packed vector
};

Layers layers(int L, const int* c) {
  Layers Y = {};
  for (int l = 0; l < L; ++l) {
    Y.hoff[l] = Y.tot;
    Y.tot += c[l + 1];
  }
  return Y;
}

// ------------------------------------------------------------- affine form

constexpr int FWD_ROWS = 32;
constexpr int BWD_ROWS = 16;

struct Stack {
  int L;
  int c[MAXL + 1];     // widths: c[0] the table's, c[l + 1] layer l's output
  int woff[MAXL];      // offset of W_l in the packed weights
  int hoff[MAXL];      // offset of layer l's channels in a packed vector
  int cmax;            // widest of c[0..L]
  float slope;
  const float* W;
  const float* a;
  const float* b;
};

// For every output (r, o), r < RT and o < n, calls epi(r, o, acc) with
//   acc = sum_{j < k} A[r * lda + j] * B(j, o)   (one fmaf chain, j from 0)
// where B(j, o) = W[j * n + o], or W[o * k + j] when TRANS. A thread owns
// column o of a chunk of 256 columns for rows g, g + G, ... (G = 256 / n).
template <int RT, bool TRANS, typename Epi>
__device__ __forceinline__ void tile_product(const float* A, int lda, int k,
                                             const float* __restrict__ W,
                                             int n, Epi epi) {
  for (int o0 = 0; o0 < n; o0 += THREADS) {
    const int cols = min(THREADS, n - o0);
    const int G = THREADS / cols;
    const int g = threadIdx.x / cols;
    const int o = o0 + threadIdx.x % cols;
    if (g >= G) continue;
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.f;
    for (int j = 0; j < k; ++j) {
      const float w = TRANS ? __ldg(W + (size_t)o * k + j)
                            : __ldg(W + (size_t)j * n + o);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = g + i * G;
        if (r < RT) acc[i] = fmaf(A[r * lda + j], w, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = g + i * G;
      if (r < RT) epi(r, o, acc[i]);
    }
  }
}

// Y = act(X W_l a_l + b_l) for one tile; Z (when given) keeps X W_l.
template <int RT>
__device__ __forceinline__ void layer_fwd(const Stack& S, int l, const float* X,
                                          float* Y, float* Z) {
  const int cin = S.c[l], cout = S.c[l + 1];
  const float* a = S.a + S.hoff[l];
  const float* b = S.b + S.hoff[l];
  const float slope = S.slope;
  tile_product<RT, false>(X, cin, cin, S.W + S.woff[l], cout,
                          [&](int r, int o, float z) {
                            if (Z != nullptr) Z[r * cout + o] = z;
                            Y[r * cout + o] =
                                act(fmaf(z, __ldg(a + o), __ldg(b + o)), slope);
                          });
}

// X[r][c] = table row row0 + r (zero past row R).
template <int RT>
__device__ __forceinline__ void load_rows(const float* __restrict__ table,
                                          int R, int c0, int row0, float* X) {
  const size_t base = (size_t)row0 * c0;
  for (int i = threadIdx.x; i < RT * c0; i += THREADS)
    X[i] = row0 + i / c0 < R ? table[base + i] : 0.f;
}

// mode 0: pooled = max over each neighbourhood of x_L.
// mode 1: cnt = number of the neighbourhood's rows equal to pooled.
// A block owns TM whole neighbourhoods and walks their rows in tiles.
__global__ void __launch_bounds__(THREADS)
pool_kernel(Stack S, const float* __restrict__ table, int R, int ns, int TM,
            int mode, float* __restrict__ pooled, float* __restrict__ cnt) {
  constexpr int RT = FWD_ROWS;
  extern __shared__ float sm[];
  float* buf[2] = {sm, sm + RT * S.cmax};
  float* run = sm + 2 * RT * S.cmax;       // [TM, cout]
  const int cout = S.c[S.L];
  const int nctr = R / ns;
  const int ctr0 = blockIdx.x * TM;
  const int nc = min(TM, nctr - ctr0);
  for (int i = threadIdx.x; i < nc * cout; i += THREADS)
    run[i] = mode == 0 ? -CUDART_INF_F : 0.f;
  const int row_end = (ctr0 + nc) * ns;
  for (int row0 = ctr0 * ns; row0 < row_end; row0 += RT) {
    __syncthreads();
    load_rows<RT>(table, row_end, S.c[0], row0, buf[0]);
    __syncthreads();
    int cur = 0;
    for (int l = 0; l < S.L; ++l) {
      layer_fwd<RT>(S, l, buf[cur], buf[cur ^ 1], nullptr);
      __syncthreads();
      cur ^= 1;
    }
    const float* Y = buf[cur];
    for (int i = threadIdx.x; i < nc * cout; i += THREADS) {
      const int j = i / cout, o = i % cout;
      const int lo = max(row0, (ctr0 + j) * ns);
      const int hi = min(row0 + RT, (ctr0 + j + 1) * ns);
      float v = run[i];
      if (mode == 0) {
        for (int r = lo; r < hi; ++r) v = fmaxf(v, Y[(r - row0) * cout + o]);
      } else {
        const float ref = pooled[(size_t)ctr0 * cout + i];
        for (int r = lo; r < hi; ++r)
          v += Y[(r - row0) * cout + o] == ref ? 1.f : 0.f;
      }
      run[i] = v;
    }
  }
  __syncthreads();
  float* out = mode == 0 ? pooled : cnt;
  for (int i = threadIdx.x; i < nc * cout; i += THREADS)
    out[(size_t)ctr0 * cout + i] = run[i];
}

// The affine form's backward: one kernel that also held the batch-norm
// form's passes before that form had the kernels above; it runs with bn = 0
// and stop = -1, so those paths no longer run. A copy without them measured
// slower on the same inputs (3.77 against 3.47 ms at sa_0 [4, 1024, 32, 6]
// 64 -> 128, 0.69 against 0.53 at group_all [4, 1, 128, 259] 256 -> 256;
// NVIDIA H100 80GB HBM3, 700.00 W): the compiler lays the same affine code
// out otherwise.
// Per-thread sums (column t % n, rows t / n + k G) -> one value per column,
// added over the row groups in order.
__device__ __forceinline__ void block_sums(float s, float q, int n,
                                           float* red, float* out_s,
                                           float* out_q) {
  red[threadIdx.x] = s;
  red[THREADS + threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.x < n) {
    const int G = THREADS / n;
    float ss = 0.f, qq = 0.f;
    for (int g = 0; g < G; ++g) {
      ss += red[g * n + threadIdx.x];
      qq += red[THREADS + g * n + threadIdx.x];
    }
    out_s[blockIdx.x * n + threadIdx.x] = ss;
    out_q[blockIdx.x * n + threadIdx.x] = qq;
  }
}

// Backward over the block's tiles. stop >= 0: partial S1, S2 of layer
// stop (the layers above it use their finished S1, S2). stop < 0: dtable
// rows and the block's partial dW of every layer, at dw_part + blockIdx.x *
// pstride. bn == 0 (the affine form; mu, ivar, s1, s2 unused, stop < 0):
// also the block's partial da and db of every layer, packed per layer after
// the block's dW, at wtotal + hoff[l] and wtotal + htotal + hoff[l].
__global__ void __launch_bounds__(THREADS)
bwd_kernel(Stack S, const float* __restrict__ table, int R, int ns,
           const float* __restrict__ pooled, const float* __restrict__ gout,
           const float* __restrict__ cnt, const float* __restrict__ mu,
           const float* __restrict__ ivar, const float* __restrict__ s1,
           const float* __restrict__ s2, float ninv, int stop,
           float* __restrict__ part1, float* __restrict__ part2,
           float* __restrict__ dtable, float* __restrict__ dw_part,
           int wtotal, int htotal, int pstride, int bn) {
  constexpr int RT = BWD_ROWS;
  extern __shared__ float sm[];
  const int L = S.L;
  float* X[MAXL + 1];                      // X[l]: input of layer l; X[L]: output
  float* Z[MAXL];                          // Z[l] = X[l] W_l
  float* p = sm;
  for (int l = 0; l <= L; ++l) {
    X[l] = p;
    p += RT * S.c[l];
  }
  for (int l = 0; l < L; ++l) {
    Z[l] = p;
    p += RT * S.c[l + 1];
  }
  float* D = p;                            // cotangent of a layer's output
  float* DZ = D + RT * S.cmax;             // cotangent of its z
  float* red = DZ + RT * S.cmax;
  const float slope = S.slope;
  const int cL = S.c[L];
  float acc1 = 0.f, acc2 = 0.f;

  const int ntiles = (R + RT - 1) / RT;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * RT;
    __syncthreads();
    load_rows<RT>(table, R, S.c[0], row0, X[0]);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      layer_fwd<RT>(S, l, X[l], X[l + 1], Z[l]);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < RT * cL; i += THREADS) {
      const int row = row0 + i / cL, o = i % cL;
      float d = 0.f;
      if (row < R) {
        const size_t k = (size_t)(row / ns) * cL + o;
        if (X[L][i] == pooled[k]) d = gout[k] / cnt[k];
      }
      D[i] = d;
    }
    __syncthreads();
    for (int q = L - 1; q >= 0; --q) {
      const int n = S.c[q + 1], cin = S.c[q];
      const float* aq = S.a + S.hoff[q];
      const float* bq = S.b + S.hoff[q];
      float* dw = dw_part + (size_t)blockIdx.x * pstride;
      if (!bn) {
        // the affine form: dpre (kept in D for da, db), dz = a dpre
        for (int i = threadIdx.x; i < RT * n; i += THREADS) {
          const int o = i % n;
          float dpre = 0.f;
          if (row0 + i / n < R)
            dpre = D[i] * act_grad(fmaf(Z[q][i], aq[o], bq[o]), slope);
          D[i] = dpre;
          DZ[i] = aq[o] * dpre;
        }
        __syncthreads();
        for (int o = threadIdx.x; o < n; o += THREADS) {
          float sa = 0.f, sb = 0.f;
          for (int r = 0; r < RT; ++r) {
            sa = fmaf(D[r * n + o], Z[q][r * n + o], sa);
            sb += D[r * n + o];
          }
          dw[wtotal + S.hoff[q] + o] += sa;
          dw[wtotal + htotal + S.hoff[q] + o] += sb;
        }
        for (int i = threadIdx.x; i < cin * n; i += THREADS) {
          const int c = i / n, o = i % n;
          float acc = 0.f;
          for (int r = 0; r < RT; ++r)
            acc = fmaf(X[q][r * cin + c], DZ[r * n + o], acc);
          dw[S.woff[q] + i] += acc;
        }
        __syncthreads();                   // D is read; the product rewrites it
        tile_product<RT, true>(DZ, n, n, S.W + S.woff[q], cin,
                               [&](int r, int c, float v) { D[r * cin + c] = v; });
        __syncthreads();
        if (q == 0) {
          const int c0 = S.c[0];
          for (int i = threadIdx.x; i < RT * c0; i += THREADS)
            if (row0 + i / c0 < R) dtable[(size_t)row0 * c0 + i] = D[i];
        }
        continue;
      }
      const float* mq = mu + S.hoff[q];
      const float* iq = ivar + S.hoff[q];
      if (q == stop) {
        const int G = THREADS / n, g = threadIdx.x / n, o = threadIdx.x % n;
        if (g < G) {
          for (int r = g; r < RT; r += G) {
            if (row0 + r >= R) continue;
            const float z = Z[q][r * n + o];
            const float pre = fmaf(z, aq[o], bq[o]);
            const float dpre = D[r * n + o] * act_grad(pre, slope);
            const float zhat = (z - mq[o]) * iq[o];
            acc1 += dpre;
            acc2 = fmaf(dpre, zhat, acc2);
          }
        }
        break;
      }
      const float* s1q = s1 + S.hoff[q];
      const float* s2q = s2 + S.hoff[q];
      for (int i = threadIdx.x; i < RT * n; i += THREADS) {
        const int o = i % n;
        float dz = 0.f;
        if (row0 + i / n < R) {
          const float z = Z[q][i];
          const float pre = fmaf(z, aq[o], bq[o]);
          const float dpre = D[i] * act_grad(pre, slope);
          const float zhat = (z - mq[o]) * iq[o];
          dz = aq[o] * (dpre - s1q[o] * ninv - zhat * (s2q[o] * ninv));
        }
        DZ[i] = dz;
      }
      __syncthreads();
      if (stop < 0) {
        for (int i = threadIdx.x; i < cin * n; i += THREADS) {
          const int c = i / n, o = i % n;
          float acc = 0.f;
          for (int r = 0; r < RT; ++r)
            acc = fmaf(X[q][r * cin + c], DZ[r * n + o], acc);
          dw[S.woff[q] + i] += acc;
        }
      }
      tile_product<RT, true>(DZ, n, n, S.W + S.woff[q], cin,
                             [&](int r, int c, float v) { D[r * cin + c] = v; });
      __syncthreads();
      if (q == 0 && stop < 0) {
        const int c0 = S.c[0];
        for (int i = threadIdx.x; i < RT * c0; i += THREADS)
          if (row0 + i / c0 < R) dtable[(size_t)row0 * c0 + i] = D[i];
      }
    }
  }
  if (stop >= 0) {
    __syncthreads();
    block_sums(acc1, acc2, S.c[stop + 1], red, part1, part2);
  }
}

Stack make_stack(int L, const int* c, float slope, const void* W,
                 const void* a, const void* b) {
  Stack S;
  S.L = L;
  S.cmax = 0;
  int wo = 0, ho = 0;
  for (int l = 0; l <= MAXL; ++l) S.c[l] = l <= L ? c[l] : 0;
  for (int l = 0; l <= L; ++l) S.cmax = S.c[l] > S.cmax ? S.c[l] : S.cmax;
  for (int l = 0; l < MAXL; ++l) {
    S.woff[l] = wo;
    S.hoff[l] = ho;
    if (l < L) {
      wo += c[l] * c[l + 1];
      ho += c[l + 1];
    }
  }
  S.slope = slope;
  S.W = static_cast<const float*>(W);
  S.a = static_cast<const float*>(a);
  S.b = static_cast<const float*>(b);
  return S;
}

cudaError_t pool(const Stack& S, const float* table, int R, int ns, int mode,
                 float* pooled, float* cnt, cudaStream_t st) {
  const int TM = ns < FWD_ROWS ? FWD_ROWS / ns : 1;
  const int nctr = R / ns;
  const size_t smem =
      sizeof(float) * (2 * FWD_ROWS * S.cmax + TM * S.c[S.L]);
  cudaError_t e = allow_smem(pool_kernel, smem);
  if (e != cudaSuccess) return e;
  pool_kernel<<<(nctr + TM - 1) / TM, THREADS, smem, st>>>(S, table, R, ns, TM,
                                                           mode, pooled, cnt);
  return cudaGetLastError();
}

}  // namespace

// Forward of the batch-norm form. In: table [R, c0], W[l] [c_l, c_{l+1}],
// gamma[l], beta[l]. Out: z[l] [R, c_{l+1}] (kept for the backward), stats
// = mu, var, ivar, a, b, each packed over the layers, pooled [R / ns, cL].
// Scratch: part, 2 * tiles * max(c_1..c_L) floats (tiles = ceil(R /
// tile_rows)); ext, 2 * (R / ns) * cL floats. tile_rows: a multiple of ns.
extern "C" int pmlp_bn_forward(const void* table, const void* const* W,
                               const void* const* gamma,
                               const void* const* beta, void* const* z,
                               void* stats, void* part, void* ext,
                               void* pooled, int R, int ns, int L,
                               const int* c, int tile_rows, float slope,
                               float eps, void* stream) {
  const Layers Y = layers(L, c);
  auto st = static_cast<cudaStream_t>(stream);
  float* mu = static_cast<float*>(stats);
  float* var = mu + Y.tot;
  float* ivar = var + Y.tot;
  float* a = ivar + Y.tot;
  float* b = a + Y.tot;
  const int tiles = (R + tile_rows - 1) / tile_rows;
  const int nout = (R / ns) * c[L];
  float* zmax = static_cast<float*>(ext);
  for (int p = 0; p < L; ++p) {
    const int K = c[p], N = c[p + 1], h = Y.hoff[p];
    const int hb = p > 0 ? Y.hoff[p - 1] : 0;
    RowsArgs P = {};
    P.A = input_src(p, table, z, a + hb, b + hb, R, K, slope);
    P.B = plain_src(W[p], K, N);
    P.R = R;
    P.K = K;
    P.N = N;
    P.tile_rows = tile_rows;
    P.ns = ns;
    P.epi = kStats;
    P.out = static_cast<float*>(z[p]);
    P.part_u = static_cast<float*>(part);
    P.part_v = P.part_u + (size_t)tiles * N;
    if (p == L - 1) {
      P.zmax = zmax;
      P.zmin = zmax + nout;
    }
    cudaError_t e = rows_launch(P, false, p == 0 ? kPlain : kAct, st);
    if (e != cudaSuccess) return (int)e;
    bn_stats<<<(N + RX - 1) / RX, dim3(RX, RY), 0, st>>>(
        P.part_u, P.part_v, tiles, N, (double)R,
        static_cast<const float*>(gamma[p]), static_cast<const float*>(beta[p]),
        eps, mu + h, var + h, ivar + h, a + h, b + h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int hL = Y.hoff[L - 1];
  pool_extremes<<<(nout + 255) / 256, 256, 0, st>>>(
      zmax, zmax + nout, a + hL, b + hL, nout, c[L], slope,
      static_cast<float*>(pooled));
  return (int)cudaGetLastError();
}

// Backward of pmlp_bn_forward. In: table, W[l], z[l], stats (as the
// forward wrote them), pooled, gout (the cotangent of pooled). Out: dtable
// [R, c0], dW[l] [c_l, c_{l+1}], s12 = S1 (dbeta) then S2 (dgamma), each
// packed over the layers. Scratch: dpre[l] [R, c_{l+1}]; part, 2 *
// max(ceil(R / tile_rows), ceil(R / 128)) * max(c_1..c_L) floats; dw_part,
// max over l of splits_l * c_l * c_{l+1} floats (splits_l = ceil(R /
// split_rows[l])).
extern "C" int pmlp_bn_backward(const void* table, const void* const* W,
                                const void* const* z, const void* stats,
                                const void* pooled, const void* gout,
                                void* const* dpre, void* part, void* dw_part,
                                void* dtable, void* const* dW, void* s12,
                                int R, int ns, int L, const int* c,
                                int tile_rows, const int* split_rows,
                                float slope, void* stream) {
  const Layers Y = layers(L, c);
  auto st = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(stats);
  const float* ivar = mu + 2 * Y.tot;
  const float* a = mu + 3 * Y.tot;
  const float* b = mu + 4 * Y.tot;
  float* s1 = static_cast<float*>(s12);
  float* s2 = s1 + Y.tot;
  float* pu = static_cast<float*>(part);
  const float ninv = 1.f / (float)R;
  cudaError_t e;

  const int top_tiles = (R + tile_rows - 1) / tile_rows;
  const int cL = c[L], hL = Y.hoff[L - 1];
  const TopArgs T = {static_cast<const float*>(z[L - 1]), a + hL, b + hL,
                     mu + hL, ivar + hL, static_cast<const float*>(pooled),
                     static_cast<const float*>(gout),
                     static_cast<float*>(dpre[L - 1]), pu,
                     pu + (size_t)top_tiles * cL, R, ns, cL, tile_rows, slope};
  top_kernel<<<top_tiles, THREADS, 0, st>>>(T);
  sum_cols_launch(T.part_u, top_tiles, cL, s1 + hL, st);
  sum_cols_launch(T.part_v, top_tiles, cL, s2 + hL, st);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int row_tiles = (R + ROW_TILE - 1) / ROW_TILE;
  for (int q = L - 1; q >= 0; --q) {
    const int C = c[q], N1 = c[q + 1], h = Y.hoff[q];
    const int hb = q > 0 ? Y.hoff[q - 1] : 0;
    Src dz = plain_src(dpre[q], R, N1);
    dz.z = static_cast<const float*>(z[q]);
    dz.v[0] = a + h;
    dz.v[1] = mu + h;
    dz.v[2] = ivar + h;
    dz.v[3] = s1 + h;
    dz.v[4] = s2 + h;
    dz.ninv = ninv;

    DwArgs D = {};
    D.A = input_src(q, table, z, a + hb, b + hb, R, C, slope);
    D.B = dz;
    D.R = R;
    D.M = C;
    D.N = N1;
    D.split_rows = split_rows[q];
    D.part = static_cast<float*>(dw_part);
    e = dw_launch(D, q == 0 ? kPlain : kAct, st);
    if (e != cudaSuccess) return (int)e;
    sum_cols_launch(D.part, (R + D.split_rows - 1) / D.split_rows, C * N1,
                    static_cast<float*>(dW[q]), st);

    RowsArgs P = {};
    P.A = dz;
    P.B = plain_src(W[q], C, N1);
    P.R = R;
    P.K = N1;
    P.N = C;
    P.tile_rows = ROW_TILE;
    P.ns = ns;
    P.slope = slope;
    if (q == 0) {
      P.epi = kStore;
      P.out = static_cast<float*>(dtable);
    } else {
      P.epi = kDpre;
      P.out = static_cast<float*>(dpre[q - 1]);
      P.zp = static_cast<const float*>(z[q - 1]);
      P.pv[0] = a + hb;
      P.pv[1] = b + hb;
      P.pv[2] = mu + hb;
      P.pv[3] = ivar + hb;
      P.part_u = pu;
      P.part_v = pu + (size_t)row_tiles * C;
    }
    e = rows_launch(P, true, kDz, st);
    if (e != cudaSuccess) return (int)e;
    if (q > 0) {
      sum_cols_launch(P.part_u, row_tiles, C, s1 + hb, st);
      sum_cols_launch(P.part_v, row_tiles, C, s2 + hb, st);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Forward of the affine form: pooled = max over ns of the stack with the
// given a, b (packed), weights packed one layer after another.
// c = (c0, ..., cL); R % ns == 0; every c[l + 1] <= 256.
extern "C" int pmlp_affine_forward(const void* table, const void* W,
                                   const void* a, const void* b, void* pooled,
                                   int R, int ns, int L, int c0, int c1,
                                   int c2, int c3, int c4, float slope,
                                   void* stream) {
  const int c[MAXL + 1] = {c0, c1, c2, c3, c4};
  const Stack S = make_stack(L, c, slope, W, a, b);
  return (int)pool(S, static_cast<const float*>(table), R, ns, 0,
                   static_cast<float*>(pooled), nullptr,
                   static_cast<cudaStream_t>(stream));
}

// Backward of the affine forward. In: table, W, a, b, pooled, gout. Out:
// dtable [R, c0] and grads = (dW packed, then da packed, then db packed).
// Scratch: cnt [R / ns, cL], dw_part of nblk * (size of grads) floats,
// ZEROED.
extern "C" int pmlp_backward_affine(const void* table, const void* W,
                                    const void* a, const void* b,
                                    const void* pooled, const void* gout,
                                    void* cnt, void* dw_part, void* dtable,
                                    void* grads, int R, int ns, int L, int c0,
                                    int c1, int c2, int c3, int c4,
                                    float slope, int nblk, void* stream) {
  const int c[MAXL + 1] = {c0, c1, c2, c3, c4};
  const Stack S = make_stack(L, c, slope, W, a, b);
  auto st = static_cast<cudaStream_t>(stream);
  auto tbl = static_cast<const float*>(table);
  auto pl = static_cast<const float*>(pooled);
  auto ct = static_cast<float*>(cnt);
  cudaError_t e = pool(S, tbl, R, ns, 1, const_cast<float*>(pl), ct, st);
  if (e != cudaSuccess) return (int)e;

  int wtotal = 0, htotal = 0, widths = 0;
  for (int l = 0; l < L; ++l) {
    wtotal += c[l] * c[l + 1];
    htotal += c[l + 1];
    widths += c[l] + c[l + 1];
  }
  widths += c[L];                          // X[0..L] and Z[0..L-1]
  const size_t smem =
      sizeof(float) * (BWD_ROWS * (widths + 2 * S.cmax) + 2 * THREADS);
  e = allow_smem(bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int pstride = wtotal + 2 * htotal;
  bwd_kernel<<<nblk, THREADS, smem, st>>>(
      S, tbl, R, ns, pl, static_cast<const float*>(gout), ct, nullptr, nullptr,
      nullptr, nullptr, 0.f, -1, nullptr, nullptr, static_cast<float*>(dtable),
      static_cast<float*>(dw_part), wtotal, htotal, pstride, 0);
  sum_parts<<<(pstride + 255) / 256, 256, 0, st>>>(
      static_cast<float*>(dw_part), nblk, pstride, static_cast<float*>(grads));
  return (int)cudaGetLastError();
}
