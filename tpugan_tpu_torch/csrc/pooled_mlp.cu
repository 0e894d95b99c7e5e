// Grouped SharedMLP with train-mode BatchNorm and a neighbourhood max-pool,
// forward and backward; and the same stack with given affines (the eval-mode
// and norm-free form).
//
// Replaces tpugan_tpu/ops/pallas/pooled_mlp_kernel.py : pooled_mlp_bn_train
// and its custom VJP: the forward _bn_train_impl (passes _stats_kernel and
// _final_kernel) and the backward _bwd_pallas_bn (_tie_count_kernel,
// _bwd_stats_kernel, _bwd_apply_kernel); and pooled_mlp_affine: its
// forward (_run_final_pass with given affines) and its backward
// _bwd_pallas_affine, the affine form below.
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
//   affine form: the forward with a_p, b_p given (no moments); its
//     backward dz_p = a_p dpre_p, da_p = sum dpre_p z_p, db_p = sum dpre_p,
//     dW_p and dx_p as above: the batch-norm backward with mu_p = 0,
//     ivar_p = 1 and no correction terms.
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
//   Moments over more rows than a call's (a batch split over ranks, the
//   port's twin of GSPMD's global-batch moments): pmlp_bn_forward_sums /
//   pmlp_bn_forward_finish and pmlp_bn_backward_stage run the same passes
//   a layer at a time, so that the caller can sum each layer's column sums
//   (forward, double) and its S1, S2 (backward) over the ranks between
//   them; mu, var and dz then take the summed sums and row count, while
//   dW, dgamma and dbeta stay sums over this call's rows.
//
// The affine form runs on the same blocks, a subset of the batch-norm
// form's work: pmlp_affine_forward computes each layer's z once
// (rows_gemm, no column sums), the top layer keeping each neighbourhood's
// max and min of z (under autograd every z is written for the backward;
// without it only the layers below the top, and their buffers alternate),
// and pool_extremes forms pooled with the given a, b as above. Its widths
// are bounded only by the column tiles (a grid column of 64 or 128 columns
// each) and the packed channel count (rows x width < 2^31): the action
// towers' 512-wide SA pooling is four column tiles of the same instances.
// What caps the other passes at 256 is top_kernel, a thread a column.
// pmlp_backward_affine is pmlp_bn_backward given mu = 0 and ivar = 1, whose
// S1 and S2 are then db and da, with dz = a dpre where the batch-norm form
// has its correction (the operand transform kScale in place of kDz, which
// reads no z). What bounds it is what bounds the batch-norm form.
#include "gemm_tile.cuh"

namespace {

constexpr int MAXL = 4;

__device__ __forceinline__ float act_grad(float pre, float slope) {
  return pre >= 0.f ? 1.f : slope;
}

// ---------------------------------------- the GEMM passes of both forms

constexpr int ROW_TILE = 128;  // rows of a row-major product's tile

enum Epi { kStore = 0, kStats = 1, kDpre = 2 };

// out [R, N] = A [R, K] B [K, N] over row tiles of tile_rows rows (chunks of
// ROW_TILE), by epilogue:
//   kStore  out = the product (dtable; the affine form's z, none when out
//           is null);
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
      if (P.out == nullptr) {
        // the affine form's top layer without autograd: extremes only
      } else if (full) {
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
// W) or, with bkc, the backward's dx = dz W^T (A: dz by akind, kDz or
// kScale; B: W read transposed).
cudaError_t rows_launch(const RowsArgs& P, bool bkc, int akind,
                        cudaStream_t st) {
  const int bn = tile_width(P.N);
  const dim3 grid((P.R + P.tile_rows - 1) / P.tile_rows, (P.N + bn - 1) / bn);
  if (bkc && akind == kScale)
    return bn == 64 ? rows_go<64, true, kScale>(P, grid, st)
                    : rows_go<128, true, kScale>(P, grid, st);
  if (bkc)
    return bn == 64 ? rows_go<64, true, kDz>(P, grid, st)
                    : rows_go<128, true, kDz>(P, grid, st);
  if (akind == kAct)
    return bn == 64 ? rows_go<64, false, kAct>(P, grid, st)
                    : rows_go<128, false, kAct>(P, grid, st);
  return bn == 64 ? rows_go<64, false, kPlain>(P, grid, st)
                  : rows_go<128, false, kPlain>(P, grid, st);
}

template <int BM, int BN, int AKIND, int BKIND>
cudaError_t dw_go(const DwArgs& P, dim3 grid, cudaStream_t st) {
  const size_t smem =
      pipe_floats<BM, BN, false, false, AKIND, BKIND>() * sizeof(float);
  static const cudaError_t e =
      allow_smem(dw_gemm<BM, BN, AKIND, BKIND>, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  dw_gemm<BM, BN, AKIND, BKIND><<<grid, THREADS, smem, st>>>(P);
  return cudaGetLastError();
}

template <int AKIND, int BKIND>
cudaError_t dw_tiles(const DwArgs& P, cudaStream_t st) {
  const int bm = tile_width(P.M), bn = tile_width(P.N);
  const dim3 grid((P.M + bm - 1) / bm, (P.N + bn - 1) / bn,
                  (P.R + P.split_rows - 1) / P.split_rows);
  if (bm == 64)
    return bn == 64 ? dw_go<64, 64, AKIND, BKIND>(P, grid, st)
                    : dw_go<64, 128, AKIND, BKIND>(P, grid, st);
  return bn == 64 ? dw_go<128, 64, AKIND, BKIND>(P, grid, st)
                  : dw_go<128, 128, AKIND, BKIND>(P, grid, st);
}

// dW partials (A: the table, or act of the layer below's z; B: dz by
// bkind, kDz or kScale).
cudaError_t dw_launch(const DwArgs& P, int akind, int bkind, cudaStream_t st) {
  if (bkind == kScale)
    return akind == kAct ? dw_tiles<kAct, kScale>(P, st)
                         : dw_tiles<kPlain, kScale>(P, st);
  return akind == kAct ? dw_tiles<kAct, kDz>(P, st)
                       : dw_tiles<kPlain, kDz>(P, st);
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

// mu, var, ivar, a, b of channel o from its column sum s and sum of squares
// q over count rows.
__device__ __forceinline__ void bn_moments(double s, double q, double count,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           float eps, float* mu, float* var,
                                           float* ivar, float* a, float* b,
                                           int o) {
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
  bn_moments(s, q, count, gamma, beta, eps, mu, var, ivar, a, b, o);
}

// The split forward's halves of bn_stats: bn_sums writes one layer's column
// sums and sums of squares, sums [2, n] in double (added in the same fixed
// order as bn_stats adds them), which the caller may sum over ranks;
// bn_finish forms the moments from them.
__global__ void __launch_bounds__(RX * RY)
bn_sums(const float* __restrict__ part_s, const float* __restrict__ part_q,
        int nblk, int n, double* __restrict__ sums) {
  __shared__ double red[RY][RX];
  const double s = col_sum(part_s, nblk, n, red);
  const double q = col_sum(part_q, nblk, n, red);
  const int o = blockIdx.x * RX + threadIdx.x;
  if (threadIdx.y != 0 || o >= n) return;
  sums[o] = s;
  sums[n + o] = q;
}

__global__ void bn_finish(const double* __restrict__ sums, int n,
                          double count, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float eps, float* mu,
                          float* var, float* ivar, float* a, float* b) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  bn_moments(sums[o], sums[n + o], count, gamma, beta, eps, mu, var, ivar, a,
             b, o);
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

// The packed moments of the batch-norm form's forward.
struct Moments {
  float *mu, *var, *ivar, *a, *b;
};

Moments moments(void* stats, int tot) {
  float* mu = static_cast<float*>(stats);
  return {mu, mu + tot, mu + 2 * tot, mu + 3 * tot, mu + 4 * tot};
}

// Layer p's product pass of the batch-norm forward: z_p = x_p W_p with its
// per-tile column sums and sums of squares in part; the last layer also
// keeps each neighbourhood's extremes of z in ext.
RowsArgs stats_pass(const void* table, const void* const* W, void* const* z,
                    const Moments& S, const Layers& Y, void* part, void* ext,
                    int R, int ns, int L, const int* c, int tile_rows,
                    float slope, int p) {
  const int K = c[p], N = c[p + 1];
  const int hb = p > 0 ? Y.hoff[p - 1] : 0;
  const int tiles = (R + tile_rows - 1) / tile_rows;
  const int nout = (R / ns) * c[L];
  RowsArgs P = {};
  P.A = input_src(p, table, z, S.a + hb, S.b + hb, R, K, slope);
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
    P.zmax = static_cast<float*>(ext);
    P.zmin = P.zmax + nout;
  }
  return P;
}

cudaError_t pool_top(const Moments& S, const Layers& Y, const void* ext,
                     void* pooled, int R, int ns, int L, const int* c,
                     float slope, cudaStream_t st) {
  const int nout = (R / ns) * c[L], hL = Y.hoff[L - 1];
  const float* zmax = static_cast<const float*>(ext);
  pool_extremes<<<(nout + 255) / 256, 256, 0, st>>>(
      zmax, zmax + nout, S.a + hL, S.b + hL, nout, c[L], slope,
      static_cast<float*>(pooled));
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
  const Moments S = moments(stats, Y.tot);
  const int tiles = (R + tile_rows - 1) / tile_rows;
  for (int p = 0; p < L; ++p) {
    const int N = c[p + 1], h = Y.hoff[p];
    const RowsArgs P = stats_pass(table, W, z, S, Y, part, ext, R, ns, L, c,
                                  tile_rows, slope, p);
    cudaError_t e = rows_launch(P, false, p == 0 ? kPlain : kAct, st);
    if (e != cudaSuccess) return (int)e;
    bn_stats<<<(N + RX - 1) / RX, dim3(RX, RY), 0, st>>>(
        P.part_u, P.part_v, tiles, N, (double)R,
        static_cast<const float*>(gamma[p]), static_cast<const float*>(beta[p]),
        eps, S.mu + h, S.var + h, S.ivar + h, S.a + h, S.b + h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)pool_top(S, Y, ext, pooled, R, ns, L, c, slope, st);
}

// pmlp_bn_forward split at each layer's moments, for moments over more rows
// than this call's (a batch split over ranks): pmlp_bn_forward_sums runs
// layer p's product (reading layer p - 1's a, b from stats) and writes
// sums [2, c_{p+1}] (double): its column sums and sums of squares over this
// call's R rows; pmlp_bn_forward_finish forms layer p's moments from sums
// over count rows (the caller may have summed them over ranks) and, after
// the last layer, pooled. Called for p = 0..L-1 in turn with the arguments
// of pmlp_bn_forward, they compute what it computes, bit for bit when sums
// are this call's own and count is R.
extern "C" int pmlp_bn_forward_sums(const void* table, const void* const* W,
                                    void* const* z, void* stats, void* part,
                                    void* ext, void* sums, int R, int ns,
                                    int L, const int* c, int tile_rows,
                                    float slope, int p, void* stream) {
  const Layers Y = layers(L, c);
  auto st = static_cast<cudaStream_t>(stream);
  const RowsArgs P = stats_pass(table, W, z, moments(stats, Y.tot), Y, part,
                                ext, R, ns, L, c, tile_rows, slope, p);
  const cudaError_t e = rows_launch(P, false, p == 0 ? kPlain : kAct, st);
  if (e != cudaSuccess) return (int)e;
  const int N = c[p + 1];
  bn_sums<<<(N + RX - 1) / RX, dim3(RX, RY), 0, st>>>(
      P.part_u, P.part_v, (R + tile_rows - 1) / tile_rows, N,
      static_cast<double*>(sums));
  return (int)cudaGetLastError();
}

extern "C" int pmlp_bn_forward_finish(const void* sums, double count,
                                      const void* gamma, const void* beta,
                                      void* stats, const void* ext,
                                      void* pooled, int R, int ns, int L,
                                      const int* c, float slope, float eps,
                                      int p, void* stream) {
  const Layers Y = layers(L, c);
  auto st = static_cast<cudaStream_t>(stream);
  const Moments S = moments(stats, Y.tot);
  const int N = c[p + 1], h = Y.hoff[p];
  bn_finish<<<(N + 127) / 128, 128, 0, st>>>(
      static_cast<const double*>(sums), N, count,
      static_cast<const float*>(gamma), static_cast<const float*>(beta), eps,
      S.mu + h, S.var + h, S.ivar + h, S.a + h, S.b + h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p < L - 1) return (int)e;
  return (int)pool_top(S, Y, ext, pooled, R, ns, L, c, slope, st);
}

namespace {

// Layer l's a, b, mu, ivar: packed in stats as pmlp_bn_forward writes
// them, or (the affine form, stats null) a[l], b[l] given, and mu = zeros,
// ivar = ones (at least as wide as every layer) for all layers.
struct Vecs {
  const float* stats;
  const void* const* a;
  const void* const* b;
  const float* zeros;
  const float* ones;
  int tot;
  const float* at(int k, int h, int l) const {
    if (l < 0) return nullptr;             // layer 0 reads the table
    if (stats != nullptr) return stats + k * tot + h;
    if (k == 3) return static_cast<const float*>(a[l]);
    if (k == 4) return static_cast<const float*>(b[l]);
    return k == 0 ? zeros : ones;
  }
};

// The backward of both forms (pmlp_bn_backward, pmlp_backward_affine);
// affine: dz = a dpre (kScale), with mu = 0 and ivar = 1 (zhat = z), so
// S1 is db and S2 da. Each pass writes its layer's S1, S2 (this call's
// rows) into s12; the batch-norm form's dz reads them from s12g (packed as
// s12) with ninv = 1 / the rows they sum over. stage < 0 runs every pass;
// stage L the top pass alone, stage q < L layer q's products alone (the
// split backward, pmlp_bn_backward_stage).
int backward(const void* table, const void* const* W, const void* const* z,
             const Vecs& V, const void* pooled, const void* gout,
             void* const* dpre, void* part, void* dw_part, void* dtable,
             void* const* dW, void* s12, const void* s12g, int R, int ns,
             int L, const int* c, int tile_rows, const int* split_rows,
             float slope, float ninv, bool affine, int stage, void* stream) {
  const Layers Y = layers(L, c);
  auto st = static_cast<cudaStream_t>(stream);
  enum { MU = 0, IVAR = 2, A = 3, B = 4 };
  float* s1 = static_cast<float*>(s12);
  float* s2 = s1 + Y.tot;
  const float* g1 = static_cast<const float*>(s12g);
  const float* g2 = g1 + Y.tot;
  float* pu = static_cast<float*>(part);
  const int dz_kind = affine ? kScale : kDz;
  cudaError_t e;

  if (stage < 0 || stage == L) {
    const int top_tiles = (R + tile_rows - 1) / tile_rows;
    const int cL = c[L], hL = Y.hoff[L - 1];
    const TopArgs T = {static_cast<const float*>(z[L - 1]),
                       V.at(A, hL, L - 1), V.at(B, hL, L - 1),
                       V.at(MU, hL, L - 1), V.at(IVAR, hL, L - 1),
                       static_cast<const float*>(pooled),
                       static_cast<const float*>(gout),
                       static_cast<float*>(dpre[L - 1]), pu,
                       pu + (size_t)top_tiles * cL, R, ns, cL, tile_rows,
                       slope};
    top_kernel<<<top_tiles, THREADS, 0, st>>>(T);
    sum_cols_launch(T.part_u, top_tiles, cL, s1 + hL, st);
    sum_cols_launch(T.part_v, top_tiles, cL, s2 + hL, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  const int row_tiles = (R + ROW_TILE - 1) / ROW_TILE;
  for (int q = L - 1; q >= 0; --q) {
    if (stage >= 0 && stage != q) continue;
    const int C = c[q], N1 = c[q + 1], h = Y.hoff[q];
    const int hb = q > 0 ? Y.hoff[q - 1] : 0;
    Src dz = plain_src(dpre[q], R, N1);
    dz.v[0] = V.at(A, h, q);
    if (!affine) {
      dz.z = static_cast<const float*>(z[q]);
      dz.v[1] = V.at(MU, h, q);
      dz.v[2] = V.at(IVAR, h, q);
      dz.v[3] = g1 + h;
      dz.v[4] = g2 + h;
      dz.ninv = ninv;
    }

    DwArgs D = {};
    D.A = input_src(q, table, z, V.at(A, hb, q - 1), V.at(B, hb, q - 1), R, C,
                    slope);
    D.B = dz;
    D.R = R;
    D.M = C;
    D.N = N1;
    D.split_rows = split_rows[q];
    D.part = static_cast<float*>(dw_part);
    e = dw_launch(D, q == 0 ? kPlain : kAct, dz_kind, st);
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
      P.pv[0] = V.at(A, hb, q - 1);
      P.pv[1] = V.at(B, hb, q - 1);
      P.pv[2] = V.at(MU, hb, q - 1);
      P.pv[3] = V.at(IVAR, hb, q - 1);
      P.part_u = pu;
      P.part_v = pu + (size_t)row_tiles * C;
    }
    e = rows_launch(P, true, dz_kind, st);
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

}  // namespace

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
  const Vecs V = {static_cast<const float*>(stats), nullptr, nullptr,
                  nullptr, nullptr, layers(L, c).tot};
  return backward(table, W, z, V, pooled, gout, dpre, part, dw_part, dtable,
                  dW, s12, s12, R, ns, L, c, tile_rows, split_rows, slope,
                  1.f / (float)R, false, -1, stream);
}

// pmlp_bn_backward in stages, for moments over more rows than this call's:
// stage L runs the top pass (S1, S2 of layer L - 1 into s12), then stage q
// = L - 1..0 layer q's products, whose dz reads S1, S2 of layer q from
// s12g (summed over count rows: the caller may have summed s12's over
// ranks) and which write S1, S2 of layer q - 1 into s12. The other
// arguments are pmlp_bn_backward's; with s12g equal to s12 and count R the
// stages compute what it computes, bit for bit.
extern "C" int pmlp_bn_backward_stage(const void* table, const void* const* W,
                                      const void* const* z, const void* stats,
                                      const void* pooled, const void* gout,
                                      void* const* dpre, void* part,
                                      void* dw_part, void* dtable,
                                      void* const* dW, void* s12,
                                      const void* s12g, int R, int ns, int L,
                                      const int* c, int tile_rows,
                                      const int* split_rows, float slope,
                                      int count, int stage, void* stream) {
  const Vecs V = {static_cast<const float*>(stats), nullptr, nullptr,
                  nullptr, nullptr, layers(L, c).tot};
  return backward(table, W, z, V, pooled, gout, dpre, part, dw_part, dtable,
                  dW, s12, s12g, R, ns, L, c, tile_rows, split_rows, slope,
                  1.f / (float)count, false, stage, stream);
}

// Forward of the affine form. In: table [R, c0], W[l] [c_l, c_{l+1}],
// a[l], b[l] [c_{l+1}]. Out: pooled [R / ns, cL]; z[l] [R, c_{l+1}] where
// z[l] is not null (the backward reads them; layer l + 1 reads z[l], so
// every z[l] below the top is given, and z[l] and z[l + 2] may share a
// buffer). Scratch: ext, 2 * (R / ns) * cL floats. tile_rows: a multiple
// of ns.
extern "C" int pmlp_affine_forward(const void* table, const void* const* W,
                                   const void* const* a, const void* const* b,
                                   void* const* z, void* ext, void* pooled,
                                   int R, int ns, int L, const int* c,
                                   int tile_rows, float slope, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int nout = (R / ns) * c[L];
  float* zmax = static_cast<float*>(ext);
  for (int p = 0; p < L; ++p) {
    RowsArgs P = {};
    P.A = input_src(p, table, z, p > 0 ? static_cast<const float*>(a[p - 1]) : nullptr,
                    p > 0 ? static_cast<const float*>(b[p - 1]) : nullptr, R,
                    c[p], slope);
    P.B = plain_src(W[p], c[p], c[p + 1]);
    P.R = R;
    P.K = c[p];
    P.N = c[p + 1];
    P.tile_rows = tile_rows;
    P.ns = ns;
    P.epi = kStore;
    P.out = static_cast<float*>(z[p]);
    if (p == L - 1) {
      P.zmax = zmax;
      P.zmin = zmax + nout;
    }
    const cudaError_t e = rows_launch(P, false, p == 0 ? kPlain : kAct, st);
    if (e != cudaSuccess) return (int)e;
  }
  pool_extremes<<<(nout + 255) / 256, 256, 0, st>>>(
      zmax, zmax + nout, static_cast<const float*>(a[L - 1]),
      static_cast<const float*>(b[L - 1]), nout, c[L], slope,
      static_cast<float*>(pooled));
  return (int)cudaGetLastError();
}

// Backward of pmlp_affine_forward: the arguments of pmlp_bn_backward, with
// a[l], b[l], and zeros and ones of at least max(c_1..c_L) floats, in
// place of stats, and z[l] the forward's; s12 = db then da, each packed
// over the layers.
extern "C" int pmlp_backward_affine(const void* table, const void* const* W,
                                    const void* const* z,
                                    const void* const* a,
                                    const void* const* b, const void* zeros,
                                    const void* ones, const void* pooled,
                                    const void* gout, void* const* dpre,
                                    void* part, void* dw_part, void* dtable,
                                    void* const* dW, void* s12, int R, int ns,
                                    int L, const int* c, int tile_rows,
                                    const int* split_rows, float slope,
                                    void* stream) {
  const Vecs V = {nullptr, a, b, static_cast<const float*>(zeros),
                  static_cast<const float*>(ones), layers(L, c).tot};
  return backward(table, W, z, V, pooled, gout, dpre, part, dw_part, dtable,
                  dW, s12, s12, R, ns, L, c, tile_rows, split_rows, slope,
                  1.f / (float)R, true, -1, stream);
}
