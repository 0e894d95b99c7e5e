// Grouped SharedMLP with train-mode BatchNorm and a neighbourhood max-pool,
// forward and backward, with no per-layer intermediate in device memory.
//
// Replaces tpugan_tpu/ops/pallas/pooled_mlp_kernel.py : pooled_mlp_bn_train
// and its custom VJP: the passes _stats_kernel and _final_kernel of the
// forward, _tie_count_kernel, _bwd_stats_kernel and _bwd_apply_kernel of
// _bwd_pallas_bn. The forward's final pass with given affines is
// pooled_mlp_affine's forward (eval-mode SetConvs); its backward
// (_bwd_pallas_affine) is the tie pass and the apply pass without the
// batch-norm terms.
//
// Contract: table [R, C0] f32, R = B*M*ns rows, row r in neighbourhood
// r / ns; L <= 4 layers W_l [C_l, C_{l+1}] packed one after another;
// slope s of the leaky ReLU (0: ReLU). Per-channel vectors of every layer
// (gamma, beta, a, b, mu, var, ivar, S1, S2) are packed the same way.
//   forward, train: for p = 0..L-1 over all R rows
//     z_p = x_p W_p, mu_p = E[z_p], var_p = E[z_p^2] - mu_p^2 (biased),
//     a_p = gamma_p / sqrt(max(var_p, 0) + eps), b_p = beta_p - mu_p a_p,
//     x_{p+1} = act(z_p a_p + b_p);  pooled = max over ns of x_L.
//   forward, affine: the same final pass with a_p, b_p given.
//   backward of pooled (cotangent g): the cotangent goes to every row that
//     equals the pooled value, split evenly over the ties (cnt). Then top
//     down, dpre_p = dx_{p+1} act'(pre_p), zhat_p = (z_p - mu_p) ivar_p,
//     S1_p = sum dpre_p = dbeta_p, S2_p = sum dpre_p zhat_p = dgamma_p,
//     dz_p = a_p (dpre_p - S1_p / R - zhat_p S2_p / R),
//     dW_p = x_p^T dz_p, dx_p = dz_p W_p^T, dtable = dx_0.
//   backward of the affine form: dz_p = a_p dpre_p, da_p = sum dpre_p z_p,
//     db_p = sum dpre_p, dW_p and dx_p as above.
//
// What bounds it on the H100: operations. The spatial critic's second stage
// (4 x 512 x 32 rows of 131 channels, 128 -> 128) recomputes its layers in
// every pass: 2 L + 1 passes in all, each about 2 R (C0 H1 + H1 H2)
// multiply-adds on the f32 cores, against a table read of a few MB.
//
// Design. A block works on tiles of 32 rows (16 in the backward, whose
// tile keeps every layer's input and pre-activation in shared memory).
// Each layer of a tile is a [rows, Cin] x [Cin, Cout] product: thread t
// owns column t % Cout for rows t / Cout, t / Cout + 256 / Cout, ...,
// reads the activations from shared memory as broadcasts and the weights
// through L2 (the last stage's weights, 527 KB, exceed shared memory). The
// product of an element is one fmaf chain over the input channels from 0,
// and every pass computes the layer stack through the same device
// function, so the final, tie-count and backward passes see bit-identical
// activations and the tie mask (y == pooled) agrees between them.
// Reductions over all rows never use float atomics, whose order changes
// from run to run: a block walks a fixed set of tiles and writes its own
// partial sums, and a second kernel adds the partials in block order. The
// max-pool runs in the block that owns the whole neighbourhood.
#include "common.cuh"
#include "reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXL = 4;
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

__device__ __forceinline__ float act(float pre, float slope) {
  return pre >= 0.f ? pre : __fmul_rn(slope, pre);
}

__device__ __forceinline__ float act_grad(float pre, float slope) {
  return pre >= 0.f ? 1.f : slope;
}

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

// Partial sum and sum of squares of z_p over the block's tiles.
__global__ void __launch_bounds__(THREADS)
stats_kernel(Stack S, const float* __restrict__ table, int R, int p,
             float* __restrict__ part_s, float* __restrict__ part_q) {
  constexpr int RT = FWD_ROWS;
  extern __shared__ float sm[];
  float* buf[2] = {sm, sm + RT * S.cmax};
  float* red = sm + 2 * RT * S.cmax;
  const int n = S.c[p + 1];
  float s = 0.f, q = 0.f;
  const int ntiles = (R + RT - 1) / RT;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * RT;
    __syncthreads();                       // the previous tile is read
    load_rows<RT>(table, R, S.c[0], row0, buf[0]);
    __syncthreads();
    int cur = 0;
    for (int l = 0; l < p; ++l) {
      layer_fwd<RT>(S, l, buf[cur], buf[cur ^ 1], nullptr);
      __syncthreads();
      cur ^= 1;
    }
    tile_product<RT, false>(buf[cur], S.c[p], S.c[p], S.W + S.woff[p], n,
                            [&](int r, int, float z) {
                              if (row0 + r < R) {
                                s += z;
                                q = fmaf(z, z, q);
                              }
                            });
  }
  __syncthreads();
  block_sums(s, q, n, red, part_s, part_q);
}

// mu, var, ivar, a, b of one layer from the blocks' partial sums.
__global__ void finalize_stats(const float* __restrict__ part_s,
                               const float* __restrict__ part_q, int nblk,
                               int n, double count,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, float eps,
                               float* mu, float* var, float* ivar, float* a,
                               float* b) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  double s = 0.0, q = 0.0;
  for (int k = 0; k < nblk; ++k) {
    s += part_s[(size_t)k * n + o];
    q += part_q[(size_t)k * n + o];
  }
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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

// Forward. train != 0: gamma, beta in; mu, var, ivar, a, b out (packed per
// layer); part is scratch of 2 * nblk * cmax floats. train == 0: a, b in
// (the affine form); gamma, beta, mu, var, ivar and part unused.
// c = (c0, ..., cL); R % ns == 0; every c[l + 1] <= 256.
extern "C" int pmlp_forward(const void* table, const void* W,
                            const void* gamma, const void* beta, void* a,
                            void* b, void* mu, void* var, void* ivar,
                            void* pooled, void* part, int R, int ns, int L,
                            int c0, int c1, int c2, int c3, int c4, float slope,
                            float eps, int train, int nblk, void* stream) {
  const int c[MAXL + 1] = {c0, c1, c2, c3, c4};
  const Stack S = make_stack(L, c, slope, W, a, b);
  auto st = static_cast<cudaStream_t>(stream);
  auto tbl = static_cast<const float*>(table);
  cudaError_t e;
  if (train) {
    float* ps = static_cast<float*>(part);
    float* pq = ps + (size_t)nblk * S.cmax;
    const size_t smem = sizeof(float) * (2 * FWD_ROWS * S.cmax + 2 * THREADS);
    e = allow_smem(stats_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    for (int p = 0; p < L; ++p) {
      const int n = c[p + 1], h = S.hoff[p];
      stats_kernel<<<nblk, THREADS, smem, st>>>(S, tbl, R, p, ps, pq);
      finalize_stats<<<(n + 127) / 128, 128, 0, st>>>(
          ps, pq, nblk, n, (double)R, static_cast<const float*>(gamma) + h,
          static_cast<const float*>(beta) + h, eps,
          static_cast<float*>(mu) + h, static_cast<float*>(var) + h,
          static_cast<float*>(ivar) + h, static_cast<float*>(a) + h,
          static_cast<float*>(b) + h);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)pool(S, tbl, R, ns, 0, static_cast<float*>(pooled), nullptr, st);
}

// Backward of the train-mode forward. In: table, W, a, b, mu, ivar, pooled,
// gout (the cotangent of pooled). Out: dtable [R, c0], dW (packed), s1 =
// dbeta and s2 = dgamma (packed). Scratch: cnt [R / ns, cL], part of
// 2 * nblk * cmax floats, dw_part of nblk * (packed W size) floats, ZEROED.
extern "C" int pmlp_backward(const void* table, const void* W, const void* a,
                             const void* b, const void* mu, const void* ivar,
                             const void* pooled, const void* gout, void* cnt,
                             void* s1, void* s2, void* part, void* dw_part,
                             void* dtable, void* dW, int R, int ns, int L,
                             int c0, int c1, int c2, int c3, int c4,
                             float slope, int nblk, void* stream) {
  const int c[MAXL + 1] = {c0, c1, c2, c3, c4};
  const Stack S = make_stack(L, c, slope, W, a, b);
  auto st = static_cast<cudaStream_t>(stream);
  auto tbl = static_cast<const float*>(table);
  auto pl = static_cast<const float*>(pooled);
  auto ct = static_cast<float*>(cnt);
  cudaError_t e = pool(S, tbl, R, ns, 1, const_cast<float*>(pl), ct, st);
  if (e != cudaSuccess) return (int)e;

  int wtotal = 0, widths = 0;
  for (int l = 0; l < L; ++l) {
    wtotal += c[l] * c[l + 1];
    widths += c[l] + c[l + 1];
  }
  widths += c[L];                          // X[0..L] and Z[0..L-1]
  const size_t smem =
      sizeof(float) * (BWD_ROWS * (widths + 2 * S.cmax) + 2 * THREADS);
  e = allow_smem(bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  float* p1 = static_cast<float*>(part);
  float* p2 = p1 + (size_t)nblk * S.cmax;
  auto f1 = static_cast<float*>(s1);
  auto f2 = static_cast<float*>(s2);
  const float ninv = 1.f / (float)R;
  for (int p = L - 1; p >= 0; --p) {
    const int n = c[p + 1];
    bwd_kernel<<<nblk, THREADS, smem, st>>>(
        S, tbl, R, ns, pl, static_cast<const float*>(gout), ct,
        static_cast<const float*>(mu), static_cast<const float*>(ivar), f1, f2,
        ninv, p, p1, p2, nullptr, nullptr, wtotal, 0, wtotal, 1);
    sum_parts<<<(n + 127) / 128, 128, 0, st>>>(p1, nblk, n, f1 + S.hoff[p]);
    sum_parts<<<(n + 127) / 128, 128, 0, st>>>(p2, nblk, n, f2 + S.hoff[p]);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  bwd_kernel<<<nblk, THREADS, smem, st>>>(
      S, tbl, R, ns, pl, static_cast<const float*>(gout), ct,
      static_cast<const float*>(mu), static_cast<const float*>(ivar), f1, f2,
      ninv, -1, nullptr, nullptr, static_cast<float*>(dtable),
      static_cast<float*>(dw_part), wtotal, 0, wtotal, 1);
  sum_parts<<<(wtotal + 255) / 256, 256, 0, st>>>(
      static_cast<float*>(dw_part), nblk, wtotal, static_cast<float*>(dW));
  return (int)cudaGetLastError();
}

// Backward of the affine forward (pmlp_forward with train == 0). In: table,
// W, a, b, pooled, gout. Out: dtable [R, c0] and grads = (dW packed, then
// da packed, then db packed). Scratch: cnt [R / ns, cL], dw_part of nblk *
// (size of grads) floats, ZEROED.
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
  widths += c[L];
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
