// Fused EdgeConv forward and backward on a neighbour-major table.
//
// Replaces tpugan_tpu/ops/pallas/edgeconv_kernel.py : edgeconv_fused, its
// forward _fwd_pallas / _edgeconv_kernel and its backward _bwd_pallas /
// _edgeconv_bwd_kernel (the backward's note is above edgeconv_bwd_kernel).
//
// Contract: nbr_t [B,K,N,C] (plane j = neighbour j of every point),
// ctr [B,N,C], Wn, We [C,H], optional W1 [H,H] and W2 [H,O]; element type T
// is f32 or bf16 for all of them. For every point and neighbour j
//   y_j = lrelu(nbr_j Wn) + lrelu((nbr_j - ctr) We)        (slope 0.2)
//   y_j = lrelu(y_j W1); y_j = lrelu(y_j W2)                (when W1, W2)
//   out = max / min / sum / mean over j                     -> [B,N,O] T
// Every product accumulates in f32 and each layer's output is rounded to T,
// as the TPU kernel's dots with preferred_element_type=f32 and astype(cdt);
// nbr_j - ctr is formed in T, and sum / mean fold in T, plane by plane.
//
// What bounds it on the H100: operations. The upsampler's first EdgeConv
// (N=10240, k=12, C=64, H=128, O=256) does 16.1 GFLOP against 31 MB of
// neighbour table, about 510 operations per byte: far above the card's f32
// balance point (67 TFLOP/s over 3.35 TB/s, 20 per byte) and above its
// bf16 tensor-core one (about 295 per byte), so products moved onto the
// tensor cores would still be bound by operations.
//
// Design: a block owns a tile of TP=16 points and walks its K neighbour
// planes in order, so only the [N, O] result is written to device memory:
// the table is read once and no [B,K,N,H] intermediate exists. Per plane,
// the 16 neighbour rows go to shared memory, and each layer is a small
// [16, Cin] x [Cin, Cout] product: thread t computes column t % Cout for
// the points t / Cout, t / Cout + 256 / Cout, ..., reading the activation
// rows as float4 broadcasts from shared memory and one weight per input
// channel straight from device memory. The weights are not staged: the
// upsampler's f32 weights (Wn and We 64 KB, W1 64 KB, W2 128 KB) exceed a
// block's 227 KB of shared memory, and every block reads them in the same
// order, so they stay resident in the 50 MB L2 and partly in L1. The last
// layer's outputs are folded into the aggregate in registers (a thread
// keeps the same (point, column) pairs for every plane), so they never
// touch shared memory either.
#include "common.cuh"
#include "reduce.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TP = 16;   // points per block

enum Aggregate { kMax = 0, kMin = 1, kSum = 2, kMean = 3 };

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : 0.2f * x; }

template <typename T>
__device__ __forceinline__ float fold(float acc, float y, int agg) {
  if (agg == kMax) return fmaxf(acc, y);
  if (agg == kMin) return fminf(acc, y);
  return round_to<T>(acc + y);   // sum / mean fold in the compute type
}

__host__ __device__ constexpr int padded(int c) { return ((c + 3) / 4) * 4 + 4; }

__device__ __forceinline__ float lrelu_grad(float z) { return z >= 0.f ? 1.f : 0.2f; }

// A thread's share of a layer of width w <= THREADS: column o of points
// p, p + g, ... (p == TP: the thread is idle in this layer).
struct Share {
  int o, p, g;
};

__device__ __forceinline__ Share share_of(int w, int o0 = 0) {
  const int g = THREADS / w, t = threadIdx.x;
  return {o0 + t % w, t / w < g ? t / w : TP, g};
}

// acc[r] = sum_{c < k} X[p_r][c] B(c, o) over the thread's points p_r,
// B(c, o) = W[c * n + o], or W[o * k + c] when TRANS (a product with W^T).
// X rows are zero-padded to a multiple of 4; one fmaf chain from c = 0.
template <typename T, bool TRANS>
__device__ __forceinline__ void product(const float* X, int ldx, int k,
                                        const T* __restrict__ W, int n,
                                        const Share& s, float (&acc)[TP]) {
#pragma unroll
  for (int r = 0; r < TP; ++r) acc[r] = 0.f;
  if (s.p >= TP) return;
  for (int c = 0; c < k; c += 4) {
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = c + u < k ? to_f32<T>(TRANS ? W[(size_t)s.o * k + c + u]
                                         : W[(size_t)(c + u) * n + s.o])
                       : 0.f;
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int p = s.p + r * s.g;
      if (p < TP) {
        const float4 x = *reinterpret_cast<const float4*>(X + p * ldx + c);
        acc[r] = fmaf(x.x, w[0], acc[r]);
        acc[r] = fmaf(x.y, w[1], acc[r]);
        acc[r] = fmaf(x.z, w[2], acc[r]);
        acc[r] = fmaf(x.w, w[3], acc[r]);
      }
    }
  }
}

// The node and edge affines z1a = nb Wn, z1b = (nb - ctr) We of the thread's
// (point, column) pairs (edge = nb - ctr formed in T).
template <typename T>
__device__ __forceinline__ void affines(const float* nb_s, const float* ctr_s,
                                        int ldc, int C, const T* __restrict__ wn,
                                        const T* __restrict__ we, int H,
                                        const Share& s, float (&za)[TP],
                                        float (&zb)[TP]) {
#pragma unroll
  for (int r = 0; r < TP; ++r) { za[r] = 0.f; zb[r] = 0.f; }
  if (s.p >= TP) return;
  for (int c = 0; c < C; c += 4) {
    float wnv[4], wev[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = c + u < C;
      wnv[u] = in ? to_f32<T>(wn[(size_t)(c + u) * H + s.o]) : 0.f;
      wev[u] = in ? to_f32<T>(we[(size_t)(c + u) * H + s.o]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int p = s.p + r * s.g;
      if (p < TP) {
        const float4 x = *reinterpret_cast<const float4*>(nb_s + p * ldc + c);
        const float4 z = *reinterpret_cast<const float4*>(ctr_s + p * ldc + c);
        za[r] = fmaf(x.x, wnv[0], za[r]);
        za[r] = fmaf(x.y, wnv[1], za[r]);
        za[r] = fmaf(x.z, wnv[2], za[r]);
        za[r] = fmaf(x.w, wnv[3], za[r]);
        zb[r] = fmaf(round_to<T>(x.x - z.x), wev[0], zb[r]);
        zb[r] = fmaf(round_to<T>(x.y - z.y), wev[1], zb[r]);
        zb[r] = fmaf(round_to<T>(x.z - z.z), wev[2], zb[r]);
        zb[r] = fmaf(round_to<T>(x.w - z.w), wev[3], zb[r]);
      }
    }
  }
}

// Rows p of plane j into dst (zero for p >= np).
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int np,
                                          int C, int ld, float* dst) {
  for (int e = threadIdx.x; e < TP * C; e += THREADS) {
    const int p = e / C;
    dst[p * ld + (e - p * C)] = p < np ? to_f32<T>(src[e]) : 0.f;
  }
}

template <typename T, bool MLP>
__global__ void __launch_bounds__(THREADS)
edgeconv_kernel(const T* __restrict__ nbr, const T* __restrict__ ctr,
                const T* __restrict__ wn, const T* __restrict__ we,
                const T* __restrict__ w1, const T* __restrict__ w2,
                T* __restrict__ out, int K, int N, int C, int H, int O, int agg) {
  extern __shared__ __align__(16) float smem[];
  const int ldc = padded(C), ldh = padded(H);
  float* ctr_s = smem;                 // [TP][ldc]
  float* nb_s = ctr_s + TP * ldc;      // [TP][ldc]
  float* h1_s = nb_s + TP * ldc;       // [TP][ldh]
  float* h2_s = h1_s + TP * ldh;       // [TP][ldh] (MLP only)

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  const int total = TP * ldc * 2 + TP * ldh * (MLP ? 2 : 1);
  for (int e = threadIdx.x; e < total; e += THREADS) smem[e] = 0.f;  // padding
  __syncthreads();
  const int np = min(TP, N - p0);
  load_rows<T>(ctr + ((size_t)b * N + p0) * C, np, C, ldc, ctr_s);

  const int OUT = MLP ? O : H;
  const Share sH = share_of(H), sO = share_of(OUT);
  float a1[TP], a2[TP], res[TP];
  for (int j = 0; j < K; ++j) {
    __syncthreads();  // the previous plane's rows are no longer read
    load_rows<T>(nbr + (((size_t)b * K + j) * N + p0) * C, np, C, ldc, nb_s);
    __syncthreads();

    // layer 1: the node and edge affines
    affines<T>(nb_s, ctr_s, ldc, C, wn, we, H, sH, a1, a2);
    if (!MLP) {
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const float y = round_to<T>(lrelu(a1[r]) + lrelu(a2[r]));
        res[r] = j == 0 ? y : fold<T>(res[r], y, agg);
      }
      continue;
    }
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int p = sH.p + r * sH.g;
      if (p < TP) h1_s[p * ldh + sH.o] = round_to<T>(lrelu(a1[r]) + lrelu(a2[r]));
    }
    __syncthreads();

    // layer 2: [TP, H] x W1 [H, H]
    product<T, false>(h1_s, ldh, H, w1, H, sH, a1);
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int p = sH.p + r * sH.g;
      if (p < TP) h2_s[p * ldh + sH.o] = round_to<T>(lrelu(a1[r]));
    }
    __syncthreads();

    // layer 3: [TP, H] x W2 [H, O], folded over the planes in registers
    product<T, false>(h2_s, ldh, H, w2, O, sO, a1);
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const float y = round_to<T>(lrelu(a1[r]));
      res[r] = j == 0 ? y : fold<T>(res[r], y, agg);
    }
  }

  const Share sF = MLP ? sO : sH;
#pragma unroll
  for (int r = 0; r < TP; ++r) {
    const int p = sF.p + r * sF.g;
    if (p < np) {
      const float v = agg == kMean ? round_to<T>(res[r] / (float)K) : res[r];
      out[((size_t)b * N + p0 + p) * OUT + sF.o] = from_f32<T>(v);
    }
  }
}

template <typename T, bool MLP>
int launch(const void* nbr, const void* ctr, const void* wn, const void* we,
           const void* w1, const void* w2, void* out, int B, int K, int N,
           int C, int H, int O, int agg, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * TP * (2 * padded(C) + (MLP ? 2 : 1) * padded(H));
  auto kern = edgeconv_kernel<T, MLP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((N + TP - 1) / TP, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(nbr), static_cast<const T*>(ctr),
      static_cast<const T*>(wn), static_cast<const T*>(we),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<T*>(out), K, N, C, H, O, agg);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- backward
//
// Contract: the forward's inputs and the cotangent g [B,N,O] (element type
// T). Out, all f32: gnbr [B,K,N,C], gctr [B,N,C], and dW = (dWn, dWe, dW1,
// dW2) packed one after another. With gy_j the cotangent of plane j's output
// (max / min: g * (y_j == acc) / ties, the tie rule of jnp.max; sum: g;
// mean: g / K), back through the layers of plane j:
//   d3 = gy lrelu'(z3), dW2 += h2^T d3, d2 = (d3 W2^T) lrelu'(z2),
//   dW1 += h1^T d2, gh1 = d2 W1^T (no MLP: gh1 = gy),
//   d1a = gh1 lrelu'(z1a), d1b = gh1 lrelu'(z1b), dWn += nbr_j^T d1a,
//   dWe += (nbr_j - ctr)^T d1b, gnbr_j = d1a Wn^T + d1b We^T,
//   gctr -= d1b We^T.
// Each d is rounded to T before it enters a product, h1 and h2 are rounded
// as in the forward, and g arrives in T: the TPU kernel's rounding points.
//
// What bounds it on the H100: operations. It recomputes the forward once
// for the tie count (max / min) and once beside the backward's two products
// per layer, about four times the forward's multiply-adds, against the same
// table read once more and gnbr written once.
//
// Design. Blocks walk tiles of TP points (a block takes tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...). Pass A recomputes every plane's output and
// keeps, per (point, column) a thread owns, the running max (min) and the
// count of planes equal to it: a strictly larger value resets the count, an
// equal one adds to it, so the count is that of the final aggregate, as the
// TPU kernel's second sweep over its stored outputs finds it. The backward
// therefore never compares with the forward's stored output, where one ulp
// of another summation order would lose a point's whole gradient. Pass B
// recomputes each plane again with the same device functions (bit-identical
// values) and runs its backward; the activations and cotangents of the
// plane's 16 points sit in shared memory, and the products are the
// forward's broadcast scheme (the transposed weights read through L2). The
// centre's gradient accumulates in shared memory over the planes. The
// weight gradients sum over all B*K*N rows: each block adds its rows into
// its own partial sums in device memory (no float atomics, whose order
// changes from run to run), and a second kernel adds the blocks' partials
// in block order, so the sums repeat from run to run.

template <typename T, bool MLP>
__global__ void __launch_bounds__(THREADS)
edgeconv_bwd_kernel(const T* __restrict__ nbr, const T* __restrict__ ctr,
                    const T* __restrict__ wn, const T* __restrict__ we,
                    const T* __restrict__ w1, const T* __restrict__ w2,
                    const T* __restrict__ gout, float* __restrict__ gnbr,
                    float* __restrict__ gctr, float* __restrict__ dw_part,
                    int B, int K, int N, int C, int H, int O, int agg) {
  extern __shared__ __align__(16) float smem[];
  const int OUT = MLP ? O : H;
  const int ldc = padded(C), ldh = padded(H), ldo = padded(OUT);
  float* ctr_s = smem;                 // [TP][ldc] centre rows
  float* nb_s = ctr_s + TP * ldc;      // [TP][ldc] the plane's rows
  float* gc_s = nb_s + TP * ldc;       // [TP][ldc] gradient of the centre
  float* h1_s = gc_s + TP * ldc;       // [TP][ldh]
  float* d1a_s = h1_s + TP * ldh;      // [TP][ldh]
  float* d1b_s = d1a_s + TP * ldh;     // [TP][ldh]
  float* h2_s = d1b_s + TP * ldh;      // [TP][ldh] (MLP only)
  float* d2_s = h2_s + TP * ldh;       // [TP][ldh] (MLP only)
  float* d3_s = d2_s + TP * ldh;       // [TP][ldo] (MLP only)
  const int tid = threadIdx.x;
  const int total = TP * (3 * ldc + 3 * ldh + (MLP ? 2 * ldh + ldo : 0));
  for (int e = tid; e < total; e += THREADS) smem[e] = 0.f;  // zero padding

  const Share sH = share_of(H), sO = share_of(OUT);
  const int wtotal = 2 * C * H + (MLP ? H * H + H * O : 0);
  float* pwn = dw_part + (size_t)blockIdx.x * wtotal;
  float* pwe = pwn + C * H;
  float* pw1 = pwe + C * H;
  float* pw2 = pw1 + H * H;
  const bool extreme = agg == kMax || agg == kMin;
  const int row_tiles = (N + TP - 1) / TP;

  float za[TP], zb[TP], z2[TP], t[TP], acc[TP], cnt[TP], gy[TP];
  for (int tile = blockIdx.x; tile < B * row_tiles; tile += gridDim.x) {
    const int b = tile / row_tiles, p0 = (tile - b * row_tiles) * TP;
    const int np = min(TP, N - p0);
    __syncthreads();                   // the previous tile is no longer read
    load_rows<T>(ctr + ((size_t)b * N + p0) * C, np, C, ldc, ctr_s);
    for (int e = tid; e < TP * C; e += THREADS) gc_s[(e / C) * ldc + e % C] = 0.f;

    // the plane's forward: za, zb (and z2) at the thread's H pairs, h1_s
    // (and h2_s), and the output y in t at its OUT pairs
    auto forward = [&](int j) {
      __syncthreads();                 // the previous plane is no longer read
      load_rows<T>(nbr + (((size_t)b * K + j) * N + p0) * C, np, C, ldc, nb_s);
      __syncthreads();
      affines<T>(nb_s, ctr_s, ldc, C, wn, we, H, sH, za, zb);
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const float h1 = round_to<T>(lrelu(za[r]) + lrelu(zb[r]));
        const int p = sH.p + r * sH.g;
        if (MLP && p < TP) h1_s[p * ldh + sH.o] = h1;
        if (!MLP) t[r] = h1;
      }
      if (!MLP) return;
      __syncthreads();
      product<T, false>(h1_s, ldh, H, w1, H, sH, z2);
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const int p = sH.p + r * sH.g;
        if (p < TP) h2_s[p * ldh + sH.o] = round_to<T>(lrelu(z2[r]));
      }
      __syncthreads();
      product<T, false>(h2_s, ldh, H, w2, O, sO, t);   // t = z3
    };

    // pass A (max / min): the aggregate and the number of planes equal to it
#pragma unroll
    for (int r = 0; r < TP; ++r) { acc[r] = 0.f; cnt[r] = 1.f; }
    if (extreme) {
      for (int j = 0; j < K; ++j) {
        forward(j);
#pragma unroll
        for (int r = 0; r < TP; ++r) {
          const float y = MLP ? round_to<T>(lrelu(t[r])) : t[r];
          const bool beyond = agg == kMax ? y > acc[r] : y < acc[r];
          if (j == 0 || beyond) {
            acc[r] = y;
            cnt[r] = 1.f;
          } else if (y == acc[r]) {
            cnt[r] += 1.f;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int p = sO.p + r * sO.g;
      gy[r] = p < np ? to_f32<T>(gout[((size_t)b * N + p0 + p) * OUT + sO.o]) : 0.f;
      if (agg == kMean) gy[r] = gy[r] / (float)K;
    }

    // pass B: each plane's backward
    for (int j = 0; j < K; ++j) {
      forward(j);
      // the cotangent of the plane's output (z3 in t, or y = h1 in t)
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const float y = MLP ? round_to<T>(lrelu(t[r])) : t[r];
        const float g = extreme ? (y == acc[r] ? gy[r] : 0.f) / cnt[r] : gy[r];
        if (MLP) {
          const int p = sO.p + r * sO.g;
          if (p < TP) d3_s[p * ldo + sO.o] = round_to<T>(g * lrelu_grad(t[r]));
        } else {
          t[r] = g;                    // gh1
        }
      }
      if (MLP) {
        __syncthreads();
        product<T, true>(d3_s, ldo, O, w2, 0, sH, t);           // d3 W2^T
#pragma unroll
        for (int r = 0; r < TP; ++r) {
          const int p = sH.p + r * sH.g;
          if (p < TP) d2_s[p * ldh + sH.o] = round_to<T>(t[r] * lrelu_grad(z2[r]));
        }
        __syncthreads();
        product<T, true>(d2_s, ldh, H, w1, 0, sH, t);           // gh1 = d2 W1^T
      }
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const int p = sH.p + r * sH.g;
        if (p < TP) {
          d1a_s[p * ldh + sH.o] = round_to<T>(t[r] * lrelu_grad(za[r]));
          d1b_s[p * ldh + sH.o] = round_to<T>(t[r] * lrelu_grad(zb[r]));
        }
      }
      __syncthreads();

      // gnbr_j = d1a Wn^T + d1b We^T; gctr -= d1b We^T (columns in chunks)
      for (int o0 = 0; o0 < C; o0 += THREADS) {
        const Share sC = share_of(min(THREADS, C - o0), o0);
        product<T, true>(d1a_s, ldh, H, wn, 0, sC, za);
        product<T, true>(d1b_s, ldh, H, we, 0, sC, zb);
#pragma unroll
        for (int r = 0; r < TP; ++r) {
          const int p = sC.p + r * sC.g;
          if (p < np) {
            gnbr[(((size_t)b * K + j) * N + p0 + p) * C + sC.o] = za[r] + zb[r];
            gc_s[p * ldc + sC.o] -= zb[r];
          }
        }
      }

      // the block's partial weight gradients over the plane's rows
      for (int i = tid; i < C * H; i += THREADS) {
        const int c = i / H, h = i - c * H;
        float sa = 0.f, sb = 0.f;
        for (int p = 0; p < np; ++p) {
          const float x = nb_s[p * ldc + c];
          sa = fmaf(x, d1a_s[p * ldh + h], sa);
          sb = fmaf(round_to<T>(x - ctr_s[p * ldc + c]), d1b_s[p * ldh + h], sb);
        }
        pwn[i] += sa;
        pwe[i] += sb;
      }
      if (MLP) {
        for (int i = tid; i < H * H; i += THREADS) {
          const int h = i / H, o = i - h * H;
          float s = 0.f;
          for (int p = 0; p < np; ++p) s = fmaf(h1_s[p * ldh + h], d2_s[p * ldh + o], s);
          pw1[i] += s;
        }
        for (int i = tid; i < H * O; i += THREADS) {
          const int h = i / O, o = i - h * O;
          float s = 0.f;
          for (int p = 0; p < np; ++p) s = fmaf(h2_s[p * ldh + h], d3_s[p * ldo + o], s);
          pw2[i] += s;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < np * C; e += THREADS) {
      const int p = e / C;
      gctr[((size_t)b * N + p0) * C + e] = gc_s[p * ldc + (e - p * C)];
    }
  }
}

template <typename T, bool MLP>
int launch_bwd(const void* nbr, const void* ctr, const void* wn, const void* we,
               const void* w1, const void* w2, const void* g, void* gnbr,
               void* gctr, void* dw_part, void* dw, int B, int K, int N, int C,
               int H, int O, int agg, int nblk, cudaStream_t stream) {
  const int OUT = MLP ? O : H;
  const size_t smem = sizeof(float) * TP *
      (3 * padded(C) + 3 * padded(H) + (MLP ? 2 * padded(H) + padded(OUT) : 0));
  auto kern = edgeconv_bwd_kernel<T, MLP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<nblk, THREADS, smem, stream>>>(
      static_cast<const T*>(nbr), static_cast<const T*>(ctr),
      static_cast<const T*>(wn), static_cast<const T*>(we),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(g), static_cast<float*>(gnbr),
      static_cast<float*>(gctr), static_cast<float*>(dw_part), B, K, N, C, H,
      O, agg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wtotal = 2 * C * H + (MLP ? H * H + H * O : 0);
  sum_parts<<<(wtotal + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dw_part), nblk, wtotal, static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes the wrapper (ops/kernels/edgeconv.py) admits: 1 <= H, O <= 256,
// all tensors contiguous on one device, one element type. w1 / w2 are null
// when mlp is 0 (then O == H). agg: 0 max, 1 min, 2 sum, 3 mean.
extern "C" int edgeconv_fwd(const void* nbr, const void* ctr, const void* wn,
                            const void* we, const void* w1, const void* w2,
                            void* out, int B, int K, int N, int C, int H,
                            int O, int mlp, int agg, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (mlp)
      return launch<__nv_bfloat16, true>(nbr, ctr, wn, we, w1, w2, out, B, K, N, C, H, O, agg, s);
    return launch<__nv_bfloat16, false>(nbr, ctr, wn, we, w1, w2, out, B, K, N, C, H, O, agg, s);
  }
  if (mlp) return launch<float, true>(nbr, ctr, wn, we, w1, w2, out, B, K, N, C, H, O, agg, s);
  return launch<float, false>(nbr, ctr, wn, we, w1, w2, out, B, K, N, C, H, O, agg, s);
}

// Backward of edgeconv_fwd for the cotangent g [B,N,O] (type T). gnbr
// [B,K,N,C], gctr [B,N,C] and dw (the packed dWn, dWe[, dW1, dW2]) are f32;
// dw_part is scratch of nblk * (size of dw) floats, ZEROED; nblk >= 1
// blocks stride over the B * ceil(N / 16) point tiles.
extern "C" int edgeconv_bwd(const void* nbr, const void* ctr, const void* wn,
                            const void* we, const void* w1, const void* w2,
                            const void* g, void* gnbr, void* gctr,
                            void* dw_part, void* dw, int B, int K, int N, int C,
                            int H, int O, int mlp, int agg, int bf16, int nblk,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
#define EDGECONV_BWD(T, M)                                                     \
  return launch_bwd<T, M>(nbr, ctr, wn, we, w1, w2, g, gnbr, gctr, dw_part, dw, \
                          B, K, N, C, H, O, agg, nblk, s)
  if (bf16) {
    if (mlp) EDGECONV_BWD(__nv_bfloat16, true);
    EDGECONV_BWD(__nv_bfloat16, false);
  }
  if (mlp) EDGECONV_BWD(float, true);
  EDGECONV_BWD(float, false);
#undef EDGECONV_BWD
}
