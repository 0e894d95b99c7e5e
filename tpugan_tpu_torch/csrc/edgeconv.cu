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
// channel straight from device memory. This kernel does not stage the
// weights; it now serves only the bf16 forwards outside the tensor-core
// class and the f32 forwards outside the register-tiled kernel's classes
// (below), where every block reads the weights in the same order from the
// 50 MB L2 and partly from L1. The last layer's outputs are folded into
// the aggregate in registers (a thread keeps the same (point, column)
// pairs for every plane), so they never touch shared memory either.
//
// The f32 forward at four classes (mlp, C, H, O) has a kernel of its own,
// edgeconv_f32t_kernel (entry point edgeconv_fwd_f32_tiled), with the same
// contract. It replaces _edgeconv_kernel with cdt = float32 at the
// upsampler's and mask head's (64, 128, 256), the mask head's sum without
// the SharedMLP (64, 128, 128), EdgeConv_0's (6, 64, 128) and the IDGCN's
// (32, 16, 32). TF32 stays off, so its bound is the card's 67 TFLOP/s of
// f32 FFMA; at 10,240 points a k=12 launch of (64, 128, 256) does 16.1
// GFLOP (0.240 ms), a k=4 launch 5.4 (0.080 ms), the k=8 sum 2.7 (0.040
// ms), EdgeConv_0 at k=20 5.3 (0.080 ms), the IDGCN at k=20 0.73 (0.011
// ms), each above 20 operations a byte of table. The general kernel
// feeds each weight it loads from L2 to at most 16 FMAs; here the weights
// sit in shared memory and every thread owns an R x S register tile of
// each layer's output (R = 5 points by 4 columns of h1 and h2, 8 of the
// output, at (64, 128, 256)), so per 4 input channels it reads R + S
// float4 values for 4 R S FMAs. Shared memory per block, (64, 128, 256):
// Wn, We and W1 resident (128 KB); W2 (128 KB) streamed per plane through
// two 16-row stages by cp.async (32 KB, L2 traffic of 128 KB a plane per
// 40-point tile, about 6 bytes a cycle an SM); the plane's rows and the
// centres double-buffered (4 x 10,880 B), h2 written over h1 (21,120 B):
// 228,480 of the 232,448 bytes a block may hold, one block an SM. Keeping
// W1 and W2 resident instead (192 KB) would leave Wn and We to L2 reads
// in the layer that reads the most activations. The other classes hold
// every weight: (64, 128, 128) 109,056 B, (6, 64, 128) (C padded to 8)
// 73,984 B, (32, 16, 32) 51,200 B. The grid is persistent (resident blocks
// an SM x 132, at most one a tile); a block strides over the point tiles
// (40 points, 80 at (6, 64, 128), 64 at the IDGCN: at (64, 128, 256)
// 10,240 points make 256 tiles, two rounds of 132 blocks filled to 97%),
// and the next plane's rows (at a tile's last plane, the next tile's
// centres too) arrive by cp.async while the current plane computes. Only
// [N, O] is written.
//
// The bf16 forward of the upsampler's and mask head's class, (C, H, O) =
// (64, 128, 256) with the SharedMLP, has a kernel of its own,
// edgeconv_tc_kernel (entry point edgeconv_fwd_bf16_tc). It replaces
// _edgeconv_kernel at this shape, with the same contract. Its bound: a
// k=12 launch over 10,240 points does 16.1 GFLOP, 16.3 us at the card's
// 989 TFLOP/s of bf16 tensor-core products, against 15.7 MB of bf16
// table, 4.7 us at 3.35 TB/s: bound by operations, so every product goes
// to the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), where
// the general kernel widens each bf16 value to f32 and runs FFMA chains at
// 67 TFLOP/s with its weights read from L2. The bf16 weights (128 KB)
// are staged once per block in shared memory, and the grid is persistent
// (one block an SM, at most), so each block spreads that copy over many
// tiles. Four groups of four warps share the weights; a group owns a
// 16-point tile, whose planes' rows and edges (formed in f32, rounded to
// bf16) go to shared memory, the next plane's rows waiting in registers.
// Its warps split each layer's columns (32 of h1 and h2, 64 of the
// output); h1 and h2 round to bf16 into shared memory, where ldmatrix
// reads them (and, transposed, the weights) as fragments; the output
// columns' aggregate stays in the accumulators' layout in registers over
// the K planes. Only the [N, 256] result is written.
#include "gemm_tile.cuh"
#include "reduce.cuh"

namespace {

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

// ------------------------------------------ bf16 tensor-core forward (class)
//
// edgeconv_tc_kernel: the bf16 SharedMLP forward at (C, H, O) = (64, 128,
// 256) on mma.sync.m16n8k16 (bf16 in, f32 accumulate). The contract is
// edgeconv_kernel's for T = bf16; the head of this file says what bounds it
// and how it is laid out.
namespace tc {

constexpr int C = 64, H = 128, O = 256;
constexpr int GROUPS = 4;                     // point tiles in flight a block
constexpr int GROUP_THREADS = 128;            // 4 warps share a tile
constexpr int THREADS = GROUPS * GROUP_THREADS;
// bf16 row pitches: 16 bytes of padding put the 8 rows an ldmatrix reads
// in 8 different bank groups
constexpr int LDC = C + 8, LDH = H + 8, LDO = O + 8;
constexpr int W_ELEMS = 2 * C * LDH + H * LDH + H * LDO;   // Wn, We, W1, W2
constexpr int G_ELEMS = 2 * TP * LDC + 2 * TP * LDH;       // nb, edge, h1, h2
constexpr size_t SMEM = sizeof(__nv_bfloat16) * (W_ELEMS + GROUPS * G_ELEMS);

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A fragments of a [16][ld] row-major tile at columns k0..k0+15
__device__ __forceinline__ void ldsm_a(const bf16* tile, int ld, int k0,
                                       int lane, unsigned (&r)[4]) {
  const unsigned a = smem_u32(tile + (lane & 15) * ld + k0 + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// B fragments of two n-tiles (columns n0..n0+15) of a [K][ld] row-major
// weight at rows k0..k0+15: {r[0], r[1]} for n0, {r[2], r[3]} for n0 + 8
__device__ __forceinline__ void ldsm_b(const bf16* w, int ld, int k0, int n0,
                                       int lane, unsigned (&r)[4]) {
  const unsigned a = smem_u32(w + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld
                              + n0 + (lane >> 4) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] = A[16][0:16 KS] W[0:16 KS][n0 + 8 nt .. +8] for nt < NT (f32)
template <int KS, int NT>
__device__ __forceinline__ void product(const bf16* a, int lda, const bf16* w,
                                        int ldw, int n0, int lane,
                                        float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned af[4];
    ldsm_a(a, lda, 16 * ks, lane, af);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned bf[4];
      ldsm_b(w, ldw, 16 * ks, n0 + 16 * np, lane, bf);
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// The 4 warps of a group meet; group g uses named barrier 1 + g
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "r"(GROUP_THREADS)
               : "memory");
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// bf16(n - c) of two bf16 pairs, the difference formed in f32
__device__ __forceinline__ unsigned sub_pair(unsigned n, unsigned c) {
  const float2 nf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&n));
  const float2 cf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&c));
  return pack(nf.x - cf.x, nf.y - cf.y);
}

// rows x cols bf16 from device memory into a [rows][ld] tile, 16 bytes a move
__device__ __forceinline__ void stage(const bf16* __restrict__ src, int rows,
                                      int cols, int ld, bf16* dst) {
  const int chunks = cols / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += THREADS) {
    const int r = e / chunks, c = e - r * chunks;
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) =
        __ldg(reinterpret_cast<const uint4*>(src) + e);
  }
}

template <int AGG>
__device__ __forceinline__ float fold(float acc, float y) {
  if (AGG == kMax) return fmaxf(acc, y);
  if (AGG == kMin) return fminf(acc, y);
  return round_to<bf16>(acc + y);   // sum / mean fold in bf16
}

// Blocks hold the weights in shared memory and stride over the point tiles:
// group g of block x takes tiles g * gridDim.x + x, then every
// GROUPS * gridDim.x-th. A group's thread t loads row t / 8, channels
// 8 (t % 8) .. +8 of each plane (and keeps its centre chunk in registers);
// warp w computes h1 and h2 columns 32 w .. +32 and output columns
// 64 w .. +64, whose aggregate it keeps in registers over the K planes.
template <int AGG>
__global__ void __launch_bounds__(THREADS, 1)
edgeconv_tc_kernel(const bf16* __restrict__ nbr, const bf16* __restrict__ ctr,
                   const bf16* __restrict__ wn, const bf16* __restrict__ we,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                   bf16* __restrict__ out, int B, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wn_s = reinterpret_cast<bf16*>(smem_raw);   // [C][LDH]
  bf16* we_s = wn_s + C * LDH;                       // [C][LDH]
  bf16* w1_s = we_s + C * LDH;                       // [H][LDH]
  bf16* w2_s = w1_s + H * LDH;                       // [H][LDO]
  const int group = threadIdx.x / GROUP_THREADS;
  const int gt = threadIdx.x % GROUP_THREADS;
  const int warp = gt / 32, lane = threadIdx.x % 32;
  bf16* nb_s = w2_s + H * LDO + group * G_ELEMS;     // [TP][LDC]
  bf16* ed_s = nb_s + TP * LDC;                      // [TP][LDC]
  bf16* h1_s = ed_s + TP * LDC;                      // [TP][LDH]
  bf16* h2_s = h1_s + TP * LDH;                      // [TP][LDH]

  stage(wn, C, H, LDH, wn_s);
  stage(we, C, H, LDH, we_s);
  stage(w1, H, H, LDH, w1_s);
  stage(w2, H, O, LDO, w2_s);
  __syncthreads();

  const int lr = gt / 8, lc = 8 * (gt % 8);   // the thread's row and channels
  const int fr = lane / 4, fc = 2 * (lane % 4);   // its fragment row and column
  const int row_tiles = (N + TP - 1) / TP;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int tile = group * gridDim.x + blockIdx.x; tile < B * row_tiles;
       tile += GROUPS * gridDim.x) {
    const int b = tile / row_tiles, p0 = (tile - b * row_tiles) * TP;
    const int np = min(TP, N - p0);
    const bool live = lr < np;   // rows past N stay zero and are not written
    const uint4 cv = live ? __ldg(reinterpret_cast<const uint4*>(
                                ctr + ((size_t)b * N + p0 + lr) * C + lc))
                          : zero;
    const bf16* rows = nbr + ((size_t)b * K * N + p0 + lr) * C + lc;
    uint4 nv = live ? __ldg(reinterpret_cast<const uint4*>(rows)) : zero;

    float acc[8][4];
    for (int j = 0; j < K; ++j) {
      // plane j's rows and edges into shared memory; plane j + 1's rows
      // into registers while the plane's products run
      *reinterpret_cast<uint4*>(nb_s + lr * LDC + lc) = nv;
      *reinterpret_cast<uint4*>(ed_s + lr * LDC + lc) =
          make_uint4(sub_pair(nv.x, cv.x), sub_pair(nv.y, cv.y),
                     sub_pair(nv.z, cv.z), sub_pair(nv.w, cv.w));
      group_sync(group);
      if (live && j + 1 < K)
        nv = __ldg(reinterpret_cast<const uint4*>(rows + (size_t)(j + 1) * N * C));

      // layer 1: h1 = bf16(lrelu(nb Wn) + lrelu(edge We))
      {
        float za[4][4], zb[4][4];
        product<C / 16, 4>(nb_s, LDC, wn_s, LDH, 32 * warp, lane, za);
        product<C / 16, 4>(ed_s, LDC, we_s, LDH, 32 * warp, lane, zb);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bf16* h = h1_s + fr * LDH + 32 * warp + 8 * nt + fc;
          *reinterpret_cast<unsigned*>(h) =
              pack(lrelu(za[nt][0]) + lrelu(zb[nt][0]),
                   lrelu(za[nt][1]) + lrelu(zb[nt][1]));
          *reinterpret_cast<unsigned*>(h + 8 * LDH) =
              pack(lrelu(za[nt][2]) + lrelu(zb[nt][2]),
                   lrelu(za[nt][3]) + lrelu(zb[nt][3]));
        }
      }
      group_sync(group);

      // layer 2: h2 = bf16(lrelu(h1 W1))
      {
        float z[4][4];
        product<H / 16, 4>(h1_s, LDH, w1_s, LDH, 32 * warp, lane, z);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bf16* h = h2_s + fr * LDH + 32 * warp + 8 * nt + fc;
          *reinterpret_cast<unsigned*>(h) = pack(lrelu(z[nt][0]), lrelu(z[nt][1]));
          *reinterpret_cast<unsigned*>(h + 8 * LDH) =
              pack(lrelu(z[nt][2]), lrelu(z[nt][3]));
        }
      }
      group_sync(group);

      // layer 3: y = bf16(lrelu(h2 W2)), folded into the aggregate
      {
        float z[8][4];
        product<H / 16, 8>(h2_s, LDH, w2_s, LDO, 64 * warp, lane, z);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = round_to<bf16>(lrelu(z[nt][e]));
            acc[nt][e] = j == 0 ? y : fold<AGG>(acc[nt][e], y);
          }
      }
    }

#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = fr + 8 * half;
        float lo = acc[nt][2 * half], hi = acc[nt][2 * half + 1];
        if (AGG == kMean) {
          lo = round_to<bf16>(lo / (float)K);
          hi = round_to<bf16>(hi / (float)K);
        }
        if (p < np)
          *reinterpret_cast<unsigned*>(out + ((size_t)b * N + p0 + p) * O +
                                       64 * warp + 8 * nt + fc) = pack(lo, hi);
      }
  }
}

template <int AGG>
int launch(const void* nbr, const void* ctr, const void* wn, const void* we,
           const void* w1, const void* w2, void* out, int B, int K, int N,
           cudaStream_t stream) {
  auto kern = edgeconv_tc_kernel<AGG>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = B * ((N + TP - 1) / TP);
  const int groups = (tiles + GROUPS - 1) / GROUPS;
  const int grid = groups < sms ? groups : sms;   // persistent: one wave
  kern<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const bf16*>(nbr), static_cast<const bf16*>(ctr),
      static_cast<const bf16*>(wn), static_cast<const bf16*>(we),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// --------------------------------------------- f32 register-tiled forward
//
// edgeconv_f32t_kernel: the f32 forward at the classes Shape admits. The
// contract is edgeconv_kernel's for T = float; the head of this file says
// what bounds it and how its shared memory is spent.
namespace f32t {

constexpr int KC = 16;   // rows of W2 a shared-memory stage holds

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// A class's widths and its layout. Thread (pg, cg) owns rows pg + r PG of
// the tile (r < R) and, in a layer of width 4 CG S/4, columns
// cg * 4 + q * 4 CG + u (q < S/4, u < 4): 4 columns of h1 and h2, S3 of the
// output. A warp is LP rows by LC column groups, so each float4 read of an
// activation row serves LC lanes and each of a weight row LP lanes.
template <int C_, int H_, int O_, bool MLP_, int TP_>
struct Shape {
  static constexpr int C = C_, CP = (C_ + 3) / 4 * 4, H = H_, TP = TP_;
  static constexpr bool MLP = MLP_;
  static constexpr int O = MLP_ ? O_ : H_;
  static constexpr int CG = H / 4, PG = THREADS / CG, R = TP / PG;
  static constexpr int S3 = MLP_ ? O / CG : 4;       // output columns a thread
  static constexpr int LC = CG < 8 ? CG : 8, LP = 32 / LC, WC = CG / LC;
  // row pitches of 4 (mod 32) floats: the LP rows a warp reads at once lie
  // in distinct banks
  static constexpr int LDC = CP + 4, LDH = H + 4;
  static constexpr int NCH = MLP_ ? H / KC : 0;      // W2 stages a plane
  static constexpr int W_FLOATS = 2 * CP * H + (MLP_ ? H * H + 2 * KC * O : 0);
  static constexpr int A_FLOATS = 4 * TP * LDC + (MLP_ ? TP * LDH : 0);
  static constexpr size_t SMEM = sizeof(float) * (W_FLOATS + A_FLOATS);
  static_assert(H % 4 == 0 && CG * PG == THREADS && R * PG == TP, "layout");
  static_assert(LC * LP == 32 && PG % LP == 0, "warp layout");
  static_assert(!MLP_ || (H % KC == 0 && O % (4 * CG) == 0), "MLP widths");
  static_assert(SMEM <= 232448, "shared memory");
};

// acc[r][s] += sum_{c < KD} X[row r][c] W[c][column s] of the thread's rows
// and S columns: per 4 input channels R float4 activation reads, S weight
// float4 reads, 4 R S FMAs.
template <class SH, int S, int KD, int LDX, int LDW>
__device__ __forceinline__ void product(const float* X, const float* W, int pg,
                                        int cg, float (&acc)[SH::R][S]) {
  const float* xr = X + pg * LDX;
  const float* wc = W + cg * 4;
#pragma unroll 2
  for (int c = 0; c < KD; c += 4) {
    float4 x[SH::R];
#pragma unroll
    for (int r = 0; r < SH::R; ++r)
      x[r] = *reinterpret_cast<const float4*>(xr + r * SH::PG * LDX + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float w[S];
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(wc + (c + u) * LDW + q * 4 * SH::CG);
        w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < SH::R; ++r)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[r][s] = fmaf(part(x[r], u), w[s], acc[r][s]);
    }
  }
}

// Layer 1's two products: za = nb Wn, zb = (nb - ctr) We at the thread's
// rows and 4 columns (the edge formed in registers, exact in f32).
template <class SH>
__device__ __forceinline__ void affines(const float* nb, const float* ct,
                                        const float* wn, const float* we,
                                        int pg, int cg, float (&za)[SH::R][4],
                                        float (&zb)[SH::R][4]) {
  constexpr int LD = SH::LDC, H = SH::H;
#pragma unroll
  for (int r = 0; r < SH::R; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) { za[r][s] = 0.f; zb[r][s] = 0.f; }
#pragma unroll 2
  for (int c = 0; c < SH::CP; c += 4) {
    float4 x[SH::R], e[SH::R];
#pragma unroll
    for (int r = 0; r < SH::R; ++r) {
      const int o = (pg + r * SH::PG) * LD + c;
      x[r] = *reinterpret_cast<const float4*>(nb + o);
      const float4 z = *reinterpret_cast<const float4*>(ct + o);
      e[r] = make_float4(x[r].x - z.x, x[r].y - z.y, x[r].z - z.z, x[r].w - z.w);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 a = *reinterpret_cast<const float4*>(wn + (c + u) * H + cg * 4);
      const float4 b = *reinterpret_cast<const float4*>(we + (c + u) * H + cg * 4);
#pragma unroll
      for (int r = 0; r < SH::R; ++r) {
        const float xu = part(x[r], u), eu = part(e[r], u);
        za[r][0] = fmaf(xu, a.x, za[r][0]); zb[r][0] = fmaf(eu, b.x, zb[r][0]);
        za[r][1] = fmaf(xu, a.y, za[r][1]); zb[r][1] = fmaf(eu, b.y, zb[r][1]);
        za[r][2] = fmaf(xu, a.z, za[r][2]); zb[r][2] = fmaf(eu, b.z, zb[r][2]);
        za[r][3] = fmaf(xu, a.w, za[r][3]); zb[r][3] = fmaf(eu, b.w, zb[r][3]);
      }
    }
  }
}

// Rows p0 .. p0 + TP of a [.., C] tensor (src points at row p0) into a
// [TP][LDC] tile by cp.async; rows past np and channels past C read as 0.
template <class SH>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int np,
                                          float* dst) {
  constexpr int C = SH::C, LD = SH::LDC;
  if constexpr (C % 4 == 0) {
    constexpr int CH = C / 4;
    for (int e = threadIdx.x; e < SH::TP * CH; e += THREADS) {
      const int p = e / CH, c = 4 * (e - p * CH);
      const bool in = p < np;
      cp_async16(dst + p * LD + c, in ? src + (size_t)p * C + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < SH::TP * SH::CP; e += THREADS) {
      const int p = e / SH::CP, c = e - p * SH::CP;
      const bool in = p < np && c < C;
      cp_async4(dst + p * LD + c, in ? src + (size_t)p * C + c : src, in);
    }
  }
}

template <int AGG>
__device__ __forceinline__ float fold(float acc, float y) {
  if (AGG == kMax) return fmaxf(acc, y);
  if (AGG == kMin) return fminf(acc, y);
  return acc + y;   // sum / mean fold in f32
}

// Blocks hold Wn, We and W1 in shared memory and stride over the point
// tiles (tile blockIdx.x, then every gridDim.x-th). A block walks its
// tiles' planes in order; while plane j computes, the rows of the next
// plane (and, at a tile's last plane, the next tile's centres) arrive in
// the other buffer. Per plane: layer 1 into registers, h1 to shared
// memory; layer 2 into registers, h2 over h1; layer 3 over W2 in KC-row
// stages, two in flight, its outputs folded into the aggregate in
// registers. Only [N, O] is written.
template <class SH, int AGG>
__global__ void __launch_bounds__(THREADS, 1)
edgeconv_f32t_kernel(const float* __restrict__ nbr, const float* __restrict__ ctr,
                     const float* __restrict__ wn, const float* __restrict__ we,
                     const float* __restrict__ w1, const float* __restrict__ w2,
                     float* __restrict__ out, int B, int K, int N) {
  constexpr int C = SH::C, CP = SH::CP, H = SH::H, O = SH::O, TP = SH::TP;
  constexpr int R = SH::R, PG = SH::PG, CG = SH::CG, S3 = SH::S3;
  constexpr int LDC = SH::LDC, LDH = SH::LDH, NCH = SH::NCH;
  constexpr bool MLP = SH::MLP;
  extern __shared__ __align__(16) float smem[];
  float* wn_s = smem;                                // [CP][H]
  float* we_s = wn_s + CP * H;                       // [CP][H]
  float* w1_s = we_s + CP * H;                       // [H][H] (MLP)
  float* w2_s = w1_s + (MLP ? H * H : 0);            // 2 x [KC][O] (MLP)
  float* nb_s = w2_s + (MLP ? 2 * KC * O : 0);       // 2 x [TP][LDC]
  float* ct_s = nb_s + 2 * TP * LDC;                 // 2 x [TP][LDC]
  float* h_s = ct_s + 2 * TP * LDC;                  // [TP][LDH] h1, then h2
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cg = (warp % SH::WC) * SH::LC + lane % SH::LC;
  const int pg = (warp / SH::WC) * SH::LP + lane / SH::LC;
  const int row_tiles = (N + TP - 1) / TP, tiles = B * row_tiles;
  int tile = blockIdx.x;
  if (tile >= tiles) return;

  for (int e = tid; e < CP * H / 4; e += THREADS) {   // Wn, We; rows past C 0
    const bool in = 4 * e < C * H;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(wn_s)[e] = in ? __ldg(reinterpret_cast<const float4*>(wn) + e) : z;
    reinterpret_cast<float4*>(we_s)[e] = in ? __ldg(reinterpret_cast<const float4*>(we) + e) : z;
  }
  if (MLP)
    for (int e = tid; e < H * H / 4; e += THREADS)
      reinterpret_cast<float4*>(w1_s)[e] = __ldg(reinterpret_cast<const float4*>(w1) + e);
  auto load_w2 = [&](int i) {   // W2 rows KC i .. +KC into stage i % 2
    const float* src = w2 + (size_t)i * KC * O;
    float* dst = w2_s + (i % 2) * KC * O;
    for (int e = tid; e < KC * O / 4; e += THREADS) cp_async16(dst + 4 * e, src + 4 * e, true);
  };
  auto rows_of = [&](int t, int& b, int& p0) {
    b = t / row_tiles;
    p0 = (t - b * row_tiles) * TP;
  };
  {
    int b, p0;
    rows_of(tile, b, p0);
    load_rows<SH>(ctr + ((size_t)b * N + p0) * C, N - p0, ct_s);
    load_rows<SH>(nbr + ((size_t)b * K * N + p0) * C, N - p0, nb_s);
    cp_commit();
  }

  int nbuf = 0, cbuf = 0;
  for (; tile < tiles; tile += gridDim.x) {
    int b, p0;
    rows_of(tile, b, p0);
    const int np = min(TP, N - p0);
    float res[R][S3];
    for (int j = 0; j < K; ++j) {
      cp_wait<0>();
      __syncthreads();   // plane j's rows are in; plane j - 1 is no longer read
      const int nt = j + 1 < K ? tile : tile + (int)gridDim.x;
      const int nj = j + 1 < K ? j + 1 : 0;
      if (nt < tiles) {
        int nb_b, nb_p0;
        rows_of(nt, nb_b, nb_p0);
        load_rows<SH>(nbr + (((size_t)nb_b * K + nj) * N + nb_p0) * C,
                      N - nb_p0, nb_s + (nbuf ^ 1) * TP * LDC);
        if (nj == 0)
          load_rows<SH>(ctr + ((size_t)nb_b * N + nb_p0) * C, N - nb_p0,
                        ct_s + (cbuf ^ 1) * TP * LDC);
      }
      cp_commit();
      if (MLP) {
        load_w2(0);
        cp_commit();
        if (NCH > 1) load_w2(1);
        cp_commit();
      }

      // layer 1: h1 = lrelu(nb Wn) + lrelu((nb - ctr) We)
      float za[R][4], zb[R][4];
      affines<SH>(nb_s + nbuf * TP * LDC, ct_s + cbuf * TP * LDC, wn_s, we_s,
                  pg, cg, za, zb);
      nbuf ^= 1;
      if (!MLP) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const float y = lrelu(za[r][s]) + lrelu(zb[r][s]);
            res[r][s] = j == 0 ? y : fold<AGG>(res[r][s], y);
          }
        continue;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(h_s + (pg + r * PG) * LDH + cg * 4) =
            make_float4(lrelu(za[r][0]) + lrelu(zb[r][0]),
                        lrelu(za[r][1]) + lrelu(zb[r][1]),
                        lrelu(za[r][2]) + lrelu(zb[r][2]),
                        lrelu(za[r][3]) + lrelu(zb[r][3]));
      __syncthreads();

      // layer 2: h2 = lrelu(h1 W1), written over h1 once every thread has
      // read it
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) za[r][s] = 0.f;
      product<SH, 4, H, LDH, H>(h_s, w1_s, pg, cg, za);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(h_s + (pg + r * PG) * LDH + cg * 4) =
            make_float4(lrelu(za[r][0]), lrelu(za[r][1]), lrelu(za[r][2]),
                        lrelu(za[r][3]));

      // layer 3: y = lrelu(h2 W2) over the W2 stages, folded in registers
      float z[R][S3];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < S3; ++s) z[r][s] = 0.f;
      for (int i = 0; i < NCH; ++i) {
        if (i + 1 < NCH) cp_wait<1>(); else cp_wait<0>();
        __syncthreads();   // stage i (and, at i = 0, h2) visible
        product<SH, S3, KC, LDH, O>(h_s + i * KC, w2_s + (i % 2) * KC * O, pg,
                                    cg, z);
        if (i + 2 < NCH) {
          __syncthreads();   // stage i % 2 is no longer read
          load_w2(i + 2);
          cp_commit();
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < S3; ++s) {
          const float y = lrelu(z[r][s]);
          res[r][s] = j == 0 ? y : fold<AGG>(res[r][s], y);
        }
    }
    cbuf ^= 1;

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = pg + r * PG;
      if (p >= np) continue;
#pragma unroll
      for (int q = 0; q < S3 / 4; ++q) {
        float4 v = make_float4(res[r][4 * q], res[r][4 * q + 1],
                               res[r][4 * q + 2], res[r][4 * q + 3]);
        if (AGG == kMean) {
          const float k = (float)K;
          v = make_float4(v.x / k, v.y / k, v.z / k, v.w / k);
        }
        *reinterpret_cast<float4*>(out + ((size_t)b * N + p0 + p) * O + cg * 4 +
                                   q * 4 * CG) = v;
      }
    }
  }
}

template <class SH, int AGG>
int launch(const void* nbr, const void* ctr, const void* wn, const void* we,
           const void* w1, const void* w2, void* out, int B, int K, int N,
           cudaStream_t stream) {
  auto kern = edgeconv_f32t_kernel<SH, AGG>;
  static int grid_max = 0;   // SMs x resident blocks an SM, found once
  if (grid_max == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SH::SMEM);
    int device = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                        SH::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_max = sms * per_sm;
  }
  const int tiles = B * ((N + SH::TP - 1) / SH::TP);
  const int grid = tiles < grid_max ? tiles : grid_max;   // persistent
  kern<<<grid, THREADS, SH::SMEM, stream>>>(
      static_cast<const float*>(nbr), static_cast<const float*>(ctr),
      static_cast<const float*>(wn), static_cast<const float*>(we),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<float*>(out), B, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <class SH>
int launch_agg(const void* nbr, const void* ctr, const void* wn, const void* we,
               const void* w1, const void* w2, void* out, int B, int K, int N,
               int agg, cudaStream_t s) {
  switch (agg) {
    case kMax: return launch<SH, kMax>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
    case kMin: return launch<SH, kMin>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
    case kSum: return launch<SH, kSum>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
    default: return launch<SH, kMean>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
  }
}

}  // namespace f32t

// ------------------------------------- f32 backward on GEMM tiles (one class)
//
// bwdt: the f32 backward with the SharedMLP at (C, H, O) = (64, 128, 256),
// the upsampler's and the mask head's class (entry point
// edgeconv_bwd_f32_tiled). It replaces _bwd_pallas / _edgeconv_bwd_kernel
// (tpugan_tpu/ops/pallas/edgeconv_kernel.py:277) at this class, with
// edgeconv_bwd's contract for bf16 = 0, mlp = 1; in f32 every rounding
// point is the identity.
//
// What bounds it on the H100: operations. Over R = B K N plane-rows it does
// three times the forward's 65,536 multiply-adds a row (the forward once,
// then per layer dW and dX): at the fused train step's 12 frames of 1,152
// points, 65.2 GFLOP at k = 12 (0.974 ms at 67 TFLOP/s of f32 FFMA, TF32
// off) and 21.7 at k = 4 (0.325 ms). What it keeps between the layers
// (edge, h1, h2, z3 and their cotangents, 2,352 bytes a row) moves about
// 2.5 GB at k = 12, 0.76 ms at 3.35 TB/s: under the operations, not far.
//
// Design: layer-wise products over all R rows, each computed once, on the
// register-tiled GEMM block of gemm_tile.cuh (a 128 x 128 or 128 x 64
// output tile a block, 8 x 8 or 8 x 4 accumulators a thread, a 3-stage
// cp.async pipeline of 8-deep slabs). Row r = (b K + j) N + n, its centre
// row b N + n; each kernel below is one launch, in this order:
//   forward  bwd_edge: edge = nb - ctr into xe (read again by dWe);
//            bwd_rows<kAct>: z1a = nb Wn, lrelu(z1a) into x1, its signs
//            into sgn; bwd_rows<kAddAct>: z1b = edge We, its signs, h1 =
//            lrelu(z1a) + lrelu(z1b) over x1;
//            bwd_rows<kAct>: z2 = h1 W1, h2 = lrelu(z2) into x2, its signs;
//            bwd_rows<kStore>: z3 = h2 W2 into x3;
//   ties     bwd_ties: per (b, n, column) the K values of z3 give y =
//            lrelu(z3), the aggregate and the count of planes equal to it
//            (max / min), and d3 = gy [y == acc] / cnt lrelu'(z3) (sum: gy
//            = g; mean: g / K) over z3 in x3. The count and the comparison
//            come from the same stored z3, never from the forward kernel's
//            output, where one ulp of another summation order would lose a
//            point's whole gradient;
//   layers   dW2 = h2^T d3 (dw_gemm, split-K); bwd_rows<kD2>: d2 = (d3
//            W2^T) lrelu'(z2) over h2; dW1 = h1^T d2; bwd_rows<kD1>: gh1 =
//            d2 W1^T, d1a = gh1 lrelu'(z1a) over h1, d1b = gh1 lrelu'(z1b)
//            over d3; dWn = nb^T d1a, dWe = edge^T d1b; bwd_rows<kGnbr>:
//            d1b We^T into x2 (for gctr), then the same chains continue
//            over d1a Wn^T: gnbr = [d1b | d1a] [We ; Wn]^T, one product of
//            depth 256; bwd_gctr: gctr = -sum_j (d1b_j We^T), j ascending.
// Only a slope is read of z1a, z1b and z2: their signs are kept as bits,
// 48 bytes a row (store_signs). Every dot product of a row is one fmaf
// chain in a fixed order wherever the row lies in a tile, so duplicated
// planes give equal gradients bit for bit; each dW product sums fixed row
// ranges into one partial per block, which sum_cols adds in a fixed order:
// no float atomics, two calls agree bit for bit. The wrapper allocates the
// scratch (ops/kernels/edgeconv.py : tiled_bwd_plan).
//
// On the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md): a k = 12 launch
// 2.18 ms of device time (predicted 1.9-2.9; the general kernel 37.5, the
// plain version 3.9), 2.24x its bound; k = 4 0.84 ms, 2.6x. The products
// run at 32-38 TFLOP/s, about half the FFMA peak; the tie pass, which
// reads z3 twice at max / min, took 0.18 ms against 0.11-0.16 predicted.
// Holding z1a and z1b's products in one block, or forming edge in the
// operand load, spilled registers: hence the separate launches above.
namespace bwdt {

constexpr int C = 64, H = 128, O = 256;
constexpr int BM = 128;   // rows of a row product's tile
constexpr int SW = 12;    // sign words a row: z1a, z1b, z2, 4 each

// bwd_rows epilogues: kStore the product; kAct its signs into the words
// from w0, lrelu of it into out; kAddAct the same, added to out; kD2, kD1,
// kGnbr as the note above says
enum RowEpi { kStore = 0, kAct = 1, kAddAct = 2, kD2 = 3, kD1 = 4, kGnbr = 5 };

__device__ __forceinline__ float lrelu_rn(float x) {
  return x >= 0.f ? x : __fmul_rn(0.2f, x);
}

// The signs (z >= 0) of a 128 x 128 tile's accumulators into each row's 4
// sign words from word w0: thread (ty, tx)'s column j (Tile<BM, 128>) is
// bit 16 (j % 2) + tx of word j / 2. A warp holds two ty: lanes 0-15 write
// the even one's words, lanes 16-31 the odd one's. Every lane must call.
__device__ __forceinline__ void store_signs(const float (&acc)[8][8],
                                            unsigned* sgn, int w0, int m0,
                                            int R) {
  using T = Tile<BM, H>;
  const int lane = threadIdx.x % 32, sh = lane & 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    unsigned b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = (__ballot_sync(0xffffffffu, acc[i][j] >= 0.f) >> sh) & 0xffffu;
    const int r = m0 + T::row(i);
    if (lane % 16 == 0 && r < R)
      *reinterpret_cast<uint4*>(sgn + (size_t)r * SW + w0) =
          make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16, b[4] | b[5] << 16,
                     b[6] | b[7] << 16);
  }
}

__device__ __forceinline__ uint4 sign_words(const unsigned* sgn, int r, int w0) {
  return *reinterpret_cast<const uint4*>(sgn + (size_t)r * SW + w0);
}

// lrelu'(z) at the thread's register column j (< 8) from its row's words.
__device__ __forceinline__ float slope_of(const uint4& w, int j) {
  const unsigned word = j / 2 == 0 ? w.x : j / 2 == 1 ? w.y : j / 2 == 2 ? w.z : w.w;
  return (word >> (16 * (j % 2) + threadIdx.x % 16)) & 1u ? 1.f : 0.2f;
}

// Rows m0 + Tile::row(i) < R of out [R, ld] from column n0 (float4 stores).
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BM / 16][BN / 16],
                                           float* out, int ld, int m0, int n0,
                                           int R) {
  using T = Tile<BM, BN>;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = m0 + T::row(i);
    if (r >= R) continue;
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g)
      *reinterpret_cast<float4*>(out + (size_t)r * ld + n0 + g * 64 + tx * 4) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  }
}

struct RowArgs {
  Src a, b;       // the product a b (depth the channels of a)
  Src a2, b2;     // kGnbr: the second half's pair
  int R, depth, ldo, w0;
  float* out;     // [R, ldo]
  float* out2;    // kD1: d1b [R, H]; kGnbr: d1b We^T [R, C]
  unsigned* sgn;  // [R, SW]
};

// One BM x BN tile of a row product (rows blockIdx.x BM, columns blockIdx.y
// BN) and its epilogue EPI. BKC: b is read transposed (a W^T product).
template <int BN, bool BKC, int EPI>
__global__ void __launch_bounds__(THREADS, 2) bwd_rows(RowArgs P) {
  using T = Tile<BM, BN>;
  extern __shared__ float sm[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[T::TM][T::TN];
  product<BM, BN, true, BKC, kPlain, kPlain>(P.a, P.R, m0, P.b, P.b.rows, n0,
                                             0, P.depth, sm, acc);
  if constexpr (EPI == kAct || EPI == kAddAct) {
    store_signs(acc, P.sgn, P.w0, m0, P.R);
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int r = m0 + T::row(i);
      if (r >= P.R) continue;
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) {
        float4* const o = reinterpret_cast<float4*>(
            P.out + (size_t)r * P.ldo + n0 + g * 64 + tx * 4);
        float4 v = make_float4(lrelu_rn(acc[i][4 * g]), lrelu_rn(acc[i][4 * g + 1]),
                               lrelu_rn(acc[i][4 * g + 2]), lrelu_rn(acc[i][4 * g + 3]));
        if (EPI == kAddAct) {
          const float4 u = *o;
          v = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
        }
        *o = v;
      }
    }
  } else if constexpr (EPI == kStore) {
    store_tile<BN>(acc, P.out, P.ldo, m0, n0, P.R);
  } else if constexpr (EPI == kD2 || EPI == kD1) {
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int r = m0 + T::row(i);
      if (r >= P.R) continue;
      const uint4 wa = sign_words(P.sgn, r, EPI == kD2 ? 8 : 0);
      const uint4 wb = EPI == kD1 ? sign_words(P.sgn, r, 4) : wa;
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) {
        float da[4], db[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          da[u] = acc[i][4 * g + u] * slope_of(wa, 4 * g + u);
          db[u] = acc[i][4 * g + u] * slope_of(wb, 4 * g + u);
        }
        const size_t o = (size_t)r * P.ldo + g * 64 + tx * 4;
        *reinterpret_cast<float4*>(P.out + o) = make_float4(da[0], da[1], da[2], da[3]);
        if (EPI == kD1)
          *reinterpret_cast<float4*>(P.out2 + o) = make_float4(db[0], db[1], db[2], db[3]);
      }
    }
  } else {   // kGnbr
    store_tile<BN>(acc, P.out2, P.ldo, m0, n0, P.R);
    product<BM, BN, true, BKC, kPlain, kPlain, false>(P.a2, P.R, m0, P.b2,
                                                      P.b2.rows, n0, 0, P.depth,
                                                      sm, acc);
    store_tile<BN>(acc, P.out, P.ldo, m0, n0, P.R);
  }
}

// edge [R, C] = nb - its centre's row (thread i: 4 columns of row i / 16).
__global__ void __launch_bounds__(THREADS)
bwd_edge(const float* __restrict__ nb, const float* __restrict__ ctr, int B,
         int K, int N, float* __restrict__ edge) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * K * N * (C / 4)) return;
  const int q = i % (C / 4), r = i / (C / 4), p = r / (K * N) * N + r % N;
  const float4 v = *reinterpret_cast<const float4*>(nb + (size_t)r * C + 4 * q);
  const float4 c = *reinterpret_cast<const float4*>(ctr + (size_t)p * C + 4 * q);
  *reinterpret_cast<float4*>(edge + (size_t)r * C + 4 * q) =
      make_float4(v.x - c.x, v.y - c.y, v.z - c.z, v.w - c.w);
}

// d3 over z3 [R, O] (above): thread i holds 4 columns of one (b, n).
template <int AGG>
__global__ void __launch_bounds__(THREADS)
bwd_ties(float* __restrict__ z, const float* __restrict__ g, int B, int K,
         int N) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * N * (O / 4)) return;
  const int q = i % (O / 4), p = i / (O / 4), b = p / N, n = p - b * N;
  float* const z0 = z + ((size_t)b * K * N + n) * O + 4 * q;
  const size_t step = (size_t)N * O;
  const float4 gv = *reinterpret_cast<const float4*>(g + (size_t)p * O + 4 * q);
  float gy[4] = {gv.x, gv.y, gv.z, gv.w}, acc[4], cnt[4];
  constexpr bool extreme = AGG == kMax || AGG == kMin;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (AGG == kMean) gy[u] = gy[u] / (float)K;
    acc[u] = 0.f;
    cnt[u] = 1.f;
  }
  if (extreme) {
    for (int j = 0; j < K; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(z0 + j * step);
      const float zz[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float y = lrelu_rn(zz[u]);
        const bool beyond = AGG == kMax ? y > acc[u] : y < acc[u];
        if (j == 0 || beyond) {
          acc[u] = y;
          cnt[u] = 1.f;
        } else if (y == acc[u]) {
          cnt[u] += 1.f;
        }
      }
    }
  }
  for (int j = 0; j < K; ++j) {
    float4* const zp = reinterpret_cast<float4*>(z0 + j * step);
    const float4 v = *zp;
    const float zz[4] = {v.x, v.y, v.z, v.w};
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float gu =
          extreme ? (lrelu_rn(zz[u]) == acc[u] ? gy[u] : 0.f) / cnt[u] : gy[u];
      d[u] = gu * lrelu_grad(zz[u]);
    }
    *zp = make_float4(d[0], d[1], d[2], d[3]);
  }
}

// gctr [B, N, C] = -sum over j ascending of gb [R, C] at the rows of (b, n).
__global__ void __launch_bounds__(THREADS)
bwd_gctr(const float* __restrict__ gb, int B, int K, int N,
         float* __restrict__ gctr) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * N * (C / 4)) return;
  const int q = i % (C / 4), p = i / (C / 4), b = p / N, n = p - b * N;
  const float* const g0 = gb + ((size_t)b * K * N + n) * C + 4 * q;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < K; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(g0 + (size_t)j * N * C);
    s = make_float4(s.x - v.x, s.y - v.y, s.z - v.z, s.w - v.w);
  }
  *reinterpret_cast<float4*>(gctr + (size_t)p * C + 4 * q) = s;
}

template <int BN, bool BKC, int EPI>
cudaError_t rows_go(const RowArgs& P, int col_tiles, cudaStream_t st) {
  auto kern = bwd_rows<BN, BKC, EPI>;
  static const cudaError_t e = allow_smem(kern, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.R + BM - 1) / BM, col_tiles);
  kern<<<grid, THREADS,
         sizeof(float) * pipe_floats<BM, BN, true, BKC, kPlain, kPlain>(), st>>>(P);
  return cudaGetLastError();
}

// dW [M, 128 k] = A^T B over the split row ranges, then their sum into out.
template <int BMW, int AKIND>
cudaError_t dw_go(const DwArgs& P, float* out, cudaStream_t st) {
  auto kern = dw_gemm<BMW, 128, AKIND, kPlain>;
  static const cudaError_t e = allow_smem(kern, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  const int splits = (P.R + P.split_rows - 1) / P.split_rows;
  const size_t smem =
      sizeof(float) * pipe_floats<BMW, 128, false, false, AKIND, kPlain>();
  kern<<<dim3(P.M / BMW, P.N / 128, splits), THREADS, smem, st>>>(P);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return e2;
  sum_cols_launch(P.part, splits, P.M * P.N, out, st);
  return cudaGetLastError();
}

template <int AGG>
cudaError_t ties_go(float* z3, const float* g, int B, int K, int N,
                    cudaStream_t st) {
  const int n = B * N * (O / 4);
  bwd_ties<AGG><<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(z3, g, B, K, N);
  return cudaGetLastError();
}

Src src(const void* p, int rows, int chans) {
  Src s = {};
  s.p = static_cast<const float*>(p);
  s.rows = rows;
  s.chans = chans;
  return s;
}

DwArgs dw_args(const Src& a, const Src& b, int R, int M, int N, int split_rows,
               float* part) {
  DwArgs D = {};
  D.A = a;
  D.B = b;
  D.R = R;
  D.M = M;
  D.N = N;
  D.split_rows = split_rows;
  D.part = part;
  return D;
}

#define BWDT_TRY(call)                        \
  do {                                        \
    const cudaError_t e_ = (call);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

// The launches in order (the note above). split: the rows of a dW partial,
// for dW2, dW1, dWn, dWe.
cudaError_t backward(const void* nbr, const void* ctr, const void* wn,
                     const void* we, const void* w1, const void* w2,
                     const void* g, float* gnbr, float* gctr, float* dw,
                     float* scratch, float* part, int B, int K, int N, int agg,
                     const int (&split)[4], cudaStream_t st) {
  const int R = B * K * N;
  float* const x1 = scratch;                  // h1, then d1a
  float* const x2 = x1 + (size_t)R * H;       // h2, then d2, then d1b We^T
  float* const x3 = x2 + (size_t)R * H;       // z3, then d3, then d1b
  float* const xe = x3 + (size_t)R * O;       // edge
  unsigned* const sgn = reinterpret_cast<unsigned*>(xe + (size_t)R * C);
  float* const dwn = dw;
  float* const dwe = dwn + C * H;
  float* const dw1 = dwe + C * H;
  float* const dw2 = dw1 + H * H;
  const int ne = R * (C / 4);
  bwd_edge<<<(ne + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      static_cast<const float*>(nbr), static_cast<const float*>(ctr), B, K, N,
      xe);
  BWDT_TRY(cudaGetLastError());
  const Src edge = src(xe, R, C);

  RowArgs P = {};
  P.R = R;
  P.sgn = sgn;
  P.a = src(nbr, R, C);
  P.b = src(wn, C, H);
  P.depth = C;
  P.ldo = H;
  P.w0 = 0;
  P.out = x1;
  BWDT_TRY((rows_go<H, false, kAct>(P, 1, st)));
  P.a = edge;
  P.b = src(we, C, H);
  P.w0 = 4;
  BWDT_TRY((rows_go<H, false, kAddAct>(P, 1, st)));
  P.a = src(x1, R, H);
  P.b = src(w1, H, H);
  P.depth = H;
  P.w0 = 8;
  P.out = x2;
  BWDT_TRY((rows_go<H, false, kAct>(P, 1, st)));
  P.a = src(x2, R, H);
  P.b = src(w2, H, O);
  P.ldo = O;
  P.out = x3;
  BWDT_TRY((rows_go<128, false, kStore>(P, O / 128, st)));
  const float* gf = static_cast<const float*>(g);
  switch (agg) {
    case kMax: BWDT_TRY(ties_go<kMax>(x3, gf, B, K, N, st)); break;
    case kMin: BWDT_TRY(ties_go<kMin>(x3, gf, B, K, N, st)); break;
    case kSum: BWDT_TRY(ties_go<kSum>(x3, gf, B, K, N, st)); break;
    default: BWDT_TRY(ties_go<kMean>(x3, gf, B, K, N, st));
  }

  BWDT_TRY((dw_go<128, kPlain>(
      dw_args(src(x2, R, H), src(x3, R, O), R, H, O, split[0], part), dw2, st)));
  P.a = src(x3, R, O);
  P.b = src(w2, H, O);          // read transposed: W2^T
  P.depth = O;
  P.ldo = H;
  P.out = x2;
  BWDT_TRY((rows_go<H, true, kD2>(P, 1, st)));
  BWDT_TRY((dw_go<128, kPlain>(
      dw_args(src(x1, R, H), src(x2, R, H), R, H, H, split[1], part), dw1, st)));
  P.a = src(x2, R, H);
  P.b = src(w1, H, H);
  P.depth = H;
  P.out = x1;
  P.out2 = x3;
  BWDT_TRY((rows_go<H, true, kD1>(P, 1, st)));
  BWDT_TRY((dw_go<64, kPlain>(
      dw_args(src(nbr, R, C), src(x1, R, H), R, C, H, split[2], part), dwn, st)));
  BWDT_TRY((dw_go<64, kPlain>(
      dw_args(edge, src(x3, R, H), R, C, H, split[3], part), dwe, st)));
  P.a = src(x3, R, H);          // d1b We^T, then d1a Wn^T
  P.b = src(we, C, H);
  P.a2 = src(x1, R, H);
  P.b2 = src(wn, C, H);
  P.ldo = C;
  P.out = gnbr;
  P.out2 = x2;
  BWDT_TRY((rows_go<C, true, kGnbr>(P, 1, st)));
  const int n = B * N * (C / 4);
  bwd_gctr<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(x2, B, K, N, gctr);
  return cudaGetLastError();
}

#undef BWDT_TRY

}  // namespace bwdt

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

// The bf16 forward with the SharedMLP at (C, H, O) = (64, 128, 256) on the
// tensor cores: edgeconv_fwd's contract for bf16 = 1, mlp = 1 at these
// widths. Every pointer 16-byte aligned; B * N >= 1, K >= 1.
extern "C" int edgeconv_fwd_bf16_tc(const void* nbr, const void* ctr,
                                    const void* wn, const void* we,
                                    const void* w1, const void* w2, void* out,
                                    int B, int K, int N, int agg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (agg) {
    case kMax: return tc::launch<kMax>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
    case kMin: return tc::launch<kMin>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
    case kSum: return tc::launch<kSum>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
    default: return tc::launch<kMean>(nbr, ctr, wn, we, w1, w2, out, B, K, N, s);
  }
}

// The f32 forward on register tiles (f32t::edgeconv_f32t_kernel): the
// contract of edgeconv_fwd for bf16 = 0 at the classes below (mlp, C, H, O);
// any other class returns cudaErrorInvalidValue. Every pointer 16-byte
// aligned; B * N >= 1, K >= 1.
extern "C" int edgeconv_fwd_f32_tiled(const void* nbr, const void* ctr,
                                      const void* wn, const void* we,
                                      const void* w1, const void* w2, void* out,
                                      int B, int K, int N, int C, int H, int O,
                                      int mlp, int agg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using namespace f32t;
#define EDGECONV_F32T(c, h, o, m, tp)                                          \
  if (bool(mlp) == m && C == c && H == h && O == o)                           \
    return launch_agg<Shape<c, h, o, m, tp>>(nbr, ctr, wn, we, w1, w2, out, B, \
                                             K, N, agg, s)
  EDGECONV_F32T(64, 128, 256, true, 40);    // upsampler and mask head
  EDGECONV_F32T(64, 128, 128, false, 40);   // mask head's sum
  EDGECONV_F32T(6, 64, 128, true, 80);      // EdgeConv_0
  EDGECONV_F32T(32, 16, 32, true, 64);      // IDGCN
#undef EDGECONV_F32T
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 backward with the SharedMLP at (C, H, O) = (64, 128, 256) on GEMM
// tiles (bwdt): edgeconv_bwd's contract for bf16 = 0, mlp = 1 at these
// widths, without dw_part. scratch: R (2 H + O + C) floats and R 12 words, R =
// B K N; part: max over the dW products of splits M N floats, splits =
// ceil(R / split_rows) (dW2 128 x 256, dW1 128 x 128, dWn and dWe 64 x 128),
// split_rows a multiple of 8. Every pointer 16-byte aligned; B * N >= 1,
// K >= 1, R * 256 < 2^31.
extern "C" int edgeconv_bwd_f32_tiled(const void* nbr, const void* ctr,
                                      const void* wn, const void* we,
                                      const void* w1, const void* w2,
                                      const void* g, void* gnbr, void* gctr,
                                      void* dw, void* scratch, void* part,
                                      int B, int K, int N, int agg,
                                      int split_w2, int split_w1, int split_wn,
                                      int split_we, void* stream) {
  const int split[4] = {split_w2, split_w1, split_wn, split_we};
  return static_cast<int>(bwdt::backward(
      nbr, ctr, wn, we, w1, w2, g, static_cast<float*>(gnbr),
      static_cast<float*>(gctr), static_cast<float*>(dw),
      static_cast<float*>(scratch), static_cast<float*>(part), B, K, N, agg,
      split, static_cast<cudaStream_t>(stream)));
}
