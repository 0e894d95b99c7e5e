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
// weights; it now serves only the f32 forwards outside the register-tiled
// kernel's classes and the bf16 forwards outside the tensor-core kernel's
// (both below), where every block reads the weights in the same order from
// the 50 MB L2 and partly from L1. The last layer's outputs are folded into
// the aggregate in registers (a thread keeps the same (point, column)
// pairs for every plane), so they never touch shared memory either.
//
// The f32 forward at five classes (mlp, C, H, O) has a kernel of its own,
// edgeconv_f32t_kernel (entry point edgeconv_fwd_f32_tiled), with the same
// contract. It replaces _edgeconv_kernel with cdt = float32 at the
// upsampler's and mask head's (64, 128, 256), the mask head's sum without
// the SharedMLP (64, 128, 128), EdgeConv_0's (6, 64, 128), the IDGCN's
// (32, 16, 32) and the action generator's EdgeConv_0 (3, 64, 128). TF32 stays off, so its bound is the card's 67 TFLOP/s of
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
// 73,984 B, (32, 16, 32) 51,200 B, (3, 64, 128) (C padded to 4) 41,216 B.
// The grid is persistent (resident blocks an SM x 132, at most one a
// tile); a block strides over the point tiles (40 points, 80 at (6, 64,
// 128), 64 at the IDGCN, 16 at (3, 64, 128), whose 128-point action
// frames would fill only 2 blocks with 80-point tiles: one frame runs 8
// blocks, a train step's 12 frames 96; at (64, 128, 256) 10,240 points
// make 256 tiles, two rounds of 132 blocks filled to 97%),
// and the next plane's rows (at a tile's last plane, the next tile's
// centres too) arrive by cp.async while the current plane computes. Only
// [N, O] is written.
//
// The bf16 forward at every class of the serving forward has a kernel of
// its own, edgeconv_tc_kernel (entry point edgeconv_fwd_bf16_tc), with the
// same contract: (mlp, C, H, O) = (1, 64, 128, 256), the upsampler's and
// mask head's; (0, 64, 128, 128), the mask head's sum; (1, 6, 64, 128),
// EdgeConv_0; (1, 32, 16, 32), the IDGCN's. It replaces _edgeconv_kernel
// with cdt = bfloat16 there. Its bound at 10,240 points: a k=12 launch of
// (64, 128, 256) does 16.1 GFLOP, 16.3 us at the card's 989 TFLOP/s of
// bf16 tensor-core products, against 15.7 MB of bf16 table, 4.7 us at 3.35
// TB/s; EdgeConv_0 at k=20 5.3 GFLOP (5.4 us) against 2.5 MB; the IDGCN
// at k=20 0.73 GFLOP (0.7 us) against 13.1 MB (3.9 us), the k=8 sum 2.7
// (2.7 us) against 14.4 MB (4.3 us). Every product goes to the tensor
// cores, where the general kernel widens each bf16 value to f32 and runs
// FFMA chains at 67 TFLOP/s with its weights read from L2. A class's bf16
// weights are staged once per block in shared memory (128 KB at (64, 128,
// 256), 35 KB at the sum, 31 KB at EdgeConv_0, 5 KB at the IDGCN). WG warps
// share a 16-point tile (tc::Shape): its planes' rows and edges (formed in
// f32, rounded to bf16) go to shared memory, the next plane's rows waiting
// in registers; the warps split each layer's columns; h1 and h2 round to
// bf16 into shared memory, where ldmatrix reads them (and, transposed, the
// weights) as fragments; the output columns' aggregate stays in the
// accumulators' layout in registers over the K planes. Only [N, O] is
// written. EdgeConv_0's 6 channels pad to one k16 step with zero channels
// and zero weight rows (exact: zeros add nothing); its 16-row tile, 192
// contiguous bytes, starts on 16 bytes only where (row * 6) % 8 == 0, so a
// thread moves its 16 bytes at once where they are aligned and whole and
// in four 4-byte moves otherwise. At (64, 128, 256) four groups of four
// warps share one block an SM (the weights fill it); the sum and
// EdgeConv_0 take one group a block, five blocks an SM; the IDGCN (H = 16,
// two n8 tiles, which four warps cannot split) one warp a tile, meeting
// only at __syncwarp, two tiles a block. 10,240 points (640 tiles) run in
// one wave at each of the three.
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

// ---------------------------------------- bf16 tensor-core forward (classes)
//
// edgeconv_tc_kernel: the bf16 forward at the classes of Shape on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). The contract is
// edgeconv_kernel's for T = bf16; the head of this file says what bounds it
// and how it is laid out.
namespace tc {

using bf16 = __nv_bfloat16;

// A class's widths and layout. WG warps share a 16-point tile, warp w
// computing columns HW w .. +HW of h1 and h2 and OW w .. +OW of the output
// (without the SharedMLP the output is h1 folded: OW = HW); a block holds
// GROUPS tiles in flight and at least MINB blocks fit an SM. C pads to
// CP, a multiple of the k16 step, with zero channels and weight rows: zeros
// add exactly. bf16 row pitches carry 16 bytes of padding, so the 8 rows an
// ldmatrix reads lie in 8 different bank groups. Without the SharedMLP the
// group double-buffers the plane's rows, so a plane needs one barrier.
template <int C_, int H_, int O_, bool MLP_, int WG_, int GROUPS_, int MINB_>
struct Shape {
  static constexpr int C = C_, CP = (C_ + 15) / 16 * 16, H = H_;
  static constexpr bool MLP = MLP_;
  static constexpr int O = MLP_ ? O_ : H_;
  static constexpr int WG = WG_, GROUPS = GROUPS_, MINB = MINB_;
  static constexpr int GT = 32 * WG, THREADS = GT * GROUPS;
  static constexpr int HW = H / WG, OW = O / WG;
  static constexpr int LDC = CP + 8, LDH = H + 8, LDO = O + 8;
  static constexpr int NB = MLP ? 1 : 2;                 // row buffers a group
  static constexpr int W_ELEMS = 2 * CP * LDH + (MLP ? H * LDH + H * LDO : 0);
  static constexpr int G_ELEMS = NB * 2 * TP * LDC + (MLP ? 2 * TP * LDH : 0);
  static constexpr size_t SMEM = sizeof(bf16) * (W_ELEMS + GROUPS * G_ELEMS);
  // A tile of TP rows is TP C contiguous values in device memory: UNITS
  // units of 8 (16 bytes), unit q holding values 8q .. 8q + 7; a thread
  // owns units gt, gt + GT, ... (NU of them). WIDE: a unit lies in one row.
  static constexpr bool WIDE = C_ % 8 == 0;
  static constexpr int UNITS = TP * C_ / 8, NU = (UNITS + GT - 1) / GT;
  static_assert(C_ % 2 == 0 && H % 16 == 0 && HW % 16 == 0 && OW % 16 == 0,
                "widths");
  static_assert(GROUPS <= 15 && SMEM <= 232448, "barriers and shared memory");
};

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

// The WG warps of a tile meet: one warp alone syncs as a warp; group g of
// several uses named barrier 1 + g
template <class SH>
__device__ __forceinline__ void group_sync(int group) {
  if constexpr (SH::WG == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "r"(SH::GT)
                 : "memory");
  }
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

__device__ __forceinline__ unsigned word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// A [rows][cols] bf16 weight into a [rows_p][ld] tile, 16 bytes a move;
// rows past ``rows`` are zero
template <class SH>
__device__ __forceinline__ void stage(const bf16* __restrict__ src, int rows,
                                      int rows_p, int cols, int ld, bf16* dst) {
  const int chunks = cols / 8;
  for (int e = threadIdx.x; e < rows_p * chunks; e += SH::THREADS) {
    const int r = e / chunks, c = e - r * chunks;
    *reinterpret_cast<uint4*>(dst + r * ld + 8 * c) =
        r < rows ? __ldg(reinterpret_cast<const uint4*>(src) + e)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The thread's units of the TP-row tile of a [.., C] tensor whose first
// row is at src; values of rows past np read as 0. A unit of a WIDE class
// is one 16-byte move; otherwise (C = 6: a unit straddles rows, and the
// tile starts on 16 bytes only where (row * C) % 8 == 0) one 16-byte move
// where it is aligned and whole, else four 4-byte moves (C is even, so a
// pair never straddles rows).
template <class SH>
__device__ __forceinline__ void load_units(const bf16* __restrict__ src, int np,
                                           int gt, uint4 (&v)[SH::NU]) {
  const int live = np * SH::C;   // values of the tile's live rows
#pragma unroll
  for (int u = 0; u < SH::NU; ++u) {
    const int q = gt + u * SH::GT;
    v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (q >= SH::UNITS) continue;
    const bf16* s = src + (size_t)q * 8;
    const bool aligned = (reinterpret_cast<size_t>(s) & 15) == 0;
    if (SH::WIDE || (aligned && 8 * q + 8 <= live)) {
      if (8 * q < live) v[u] = __ldg(reinterpret_cast<const uint4*>(s));
    } else {
      const unsigned* sw = reinterpret_cast<const unsigned*>(s);
      v[u] = make_uint4(8 * q < live ? __ldg(sw) : 0u,
                        8 * q + 2 < live ? __ldg(sw + 1) : 0u,
                        8 * q + 4 < live ? __ldg(sw + 2) : 0u,
                        8 * q + 6 < live ? __ldg(sw + 3) : 0u);
    }
  }
}

// The thread's units of a plane's rows (nv) and their edges bf16(nv - cv)
// into the [TP][LDC] tiles nb and ed (channels C .. CP stay as they are: 0)
template <class SH>
__device__ __forceinline__ void store_units(const uint4 (&nv)[SH::NU],
                                            const uint4 (&cv)[SH::NU], int gt,
                                            bf16* nb, bf16* ed) {
#pragma unroll
  for (int u = 0; u < SH::NU; ++u) {
    const int q = gt + u * SH::GT;
    if (q >= SH::UNITS) continue;
    const uint4 n = nv[u], c = cv[u];
    if constexpr (SH::WIDE) {
      const int o = (q / (SH::C / 8)) * SH::LDC + 8 * (q % (SH::C / 8));
      *reinterpret_cast<uint4*>(nb + o) = n;
      *reinterpret_cast<uint4*>(ed + o) =
          make_uint4(sub_pair(n.x, c.x), sub_pair(n.y, c.y),
                     sub_pair(n.z, c.z), sub_pair(n.w, c.w));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 8 * q + 2 * k;   // the pair's first value in the tile
        const int o = (e / SH::C) * SH::LDC + e % SH::C;
        *reinterpret_cast<unsigned*>(nb + o) = word(n, k);
        *reinterpret_cast<unsigned*>(ed + o) = sub_pair(word(n, k), word(c, k));
      }
    }
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
// GROUPS * gridDim.x-th. A group's threads each load their units of every
// plane (and keep their centre units in registers); warp w computes its
// columns of each layer and keeps its output columns' aggregate in the
// accumulators' layout over the K planes; the next plane's units wait in
// registers while the current plane's products run. Only [N, O] is
// written.
template <class SH, int AGG>
__global__ void __launch_bounds__(SH::THREADS, SH::MINB)
edgeconv_tc_kernel(const bf16* __restrict__ nbr, const bf16* __restrict__ ctr,
                   const bf16* __restrict__ wn, const bf16* __restrict__ we,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                   bf16* __restrict__ out, int B, int K, int N) {
  constexpr int C = SH::C, CP = SH::CP, H = SH::H, O = SH::O;
  constexpr int LDC = SH::LDC, LDH = SH::LDH, LDO = SH::LDO;
  constexpr int HW = SH::HW, OW = SH::OW, NU = SH::NU, GT = SH::GT;
  constexpr bool MLP = SH::MLP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wn_s = reinterpret_cast<bf16*>(smem_raw);    // [CP][LDH]
  bf16* we_s = wn_s + CP * LDH;                      // [CP][LDH]
  bf16* w1_s = we_s + CP * LDH;                      // [H][LDH] (MLP)
  bf16* w2_s = w1_s + (MLP ? H * LDH : 0);           // [H][LDO] (MLP)
  const int group = threadIdx.x / GT, gt = threadIdx.x % GT;
  const int warp = gt / 32, lane = threadIdx.x % 32;
  bf16* nb_s = wn_s + SH::W_ELEMS + group * SH::G_ELEMS;   // NB x [TP][LDC]
  bf16* ed_s = nb_s + SH::NB * TP * LDC;                    // NB x [TP][LDC]
  bf16* h1_s = ed_s + SH::NB * TP * LDC;                    // [TP][LDH] (MLP)
  bf16* h2_s = h1_s + TP * LDH;                             // [TP][LDH] (MLP)

  for (int e = gt; e < SH::G_ELEMS / 8; e += GT)   // channels past C stay 0
    reinterpret_cast<uint4*>(nb_s)[e] = make_uint4(0u, 0u, 0u, 0u);
  stage<SH>(wn, C, CP, H, LDH, wn_s);
  stage<SH>(we, C, CP, H, LDH, we_s);
  if constexpr (MLP) {
    stage<SH>(w1, H, H, H, LDH, w1_s);
    stage<SH>(w2, H, H, O, LDO, w2_s);
  }
  __syncthreads();

  const int fr = lane / 4, fc = 2 * (lane % 4);   // fragment row and column
  const int row_tiles = (N + TP - 1) / TP;
  int plane = 0;   // planes this group has run (the row buffer's parity)
  for (int tile = group * gridDim.x + blockIdx.x; tile < B * row_tiles;
       tile += SH::GROUPS * gridDim.x) {
    const int b = tile / row_tiles, p0 = (tile - b * row_tiles) * TP;
    const int np = min(TP, N - p0);
    uint4 cv[NU], nv[NU];
    load_units<SH>(ctr + ((size_t)b * N + p0) * C, np, gt, cv);
    const bf16* rows = nbr + ((size_t)b * K * N + p0) * C;
    load_units<SH>(rows, np, gt, nv);

    float acc[OW / 8][4];
    for (int j = 0; j < K; ++j, ++plane) {
      // plane j's rows and edges into shared memory; plane j + 1's rows
      // into registers while the plane's products run
      bf16* nb = nb_s + (plane % SH::NB) * TP * LDC;
      bf16* ed = ed_s + (plane % SH::NB) * TP * LDC;
      store_units<SH>(nv, cv, gt, nb, ed);
      group_sync<SH>(group);
      if (j + 1 < K) load_units<SH>(rows + (size_t)(j + 1) * N * C, np, gt, nv);

      // layer 1: h1 = bf16(lrelu(nb Wn) + lrelu(edge We))
      float za[HW / 8][4], zb[HW / 8][4];
      product<CP / 16, HW / 8>(nb, LDC, wn_s, LDH, HW * warp, lane, za);
      product<CP / 16, HW / 8>(ed, LDC, we_s, LDH, HW * warp, lane, zb);
      if constexpr (!MLP) {   // the output is h1, folded
#pragma unroll
        for (int nt = 0; nt < HW / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = round_to<bf16>(lrelu(za[nt][e]) + lrelu(zb[nt][e]));
            acc[nt][e] = j == 0 ? y : fold<AGG>(acc[nt][e], y);
          }
        continue;
      }
#pragma unroll
      for (int nt = 0; nt < HW / 8; ++nt) {
        bf16* h = h1_s + fr * LDH + HW * warp + 8 * nt + fc;
        *reinterpret_cast<unsigned*>(h) =
            pack(lrelu(za[nt][0]) + lrelu(zb[nt][0]),
                 lrelu(za[nt][1]) + lrelu(zb[nt][1]));
        *reinterpret_cast<unsigned*>(h + 8 * LDH) =
            pack(lrelu(za[nt][2]) + lrelu(zb[nt][2]),
                 lrelu(za[nt][3]) + lrelu(zb[nt][3]));
      }
      group_sync<SH>(group);

      // layer 2: h2 = bf16(lrelu(h1 W1))
      {
        float z[HW / 8][4];
        product<H / 16, HW / 8>(h1_s, LDH, w1_s, LDH, HW * warp, lane, z);
#pragma unroll
        for (int nt = 0; nt < HW / 8; ++nt) {
          bf16* h = h2_s + fr * LDH + HW * warp + 8 * nt + fc;
          *reinterpret_cast<unsigned*>(h) = pack(lrelu(z[nt][0]), lrelu(z[nt][1]));
          *reinterpret_cast<unsigned*>(h + 8 * LDH) =
              pack(lrelu(z[nt][2]), lrelu(z[nt][3]));
        }
      }
      group_sync<SH>(group);

      // layer 3: y = bf16(lrelu(h2 W2)), folded into the aggregate
      {
        float z[OW / 8][4];
        product<H / 16, OW / 8>(h2_s, LDH, w2_s, LDO, OW * warp, lane, z);
#pragma unroll
        for (int nt = 0; nt < OW / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = round_to<bf16>(lrelu(z[nt][e]));
            acc[nt][e] = j == 0 ? y : fold<AGG>(acc[nt][e], y);
          }
      }
    }

    // the aggregate out (bf16 values, exact); the mean then reads its sums
    // back one pair at a time and divides, so that no accumulator is live
    // across the true division's slow path (at the 128 registers of 512
    // threads, it spilled)
#pragma unroll
    for (int nt = 0; nt < OW / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = fr + 8 * half;
        if (p < np)
          *reinterpret_cast<unsigned*>(out + ((size_t)b * N + p0 + p) * O +
                                       OW * warp + 8 * nt + fc) =
              pack(acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
    if constexpr (AGG == kMean) {
#pragma unroll
      for (int nt = 0; nt < OW / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = fr + 8 * half;
          if (p >= np) continue;
          unsigned* o = reinterpret_cast<unsigned*>(
              out + ((size_t)b * N + p0 + p) * O + OW * warp + 8 * nt + fc);
          unsigned v;   // opaque to the compiler: no forwarding of the store
          asm volatile("ld.global.u32 %0, [%1];\n"
                       : "=r"(v) : "l"(o) : "memory");
          const float2 f =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
          *o = pack(round_to<bf16>(f.x / (float)K),
                    round_to<bf16>(f.y / (float)K));
        }
    }
  }
}

template <class SH, int AGG>
int launch(const void* nbr, const void* ctr, const void* wn, const void* we,
           const void* w1, const void* w2, void* out, int B, int K, int N,
           cudaStream_t stream) {
  auto kern = edgeconv_tc_kernel<SH, AGG>;
  static int grid_max = 0;   // SMs x resident blocks an SM, found once
  if (grid_max == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SH::SMEM);
    int device = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        SH::THREADS, SH::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid_max = sms * per_sm;
  }
  const int tiles = B * ((N + TP - 1) / TP);
  const int groups = (tiles + SH::GROUPS - 1) / SH::GROUPS;
  const int grid = groups < grid_max ? groups : grid_max;   // one wave
  kern<<<grid, SH::THREADS, SH::SMEM, stream>>>(
      static_cast<const bf16*>(nbr), static_cast<const bf16*>(ctr),
      static_cast<const bf16*>(wn), static_cast<const bf16*>(we),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), B, K, N);
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

// ----------------------------- f32 backward on GEMM tiles and on row tiles
//
// The f32 backward at the four classes of the fused train step (entry
// point edgeconv_bwd_f32_tiled), with edgeconv_bwd's contract for bf16 = 0,
// every aggregate; in f32 every rounding point is the identity. It
// replaces _bwd_pallas / _edgeconv_bwd_kernel
// (tpugan_tpu/ops/pallas/edgeconv_kernel.py:277) at (mlp, C, H, O) =
// (1, 64, 128, 256), the upsampler's and the mask head's; (0, 64, 128,
// 128), the mask head's sum; (1, 6, 64, 128), EdgeConv_0; (1, 3, 64, 128),
// the action generator's EdgeConv_0; and (1, 32, 16, 32), the IDGCN's.
// The first four run layer-wise products on GEMM tiles (bwdt, a template
// over its Shape), the IDGCN a row-fused kernel (rowf).
//
// What bounds it on the H100: operations. Over R = B K N plane-rows it does
// three times the forward's multiply-adds a row (the forward once, then
// per layer dW and dX): at the fused train step's 12 frames of 1,152
// points, (64, 128, 256) 65.2 GFLOP at k = 12 (0.974 ms at 67 TFLOP/s of
// f32 FFMA, TF32 off) and 21.7 at k = 4 (0.325 ms); EdgeConv_0 21.7 at
// k = 20 (0.323 ms); the sum 10.9 at k = 8 (0.162 ms); the IDGCN 2.97 at
// k = 20 (0.044 ms) and 1.49 at k = 10. What the layer-wise products keep
// between the layers (edge, h1, h2, z3 and their cotangents, 2,352 bytes a
// row at (64, 128, 256)) moves about 2.5 GB at k = 12, 0.76 ms at 3.35
// TB/s: under the operations, not far.
//
// bwdt, layer-wise products over all R rows, each computed once, on the
// register-tiled GEMM block of gemm_tile.cuh (a 128 x 128 or 128 x 64
// output tile a block, 8 x 8 or 8 x 4 accumulators a thread, a 3-stage
// cp.async pipeline of 8-deep slabs). Row r = (b K + j) N + n, its centre
// row b N + n; each kernel below is one launch, in this order:
//   forward  bwd_edge: edge = nb - ctr into xe (read again by dWe);
//            bwd_rows<kAct>: z1a = nb Wn, lrelu(z1a) into x1, its signs
//            into sgn; bwd_rows<kAddAct>: z1b = edge We, its signs, h1 =
//            lrelu(z1a) + lrelu(z1b) over x1;
//            with the MLP: bwd_rows<kAct>: z2 = h1 W1, h2 = lrelu(z2) into
//            x2, its signs; bwd_rows<kStore>: z3 = h2 W2 into x3;
//   ties     bwd_ties: per (b, n, column) the K values of z3 give y =
//            lrelu(z3), the aggregate and the count of planes equal to it
//            (max / min), and d3 = gy [y == acc] / cnt lrelu'(z3) (sum: gy
//            = g; mean: g / K) over z3 in x3. Without the MLP the output is
//            h1 itself: bwd_ties_h1 takes y = h1 and writes d1a = gy
//            lrelu'(z1a) over h1 and d1b = gy lrelu'(z1b) into x3. The
//            count and the comparison come from the same stored values,
//            never from the forward kernel's output, where one ulp of
//            another summation order would lose a point's whole gradient;
//   layers   with the MLP: dW2 = h2^T d3 (dw_gemm, split-K);
//            bwd_rows<kD2>: d2 = (d3 W2^T) lrelu'(z2) over h2; dW1 = h1^T
//            d2; bwd_rows<kD1>: gh1 = d2 W1^T, d1a = gh1 lrelu'(z1a) over
//            h1, d1b = gh1 lrelu'(z1b) over d3; then every class: dWn = nb^T
//            d1a, dWe = edge^T d1b; bwd_rows<kGnbr>: d1b We^T into gb (for
//            gctr), then the same chains continue over d1a Wn^T: gnbr =
//            [d1b | d1a] [We ; Wn]^T, one product of depth 2 H; bwd_gctr:
//            gctr = -sum_j (d1b_j We^T), j ascending.
// Only a slope is read of z1a, z1b and z2: their signs are kept as bits,
// H / 32 words a layer and row (store_signs). EdgeConv_0's C = 6, and the
// action generator's C = 3 alike ("narrow"): z1a and z1b read their
// operands through 4-byte copies that zero-fill past the C channels (depth
// C in one 8-deep slab) and run in one block (bwd_rows<kH1>: one pass over
// h1); gnbr, dWn and dWe, which would fill C lanes of a 64-wide tile, take
// a tail kernel instead (bwd_narrow, after kD1); its 24- or 12-byte rows
// are not 16-byte aligned, so edge, gnbr and gctr move 4 bytes at a time
// there, and the sign words after the edges start at R C rounded up to
// H / 32 floats (R C is odd at C = 3 and odd R).
//
// rowf, the IDGCN (H = 16 would fill an eighth of a 128-column tile): a
// thread runs one plane-row's whole backward, the weights (7 KB) in shared
// memory, read as broadcasts. rowf_fwd: z3 = the row's forward into scratch;
// bwd_ties<.., 32>: d3 over it; rowf_bwd: a block of 128 threads walks
// 128-row tiles (blockIdx.x, + gridDim.x, ...): the tile's nb, edge and d3
// rows go to shared memory, each thread recomputes its row's forward (the
// slopes of z1a, z1b, z2 as 16-bit masks in registers) and runs its
// backward (d2, gh1, d1a, d1b into shared memory; gnbr and gb = d1b We^T
// straight to device memory, gb over the row's d3). Then the tile's dW
// products: each warp owns one of dWn, dWe, dW1, dW2, each lane a 4 x 4
// block of it in registers, over the block's tiles in order; at the end a
// block writes its 1,792 partial sums once, which sum_cols adds in block
// order. bwd_gctr sums gb as above.
//
// Every dot product of a row is one fmaf chain in a fixed order wherever
// the row lies in a tile, so duplicated planes give equal gradients bit for
// bit; each dW product sums fixed row ranges into one partial per block,
// which sum_cols adds in a fixed order: no float atomics, two calls agree
// bit for bit. The wrapper allocates the scratch and the partials
// (ops/kernels/edgeconv.py : tiled_bwd_plan).
//
// On the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md), device ms a launch
// at the fused step: (64, 128, 256) k = 12 2.18 (the general kernel 37.5,
// the plain version 3.9), 2.24x its bound, k = 4 0.84, 2.6x; EdgeConv_0
// 1.09 (general 16.8), 3.4x; the sum 0.50 (3.9), 3.1x; the IDGCN k = 20
// 0.33 (5.2), 7.4x, k = 10 0.18 (2.6); the action generator's EdgeConv_0
// at 12 x 128 points, k = 20, 0.157 (general 2.34), 4.5x. The wide
// products run at 32-38
// TFLOP/s, about half the FFMA peak; the tie pass, which reads z3 twice at
// max / min, takes 0.17-0.18 ms. rowf runs at about a quarter of the peak:
// a 16-byte weight broadcast feeds 4 FFMA a thread, so shared-memory loads
// pace it, and rowf_bwd holds 255 registers with one row a thread. At
// (64, 128, 256), holding z1a and z1b's products in one block, or forming
// edge in the operand load, spilled registers: hence the separate launches
// above (at C = 6 their depth is one slab, and kH1 holds both).
namespace bwdt {

constexpr int BM = 128;   // rows of a row product's tile

// A class: (C, H, O) with or without the SharedMLP (without: O = H). HW
// sign words a layer and row, SW a row (z1a, z1b and with the MLP z2).
template <int C_, int H_, int O_, bool MLP_>
struct Shape {
  static constexpr int C = C_, H = H_, O = MLP_ ? O_ : H_;
  static constexpr bool MLP = MLP_;
  static constexpr int HW = H / 32, SW = (MLP ? 3 : 2) * HW;
  static_assert(H == 64 || H == 128, "a layer's rows fill one tile");
  static_assert(!MLP || O % 128 == 0, "z3 in 128-column tiles");
  static_assert(C == 64 || C % 4 != 0, "gnbr fills one 64-column tile, or "
                                       "the narrow tail takes it");
};

// The tile of a dW product's M (N) extent.
__host__ __device__ constexpr int dw_tile(int m) { return m >= 128 ? 128 : 64; }

// bwd_rows epilogues: kStore the product; kAct its signs into the words
// from w0, lrelu of it into out; kAddAct the same, added to out; kD2, kD1,
// kGnbr as the note above says; kH1 (narrow C) z1a = a b and z1b = a2 b2 in
// one block, both signs, h1 = lrelu(z1a) + lrelu(z1b) into out
enum RowEpi { kStore = 0, kAct = 1, kAddAct = 2, kD2 = 3, kD1 = 4, kGnbr = 5,
              kH1 = 6 };

__device__ __forceinline__ float lrelu_rn(float x) {
  return x >= 0.f ? x : __fmul_rn(0.2f, x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The signs (z >= 0) of a BM x 16 TN tile's accumulators into each row's
// TN / 2 sign words from word w0 (sw words a row): thread (ty, tx)'s column
// j (Tile<BM, 16 TN>) is bit 16 (j % 2) + tx of word j / 2. A warp holds
// two ty: lanes 0-15 write the even one's words, lanes 16-31 the odd one's.
// Every lane must call.
template <int TN>
__device__ __forceinline__ void store_signs(const float (&acc)[BM / 16][TN],
                                            unsigned* sgn, int sw, int w0,
                                            int m0, int R) {
  using T = Tile<BM, 16 * TN>;
  static_assert(TN == 4 || TN == 8, "two or four words a layer");
  const int lane = threadIdx.x % 32, sh = lane & 16;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    unsigned b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = (__ballot_sync(0xffffffffu, acc[i][j] >= 0.f) >> sh) & 0xffffu;
    const int r = m0 + T::row(i);
    if (lane % 16 == 0 && r < R) {
      unsigned* const p = sgn + (size_t)r * sw + w0;
      if constexpr (TN == 8)
        *reinterpret_cast<uint4*>(p) =
            make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16, b[4] | b[5] << 16,
                       b[6] | b[7] << 16);
      else
        *reinterpret_cast<uint2*>(p) = make_uint2(b[0] | b[1] << 16,
                                                  b[2] | b[3] << 16);
    }
  }
}

// A row's HW sign words of one layer, from word w0.
template <int HW>
struct Words {
  unsigned w[HW];
};

template <int HW>
__device__ __forceinline__ Words<HW> sign_words(const unsigned* sgn, int sw,
                                                int r, int w0) {
  const unsigned* const p = sgn + (size_t)r * sw + w0;
  Words<HW> s;
  if constexpr (HW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    s.w[0] = v.x; s.w[1] = v.y; s.w[2] = v.z; s.w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    s.w[0] = v.x; s.w[1] = v.y;
  }
  return s;
}

// lrelu'(z) at the thread's register column j from its row's words.
template <int HW>
__device__ __forceinline__ float slope_of(const Words<HW>& s, int j) {
  return (s.w[j / 2] >> (16 * (j % 2) + threadIdx.x % 16)) & 1u ? 1.f : 0.2f;
}

// Whether z >= 0 at column col of a row whose layer words start at w: the
// same bit as above, found from the column (col = (j / 4) 64 + 4 tx + j % 4).
__device__ __forceinline__ bool sign_at(const unsigned* w, int col) {
  const int u = col % 4;
  return (w[2 * (col / 64) + u / 2] >> (16 * (u % 2) + (col % 64) / 4)) & 1u;
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
  unsigned* sgn;  // [R, S::SW]
};

// One BM x BN tile of a row product (rows blockIdx.x BM, columns blockIdx.y
// BN) and its epilogue EPI. BKC: b is read transposed (a W^T product).
template <class S, int BN, bool BKC, int EPI>
__global__ void __launch_bounds__(THREADS, 2) bwd_rows(RowArgs P) {
  using T = Tile<BM, BN>;
  extern __shared__ float sm[];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[T::TM][T::TN];
  product<BM, BN, true, BKC, kPlain, kPlain>(P.a, P.R, m0, P.b, P.b.rows, n0,
                                             0, P.depth, sm, acc);
  if constexpr (EPI == kH1) {
    float acc2[T::TM][T::TN];
    product<BM, BN, true, BKC, kPlain, kPlain>(P.a2, P.R, m0, P.b2, P.b2.rows,
                                               n0, 0, P.depth, sm, acc2);
    store_signs<T::TN>(acc, P.sgn, S::SW, 0, m0, P.R);
    store_signs<T::TN>(acc2, P.sgn, S::SW, S::HW, m0, P.R);
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int r = m0 + T::row(i);
      if (r >= P.R) continue;
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = lrelu_rn(acc[i][4 * g + u]) + lrelu_rn(acc2[i][4 * g + u]);
        *reinterpret_cast<float4*>(P.out + (size_t)r * P.ldo + n0 + g * 64 + tx * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  } else if constexpr (EPI == kAct || EPI == kAddAct) {
    store_signs<T::TN>(acc, P.sgn, S::SW, P.w0, m0, P.R);
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
    constexpr int HW = S::HW;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int r = m0 + T::row(i);
      if (r >= P.R) continue;
      const Words<HW> wa = sign_words<HW>(P.sgn, S::SW, r, EPI == kD2 ? 2 * HW : 0);
      const Words<HW> wb = EPI == kD1 ? sign_words<HW>(P.sgn, S::SW, r, HW) : wa;
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

// Floats a thread of bwd_edge / bwd_gctr moves: 4 where C rows are
// 16-byte aligned, else 1.
template <int C>
__host__ __device__ constexpr int vec() { return C % 4 == 0 ? 4 : 1; }

// The tail at a narrow C (EdgeConv_0's 6 channels, or the action
// generator's 3, where gnbr, dWn and dWe would fill C lanes of a 64-wide
// GEMM tile): blocks walk NTR-row tiles (blockIdx.x, + gridDim.x, ...)
// with the tile's d1a, d1b, nb and edge rows in shared memory. gnbr = d1a
// Wn^T + d1b We^T and gb = d1b We^T: one thread an output (row, c), one
// fmaf chain each over h ascending. dWn = nb^T d1a and dWe = edge^T d1b:
// thread t owns column t % H of one product for the channels c0 .. c0 + NC
// below C, c0 = (t / 2 H) NC (at C = 3 the second group holds one
// channel), over its block's rows in order; part [gridDim.x, 2 C H] (dWn,
// dWe) written once a block.
constexpr int NTR = 64;

template <class S>
__global__ void __launch_bounds__(THREADS)
bwd_narrow(const float* __restrict__ nb, const float* __restrict__ edge,
           const float* __restrict__ d1a, const float* __restrict__ d1b,
           const float* __restrict__ wn, const float* __restrict__ we, int R,
           float* __restrict__ gnbr, float* __restrict__ gb,
           float* __restrict__ part) {
  constexpr int C = S::C, H = S::H, LD = H + 4;
  constexpr int GROUPS = THREADS / (2 * H), NC = (C + GROUPS - 1) / GROUPS;
  static_assert(THREADS % (2 * H) == 0 && (GROUPS - 1) * NC < C,
                "threads own whole columns of dWn and dWe, every group one "
                "channel at least");
  __shared__ __align__(16) float w_s[2][C][LD];     // Wn, We
  __shared__ __align__(16) float d_s[2][NTR][LD];   // d1a, d1b rows
  __shared__ float x_s[2][NTR][C];                  // nb, edge rows
  for (int e = threadIdx.x; e < C * H; e += THREADS) {
    w_s[0][e / H][e % H] = wn[e];
    w_s[1][e / H][e % H] = we[e];
  }
  const int h = threadIdx.x % H, p = threadIdx.x / H % 2;
  const int c0 = threadIdx.x / (2 * H) * NC;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  const int tiles = (R + NTR - 1) / NTR;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * NTR, nr = min(NTR, R - r0);
    __syncthreads();                   // the previous tile is no longer read
    for (int e = threadIdx.x; e < nr * (H / 4); e += THREADS) {
      const int row = e / (H / 4), q = e % (H / 4);
      const size_t o = (size_t)(r0 + row) * H + 4 * q;
      *reinterpret_cast<float4*>(&d_s[0][row][4 * q]) = ld4(d1a + o);
      *reinterpret_cast<float4*>(&d_s[1][row][4 * q]) = ld4(d1b + o);
    }
    for (int e = threadIdx.x; e < nr * C; e += THREADS) {
      x_s[0][e / C][e % C] = nb[(size_t)r0 * C + e];
      x_s[1][e / C][e % C] = edge[(size_t)r0 * C + e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nr * C; e += THREADS) {
      const int row = e / C, c = e % C;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int k = 0; k < H; k += 4) {
        const float4 a = ld4(&d_s[0][row][k]), b = ld4(&d_s[1][row][k]);
        const float4 u = ld4(&w_s[0][c][k]), v = ld4(&w_s[1][c][k]);
        sa = fmaf(a.x, u.x, sa);
        sa = fmaf(a.y, u.y, sa);
        sa = fmaf(a.z, u.z, sa);
        sa = fmaf(a.w, u.w, sa);
        sb = fmaf(b.x, v.x, sb);
        sb = fmaf(b.y, v.y, sb);
        sb = fmaf(b.z, v.z, sb);
        sb = fmaf(b.w, v.w, sb);
      }
      gnbr[(size_t)r0 * C + e] = sa + sb;
      gb[(size_t)r0 * C + e] = sb;
    }
    for (int row = 0; row < nr; ++row) {
      const float d = d_s[p][row][h];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (c0 + i < C) acc[i] = fmaf(x_s[p][row][c0 + i], d, acc[i]);
    }
  }
  float* const out = part + (size_t)blockIdx.x * 2 * C * H + p * C * H;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (c0 + i < C) out[(c0 + i) * H + h] = acc[i];
}

// edge [R, C] = nb - its centre's row (thread i: vec<C>() columns of row
// i / (C / vec<C>())).
template <int C>
__global__ void __launch_bounds__(THREADS)
bwd_edge(const float* __restrict__ nb, const float* __restrict__ ctr, int B,
         int K, int N, float* __restrict__ edge) {
  constexpr int V = vec<C>(), Q = C / V;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * K * N * Q) return;
  const int q = i % Q, r = i / Q, p = r / (K * N) * N + r % N;
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(nb + (size_t)r * C + 4 * q);
    const float4 c = *reinterpret_cast<const float4*>(ctr + (size_t)p * C + 4 * q);
    *reinterpret_cast<float4*>(edge + (size_t)r * C + 4 * q) =
        make_float4(v.x - c.x, v.y - c.y, v.z - c.z, v.w - c.w);
  } else {
    edge[(size_t)r * C + q] = nb[(size_t)r * C + q] - ctr[(size_t)p * C + q];
  }
}

// d3 over z3 [R, O] (above): thread i holds 4 columns of one (b, n).
template <int AGG, int O>
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

// Without the MLP: y = h1 [R, H] (in place) -> d1a = gy lrelu'(z1a) over
// it and d1b = gy lrelu'(z1b) into d1b [R, H], gy as in bwd_ties; the
// slopes from the row's sign words (z1a's at 0, z1b's at S::HW).
template <class S, int AGG>
__global__ void __launch_bounds__(THREADS)
bwd_ties_h1(float* __restrict__ h1, float* __restrict__ d1b,
            const unsigned* __restrict__ sgn, const float* __restrict__ g,
            int B, int K, int N) {
  constexpr int H = S::H;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * N * (H / 4)) return;
  const int q = i % (H / 4), p = i / (H / 4), b = p / N, n = p - b * N;
  const size_t r0 = (size_t)b * K * N + n;
  const float4 gv = *reinterpret_cast<const float4*>(g + (size_t)p * H + 4 * q);
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
      const float4 v =
          *reinterpret_cast<const float4*>(h1 + (r0 + (size_t)j * N) * H + 4 * q);
      const float yy[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool beyond = AGG == kMax ? yy[u] > acc[u] : yy[u] < acc[u];
        if (j == 0 || beyond) {
          acc[u] = yy[u];
          cnt[u] = 1.f;
        } else if (yy[u] == acc[u]) {
          cnt[u] += 1.f;
        }
      }
    }
  }
  for (int j = 0; j < K; ++j) {
    const size_t r = r0 + (size_t)j * N;
    float4* const hp = reinterpret_cast<float4*>(h1 + r * H + 4 * q);
    const float4 v = *hp;
    const float yy[4] = {v.x, v.y, v.z, v.w};
    const unsigned* const w = sgn + r * S::SW;
    float da[4], db[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float gu =
          extreme ? (yy[u] == acc[u] ? gy[u] : 0.f) / cnt[u] : gy[u];
      da[u] = gu * (sign_at(w, 4 * q + u) ? 1.f : 0.2f);
      db[u] = gu * (sign_at(w + S::HW, 4 * q + u) ? 1.f : 0.2f);
    }
    *hp = make_float4(da[0], da[1], da[2], da[3]);
    *reinterpret_cast<float4*>(d1b + r * H + 4 * q) =
        make_float4(db[0], db[1], db[2], db[3]);
  }
}

// gctr [B, N, C] = -sum over j ascending of gb [R, C] at the rows of (b, n)
// (thread i: vec<C>() columns).
template <int C>
__global__ void __launch_bounds__(THREADS)
bwd_gctr(const float* __restrict__ gb, int B, int K, int N,
         float* __restrict__ gctr) {
  constexpr int V = vec<C>(), Q = C / V;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B * N * Q) return;
  const int q = i % Q, p = i / Q, b = p / N, n = p - b * N;
  const float* const g0 = gb + ((size_t)b * K * N + n) * C + V * q;
  if constexpr (V == 4) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < K; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(g0 + (size_t)j * N * C);
      s = make_float4(s.x - v.x, s.y - v.y, s.z - v.z, s.w - v.w);
    }
    *reinterpret_cast<float4*>(gctr + (size_t)p * C + 4 * q) = s;
  } else {
    float s = 0.f;
    for (int j = 0; j < K; ++j) s = s - g0[(size_t)j * N * C];
    gctr[(size_t)p * C + q] = s;
  }
}

template <class S, int BN, bool BKC, int EPI>
cudaError_t rows_go(const RowArgs& P, int col_tiles, cudaStream_t st) {
  auto kern = bwd_rows<S, BN, BKC, EPI>;
  static const cudaError_t e = allow_smem(kern, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  const dim3 grid((P.R + BM - 1) / BM, col_tiles);
  kern<<<grid, THREADS,
         sizeof(float) * pipe_floats<BM, BN, true, BKC, kPlain, kPlain>(), st>>>(P);
  return cudaGetLastError();
}

// dW [M, N] = A^T B over the split row ranges in BMW x BNW tiles, then
// their sum into out.
template <int BMW, int BNW, int AKIND>
cudaError_t dw_go(const DwArgs& P, float* out, cudaStream_t st) {
  auto kern = dw_gemm<BMW, BNW, AKIND, kPlain>;
  static const cudaError_t e = allow_smem(kern, SMEM_LIMIT);
  if (e != cudaSuccess) return e;
  const int splits = (P.R + P.split_rows - 1) / P.split_rows;
  const size_t smem =
      sizeof(float) * pipe_floats<BMW, BNW, false, false, AKIND, kPlain>();
  kern<<<dim3((P.M + BMW - 1) / BMW, (P.N + BNW - 1) / BNW, splits), THREADS,
         smem, st>>>(P);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return e2;
  sum_cols_launch(P.part, splits, P.M * P.N, out, st);
  return cudaGetLastError();
}

// The dW product x^T d, x [R, M], d [R, N], on its tiles.
template <int M, int N>
cudaError_t dw_product(const DwArgs& P, float* out, cudaStream_t st) {
  return dw_go<dw_tile(M), dw_tile(N), kPlain>(P, out, st);
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

template <int AGG, class S>
cudaError_t ties_go(float* x, float* d1b, const unsigned* sgn, const float* g,
                    int B, int K, int N, cudaStream_t st) {
  if constexpr (S::MLP) {
    const int n = B * N * (S::O / 4);
    bwd_ties<AGG, S::O><<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        x, g, B, K, N);
  } else {
    const int n = B * N * (S::H / 4);
    bwd_ties_h1<S, AGG><<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        x, d1b, sgn, g, B, K, N);
  }
  return cudaGetLastError();
}

#define BWDT_TRY(call)                        \
  do {                                        \
    const cudaError_t e_ = (call);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

// The launches in order (the note above). split: the rows of a dW partial,
// for dW2, dW1 (with the MLP), dWn, dWe (not at a narrow C, whose tail runs
// on `blocks` blocks). Scratch: x1 [R, H], with the MLP x2 [R, H], x3
// [R, O], xe [R, C] (rounded up to HW floats), then R SW sign words.
template <class S>
cudaError_t backward(const void* nbr, const void* ctr, const void* wn,
                     const void* we, const void* w1, const void* w2,
                     const void* g, float* gnbr, float* gctr, float* dw,
                     float* scratch, float* part, int B, int K, int N, int agg,
                     const int (&split)[4], int blocks, cudaStream_t st) {
  constexpr int C = S::C, H = S::H, O = S::O, HW = S::HW;
  constexpr bool NARROW = C % 4 != 0;   // EdgeConv_0's 6 or 3 channels
  const int R = B * K * N;
  float* const x1 = scratch;                            // h1, then d1a
  float* const x2 = x1 + (size_t)R * H;                 // h2, d2, d1b We^T
  float* const x3 = x2 + (S::MLP ? (size_t)R * H : 0);  // z3, d3, d1b
  float* const xe = x3 + (size_t)R * O;                 // edge (no MLP: gb)
  // the sign words move HW at a time (uint2 or uint4): R C rounded up to HW
  unsigned* const sgn = reinterpret_cast<unsigned*>(
      xe + ((size_t)R * C + HW - 1) / HW * HW);
  float* const dwn = dw;
  float* const dwe = dwn + C * H;
  float* const dw1 = dwe + C * H;
  float* const dw2 = dw1 + H * H;
  const int ne = R * (C / vec<C>());
  bwd_edge<C><<<(ne + THREADS - 1) / THREADS, THREADS, 0, st>>>(
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
  if constexpr (NARROW) {
    P.a2 = edge;
    P.b2 = src(we, C, H);
    BWDT_TRY((rows_go<S, H, false, kH1>(P, 1, st)));
  } else {
    BWDT_TRY((rows_go<S, H, false, kAct>(P, 1, st)));
    P.a = edge;
    P.b = src(we, C, H);
    P.w0 = HW;
    BWDT_TRY((rows_go<S, H, false, kAddAct>(P, 1, st)));
  }
  if constexpr (S::MLP) {
    P.a = src(x1, R, H);
    P.b = src(w1, H, H);
    P.depth = H;
    P.w0 = 2 * HW;
    P.out = x2;
    BWDT_TRY((rows_go<S, H, false, kAct>(P, 1, st)));
    P.a = src(x2, R, H);
    P.b = src(w2, H, O);
    P.ldo = O;
    P.out = x3;
    BWDT_TRY((rows_go<S, 128, false, kStore>(P, O / 128, st)));
  }
  const float* gf = static_cast<const float*>(g);
  switch (agg) {
    case kMax: BWDT_TRY((ties_go<kMax, S>(S::MLP ? x3 : x1, x3, sgn, gf, B, K, N, st))); break;
    case kMin: BWDT_TRY((ties_go<kMin, S>(S::MLP ? x3 : x1, x3, sgn, gf, B, K, N, st))); break;
    case kSum: BWDT_TRY((ties_go<kSum, S>(S::MLP ? x3 : x1, x3, sgn, gf, B, K, N, st))); break;
    default: BWDT_TRY((ties_go<kMean, S>(S::MLP ? x3 : x1, x3, sgn, gf, B, K, N, st)));
  }

  if constexpr (S::MLP) {
    BWDT_TRY((dw_product<H, O>(
        dw_args(src(x2, R, H), src(x3, R, O), R, H, O, split[0], part), dw2, st)));
    P.a = src(x3, R, O);
    P.b = src(w2, H, O);          // read transposed: W2^T
    P.depth = O;
    P.ldo = H;
    P.out = x2;
    BWDT_TRY((rows_go<S, H, true, kD2>(P, 1, st)));
    BWDT_TRY((dw_product<H, H>(
        dw_args(src(x1, R, H), src(x2, R, H), R, H, H, split[1], part), dw1, st)));
    P.a = src(x2, R, H);
    P.b = src(w1, H, H);
    P.depth = H;
    P.out = x1;
    P.out2 = x3;
    BWDT_TRY((rows_go<S, H, true, kD1>(P, 1, st)));
  }
  float* const gb = S::MLP ? x2 : xe;   // edge is read no more
  if constexpr (NARROW) {
    bwd_narrow<S><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(nbr), xe, x1, x3,
        static_cast<const float*>(wn), static_cast<const float*>(we), R, gnbr,
        gb, part);
    BWDT_TRY(cudaGetLastError());
    sum_cols_launch(part, blocks, 2 * C * H, dwn, st);
    BWDT_TRY(cudaGetLastError());
  } else {
    BWDT_TRY((dw_product<C, H>(
        dw_args(src(nbr, R, C), src(x1, R, H), R, C, H, split[2], part), dwn, st)));
    BWDT_TRY((dw_product<C, H>(
        dw_args(edge, src(x3, R, H), R, C, H, split[3], part), dwe, st)));
    P.a = src(x3, R, H);          // d1b We^T, then d1a Wn^T
    P.b = src(we, C, H);
    P.a2 = src(x1, R, H);
    P.b2 = src(wn, C, H);
    P.depth = H;
    P.ldo = C;
    P.out = gnbr;
    P.out2 = gb;
    BWDT_TRY((rows_go<S, C, true, kGnbr>(P, 1, st)));
  }
  const int n = B * N * (C / vec<C>());
  bwd_gctr<C><<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(gb, B, K, N, gctr);
  return cudaGetLastError();
}

}  // namespace bwdt

// The IDGCN's backward, one plane-row a thread (the note above bwdt).
namespace rowf {

constexpr int C = 32, H = 16, O = 32;
constexpr int TR = 128;                  // plane-rows a tile, threads a block
// shared row strides (floats): 4 mod 8 words, so the 8 threads of a
// 16-byte access phase reading their own rows hit 8 distinct bank groups
constexpr int LC = C + 4, LH = H + 4;
// the weights in shared memory, packed as the dW output: Wn, We, W1, W2
constexpr int WN = 0, WE = WN + C * H, W1 = WE + C * H, W2 = W1 + H * H;
constexpr int WALL = W2 + H * O;         // 1,792 floats; a block's partials
// rowf_bwd's shared memory: the weights, nb, edge and d3 rows [TR][LC],
// h1, h2, d2, d1a, d1b rows [TR][LH]
constexpr int BWD_FLOATS = WALL + TR * (3 * LC + 5 * LH);
constexpr int FWD_FLOATS = WALL + TR * 2 * LC;

using bwdt::ld4;

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

using bwdt::lrelu_rn;

// The weights into w_s (WALL floats).
__device__ __forceinline__ void load_weights(const float* wn, const float* we,
                                             const float* w1, const float* w2,
                                             float* w_s) {
  for (int e = threadIdx.x; e < C * H; e += TR) {
    w_s[WN + e] = wn[e];
    w_s[WE + e] = we[e];
  }
  for (int e = threadIdx.x; e < H * H; e += TR) w_s[W1 + e] = w1[e];
  for (int e = threadIdx.x; e < H * O; e += TR) w_s[W2 + e] = w2[e];
}

// The tile's rows r0 .. r0 + nr - 1 of nb and of edge = nb - ctr (and of d3
// when d3 is given) into [TR][LC] rows; zero past nr.
__device__ __forceinline__ void load_tile(const float* __restrict__ nbr,
                                          const float* __restrict__ ctr,
                                          const float* __restrict__ d3, int r0,
                                          int nr, int K, int N, float* nb_s,
                                          float* ed_s, float* d3_s) {
  for (int e = threadIdx.x; e < TR * (C / 4); e += TR) {
    const int row = e / (C / 4), q = e % (C / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f), c = v, d = v;
    if (row < nr) {
      const int r = r0 + row, p = r / (K * N) * N + r % N;
      v = ld4(nbr + (size_t)r * C + 4 * q);
      c = ld4(ctr + (size_t)p * C + 4 * q);
      if (d3) d = ld4(d3 + (size_t)r * O + 4 * q);
    }
    *reinterpret_cast<float4*>(nb_s + row * LC + 4 * q) = v;
    *reinterpret_cast<float4*>(ed_s + row * LC + 4 * q) =
        make_float4(v.x - c.x, v.y - c.y, v.z - c.z, v.w - c.w);
    if (d3) *reinterpret_cast<float4*>(d3_s + row * LC + 4 * q) = d;
  }
}

// A row's forward to h2: z1a = nb Wn, z1b = edge We, h1, z2 = h1 W1, h2;
// the signs of z1a, z1b, z2 as bit masks. One fmaf chain an element, its
// depth ascending.
__device__ __forceinline__ void forward_row(const float* nb, const float* ed,
                                            const float* w_s, float (&h1)[H],
                                            float (&h2)[H], unsigned& s1a,
                                            unsigned& s1b, unsigned& s2) {
  float za[H], zb[H];
#pragma unroll
  for (int h = 0; h < H; ++h) za[h] = zb[h] = 0.f;
#pragma unroll 2
  for (int c0 = 0; c0 < C; c0 += 4) {
    const float4 x4 = ld4(nb + c0), e4 = ld4(ed + c0);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w}, e[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int h = 0; h < H; h += 4) {
        const float4 a = ld4(w_s + WN + (c0 + u) * H + h);
        const float4 b = ld4(w_s + WE + (c0 + u) * H + h);
        za[h] = fmaf(x[u], a.x, za[h]);
        za[h + 1] = fmaf(x[u], a.y, za[h + 1]);
        za[h + 2] = fmaf(x[u], a.z, za[h + 2]);
        za[h + 3] = fmaf(x[u], a.w, za[h + 3]);
        zb[h] = fmaf(e[u], b.x, zb[h]);
        zb[h + 1] = fmaf(e[u], b.y, zb[h + 1]);
        zb[h + 2] = fmaf(e[u], b.z, zb[h + 2]);
        zb[h + 3] = fmaf(e[u], b.w, zb[h + 3]);
      }
    }
  }
  s1a = s1b = s2 = 0u;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    s1a |= (za[h] >= 0.f ? 1u : 0u) << h;
    s1b |= (zb[h] >= 0.f ? 1u : 0u) << h;
    h1[h] = __fadd_rn(lrelu_rn(za[h]), lrelu_rn(zb[h]));
    za[h] = 0.f;                       // z2 from here
  }
#pragma unroll
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int h = 0; h < H; h += 4) {
      const float4 a = ld4(w_s + W1 + k * H + h);
      za[h] = fmaf(h1[k], a.x, za[h]);
      za[h + 1] = fmaf(h1[k], a.y, za[h + 1]);
      za[h + 2] = fmaf(h1[k], a.z, za[h + 2]);
      za[h + 3] = fmaf(h1[k], a.w, za[h + 3]);
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    s2 |= (za[h] >= 0.f ? 1u : 0u) << h;
    h2[h] = lrelu_rn(za[h]);
  }
}

__device__ __forceinline__ float slope(unsigned s, int h) {
  return (s >> h) & 1u ? 1.f : 0.2f;
}

// z3 [R, O] = each row's forward (thread t: row t of the tile).
__global__ void __launch_bounds__(TR, 4)
rowf_fwd(const float* __restrict__ nbr, const float* __restrict__ ctr,
         const float* __restrict__ wn, const float* __restrict__ we,
         const float* __restrict__ w1, const float* __restrict__ w2, int B,
         int K, int N, float* __restrict__ z3) {
  extern __shared__ __align__(16) float sm[];
  float* const w_s = sm;
  float* const nb_s = w_s + WALL;
  float* const ed_s = nb_s + TR * LC;
  const int R = B * K * N, t = threadIdx.x;
  load_weights(wn, we, w1, w2, w_s);
  const int r0 = blockIdx.x * TR, nr = min(TR, R - r0);
  load_tile(nbr, ctr, nullptr, r0, nr, K, N, nb_s, ed_s, nullptr);
  __syncthreads();
  if (t >= nr) return;
  float h1[H], h2[H];
  unsigned s1a, s1b, s2;
  forward_row(nb_s + t * LC, ed_s + t * LC, w_s, h1, h2, s1a, s1b, s2);
  float z[O];
#pragma unroll
  for (int o = 0; o < O; ++o) z[o] = 0.f;
#pragma unroll
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int o = 0; o < O; o += 4) {
      const float4 a = ld4(w_s + W2 + k * O + o);
      z[o] = fmaf(h2[k], a.x, z[o]);
      z[o + 1] = fmaf(h2[k], a.y, z[o + 1]);
      z[o + 2] = fmaf(h2[k], a.z, z[o + 2]);
      z[o + 3] = fmaf(h2[k], a.w, z[o + 3]);
    }
  }
  float* const out = z3 + (size_t)(r0 + t) * O;
#pragma unroll
  for (int o = 0; o < O; o += 4) st4(out + o, z + o);
}

// The backward (the note above bwdt): d3 [R, O] in zd, gb over it; part
// [gridDim.x, WALL] the blocks' dW partials (packed as dw).
__global__ void __launch_bounds__(TR, 2)
rowf_bwd(const float* __restrict__ nbr, const float* __restrict__ ctr,
         const float* __restrict__ wn, const float* __restrict__ we,
         const float* __restrict__ w1, const float* __restrict__ w2, int B,
         int K, int N, float* __restrict__ zd, float* __restrict__ gnbr,
         float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  float* const w_s = sm;
  float* const nb_s = w_s + WALL;
  float* const ed_s = nb_s + TR * LC;
  float* const d3_s = ed_s + TR * LC;
  float* const h1_s = d3_s + TR * LC;
  float* const h2_s = h1_s + TR * LH;
  float* const d2_s = h2_s + TR * LH;
  float* const da_s = d2_s + TR * LH;
  float* const db_s = da_s + TR * LH;
  const int R = B * K * N, t = threadIdx.x, tiles = (R + TR - 1) / TR;
  load_weights(wn, we, w1, w2, w_s);

  // this lane's 4 x 4 block of its warp's dW product: x^T d, x rows of
  // ldx floats from xs at column 4 mg, d rows of ldd from ds at 4 ng
  const int warp = t / 32, lane = t % 32;
  const float *xs, *ds;
  int ldx, ldd, mg, ng, out0, ldw;
  if (warp == 0) {          // dWn = nb^T d1a, 32 x 16
    xs = nb_s; ds = da_s; ldx = LC; ldd = LH; mg = lane / 4; ng = lane % 4;
    out0 = WN; ldw = H;
  } else if (warp == 1) {   // dWe = edge^T d1b
    xs = ed_s; ds = db_s; ldx = LC; ldd = LH; mg = lane / 4; ng = lane % 4;
    out0 = WE; ldw = H;
  } else if (warp == 2) {   // dW1 = h1^T d2, 16 x 16: lanes 0-15
    xs = h1_s; ds = d2_s; ldx = LH; ldd = LH; mg = (lane % 16) / 4; ng = lane % 4;
    out0 = W1; ldw = H;
  } else {                  // dW2 = h2^T d3, 16 x 32
    xs = h2_s; ds = d3_s; ldx = LH; ldd = LC; mg = lane / 8; ng = lane % 8;
    out0 = W2; ldw = O;
  }
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * TR, nr = min(TR, R - r0);
    __syncthreads();                   // the previous tile is no longer read
    load_tile(nbr, ctr, zd, r0, nr, K, N, nb_s, ed_s, d3_s);
    __syncthreads();
    if (t < nr) {
      float h1[H], h2[H];
      unsigned s1a, s1b, s2;
      forward_row(nb_s + t * LC, ed_s + t * LC, w_s, h1, h2, s1a, s1b, s2);
#pragma unroll
      for (int h = 0; h < H; h += 4) {
        st4(h1_s + t * LH + h, h1 + h);
        st4(h2_s + t * LH + h, h2 + h);
      }
      // d2 = (d3 W2^T) lrelu'(z2)
      float d3[O], d2[H];
#pragma unroll
      for (int o = 0; o < O; o += 4) {
        const float4 v = ld4(d3_s + t * LC + o);
        d3[o] = v.x; d3[o + 1] = v.y; d3[o + 2] = v.z; d3[o + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < O; o += 4) {
          const float4 a = ld4(w_s + W2 + h * O + o);
          s = fmaf(d3[o], a.x, s);
          s = fmaf(d3[o + 1], a.y, s);
          s = fmaf(d3[o + 2], a.z, s);
          s = fmaf(d3[o + 3], a.w, s);
        }
        d2[h] = s * slope(s2, h);
      }
      // gh1 = d2 W1^T; d1a, d1b
      float da[H], db[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < H; k += 4) {
          const float4 a = ld4(w_s + W1 + h * H + k);
          s = fmaf(d2[k], a.x, s);
          s = fmaf(d2[k + 1], a.y, s);
          s = fmaf(d2[k + 2], a.z, s);
          s = fmaf(d2[k + 3], a.w, s);
        }
        da[h] = s * slope(s1a, h);
        db[h] = s * slope(s1b, h);
      }
#pragma unroll
      for (int h = 0; h < H; h += 4) {
        st4(d2_s + t * LH + h, d2 + h);
        st4(da_s + t * LH + h, da + h);
        st4(db_s + t * LH + h, db + h);
      }
      // gb = d1b We^T (over the row's d3, read above), gnbr = d1a Wn^T + gb
      const size_t r = (size_t)(r0 + t);
#pragma unroll 2
      for (int c0 = 0; c0 < C; c0 += 4) {
        float gn[4], gbv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float sa = 0.f, sb = 0.f;
#pragma unroll
          for (int h = 0; h < H; h += 4) {
            const float4 a = ld4(w_s + WN + (c0 + u) * H + h);
            const float4 b = ld4(w_s + WE + (c0 + u) * H + h);
            sa = fmaf(da[h], a.x, sa);
            sa = fmaf(da[h + 1], a.y, sa);
            sa = fmaf(da[h + 2], a.z, sa);
            sa = fmaf(da[h + 3], a.w, sa);
            sb = fmaf(db[h], b.x, sb);
            sb = fmaf(db[h + 1], b.y, sb);
            sb = fmaf(db[h + 2], b.z, sb);
            sb = fmaf(db[h + 3], b.w, sb);
          }
          gbv[u] = sb;
          gn[u] = sa + sb;
        }
        st4(gnbr + r * C + c0, gn);
        st4(zd + r * O + c0, gbv);
      }
    }
    __syncthreads();
    // the tile's dW products, rows in order
    if (warp != 2 || lane < 16) {
#pragma unroll 2
      for (int row = 0; row < nr; ++row) {
        const float4 x4 = ld4(xs + row * ldx + 4 * mg);
        const float4 d4 = ld4(ds + row * ldd + 4 * ng);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w}, d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], d[b], acc[a][b]);
      }
    }
  }
  if (warp != 2 || lane < 16) {
    float* const p = part + (size_t)blockIdx.x * WALL + out0;
#pragma unroll
    for (int a = 0; a < 4; ++a) st4(p + (4 * mg + a) * ldw + 4 * ng, acc[a]);
  }
}

// The launches: rowf_fwd, bwd_ties, rowf_bwd on `blocks` blocks, the dW
// partials' sum, bwd_gctr. scratch: R O floats; part: blocks WALL.
cudaError_t backward(const void* nbr, const void* ctr, const void* wn,
                     const void* we, const void* w1, const void* w2,
                     const void* g, float* gnbr, float* gctr, float* dw,
                     float* scratch, float* part, int B, int K, int N, int agg,
                     int blocks, cudaStream_t st) {
  const int R = B * K * N;
  const float* const nb = static_cast<const float*>(nbr);
  const float* const ct = static_cast<const float*>(ctr);
  const float* const a = static_cast<const float*>(wn);
  const float* const b = static_cast<const float*>(we);
  const float* const c = static_cast<const float*>(w1);
  const float* const d = static_cast<const float*>(w2);
  static const cudaError_t e0 = allow_smem(rowf_bwd, sizeof(float) * BWD_FLOATS);
  BWDT_TRY(e0);
  static const cudaError_t e1 = cudaFuncSetAttribute(
      rowf_bwd, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  BWDT_TRY(e1);
  rowf_fwd<<<(R + TR - 1) / TR, TR, sizeof(float) * FWD_FLOATS, st>>>(
      nb, ct, a, b, c, d, B, K, N, scratch);
  BWDT_TRY(cudaGetLastError());
  const float* gf = static_cast<const float*>(g);
  const int n3 = B * N * (O / 4), g3 = (n3 + THREADS - 1) / THREADS;
  switch (agg) {
    case kMax: bwdt::bwd_ties<kMax, O><<<g3, THREADS, 0, st>>>(scratch, gf, B, K, N); break;
    case kMin: bwdt::bwd_ties<kMin, O><<<g3, THREADS, 0, st>>>(scratch, gf, B, K, N); break;
    case kSum: bwdt::bwd_ties<kSum, O><<<g3, THREADS, 0, st>>>(scratch, gf, B, K, N); break;
    default: bwdt::bwd_ties<kMean, O><<<g3, THREADS, 0, st>>>(scratch, gf, B, K, N);
  }
  BWDT_TRY(cudaGetLastError());
  rowf_bwd<<<blocks, TR, sizeof(float) * BWD_FLOATS, st>>>(
      nb, ct, a, b, c, d, B, K, N, scratch, gnbr, part);
  BWDT_TRY(cudaGetLastError());
  sum_cols_launch(part, blocks, WALL, dw, st);
  BWDT_TRY(cudaGetLastError());
  const int n = B * N * (C / 4);
  bwdt::bwd_gctr<C><<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      scratch, B, K, N, gctr);
  return cudaGetLastError();
}

}  // namespace rowf

#undef BWDT_TRY

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

// The bf16 forward on the tensor cores (tc::edgeconv_tc_kernel): the
// contract of edgeconv_fwd for bf16 = 1 at the classes below (mlp, C, H, O);
// any other class returns cudaErrorInvalidValue. Every pointer 16-byte
// aligned; B * N >= 1, K >= 1.
extern "C" int edgeconv_fwd_bf16_tc(const void* nbr, const void* ctr,
                                    const void* wn, const void* we,
                                    const void* w1, const void* w2, void* out,
                                    int B, int K, int N, int C, int H, int O,
                                    int mlp, int agg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using tc::Shape;
  // (C, H, O, mlp, warps a tile, tiles a block, blocks an SM at least)
#define EDGECONV_TC(c, h, o, m, wg, groups, minb)                              \
  if (bool(mlp) == m && C == c && H == h && O == o)                           \
    return tc::launch_agg<Shape<c, h, o, m, wg, groups, minb>>(                \
        nbr, ctr, wn, we, w1, w2, out, B, K, N, agg, s)
  EDGECONV_TC(64, 128, 256, true, 4, 4, 1);    // upsampler and mask head
  EDGECONV_TC(64, 128, 128, false, 4, 1, 5);   // mask head's sum
  EDGECONV_TC(6, 64, 128, true, 4, 1, 5);      // EdgeConv_0
  EDGECONV_TC(32, 16, 32, true, 1, 2, 8);      // IDGCN
#undef EDGECONV_TC
  return static_cast<int>(cudaErrorInvalidValue);
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
  EDGECONV_F32T(3, 64, 128, true, 16);      // the action generator's EdgeConv_0
  EDGECONV_F32T(32, 16, 32, true, 64);      // IDGCN
#undef EDGECONV_F32T
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 backward at the classes below (mlp, C, H, O): edgeconv_bwd's
// contract for bf16 = 0, without dw_part; any other class returns
// cudaErrorInvalidValue. On GEMM tiles (bwdt): scratch R (H + O + SW)
// floats and R C rounded up to a multiple of H / 32, plus R H with the MLP
// (R = B K N; SW sign words a row: 12 at (64, 128, 256), 8 at (64, 128,
// 128), 6 at (6, 64, 128) and (3, 64, 128)); part: max over the dW
// products of splits M N floats, splits = ceil(R / split_rows), the split
// rows a multiple of 8 for dW2, dW1 (0 without the MLP), dWn and dWe (0 at
// C = 6 and 3, whose tail kernel runs on `blocks` >= 1 blocks, part also
// at least blocks 2 C H floats).
// On row tiles (rowf, the IDGCN): scratch R 32 floats, part blocks 1,792
// (blocks >= 1). Every pointer 16-byte aligned; B * N >= 1, K >= 1, R
// max(H, O) < 2^31.
extern "C" int edgeconv_bwd_f32_tiled(const void* nbr, const void* ctr,
                                      const void* wn, const void* we,
                                      const void* w1, const void* w2,
                                      const void* g, void* gnbr, void* gctr,
                                      void* dw, void* scratch, void* part,
                                      int B, int K, int N, int C, int H, int O,
                                      int mlp, int agg, int split_w2,
                                      int split_w1, int split_wn, int split_we,
                                      int blocks, void* stream) {
  const int split[4] = {split_w2, split_w1, split_wn, split_we};
  auto* const fg = static_cast<float*>(gnbr);
  auto* const fc = static_cast<float*>(gctr);
  auto* const fd = static_cast<float*>(dw);
  auto* const fs = static_cast<float*>(scratch);
  auto* const fp = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  using bwdt::Shape;
#define EDGECONV_BWDT(c, h, o, m)                                              \
  if (bool(mlp) == m && C == c && H == h && O == o)                           \
    return static_cast<int>(bwdt::backward<Shape<c, h, o, m>>(                 \
        nbr, ctr, wn, we, w1, w2, g, fg, fc, fd, fs, fp, B, K, N, agg, split,  \
        blocks, st))
  EDGECONV_BWDT(64, 128, 256, true);    // upsampler and mask head
  EDGECONV_BWDT(64, 128, 128, false);   // mask head's sum
  EDGECONV_BWDT(6, 64, 128, true);      // EdgeConv_0
  EDGECONV_BWDT(3, 64, 128, true);      // the action generator's EdgeConv_0
#undef EDGECONV_BWDT
  if (mlp && C == rowf::C && H == rowf::H && O == rowf::O)   // IDGCN
    return static_cast<int>(rowf::backward(nbr, ctr, wn, we, w1, w2, g, fg, fc,
                                           fd, fs, fp, B, K, N, agg, blocks,
                                           st));
  return static_cast<int>(cudaErrorInvalidValue);
}
