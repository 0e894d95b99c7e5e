// Fused EdgeConv forward on a neighbour-major table.
//
// Replaces tpugan_tpu/ops/pallas/edgeconv_kernel.py : edgeconv_fused, its
// forward _fwd_pallas / _edgeconv_kernel.
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

// acc[r] = sum_c X[p_r][c] * W[c][o] over the thread's points
// p_r = g + r * G (p_r < TP). X rows are zero-padded to a multiple of 4.
template <typename T>
__device__ __forceinline__ void project(const float* X, int ldx, int cin,
                                        const T* __restrict__ W, int cout,
                                        int o, int g, int G, float (&acc)[TP]) {
#pragma unroll
  for (int r = 0; r < TP; ++r) acc[r] = 0.f;
  for (int c = 0; c < cin; c += 4) {
    const float w0 = to_f32<T>(W[(size_t)c * cout + o]);
    const float w1 = c + 1 < cin ? to_f32<T>(W[(size_t)(c + 1) * cout + o]) : 0.f;
    const float w2 = c + 2 < cin ? to_f32<T>(W[(size_t)(c + 2) * cout + o]) : 0.f;
    const float w3 = c + 3 < cin ? to_f32<T>(W[(size_t)(c + 3) * cout + o]) : 0.f;
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int p = g + r * G;
      if (p < TP) {
        const float4 x = *reinterpret_cast<const float4*>(X + p * ldx + c);
        acc[r] = fmaf(x.x, w0, acc[r]);
        acc[r] = fmaf(x.y, w1, acc[r]);
        acc[r] = fmaf(x.z, w2, acc[r]);
        acc[r] = fmaf(x.w, w3, acc[r]);
      }
    }
  }
}

__host__ __device__ constexpr int padded(int c) { return ((c + 3) / 4) * 4 + 4; }

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
  const int tid = threadIdx.x;
  const int total = TP * ldc * 2 + TP * ldh * (MLP ? 2 : 1);
  for (int e = tid; e < total; e += THREADS) smem[e] = 0.f;  // zero padding
  __syncthreads();

  const T* cb = ctr + ((size_t)b * N + p0) * C;
  const int np = min(TP, N - p0);
  for (int e = tid; e < np * C; e += THREADS) {
    const int p = e / C;
    ctr_s[p * ldc + (e - p * C)] = to_f32<T>(cb[e]);
  }

  // thread -> (column, first point, point stride) for a layer of width cout
  const int gH = THREADS / H, oH = tid % H, pH = tid / H < gH ? tid / H : TP;
  const int OUT = MLP ? O : H;
  const int gO = THREADS / OUT, oO = tid % OUT, pO = tid / OUT < gO ? tid / OUT : TP;

  float a1[TP], a2[TP], res[TP];
  for (int j = 0; j < K; ++j) {
    __syncthreads();  // the previous plane's rows are no longer read
    const T* src = nbr + (((size_t)b * K + j) * N + p0) * C;
    for (int e = tid; e < np * C; e += THREADS) {
      const int p = e / C;
      nb_s[p * ldc + (e - p * C)] = to_f32<T>(src[e]);
    }
    __syncthreads();

    // layer 1: the node and edge affines (edge = nbr - ctr, formed in T)
#pragma unroll
    for (int r = 0; r < TP; ++r) { a1[r] = 0.f; a2[r] = 0.f; }
    if (pH < TP) {
      for (int c = 0; c < C; c += 4) {
        float wnv[4], wev[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in = c + u < C;
          wnv[u] = in ? to_f32<T>(wn[(size_t)(c + u) * H + oH]) : 0.f;
          wev[u] = in ? to_f32<T>(we[(size_t)(c + u) * H + oH]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < TP; ++r) {
          const int p = pH + r * gH;
          if (p < TP) {
            const float4 x = *reinterpret_cast<const float4*>(nb_s + p * ldc + c);
            const float4 z = *reinterpret_cast<const float4*>(ctr_s + p * ldc + c);
            a1[r] = fmaf(x.x, wnv[0], a1[r]);
            a1[r] = fmaf(x.y, wnv[1], a1[r]);
            a1[r] = fmaf(x.z, wnv[2], a1[r]);
            a1[r] = fmaf(x.w, wnv[3], a1[r]);
            a2[r] = fmaf(round_to<T>(x.x - z.x), wev[0], a2[r]);
            a2[r] = fmaf(round_to<T>(x.y - z.y), wev[1], a2[r]);
            a2[r] = fmaf(round_to<T>(x.z - z.z), wev[2], a2[r]);
            a2[r] = fmaf(round_to<T>(x.w - z.w), wev[3], a2[r]);
          }
        }
      }
    }
    if (!MLP) {
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const float y = round_to<T>(lrelu(a1[r]) + lrelu(a2[r]));
        res[r] = j == 0 ? y : fold<T>(res[r], y, agg);
      }
      continue;
    }
    if (pH < TP) {
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const int p = pH + r * gH;
        if (p < TP) h1_s[p * ldh + oH] = round_to<T>(lrelu(a1[r]) + lrelu(a2[r]));
      }
    }
    __syncthreads();

    // layer 2: [TP, H] x W1 [H, H]
    if (pH < TP) {
      project<T>(h1_s, ldh, H, w1, H, oH, pH, gH, a1);
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const int p = pH + r * gH;
        if (p < TP) h2_s[p * ldh + oH] = round_to<T>(lrelu(a1[r]));
      }
    }
    __syncthreads();

    // layer 3: [TP, H] x W2 [H, O], folded over the planes in registers
    if (pO < TP) {
      project<T>(h2_s, ldh, H, w2, O, oO, pO, gO, a1);
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const float y = round_to<T>(lrelu(a1[r]));
        res[r] = j == 0 ? y : fold<T>(res[r], y, agg);
      }
    }
  }

  const int pF = MLP ? pO : pH, gF = MLP ? gO : gH, oF = MLP ? oO : oH;
  if (pF < TP) {
#pragma unroll
    for (int r = 0; r < TP; ++r) {
      const int p = pF + r * gF;
      if (p < np) {
        const float v = agg == kMean ? round_to<T>(res[r] / (float)K) : res[r];
        out[((size_t)b * N + p0 + p) * OUT + oF] = from_f32<T>(v);
      }
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
