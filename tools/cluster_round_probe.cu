// The fixed cost of one synchronised round among the blocks of a cluster,
// by the way the blocks exchange one 16-byte value a warp: the choices the
// FPS kernel (tpugan_tpu_torch/csrc/fps.cu : fps_cluster) was built from.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o cluster_round_probe tools/cluster_round_probe.cu
//   ./cluster_round_probe          # one line per (variant, cluster, threads)
//
// Each launch runs 4 clusters for ROUNDS rounds; a round stores every
// warp's value into every block of the cluster (or, with one block, into
// its own), synchronises, and reads one value back into a running sum, so
// no round can overlap the next. Variants:
//   relaxed     barrier.cluster.arrive.relaxed / wait, nothing stored (no
//               ordering of memory: the barrier alone)
//   release     barrier.cluster.arrive.release / wait.acquire, nothing stored
//   dsmem       st.shared::cluster into every block, then the release /
//               acquire barrier (the first fps_cluster design)
//   syncthreads one block: st.shared into its own memory, __syncthreads
//   st.async    st.async into every block, completing bytes on that block's
//               mbarrier; each block waits on its own mbarrier, no cluster
//               barrier in the loop (fps_cluster's round)
// Prints microseconds a round (CUDA events over 10 launches after 3).
#include <cstdio>

#include <cuda_runtime.h>

constexpr int ROUNDS = 4096;
enum Variant { RELAXED, RELEASE, DSMEM, SYNCTHREADS, ST_ASYNC };
const char* NAMES[] = {"relaxed", "release", "dsmem", "syncthreads", "st.async"};

__device__ __forceinline__ unsigned cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned n_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned peer(unsigned local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

template <int V>
__global__ void probe(unsigned* out) {
  __shared__ __align__(16) unsigned slots[2][128][4];
  __shared__ __align__(8) unsigned long long bars[2];
  const unsigned C = n_ctas(), rank = cta_rank();
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, W = blockDim.x >> 5;
  const int nslot = C * W;
  unsigned acc = t;
  if (V == ST_ASYNC && t == 0) {
    for (int p = 0; p < 2; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"((unsigned)__cvta_generic_to_shared(&bars[p])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  for (int r = 1; r < ROUNDS; ++r) {
    const int p = r & 1;
    const unsigned slot = (unsigned)__cvta_generic_to_shared(&slots[p][rank * W + w][0]);
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&bars[p]);
    if (V == DSMEM && lane < (int)C)
      asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %1, %1, %1};"
                   :: "r"(peer(slot, lane)), "r"(acc) : "memory");
    if (V == SYNCTHREADS && lane == 0) slots[p][w][0] = acc;
    if (V == ST_ASYNC) {
      if (t == 0)
        asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(nslot * 16) : "memory");
      if (lane < (int)C)
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32"
                     " [%0], {%1, %1, %1, %1}, [%2];"
                     :: "r"(peer(slot, lane)), "r"(acc), "r"(peer(bar, lane)) : "memory");
      unsigned done = 0;
      while (!done)
        asm volatile("{ .reg .pred q; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
                     " q, [%1], %2; selp.u32 %0, 1, 0, q; }"
                     : "=r"(done) : "r"(bar), "r"(((r - 1) >> 1) & 1) : "memory");
    } else if (V == SYNCTHREADS) {
      __syncthreads();
    } else if (V == RELAXED) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    } else {
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    }
    acc += slots[p][lane % nslot][0];
  }
  if (acc == 0xdeadbeefu) out[0] = acc;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int V>
float us_per_round(int C, int T, unsigned* out) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4 * C);
  cfg.blockDim = dim3(T);
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = C;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  cfg.attrs = &a;
  cfg.numAttrs = 1;
  if (C > 8)
    cudaFuncSetAttribute(probe<V>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 3; ++i) cudaLaunchKernelEx(&cfg, probe<V>, out);
  cudaEventRecord(e0);
  for (int i = 0; i < 10; ++i) cudaLaunchKernelEx(&cfg, probe<V>, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    std::printf("error: %s\n", cudaGetErrorString(e));
    return -1.0f;
  }
  return ms / 10 * 1e3f / ROUNDS;
}

int main() {
  unsigned* out;
  cudaMalloc(&out, 4);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  std::printf("%s\n", prop.name);
  for (int C : {1, 2, 4, 8, 16})
    for (int T : {32, 128}) {
      const float v[] = {us_per_round<RELAXED>(C, T, out), us_per_round<RELEASE>(C, T, out),
                         us_per_round<DSMEM>(C, T, out),
                         C == 1 ? us_per_round<SYNCTHREADS>(C, T, out) : -1.0f,
                         us_per_round<ST_ASYNC>(C, T, out)};
      for (int i = 0; i < 5; ++i)
        if (v[i] >= 0.0f)
          std::printf("{\"variant\": \"%s\", \"cluster\": %d, \"threads\": %d, "
                      "\"us_per_round\": %.4f}\n", NAMES[i], C, T, v[i]);
    }
  return 0;
}
