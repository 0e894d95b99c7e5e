// Deterministic reduction of per-block partial sums, for the kernels whose
// weight gradients sum over every row without float atomics (edgeconv.cu,
// pooled_mlp.cu): each block writes its partial, and one thread per output
// adds the partials in block order in double, so sums repeat from run to run.
#pragma once

namespace {

// out[i] = sum over blocks of part[k][i], in block order.
__global__ void sum_parts(const float* __restrict__ part, int nblk, int n,
                          float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int k = 0; k < nblk; ++k) s += part[(size_t)k * n + i];
  out[i] = (float)s;
}

}  // namespace
