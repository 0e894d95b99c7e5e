// Shared helpers for the package's CUDA kernels (plain C interface, no
// PyTorch headers: each csrc/<name>.cu builds into its own shared library
// that tpugan_tpu_torch/_build.py loads with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

// Message for a cudaError_t returned by one of the library's entry points.
extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Element type <-> f32, and rounding an f32 value to the element type
// (round to nearest even, as an XLA astype does).
template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}
