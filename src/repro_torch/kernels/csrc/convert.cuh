// Conversions between the kernels' element types and f32, shared by the
// CUDA sources. PyTorch's extension build defines
// __CUDA_NO_BFLOAT16_CONVERSIONS__ and __CUDA_NO_HALF_CONVERSIONS__, so
// every conversion goes through an intrinsic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(bool x) { return x ? 1.0f : 0.0f; }
__device__ __forceinline__ float to_float(uint8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(int32_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(int64_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

}  // namespace repro_torch
