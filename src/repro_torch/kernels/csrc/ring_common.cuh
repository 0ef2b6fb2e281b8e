// Device helpers shared by the ring-round kernels (ring.cu, ring_q.cu):
// packed loads and stores, the rounding to the accumulation type, the masks
// of any dtype and the decode of one contribution element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "convert.cuh"
#include "kernels.h"

namespace repro_torch {
namespace ring {

constexpr int kThreads = static_cast<int>(kRingTileCols);

template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

// VEC contiguous elements; RO: through the read-only path (data the kernel
// never writes)
template <bool RO, typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  Pack<T, VEC> out;
  constexpr int kBytes = static_cast<int>(sizeof(Pack<T, VEC>));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4* q = reinterpret_cast<const uint4*>(p) + i;
      const uint4 raw = RO ? __ldg(q) : *q;
      memcpy(reinterpret_cast<char*>(&out) + 16 * i, &raw, 16);
    }
  } else if constexpr (kBytes == 8) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 raw = RO ? __ldg(q) : *q;
    memcpy(&out, &raw, 8);
  } else if constexpr (kBytes == 4) {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
    const unsigned int raw = RO ? __ldg(q) : *q;
    memcpy(&out, &raw, 4);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out.v[v] = p[v];
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& x) {
  constexpr int kBytes = static_cast<int>(sizeof(Pack<T, VEC>));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 raw;
      memcpy(&raw, reinterpret_cast<const char*>(&x) + 16 * i, 16);
      reinterpret_cast<uint4*>(p)[i] = raw;
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) p[v] = x.v[v];
  }
}

// a value rounded to the accumulation type A, held as f32
template <typename A>
__device__ __forceinline__ float round_acc(float x) {
  return to_float(from_float<A>(x));
}

__device__ __forceinline__ float load_mask(const void* m, DType dt,
                                           int64_t i) {
  switch (dt) {
    case DType::kF32:
      return to_float(static_cast<const float*>(m)[i]);
    case DType::kBF16:
      return to_float(static_cast<const __nv_bfloat16*>(m)[i]);
    case DType::kF16:
      return to_float(static_cast<const __half*>(m)[i]);
    case DType::kBool:
      return to_float(static_cast<const bool*>(m)[i]);
    case DType::kU8:
      return to_float(static_cast<const uint8_t*>(m)[i]);
    case DType::kI8:
      return to_float(static_cast<const int8_t*>(m)[i]);
    case DType::kI32:
      return to_float(static_cast<const int32_t*>(m)[i]);
    case DType::kI64:
      return to_float(static_cast<const int64_t*>(m)[i]);
  }
  return 0.0f;
}

// one element of a contribution, before the mask: an int8 payload times its
// row scale rounded to the payload type T, or a payload value as it is
template <typename T>
__device__ __forceinline__ float decode(int8_t q, float scale) {
  return to_float(from_float<T>(__fmul_rn(static_cast<float>(q), scale)));
}
template <typename T>
__device__ __forceinline__ float decode(T x, float) {
  return to_float(x);
}

}  // namespace ring
}  // namespace repro_torch
