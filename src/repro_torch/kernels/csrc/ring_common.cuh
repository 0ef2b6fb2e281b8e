// Device helpers shared by the ring-round kernels (ring.cu, ring_q.cu,
// ring_rank.cu): packed loads and stores, the rounding to the accumulation
// type, the masks of any dtype, the decode of one contribution element and
// the int8 wire's row max, step and encode.
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

// the larger of two non-negative floats (|acc| values and their maxima),
// NaN winning as torch.amax lets it: on their bits a sign-cleared NaN lies
// above +inf, and fmaxf would drop it
__device__ __forceinline__ float abs_max(float a, float b) {
  return __uint_as_float(max(__float_as_uint(a), __float_as_uint(b)));
}

// q clipped to +-levels, a NaN (from a non-finite partial or step) to 0 as
// the int8 cast of torch.clamp's NaN goes; fminf / fmaxf alone would give
// -levels
__device__ __forceinline__ float clip_q(float q, float levels) {
  return q != q ? 0.0f : fminf(fmaxf(q, -levels), levels);
}

// the int8 wire's step from a row's max|acc| (a NaN max gives 1 / levels,
// as torch.where(amax > 0, amax, 1) does)
__device__ __forceinline__ float delta_of(float amax, float levels) {
  return __fdiv_rn(amax > 0.0f ? amax : 1.0f, levels);
}

// rint(a / D) clipped to +-levels, through int as the int8 cast goes (so a
// negative zero decodes as +0)
__device__ __forceinline__ int encode(float a, float delta, float levels) {
  return static_cast<int>(clip_q(rintf(__fdiv_rn(a, delta)), levels));
}

// The same encode at one row's step D, with its reciprocal inv = rn(1 / D)
// computed once: q0 = rn(a * inv), r = rn(a - q0 * D) and
// q1 = rn(q0 + r * inv) (two fused multiply-adds) is the correctly rounded
// quotient rn(a / D) -- the correction step of an FMA division, checked
// against exact rational arithmetic near the grid's half-integers
// (tests/test_torch_ring_int8.py) and by the kernel's bitwise sweeps
// against the plain version -- for a step D in [2^-100, 2^100], where the
// residual cannot leave the normal range for any |a / D| >= 1/4 (smaller
// quotients round to 0 either way), and for a finite row, where every
// |a| <= max|a| bounds |a / D| by about levels. The caller divides
// outside that range and in a row whose max is not finite (a NaN there
// makes D 1 / levels whatever the rest holds, so an inf or a huge a would
// turn the residual to NaN). The quotient is clipped before it is rounded
// (the same integer: levels is one) and rounded without a conversion
// instruction, which issues at a quarter of the rate of an add: for
// |q| < 2^22, q + 1.5 * 2^23 rounds q half to even and holds rint(q) in
// its low mantissa bits.
__device__ __forceinline__ int encode_fma(float a, float delta, float inv,
                                         float levels) {
  const float q0 = __fmul_rn(a, inv);
  const float r = __fmaf_rn(-q0, delta, a);
  const float q = fminf(fmaxf(__fmaf_rn(r, inv, q0), -levels), levels);
  return __float_as_int(__fadd_rn(q, 12582912.0f)) - 0x4B400000;
}

// whether encode_fma gives encode's bits for every element of a row whose
// max|acc| is amax at the step delta (a finite max, delta in
// [2^-100, 2^100])
__device__ __forceinline__ bool fma_encodes(float amax, float delta) {
  return amax <= 0x1.fffffep127f && delta >= 0x1p-100f && delta <= 0x1p100f;
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
