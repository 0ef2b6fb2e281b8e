// Drop-masked ring round of one exchange group, for all n stacked ranks,
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rps_ring.py::ring_bucket_fused (body
// _make_ring_kernel) for the linear wires (f32, bf16): one bucket's
// drop-masked reduce-scatter in ring order, the recovery divisor and the
// all-gather select, on every device of an n-device ring. For a group of
// G buckets stacked as (G, n, s, d) in block order, block j owned by rank
// o = j % n:
//
//   acc  = sum over r = o+1, o+2, ..., o+n-1, o (mod n) of
//          cast_acc(stack[g,r,j]) * cast_acc(rs[g,r,j])
//          (each add rounded to the accumulation dtype; no leading 0)
//   mine = cast_payload(acc / cast_acc(div[g,j]))
//   out[g,i,j] = ag[g,i,j] ? mine : (renorm ? stack[g,i,j] : 0)
//
// -- the TPU kernel's RS hops add in that order (chunk c is started by
// rank c+1 and ends at its owner), divide once and select as each chunk
// lands. With IEEE division (no --use_fast_math) and one rounded add per
// step, it agrees bit for bit with the plain version
// (kernels/ref.py::ring_round_ref); a fused multiply-add with a 0/1 mask
// is exact, so contraction cannot break that.
//
// Why the TPU kernel's hop transport has no counterpart here: on one card
// a hop is a copy that adds bytes and nothing else, so the ranks' partial
// sums never leave registers; across cards the transport belongs to NCCL
// outside the kernel, with this arithmetic between the transfers.
//
// What bounds it: each element of the stack is read once and written once
// (G*n*s*d*(in + out bytes)) plus the masks and divisors, with one
// multiply-add per element read, so it is bound by bytes: at an f32
// (1, 16, 16, 409600) group (a 25 MiB bucket at n = 16), 839 MB take
// 0.25 ms at an H100 SXM's 3.35 TB/s (data sheet, 700 W).
//
// What the design does about it (the first, simple form):
//   - one thread block per (g, block j, tile of columns); the (g, j) mask
//     column of n ranks and the divisor are staged in shared memory, cast
//     from their raw dtypes there;
//   - each thread owns VEC contiguous columns and reads them with one
//     16-byte load per rank when d and the alignment allow, so a warp's
//     loads are coalesced; for n <= 16 the n ranks' values are loaded
//     first (n independent loads in flight) and kept in registers for the
//     all-gather fallback, above that they are read again;
//   - any d (the scalar path for a d that is not a multiple of VEC), any
//     n >= 1, any s; the kernel allocates nothing and runs on the caller's
//     stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "convert.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kThreads = static_cast<int>(kRingTileCols);
constexpr int kMaxCached = 16;

template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  Pack<T, VEC> out;
  if constexpr (VEC == 1) {
    out.v[0] = p[0];
  } else {
    static_assert(sizeof(Pack<T, VEC>) == sizeof(uint4), "16-byte packs");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &raw, sizeof(raw));
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& x) {
  if constexpr (VEC == 1) {
    p[0] = x.v[0];
  } else {
    uint4 raw;
    memcpy(&raw, &x, sizeof(raw));
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// a value rounded to the accumulation dtype A, held as f32
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

// acc (held as f32, always a value of A) += cast_acc(x) * m, rounded to A;
// the first term is taken as it is
template <typename T, typename A, int VEC>
__device__ __forceinline__ void accumulate(float (&acc)[VEC],
                                           const Pack<T, VEC>& x, float m,
                                           bool first) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float c = round_acc<A>(to_float(x.v[v])) * m;
    acc[v] = first ? c : round_acc<A>(acc[v] + c);
  }
}

// CACHE: n <= kMaxCached, the ranks' values stay in registers
template <typename T, typename A, int VEC, bool CACHE>
__global__ void __launch_bounds__(kThreads)
    ring_round_kernel(const T* __restrict__ stack, const void* rs,
                      DType rs_dtype, const void* ag, DType ag_dtype,
                      const float* __restrict__ div, T* __restrict__ out,
                      int n, int64_t s, int64_t d, int64_t tiles,
                      bool renorm) {
  extern __shared__ float smem[];  // [n] rs cast to A, then [n] ag
  float* s_rs = smem;
  float* s_ag = smem + n;
  __shared__ float s_div;
  const int64_t row = blockIdx.x / tiles;  // g * s + j
  const int64_t tile = blockIdx.x % tiles;
  const int64_t g = row / s;
  const int64_t j = row % s;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int64_t mi = (g * n + r) * s + j;
    s_rs[r] = round_acc<A>(load_mask(rs, rs_dtype, mi));
    s_ag[r] = load_mask(ag, ag_dtype, mi);
  }
  if (threadIdx.x == 0) s_div = round_acc<A>(div[row]);
  __syncthreads();

  const int64_t col = (tile * kThreads + threadIdx.x) * VEC;
  if (col >= d) return;
  const int owner = static_cast<int>(j % n);
  const int64_t stride = s * d;  // from rank r to rank r + 1
  const int64_t base = (g * n * s + j) * d + col;
  const T* src = stack + base;
  T* dst = out + base;

  float acc[VEC];
  Pack<T, VEC> cache[CACHE ? kMaxCached : 1];
  if constexpr (CACHE) {
#pragma unroll
    for (int t = 0; t < kMaxCached; ++t) {
      if (t < n) {
        int r = owner + 1 + t;
        if (r >= n) r -= n;
        cache[t] = load_pack<T, VEC>(src + r * stride);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxCached; ++t) {
      if (t < n) {
        int r = owner + 1 + t;
        if (r >= n) r -= n;
        accumulate<T, A, VEC>(acc, cache[t], s_rs[r], t == 0);
      }
    }
  } else {
    for (int t = 0; t < n; ++t) {
      int r = owner + 1 + t;
      if (r >= n) r -= n;
      accumulate<T, A, VEC>(acc, load_pack<T, VEC>(src + r * stride),
                            s_rs[r], t == 0);
    }
  }

  Pack<T, VEC> mine, zero;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mine.v[v] = from_float<T>(round_acc<A>(acc[v] / s_div));
    zero.v[v] = from_float<T>(0.0f);
  }
  if constexpr (CACHE) {
#pragma unroll
    for (int t = 0; t < kMaxCached; ++t) {
      if (t < n) {
        int r = owner + 1 + t;
        if (r >= n) r -= n;
        store_pack<T, VEC>(dst + r * stride,
                           s_ag[r] != 0.0f ? mine
                                           : (renorm ? cache[t] : zero));
      }
    }
  } else {
    for (int r = 0; r < n; ++r) {
      if (s_ag[r] != 0.0f) {
        store_pack<T, VEC>(dst + r * stride, mine);
      } else if (renorm) {
        store_pack<T, VEC>(dst + r * stride,
                           load_pack<T, VEC>(src + r * stride));
      } else {
        store_pack<T, VEC>(dst + r * stride, zero);
      }
    }
  }
}

template <typename T, typename A, int VEC>
void launch_vec(const T* stack, const void* rs, DType rs_dtype,
                const void* ag, DType ag_dtype, const float* div, T* out,
                int64_t G, int64_t n, int64_t s, int64_t d, bool renorm,
                cudaStream_t stream) {
  const int64_t tiles = (d + kThreads * VEC - 1) / (kThreads * VEC);
  const dim3 grid(static_cast<unsigned>(G * s * tiles));
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  if (n <= kMaxCached) {
    ring_round_kernel<T, A, VEC, true><<<grid, kThreads, smem, stream>>>(
        stack, rs, rs_dtype, ag, ag_dtype, div, out, static_cast<int>(n), s,
        d, tiles, renorm);
  } else {
    ring_round_kernel<T, A, VEC, false><<<grid, kThreads, smem, stream>>>(
        stack, rs, rs_dtype, ag, ag_dtype, div, out, static_cast<int>(n), s,
        d, tiles, renorm);
  }
}

template <typename T, typename A>
void launch_typed(const void* stack, const void* rs, DType rs_dtype,
                  const void* ag, DType ag_dtype, const float* div, void* out,
                  int64_t G, int64_t n, int64_t s, int64_t d, bool renorm,
                  cudaStream_t stream) {
  constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(T));
  const T* x = static_cast<const T*>(stack);
  T* y = static_cast<T*>(out);
  const bool vec_ok = d % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(x) % sizeof(uint4) == 0 &&
                      reinterpret_cast<uintptr_t>(y) % sizeof(uint4) == 0;
  if (vec_ok) {
    launch_vec<T, A, kVec>(x, rs, rs_dtype, ag, ag_dtype, div, y, G, n, s, d,
                           renorm, stream);
  } else {
    launch_vec<T, A, 1>(x, rs, rs_dtype, ag, ag_dtype, div, y, G, n, s, d,
                        renorm, stream);
  }
}

template <typename T>
void launch_acc(const void* stack, const void* rs, DType rs_dtype,
                const void* ag, DType ag_dtype, const float* div, void* out,
                DType acc_dtype, int64_t G, int64_t n, int64_t s, int64_t d,
                bool renorm, cudaStream_t stream) {
  if (acc_dtype == DType::kBF16) {
    launch_typed<T, __nv_bfloat16>(stack, rs, rs_dtype, ag, ag_dtype, div,
                                   out, G, n, s, d, renorm, stream);
  } else {  // the binding admits only f32 and bf16
    launch_typed<T, float>(stack, rs, rs_dtype, ag, ag_dtype, div, out, G, n,
                           s, d, renorm, stream);
  }
}

}  // namespace

void ring_round_launch(const void* stack, DType dtype, const void* rs,
                       DType rs_dtype, const void* ag, DType ag_dtype,
                       const float* div, void* out, DType acc_dtype,
                       bool renorm, int64_t G, int64_t n, int64_t s,
                       int64_t d, cudaStream_t stream) {
  switch (dtype) {
    case DType::kF32:
      return launch_acc<float>(stack, rs, rs_dtype, ag, ag_dtype, div, out,
                               acc_dtype, G, n, s, d, renorm, stream);
    case DType::kBF16:
      return launch_acc<__nv_bfloat16>(stack, rs, rs_dtype, ag, ag_dtype,
                                       div, out, acc_dtype, G, n, s, d,
                                       renorm, stream);
    default:
      return;  // the binding admits only f32 and bf16 payloads
  }
}

}  // namespace repro_torch
