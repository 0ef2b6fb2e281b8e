// Drop-masked ring round of one exchange group, for all n stacked ranks,
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rps_ring.py::ring_bucket_fused (body
// _make_ring_kernel) for the linear wires (f32, bf16), and its has_enc
// variant: one bucket's drop-masked reduce-scatter in ring order, the
// recovery divisor and the all-gather select, on every device of an
// n-device ring. For a group of G buckets stacked as (G, n, s, d) in block
// order, block j owned by rank o = j % n:
//
//   c[r] = cast_acc(enc[g,r,j]) * cast_acc(rs[g,r,j])          (linear)
//        = float(cast_T(float(q[g,r,j]) * scale[g,r,j])) * rs[g,r,j]  (int8)
//   acc  = sum over r = o+1, o+2, ..., o+n-1, o (mod n) of c[r]
//          (each add rounded to the accumulation dtype; no leading 0)
//   mine = cast_payload(acc / cast_acc(div[g,j]))
//   out[g,i,j] = ag[g,i,j] ? mine : (renorm ? stack[g,i,j] : 0)
//
// -- the TPU kernel's RS hops add in that order (chunk c is started by
// rank c+1 and ends at its owner), divide once and select as each chunk
// lands. The contributions `enc` are the payload `stack` itself for the
// plain round; has_enc reads them from a separate table -- an int8 payload
// with one f32 scale per (g, rank, block) row, or the EF send on a linear
// wire -- while `stack` stays the all-gather fallback (the int8 sum is in
// f32). The variant that re-encodes the partial on every hop is
// ring_q.cu's. Bit for bit equal to the plain version
// (kernels/ref.py::ring_round_ref): every multiply, divide and add is an
// explicit round-to-nearest intrinsic (__fmul_rn, __fdiv_rn, __fadd_rn),
// so no multiply-add is contracted, and the decoded int8 contribution is
// rounded to T before the f32 add, as the fake-quant send is.
//
// Why the TPU kernel's hop transport has no counterpart here: on one card
// a hop is a copy that adds bytes and nothing else, so the ranks' partial
// sums never leave registers; across cards the transport belongs to NCCL
// outside the kernel, with this arithmetic between the transfers.
//
// What bounds it: each element of the contributions is read once and each
// of the output written once (G*n*s*d*(in + out bytes)), plus the masks,
// divisors and the dropped blocks' fallback, with one multiply-add per
// element read, so it is bound by bytes: at an f32 (1, 16, 16, 409600)
// group (a 25 MiB bucket at n = 16), 839 MB take 0.25 ms at an H100 SXM's
// 3.35 TB/s (data sheet, 700 W).
//
// What the design does about it (the first, simple form):
//   - one thread block per (g, block j, tile of columns); the (g, j) mask
//     column of n ranks, their int8 scales and the divisor are staged in
//     shared memory, cast from their raw dtypes there;
//   - each thread owns VEC contiguous columns and reads them with one
//     16-byte payload load per rank (a quarter of that for int8) when d and
//     the alignment allow, so a warp's loads are coalesced; in the plain
//     round for n <= 16 the n ranks' values are loaded first (n independent
//     loads in flight) and kept in registers for the all-gather fallback,
//     otherwise the fallback is read again where ag dropped the block;
//   - any d (the scalar path for a d that is not a multiple of VEC), any
//     n >= 1, any s; the kernel allocates nothing and runs on the caller's
//     stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ring_common.cuh"

namespace repro_torch {
namespace {

using ring::decode;
using ring::kThreads;
using ring::load_mask;
using ring::load_pack;
using ring::Pack;
using ring::round_acc;
using ring::store_pack;

constexpr int kMaxCached = 16;

// acc (held as f32, always a value of A) += cast_acc(decode(x)) * m,
// rounded to A; the first term is taken as it is
template <typename T, typename C, typename A, int VEC>
__device__ __forceinline__ void accumulate(float (&acc)[VEC],
                                           const Pack<C, VEC>& x, float sc,
                                           float m, bool first) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const float c = __fmul_rn(round_acc<A>(decode<T>(x.v[v], sc)), m);
    acc[v] = first ? c : round_acc<A>(__fadd_rn(acc[v], c));
  }
}

// C: int8_t (contributions with row scales) or T. CACHE: enc is stack and
// n <= kMaxCached, the ranks' values stay in registers for the fallback.
template <typename T, typename C, typename A, int VEC, bool CACHE>
__global__ void __launch_bounds__(kThreads)
    ring_round_kernel(const T* __restrict__ stack, const C* __restrict__ enc,
                      const float* __restrict__ scale, const void* rs,
                      DType rs_dtype, const void* ag, DType ag_dtype,
                      const float* __restrict__ div, T* __restrict__ out,
                      int n, int64_t s, int64_t d, int64_t tiles,
                      bool renorm) {
  constexpr bool kScaled = std::is_same<C, int8_t>::value;
  static_assert(!CACHE || std::is_same<C, T>::value, "cache the payload");
  extern __shared__ float smem[];  // [n] rs cast to A, [n] ag, [n] scales
  float* s_rs = smem;
  float* s_ag = smem + n;
  float* s_sc = smem + 2 * n;
  __shared__ float s_div;
  const int64_t row = blockIdx.x / tiles;  // g * s + j
  const int64_t tile = blockIdx.x % tiles;
  const int64_t g = row / s;
  const int64_t j = row % s;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int64_t mi = (g * n + r) * s + j;
    s_rs[r] = round_acc<A>(load_mask(rs, rs_dtype, mi));
    s_ag[r] = load_mask(ag, ag_dtype, mi);
    if constexpr (kScaled) s_sc[r] = scale[mi];
  }
  if (threadIdx.x == 0) s_div = round_acc<A>(div[row]);
  __syncthreads();

  const int64_t col = (tile * kThreads + threadIdx.x) * VEC;
  if (col >= d) return;
  const int owner = static_cast<int>(j % n);
  const int64_t stride = s * d;  // from rank r to rank r + 1
  const int64_t base = (g * n * s + j) * d + col;
  const C* src = enc + base;
  T* dst = out + base;

  float acc[VEC];
  Pack<T, VEC> cache[CACHE ? kMaxCached : 1];
  if constexpr (CACHE) {
#pragma unroll
    for (int t = 0; t < kMaxCached; ++t) {
      if (t < n) {
        int r = owner + 1 + t;
        if (r >= n) r -= n;
        cache[t] = load_pack<true, T, VEC>(stack + base + r * stride);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxCached; ++t) {
      if (t < n) {
        int r = owner + 1 + t;
        if (r >= n) r -= n;
        accumulate<T, T, A, VEC>(acc, cache[t], 1.0f, s_rs[r], t == 0);
      }
    }
  } else {
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      int r = owner + 1 + t;
      if (r >= n) r -= n;
      accumulate<T, C, A, VEC>(acc, load_pack<true, C, VEC>(src + r * stride),
                               kScaled ? s_sc[r] : 1.0f, s_rs[r], t == 0);
    }
  }

  Pack<T, VEC> mine, zero;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mine.v[v] = from_float<T>(round_acc<A>(__fdiv_rn(acc[v], s_div)));
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
                           load_pack<true, T, VEC>(stack + base + r * stride));
      } else {
        store_pack<T, VEC>(dst + r * stride, zero);
      }
    }
  }
}

template <typename T, typename C, typename A, int VEC>
void launch_vec(const T* stack, const C* enc, const float* scale,
                const void* rs, DType rs_dtype, const void* ag,
                DType ag_dtype, const float* div, T* out, int64_t G,
                int64_t n, int64_t s, int64_t d, bool renorm,
                cudaStream_t stream) {
  const int64_t tiles = (d + kThreads * VEC - 1) / (kThreads * VEC);
  const dim3 grid(static_cast<unsigned>(G * s * tiles));
  const size_t staged = std::is_same<C, int8_t>::value ? 3 : 2;
  const size_t smem = staged * static_cast<size_t>(n) * sizeof(float);
  const int ni = static_cast<int>(n);
  if constexpr (std::is_same<C, T>::value) {
    if (n <= kMaxCached && static_cast<const void*>(enc) == stack) {
      ring_round_kernel<T, C, A, VEC, true><<<grid, kThreads, smem, stream>>>(
          stack, enc, scale, rs, rs_dtype, ag, ag_dtype, div, out, ni, s, d,
          tiles, renorm);
      return;
    }
  }
  ring_round_kernel<T, C, A, VEC, false><<<grid, kThreads, smem, stream>>>(
      stack, enc, scale, rs, rs_dtype, ag, ag_dtype, div, out, ni, s, d,
      tiles, renorm);
}

template <typename T, typename C, typename A>
void launch_typed(const void* stack, const void* enc, const float* scale,
                  const void* rs, DType rs_dtype, const void* ag,
                  DType ag_dtype, const float* div, void* out, int64_t G,
                  int64_t n, int64_t s, int64_t d, bool renorm,
                  cudaStream_t stream) {
  constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(T));
  const T* x = static_cast<const T*>(stack);
  const C* e = static_cast<const C*>(enc);
  T* y = static_cast<T*>(out);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % sizeof(uint4) == 0;
  };
  if (d % kVec == 0 && aligned(x) && aligned(y) && aligned(e)) {
    launch_vec<T, C, A, kVec>(x, e, scale, rs, rs_dtype, ag, ag_dtype, div,
                              y, G, n, s, d, renorm, stream);
  } else {
    launch_vec<T, C, A, 1>(x, e, scale, rs, rs_dtype, ag, ag_dtype, div, y,
                           G, n, s, d, renorm, stream);
  }
}

template <typename T>
void launch_enc(const void* stack, const void* enc, DType enc_dtype,
                const float* scale, const void* rs, DType rs_dtype,
                const void* ag, DType ag_dtype, const float* div, void* out,
                DType acc_dtype, int64_t G, int64_t n, int64_t s, int64_t d,
                bool renorm, cudaStream_t stream) {
  if (enc_dtype == DType::kI8) {  // the binding sums int8 in f32
    launch_typed<T, int8_t, float>(stack, enc, scale, rs, rs_dtype, ag,
                                   ag_dtype, div, out, G, n, s, d, renorm,
                                   stream);
  } else if (acc_dtype == DType::kBF16) {
    launch_typed<T, T, __nv_bfloat16>(stack, enc, nullptr, rs, rs_dtype, ag,
                                      ag_dtype, div, out, G, n, s, d, renorm,
                                      stream);
  } else {  // the binding admits only f32 and bf16
    launch_typed<T, T, float>(stack, enc, nullptr, rs, rs_dtype, ag,
                              ag_dtype, div, out, G, n, s, d, renorm, stream);
  }
}

}  // namespace

void ring_round_launch(const void* stack, DType dtype, const void* enc,
                       DType enc_dtype, const float* scale, const void* rs,
                       DType rs_dtype, const void* ag, DType ag_dtype,
                       const float* div, void* out, DType acc_dtype,
                       bool renorm, int64_t G, int64_t n, int64_t s,
                       int64_t d, cudaStream_t stream) {
  switch (dtype) {
    case DType::kF32:
      return launch_enc<float>(stack, enc, enc_dtype, scale, rs, rs_dtype,
                               ag, ag_dtype, div, out, acc_dtype, G, n, s, d,
                               renorm, stream);
    case DType::kBF16:
      return launch_enc<__nv_bfloat16>(stack, enc, enc_dtype, scale, rs,
                                       rs_dtype, ag, ag_dtype, div, out,
                                       acc_dtype, G, n, s, d, renorm,
                                       stream);
    default:
      return;  // the binding admits only f32 and bf16 payloads
  }
}

}  // namespace repro_torch
