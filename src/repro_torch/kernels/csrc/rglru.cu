// RG-LRU gated diagonal linear recurrence (Griffin) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rglru_scan.py::rglru_pallas (body
// _rglru_kernel): from h_0 = 0, for every (b, channel c),
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t
// with the carry in f32, x read in its own type (f32, bf16, f16), a in f32
// or in x's type, and h written in x's type (the TPU kernel's out_shape is
// x.dtype). It also writes the final f32 carry h_last (B, d), which the
// model's prefill keeps as the decode state.
//
// What bounds it: per element it reads x and a once and writes h once
// (2 + 4 + 2 bytes at the serving dtypes, bf16 x and f32 a) and does 5
// f32 operations, so it is memory-bound: at (8, 2048, 4096) it moves
// 537 MB, 0.160 ms at an H100 SXM's 3.35 TB/s (data sheet, 700 W). The recurrence is sequential in t but
// independent across (b, c), so the parallelism is B * d threads.
//
// What the design does about it (the first, simple form):
//   - one thread per (b, c), threads of a block along c, so every load and
//     store of a warp is one contiguous row segment of the (B, S, d)
//     layout (coalesced), and the carry stays in a register for the whole
//     sequence;
//   - the loop over t runs in chunks of kUnroll steps, and the next
//     chunk's x and a are loaded into registers, in their stored types,
//     before the current chunk's dependent FMA chain runs, so up to
//     2 * kUnroll steps of loads per thread are in flight while the chain
//     waits on none of them;
//   - any d: the ragged last block masks its threads; any S >= 1: the
//     ragged last chunk masks its steps.
// Not done yet: splitting S across blocks with a carry fix-up pass, which
// would give more than B * d threads (32,768 at the serving shape) to hide
// the memory latency with.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "convert.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <typename T, typename TA>
__global__ void __launch_bounds__(kThreads)
    rglru_fwd_kernel(const T* __restrict__ x, const TA* __restrict__ a,
                     T* __restrict__ out, float* __restrict__ h_last, int S,
                     int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * S * d + c;   // element (b, 0, c)

  // the prefetched steps stay in their stored types until they are used:
  // converting them as they are loaded would wait on the loads there,
  // before the current chunk's chain, and expose a full round trip per
  // chunk (0.42 ms against 0.26 ms at the serving shape on an H100 80GB
  // HBM3 at 700 W, PERF.md)
  T nx[kUnroll];
  TA na[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (u < S) {
      nx[u] = x[base + static_cast<int64_t>(u) * d];
      na[u] = a[base + static_cast<int64_t>(u) * d];
    }
  }
  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    T cx[kUnroll];
    TA ca[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cx[u] = nx[u];
      ca[u] = na[u];
    }
    const int t1 = t0 + kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t1 + u < S) {
        const int64_t off = base + static_cast<int64_t>(t1 + u) * d;
        nx[u] = x[off];
        na[u] = a[off];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const float at = to_float(ca[u]);
        const float bt = sqrtf(fmaxf(1.0f - at * at, 0.0f)) * to_float(cx[u]);
        h = at * h + bt;
        out[base + static_cast<int64_t>(t0 + u) * d] = from_float<T>(h);
      }
    }
  }
  h_last[b * d + c] = h;
}

template <typename T, typename TA>
void launch_typed(const void* x, const void* a, void* out, float* h_last,
                  int64_t B, int64_t S, int64_t d, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rglru_fwd_kernel<T, TA><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TA*>(a),
      static_cast<T*>(out), h_last, static_cast<int>(S),
      static_cast<int>(d));
}

template <typename T>
void launch_x(const void* x, const void* a, DType a_dtype, void* out,
              float* h_last, int64_t B, int64_t S, int64_t d,
              cudaStream_t stream) {
  if (a_dtype == DType::kF32) {
    launch_typed<T, float>(x, a, out, h_last, B, S, d, stream);
  } else {  // the binding admits only f32 or x's own type for a
    launch_typed<T, T>(x, a, out, h_last, B, S, d, stream);
  }
}

}  // namespace

void rglru_fwd_launch(const void* x, DType x_dtype, const void* a,
                      DType a_dtype, void* out, float* h_last, int64_t B,
                      int64_t S, int64_t d, cudaStream_t stream) {
  switch (x_dtype) {
    case DType::kF32:
      return launch_typed<float, float>(x, a, out, h_last, B, S, d, stream);
    case DType::kBF16:
      return launch_x<__nv_bfloat16>(x, a, a_dtype, out, h_last, B, S, d,
                                     stream);
    case DType::kF16:
      return launch_x<__half>(x, a, a_dtype, out, h_last, B, S, d, stream);
    default:
      return;  // the binding admits only the three float types
  }
}

}  // namespace repro_torch
