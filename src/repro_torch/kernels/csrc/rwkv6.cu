// RWKV-6 (Finch) recurrence for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rwkv6_scan.py::rwkv6_pallas (body
// _rwkv6_kernel): from a zero state, for every (b, h),
//   o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
// with the (dk, dv) state in f32, inputs read in their own type (f32, bf16,
// f16) and o written in it. It also writes the final state, which the TPU
// kernel keeps in its VMEM scratch: the model's prefill takes it as the
// decode cache instead of folding the sequence a second time.
//
// What bounds it: per (b, t, h) it does about 6 f32 operations for each of
// the dk * dv state entries, and reads only dk + dk + dk + dv inputs; at
// dk = dv = 64 that is over 40 operations per input byte in bf16, so the
// card's f32 rate outside the tensor cores, not its memory, is the limit
// (the serving shape (8, 512, 32, 64) needs ~48 us of f32 work against
// ~26 us of HBM traffic). The recurrence is also sequential in t, so each
// block walks S steps one after another.
//
// What the design does about it (the first, simple form; the published
// RWKV-6 CUDA forward works the same way):
//   - one thread block per (b, h) and one thread per state column j, so
//     S[:, j] lives in registers for the whole sequence and the state
//     never touches memory until the final write;
//   - per step, threads j < dk stage r_t, k_t and w_t in shared memory
//     (double-buffered, so one barrier per step suffices), and every
//     thread reads them back as broadcasts;
//   - the next step's inputs are loaded into registers before the barrier
//     and the current step's arithmetic, so their latency overlaps it;
//   - four partial sums break the dependent chain of the output's dot
//     product over dk;
//   - inputs are read in place from the (B, S, H, d) layout, step stride
//     H * d; no padding, so the final state is exactly the fold's over S
//     steps. dk is rounded up to a template width (8, 16, 32, 64) whose
//     extra rows have r = k = 0, w = 1 and stay zero.
// Not done yet: the chunked form on tensor cores, and more parallelism
// than B * H blocks of <= 64 threads (256 blocks at the serving shape, for
// 132 SMs).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "convert.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

template <typename T, int DK>
__global__ void __launch_bounds__(kRwkv6MaxDim)
    rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ w,
                     const float* __restrict__ u, T* __restrict__ out,
                     float* __restrict__ state_out, int S, int H, int dk,
                     int dv) {
  __shared__ float s_r[2][DK];
  __shared__ float s_k[2][DK];
  __shared__ float s_w[2][DK];
  __shared__ float s_u[DK];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int j = threadIdx.x;
  const bool stages = j < dk;   // thread j stages element j of r, k, w
  const bool owns = j < dv;     // thread j owns state column j
  const int64_t step_k = static_cast<int64_t>(H) * dk;
  const int64_t step_v = static_cast<int64_t>(H) * dv;
  const int64_t base_k = (static_cast<int64_t>(b) * S * H + h) * dk + j;
  const int64_t base_v = (static_cast<int64_t>(b) * S * H + h) * dv + j;

  if (j < DK) {
    s_u[j] = stages ? u[h * dk + j] : 0.0f;
    if (!stages) {  // padded rows: never written again
      s_r[0][j] = s_r[1][j] = 0.0f;
      s_k[0][j] = s_k[1][j] = 0.0f;
      s_w[0][j] = s_w[1][j] = 1.0f;
    }
  }
  float st[DK];
#pragma unroll
  for (int i = 0; i < DK; ++i) st[i] = 0.0f;

  float nr = 0.0f, nk = 0.0f, nw = 1.0f, nv = 0.0f;
  if (stages) {
    nr = to_float(r[base_k]);
    nk = to_float(k[base_k]);
    nw = to_float(w[base_k]);
  }
  if (owns) nv = to_float(v[base_v]);

  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    if (stages) {
      s_r[buf][j] = nr;
      s_k[buf][j] = nk;
      s_w[buf][j] = nw;
    }
    const float vj = nv;
    if (t + 1 < S) {
      const int64_t ok = base_k + static_cast<int64_t>(t + 1) * step_k;
      if (stages) {
        nr = to_float(r[ok]);
        nk = to_float(k[ok]);
        nw = to_float(w[ok]);
      }
      if (owns) {
        nv = to_float(v[base_v + static_cast<int64_t>(t + 1) * step_v]);
      }
    }
    // buffer `buf` was last read in step t - 2, which every thread
    // finished before the barrier of step t - 1
    __syncthreads();
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < DK; ++i) {
      const float kv = s_k[buf][i] * vj;
      const float s = st[i];
      y[i & 3] += s_r[buf][i] * (s + s_u[i] * kv);
      st[i] = s_w[buf][i] * s + kv;
    }
    if (owns) {
      out[base_v + static_cast<int64_t>(t) * step_v] =
          from_float<T>((y[0] + y[1]) + (y[2] + y[3]));
    }
  }
  if (owns) {
    float* dst = state_out + static_cast<int64_t>(blockIdx.x) * dk * dv + j;
#pragma unroll
    for (int i = 0; i < DK; ++i) {
      if (i < dk) dst[static_cast<int64_t>(i) * dv] = st[i];
    }
  }
}

template <typename T, int DK>
void launch_dk(const void* r, const void* k, const void* v, const void* w,
               const float* u, void* out, float* state, int64_t B, int64_t S,
               int64_t H, int64_t dk, int64_t dv, cudaStream_t stream) {
  const int64_t widest = dv > DK ? dv : DK;
  const int threads = static_cast<int>((widest + 31) / 32 * 32);
  rwkv6_fwd_kernel<T, DK><<<static_cast<unsigned>(B * H), threads, 0,
                            stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u,
      static_cast<T*>(out), state, static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(dk), static_cast<int>(dv));
}

template <typename T>
void launch_typed(const void* r, const void* k, const void* v, const void* w,
                  const float* u, void* out, float* state, int64_t B,
                  int64_t S, int64_t H, int64_t dk, int64_t dv,
                  cudaStream_t stream) {
  if (dk <= 8) {
    launch_dk<T, 8>(r, k, v, w, u, out, state, B, S, H, dk, dv, stream);
  } else if (dk <= 16) {
    launch_dk<T, 16>(r, k, v, w, u, out, state, B, S, H, dk, dv, stream);
  } else if (dk <= 32) {
    launch_dk<T, 32>(r, k, v, w, u, out, state, B, S, H, dk, dv, stream);
  } else {
    launch_dk<T, 64>(r, k, v, w, u, out, state, B, S, H, dk, dv, stream);
  }
}

}  // namespace

void rwkv6_fwd_launch(const void* r, const void* k, const void* v,
                      const void* w, const float* u, DType dtype, void* out,
                      float* state, int64_t B, int64_t S, int64_t H,
                      int64_t dk, int64_t dv, cudaStream_t stream) {
  switch (dtype) {
    case DType::kF32:
      return launch_typed<float>(r, k, v, w, u, out, state, B, S, H, dk, dv,
                                 stream);
    case DType::kBF16:
      return launch_typed<__nv_bfloat16>(r, k, v, w, u, out, state, B, S, H,
                                         dk, dv, stream);
    case DType::kF16:
      return launch_typed<__half>(r, k, v, w, u, out, state, B, S, H, dk, dv,
                                  stream);
    default:
      return;  // the binding admits only the three float types
  }
}

}  // namespace repro_torch
