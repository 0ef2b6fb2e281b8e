// Drop-masked renormalised block average for Hopper (sm_90a).
//
// Replaces src/repro/kernels/masked_avg.py::masked_avg_grid_pallas (body
// _masked_avg_kernel): the owner's step of the RPS reduce-scatter
// (Algorithm 1), out[b] = sum_i m[b,i] * x[b,i] / max(sum_i m[b,i], 1),
// accumulated in f32 and written in the blocks' dtype, for all B blocks of
// an exchange round in one launch.
//
// What bounds it: one read of the (B, n, d) stack and one write of the
// (B, d) output; there is about one multiply-add per element read, so the
// card's memory rate, not its arithmetic, is the limit. At the serving
// shape (B = 4, n = 4, d = 2304, f32: 184,320 bytes) even that takes well
// under a microsecond, so the launch itself dominates.
//
// What the design does about it:
//   - one thread block per (b, column tile), so a launch covers every
//     block of the round and the grid is as wide as the data allows;
//   - the block first loads its mask row into shared memory (cast from its
//     raw dtype there, so the caller never makes a float copy) and reduces
//     it to the received count;
//   - each thread owns one run of contiguous columns and loops over the n
//     workers, reading each row with one 16-byte load when the dtype and
//     alignment allow, so a warp's loads are coalesced and every byte of
//     the stack is read exactly once;
//   - the ragged last tile is masked here, with no padding copy;
//   - the kernel allocates nothing and runs on the caller's stream.
// Launch overhead is left to later work (CUDA graphs around the decode
// round, or fusing the exchange into its neighbours).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "convert.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

// VEC contiguous columns per thread: 16 / sizeof(T) on the vector path
// (one 16-byte load per worker row), 1 on the scalar path.
template <typename T, typename M, int VEC>
__global__ void masked_avg_grid_kernel(const T* __restrict__ blocks,
                                       const M* __restrict__ mask,
                                       T* __restrict__ out, int n, int64_t d,
                                       int64_t tile) {
  extern __shared__ float s_mask[];  // this block's mask row, as f32
  const int64_t b = blockIdx.x;
  const M* mrow = mask + b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_mask[i] = to_float(mrow[i]);
  }
  __syncthreads();
  float count = 0.0f;
  for (int i = 0; i < n; ++i) count += s_mask[i];
  const float denom = fmaxf(count, 1.0f);

  const int64_t tile_lo = static_cast<int64_t>(blockIdx.y) * tile;
  const int64_t tile_hi = tile_lo + tile < d ? tile_lo + tile : d;
  const int64_t col = tile_lo + static_cast<int64_t>(threadIdx.x) * VEC;
  if (col >= tile_hi) return;
  const T* src = blocks + b * n * d + col;
  T* dst = out + b * d + col;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;

  if constexpr (VEC > 1) {
    if (col + VEC <= tile_hi) {
      static_assert(VEC * sizeof(T) == sizeof(uint4), "16-byte vectors");
      for (int i = 0; i < n; ++i) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src + i * d));
        const T* vals = reinterpret_cast<const T*>(&raw);
        const float m = s_mask[i];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += m * to_float(vals[v]);
      }
      uint4 packed;
      T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int v = 0; v < VEC; ++v) res[v] = from_float<T>(acc[v] / denom);
      *reinterpret_cast<uint4*>(dst) = packed;
      return;
    }
  }
  // scalar path, and the ragged end of the last tile
  const int64_t width = tile_hi - col < VEC ? tile_hi - col : VEC;
  for (int i = 0; i < n; ++i) {
    const float m = s_mask[i];
    for (int64_t v = 0; v < width; ++v) {
      acc[v] += m * to_float(src[i * d + v]);
    }
  }
  for (int64_t v = 0; v < width; ++v) dst[v] = from_float<T>(acc[v] / denom);
}

int round_up_warp(int64_t threads) {
  return static_cast<int>((threads + 31) / 32 * 32);
}

template <typename T, typename M>
void launch_typed(const void* blocks, const void* mask, void* out, int64_t B,
                  int64_t n, int64_t d, int64_t tile, cudaStream_t stream) {
  constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(T));
  const bool vec_ok = d % kVec == 0 && tile % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(blocks) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t n_tiles = (d + tile - 1) / tile;
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(n_tiles));
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const T* x = static_cast<const T*>(blocks);
  const M* m = static_cast<const M*>(mask);
  T* y = static_cast<T*>(out);
  if (vec_ok) {
    masked_avg_grid_kernel<T, M, kVec>
        <<<grid, round_up_warp(tile / kVec), smem, stream>>>(
            x, m, y, static_cast<int>(n), d, tile);
  } else {
    masked_avg_grid_kernel<T, M, 1><<<grid, round_up_warp(tile), smem,
                                      stream>>>(x, m, y, static_cast<int>(n),
                                                d, tile);
  }
}

template <typename T>
void launch_mask(const void* blocks, const void* mask, DType mask_dtype,
                 void* out, int64_t B, int64_t n, int64_t d, int64_t tile,
                 cudaStream_t stream) {
  switch (mask_dtype) {
    case DType::kF32:
      return launch_typed<T, float>(blocks, mask, out, B, n, d, tile, stream);
    case DType::kBF16:
      return launch_typed<T, __nv_bfloat16>(blocks, mask, out, B, n, d, tile,
                                            stream);
    case DType::kF16:
      return launch_typed<T, __half>(blocks, mask, out, B, n, d, tile, stream);
    case DType::kBool:
      return launch_typed<T, bool>(blocks, mask, out, B, n, d, tile, stream);
    case DType::kU8:
      return launch_typed<T, uint8_t>(blocks, mask, out, B, n, d, tile,
                                      stream);
    case DType::kI8:
      return launch_typed<T, int8_t>(blocks, mask, out, B, n, d, tile, stream);
    case DType::kI32:
      return launch_typed<T, int32_t>(blocks, mask, out, B, n, d, tile,
                                      stream);
    case DType::kI64:
      return launch_typed<T, int64_t>(blocks, mask, out, B, n, d, tile,
                                      stream);
  }
}

}  // namespace

void masked_avg_grid_launch(const void* blocks, DType blocks_dtype,
                            const void* mask, DType mask_dtype, void* out,
                            int64_t B, int64_t n, int64_t d, int64_t tile,
                            cudaStream_t stream) {
  switch (blocks_dtype) {
    case DType::kF32:
      return launch_mask<float>(blocks, mask, mask_dtype, out, B, n, d, tile,
                                stream);
    case DType::kBF16:
      return launch_mask<__nv_bfloat16>(blocks, mask, mask_dtype, out, B, n,
                                        d, tile, stream);
    case DType::kF16:
      return launch_mask<__half>(blocks, mask, mask_dtype, out, B, n, d, tile,
                                 stream);
    default:
      return;  // the binding admits only the three float types
  }
}

}  // namespace repro_torch
