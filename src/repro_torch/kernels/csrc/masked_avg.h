// Plain C++ interface of the masked-average kernel, shared by the CUDA
// source and its PyTorch binding. No PyTorch header is included here, so
// nvcc compiles masked_avg.cu without them.
#pragma once

#include <cstdint>

#include <cuda_runtime_api.h>

namespace repro_torch {

// Element types the kernel reads. Blocks: kF32, kBF16, kF16. Mask: any.
enum class DType : int {
  kF32 = 0,
  kBF16 = 1,
  kF16 = 2,
  kBool = 3,
  kU8 = 4,
  kI8 = 5,
  kI32 = 6,
  kI64 = 7,
};

// Enqueues out[b] = sum_i mask[b,i] * blocks[b,i] / max(sum_i mask[b,i], 1)
// for a contiguous (B, n, d) stack and a contiguous (B, n) mask on `stream`,
// one thread block per (b, tile of `tile` columns). Does not synchronise;
// the caller checks cudaGetLastError() right after.
void masked_avg_grid_launch(const void* blocks, DType blocks_dtype,
                            const void* mask, DType mask_dtype, void* out,
                            int64_t B, int64_t n, int64_t d, int64_t tile,
                            cudaStream_t stream);

}  // namespace repro_torch
