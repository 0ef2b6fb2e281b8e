// Binds the masked-average kernel to PyTorch as
// torch.ops.repro_torch.masked_avg_grid(blocks, mask, out, tile). The only
// file of the build that includes PyTorch's headers; it registers the op
// through torch/library.h rather than torch/extension.h and pybind11, which
// keeps its compile short. The Python wrapper
// (repro_torch/kernels/masked_avg.py) checks devices, dtypes and contiguity
// first; the launch limits on B, n and d are checked here.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include "masked_avg.h"

namespace {

constexpr int64_t kMaxWorkers = 8192;
constexpr int64_t kMaxGridX = 2147483647;
constexpr int64_t kMaxGridY = 65535;

repro_torch::DType dtype_code(c10::ScalarType t) {
  switch (t) {
    case c10::ScalarType::Float:
      return repro_torch::DType::kF32;
    case c10::ScalarType::BFloat16:
      return repro_torch::DType::kBF16;
    case c10::ScalarType::Half:
      return repro_torch::DType::kF16;
    case c10::ScalarType::Bool:
      return repro_torch::DType::kBool;
    case c10::ScalarType::Byte:
      return repro_torch::DType::kU8;
    case c10::ScalarType::Char:
      return repro_torch::DType::kI8;
    case c10::ScalarType::Int:
      return repro_torch::DType::kI32;
    case c10::ScalarType::Long:
      return repro_torch::DType::kI64;
    default:
      TORCH_CHECK(false, "masked_avg_grid: unsupported dtype ", t);
  }
}

void masked_avg_grid(const at::Tensor& blocks, const at::Tensor& mask,
                     at::Tensor& out, int64_t tile) {
  TORCH_CHECK(blocks.is_cuda() && mask.is_cuda() && out.is_cuda(),
              "masked_avg_grid: tensors must be on a CUDA device");
  TORCH_CHECK(blocks.is_contiguous() && mask.is_contiguous() &&
                  out.is_contiguous(),
              "masked_avg_grid: tensors must be contiguous");
  TORCH_CHECK(blocks.dim() == 3 && mask.dim() == 2 && out.dim() == 2,
              "masked_avg_grid: want blocks (B, n, d), mask (B, n), "
              "out (B, d)");
  const int64_t B = blocks.size(0), n = blocks.size(1), d = blocks.size(2);
  TORCH_CHECK(mask.size(0) == B && mask.size(1) == n && out.size(0) == B &&
                  out.size(1) == d,
              "masked_avg_grid: shape mismatch");
  TORCH_CHECK(out.scalar_type() == blocks.scalar_type(),
              "masked_avg_grid: out dtype must equal blocks dtype");
  const repro_torch::DType bt = dtype_code(blocks.scalar_type());
  TORCH_CHECK(bt == repro_torch::DType::kF32 ||
                  bt == repro_torch::DType::kBF16 ||
                  bt == repro_torch::DType::kF16,
              "masked_avg_grid: blocks must be float32, bfloat16 or "
              "float16");
  TORCH_CHECK(tile >= 1 && tile <= 1024, "masked_avg_grid: bad tile ", tile);
  // the mask row lives in 32 KiB of shared memory; B and the column tiles
  // are grid.x and grid.y
  TORCH_CHECK(n >= 1 && n <= kMaxWorkers, "masked_avg_grid: n = ", n,
              " workers, want 1..", kMaxWorkers);
  TORCH_CHECK(B >= 1 && B <= kMaxGridX && d >= 1,
              "masked_avg_grid: need 1 <= B <= ", kMaxGridX, " and d >= 1");
  TORCH_CHECK((d + tile - 1) / tile <= kMaxGridY, "masked_avg_grid: d = ", d,
              " needs more than ", kMaxGridY, " column tiles of ", tile);
  const c10::cuda::CUDAGuard guard(blocks.device());
  repro_torch::masked_avg_grid_launch(
      blocks.data_ptr(), bt, mask.data_ptr(), dtype_code(mask.scalar_type()),
      out.data_ptr(), B, n, d, tile,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("masked_avg_grid(Tensor blocks, Tensor mask, Tensor(a!) out, "
        "int tile) -> ()",
        &masked_avg_grid);
}
