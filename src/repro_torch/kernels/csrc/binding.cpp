// Binds the port's CUDA kernels to PyTorch as
//   torch.ops.repro_torch.masked_avg_grid(blocks, mask, out, tile)
//   torch.ops.repro_torch.tp_combine(partials, rs, ag, out, site, receiver,
//                                    blk, wire_bf16)
//   torch.ops.repro_torch.rwkv6_fwd(r, k, v, w, u, out, state, scratch,
//                                   ready)
//   torch.ops.repro_torch.rglru_fwd(x, a, out, h_last)
//   torch.ops.repro_torch.ring_round(stack, rs, ag, div, out, renorm,
//                                    acc_bf16)
//   torch.ops.repro_torch.ring_round_enc(stack, enc, scale, rs, ag, div,
//                                        out, part, amax, renorm, acc_bf16,
//                                        levels, cluster, chunk)
//   torch.ops.repro_torch.ring_rank_hop(src, src_scale, rs, recv,
//                                       recv_scale, div, out, out_scale,
//                                       part_max, chunk, acc_bf16, levels,
//                                       last, blocks, cols)
//   torch.ops.repro_torch.ring_rank_land(cur, ag, blocks, out, chunk,
//                                        renorm)
// The only file of the build that includes PyTorch's headers; it registers
// the ops through torch/library.h rather than torch/extension.h and
// pybind11, which keeps its compile short. The Python wrappers
// (repro_torch/kernels/masked_avg.py, rwkv6.py, rglru.py, ring.py) check
// devices, dtypes and contiguity first; the launch limits are checked here.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <initializer_list>
#include <optional>
#include <vector>

#include "kernels.h"

namespace {

constexpr int64_t kMaxWorkers = 8192;
constexpr int64_t kMaxLevels = 127;
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
      TORCH_CHECK(false, "repro_torch kernels: unsupported dtype ", t);
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

void tp_combine(const at::Tensor& partials, const at::Tensor& rs,
                const at::Tensor& ag, at::Tensor& out, int64_t site,
                int64_t receiver, int64_t blk, bool wire_bf16) {
  for (const at::Tensor* t :
       std::initializer_list<const at::Tensor*>{&partials, &rs, &ag, &out}) {
    TORCH_CHECK(t->is_cuda() && t->device() == partials.device(),
                "tp_combine: tensors must be on one CUDA device");
  }
  TORCH_CHECK(out.is_contiguous(), "tp_combine: out must be contiguous");
  TORCH_CHECK(partials.dim() == 4 && partials.size(2) == 1 && rs.dim() == 3 &&
                  ag.dim() == 3 && out.dim() == 3,
              "tp_combine: want partials (n, B, 1, d), rs and ag "
              "(n_sites, n, s), out (B, 1, d)");
  const int64_t n = partials.size(0), B = partials.size(1),
                d = partials.size(3), s = rs.size(2);
  TORCH_CHECK(rs.sizes() == ag.sizes() && rs.size(1) == n &&
                  out.size(0) == B && out.size(1) == 1 && out.size(2) == d,
              "tp_combine: shape mismatch");
  const c10::ScalarType pt = partials.scalar_type();
  TORCH_CHECK(pt == c10::ScalarType::Float || pt == c10::ScalarType::BFloat16,
              "tp_combine: partials must be float32 or bfloat16");
  TORCH_CHECK(out.scalar_type() == c10::ScalarType::Float,
              "tp_combine: out must be float32");
  TORCH_CHECK(rs.scalar_type() == c10::ScalarType::Bool &&
                  ag.scalar_type() == c10::ScalarType::Bool,
              "tp_combine: rs and ag must be bool");
  TORCH_CHECK(site >= 0 && site < rs.size(0), "tp_combine: site ", site,
              " not in [0, ", rs.size(0), ")");
  TORCH_CHECK(receiver >= 0 && receiver < n, "tp_combine: receiver ",
              receiver, " not in [0, ", n, ")");
  // the requests are grid.y; the flat index c * B + b is int
  TORCH_CHECK(B >= 1 && B <= kMaxGridY && d >= 1 && B * d <= kMaxGridX,
              "tp_combine: need 1 <= B <= ", kMaxGridY,
              ", d >= 1 and B * d <= ", kMaxGridX);
  TORCH_CHECK(blk >= 1 && s * blk >= B * d,
              "tp_combine: s = ", s, " blocks of ", blk,
              " do not lay out B * d = ", B * d);
  const c10::cuda::CUDAGuard guard(partials.device());
  // the site's rows found by their strides: any layout of the mask stacks
  const bool* rs_site =
      static_cast<const bool*>(rs.data_ptr()) + site * rs.stride(0);
  const bool* ag_row = static_cast<const bool*>(ag.data_ptr()) +
                       site * ag.stride(0) + receiver * ag.stride(1);
  repro_torch::tp_combine_launch(
      partials.data_ptr(), dtype_code(pt), partials.stride(0),
      partials.stride(1), partials.stride(3), rs_site, rs.stride(1),
      rs.stride(2), ag_row, ag.stride(2),
      wire_bf16 ? repro_torch::DType::kBF16 : repro_torch::DType::kF32,
      static_cast<float*>(out.data_ptr()), n, B, d, blk, receiver,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void rwkv6_fwd(const at::Tensor& r, const at::Tensor& k, const at::Tensor& v,
               const at::Tensor& w, const at::Tensor& u, at::Tensor& out,
               at::Tensor& state, at::Tensor& scratch, at::Tensor& ready) {
  for (const at::Tensor* t : std::initializer_list<const at::Tensor*>{
           &r, &k, &v, &w, &u, &out, &state, &scratch, &ready}) {
    TORCH_CHECK(t->is_cuda() && t->device() == r.device(),
                "rwkv6_fwd: tensors must be on one CUDA device");
    TORCH_CHECK(t->is_contiguous(), "rwkv6_fwd: tensors must be contiguous");
  }
  TORCH_CHECK(r.dim() == 4 && k.dim() == 4 && v.dim() == 4 && w.dim() == 4 &&
                  u.dim() == 2 && out.dim() == 4 && state.dim() == 4,
              "rwkv6_fwd: want r, k, w (B, S, H, dk), v and out "
              "(B, S, H, dv), u (H, dk), state (B, H, dk, dv)");
  const int64_t B = r.size(0), S = r.size(1), H = r.size(2), dk = r.size(3);
  const int64_t dv = v.size(3);
  TORCH_CHECK(k.sizes() == r.sizes() && w.sizes() == r.sizes() &&
                  v.size(0) == B && v.size(1) == S && v.size(2) == H &&
                  out.sizes() == v.sizes() && u.size(0) == H &&
                  u.size(1) == dk && state.size(0) == B &&
                  state.size(1) == H && state.size(2) == dk &&
                  state.size(3) == dv,
              "rwkv6_fwd: shape mismatch");
  const c10::ScalarType st = r.scalar_type();
  TORCH_CHECK(st == c10::ScalarType::Float || st == c10::ScalarType::BFloat16 ||
                  st == c10::ScalarType::Half,
              "rwkv6_fwd: r, k, v, w must be float32, bfloat16 or float16");
  TORCH_CHECK(k.scalar_type() == st && v.scalar_type() == st &&
                  w.scalar_type() == st && out.scalar_type() == st,
              "rwkv6_fwd: r, k, v, w and out must share one dtype");
  TORCH_CHECK(u.scalar_type() == c10::ScalarType::Float &&
                  state.scalar_type() == c10::ScalarType::Float,
              "rwkv6_fwd: u and state must be float32");
  TORCH_CHECK(dk >= 1 && dk <= repro_torch::kRwkv6MaxDim && dv >= 1 &&
                  dv <= repro_torch::kRwkv6MaxDim,
              "rwkv6_fwd: dk = ", dk, ", dv = ", dv, "; the kernel takes 1..",
              repro_torch::kRwkv6MaxDim);
  // the grid is one block per (b, h, chunk of 64 tokens)
  TORCH_CHECK(S >= 1 && B >= 1 && H >= 1 &&
                  B * H <= kMaxGridX / ((S + 63) / 64),
              "rwkv6_fwd: need S >= 1 and 1 <= B * H * ceil(S / 64) <= ",
              kMaxGridX);
  TORCH_CHECK(scratch.scalar_type() == c10::ScalarType::Float &&
                  scratch.numel() >= repro_torch::rwkv6_scratch_floats(B, S, H),
              "rwkv6_fwd: scratch must be float32 of at least ",
              repro_torch::rwkv6_scratch_floats(B, S, H), " elements");
  TORCH_CHECK(ready.scalar_type() == c10::ScalarType::Int &&
                  ready.numel() == B * H * ((S + 63) / 64),
              "rwkv6_fwd: ready must be int32, B * H * ceil(S / 64) zeroed "
              "flags");
  const c10::cuda::CUDAGuard guard(r.device());
  C10_CUDA_CHECK(repro_torch::rwkv6_fwd_launch(
      r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
      static_cast<const float*>(u.data_ptr()), dtype_code(st), out.data_ptr(),
      static_cast<float*>(state.data_ptr()),
      static_cast<float*>(scratch.data_ptr()),
      static_cast<int*>(ready.data_ptr()), B, S, H, dk, dv,
      c10::cuda::getCurrentCUDAStream().stream()));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void rglru_fwd(const at::Tensor& x, const at::Tensor& a, at::Tensor& out,
               at::Tensor& h_last) {
  for (const at::Tensor* t :
       std::initializer_list<const at::Tensor*>{&x, &a, &out, &h_last}) {
    TORCH_CHECK(t->is_cuda() && t->device() == x.device(),
                "rglru_fwd: tensors must be on one CUDA device");
    TORCH_CHECK(t->is_contiguous(), "rglru_fwd: tensors must be contiguous");
  }
  TORCH_CHECK(x.dim() == 3 && h_last.dim() == 2,
              "rglru_fwd: want x, a, out (B, S, d), h_last (B, d)");
  const int64_t B = x.size(0), S = x.size(1), d = x.size(2);
  TORCH_CHECK(a.sizes() == x.sizes() && out.sizes() == x.sizes() &&
                  h_last.size(0) == B && h_last.size(1) == d,
              "rglru_fwd: shape mismatch");
  const c10::ScalarType st = x.scalar_type();
  TORCH_CHECK(st == c10::ScalarType::Float || st == c10::ScalarType::BFloat16 ||
                  st == c10::ScalarType::Half,
              "rglru_fwd: x must be float32, bfloat16 or float16");
  TORCH_CHECK(a.scalar_type() == c10::ScalarType::Float ||
                  a.scalar_type() == st,
              "rglru_fwd: a must be float32 or x's dtype");
  TORCH_CHECK(out.scalar_type() == st, "rglru_fwd: out dtype must equal x's");
  TORCH_CHECK(h_last.scalar_type() == c10::ScalarType::Float,
              "rglru_fwd: h_last must be float32");
  // the grid is (column blocks, B); S and d are passed as int
  TORCH_CHECK(S >= 1 && S <= kMaxGridX && d >= 1 && d <= kMaxGridX &&
                  B >= 1 && B <= kMaxGridY,
              "rglru_fwd: need S, d >= 1 and 1 <= B <= ", kMaxGridY);
  const c10::cuda::CUDAGuard guard(x.device());
  repro_torch::rglru_fwd_launch(
      x.data_ptr(), dtype_code(st), a.data_ptr(),
      dtype_code(a.scalar_type()), out.data_ptr(),
      static_cast<float*>(h_last.data_ptr()), B, S, d,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void ring_round(const at::Tensor& stack, const at::Tensor& rs,
                const at::Tensor& ag, const at::Tensor& div, at::Tensor& out,
                bool renorm, bool acc_bf16) {
  for (const at::Tensor* t :
       std::initializer_list<const at::Tensor*>{&stack, &rs, &ag, &div,
                                                &out}) {
    TORCH_CHECK(t->is_cuda() && t->device() == stack.device(),
                "ring_round: tensors must be on one CUDA device");
    TORCH_CHECK(t->is_contiguous(), "ring_round: tensors must be contiguous");
  }
  TORCH_CHECK(stack.dim() == 4 && rs.dim() == 3 && ag.dim() == 3 &&
                  div.dim() == 2,
              "ring_round: want stack and out (G, n, s, d), rs and ag "
              "(G, n, s), div (G, s)");
  const int64_t G = stack.size(0), n = stack.size(1), s = stack.size(2),
                d = stack.size(3);
  TORCH_CHECK(out.sizes() == stack.sizes() && rs.size(0) == G &&
                  rs.size(1) == n && rs.size(2) == s &&
                  ag.sizes() == rs.sizes() && div.size(0) == G &&
                  div.size(1) == s,
              "ring_round: shape mismatch");
  const c10::ScalarType st = stack.scalar_type();
  TORCH_CHECK(st == c10::ScalarType::Float || st == c10::ScalarType::BFloat16,
              "ring_round: stack must be float32 or bfloat16");
  TORCH_CHECK(out.scalar_type() == st,
              "ring_round: out dtype must equal stack's");
  TORCH_CHECK(div.scalar_type() == c10::ScalarType::Float,
              "ring_round: div must be float32");
  // the mask column of n ranks lives in 2 * n floats of shared memory
  // beside the divisor; the grid is one block per (g, j, column tile) on
  // grid.x
  const int64_t most = (repro_torch::kRingSmemFloats - 1) / 2;
  TORCH_CHECK(n >= 1 && n <= most, "ring_round: n = ", n, " ranks, want 1..",
              most);
  TORCH_CHECK(G >= 1 && s >= 1 && d >= 1,
              "ring_round: need G, s, d >= 1");
  const int64_t tiles =
      (d + repro_torch::kRingTileCols - 1) / repro_torch::kRingTileCols;
  TORCH_CHECK(G * s <= kMaxGridX / tiles, "ring_round: G * s * tiles = ",
              G, " * ", s, " * ", tiles, " blocks exceed ", kMaxGridX);
  const c10::cuda::CUDAGuard guard(stack.device());
  repro_torch::ring_round_launch(
      stack.data_ptr(), dtype_code(st), stack.data_ptr(), dtype_code(st),
      nullptr, rs.data_ptr(),
      dtype_code(rs.scalar_type()), ag.data_ptr(),
      dtype_code(ag.scalar_type()),
      static_cast<const float*>(div.data_ptr()), out.data_ptr(),
      acc_bf16 ? repro_torch::DType::kBF16 : repro_torch::DType::kF32, renorm,
      G, n, s, d, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void ring_round_enc(const at::Tensor& stack, const at::Tensor& enc,
                    const std::optional<at::Tensor>& scale,
                    const at::Tensor& rs, const at::Tensor& ag,
                    const at::Tensor& div, at::Tensor& out, at::Tensor& part,
                    at::Tensor& amax, bool renorm, bool acc_bf16,
                    int64_t levels, int64_t cluster, int64_t chunk) {
  std::vector<const at::Tensor*> ts{&stack, &enc, &rs, &ag, &div, &out};
  if (scale.has_value()) ts.push_back(&scale.value());
  if (levels > 0 && cluster == 0) {
    ts.push_back(&part);
    ts.push_back(&amax);
  }
  for (const at::Tensor* t : ts) {
    TORCH_CHECK(t->is_cuda() && t->device() == stack.device(),
                "ring_round_enc: tensors must be on one CUDA device");
    TORCH_CHECK(t->is_contiguous(),
                "ring_round_enc: tensors must be contiguous");
  }
  TORCH_CHECK(stack.dim() == 4 && rs.dim() == 3 && ag.dim() == 3 &&
                  div.dim() == 2,
              "ring_round_enc: want stack, enc and out (G, n, s, d), rs and "
              "ag (G, n, s), div (G, s)");
  const int64_t G = stack.size(0), n = stack.size(1), s = stack.size(2),
                d = stack.size(3);
  TORCH_CHECK(out.sizes() == stack.sizes() && enc.sizes() == stack.sizes() &&
                  rs.size(0) == G && rs.size(1) == n && rs.size(2) == s &&
                  ag.sizes() == rs.sizes() && div.size(0) == G &&
                  div.size(1) == s,
              "ring_round_enc: shape mismatch");
  const c10::ScalarType st = stack.scalar_type();
  TORCH_CHECK(st == c10::ScalarType::Float || st == c10::ScalarType::BFloat16,
              "ring_round_enc: stack must be float32 or bfloat16");
  TORCH_CHECK(out.scalar_type() == st,
              "ring_round_enc: out dtype must equal stack's");
  TORCH_CHECK(div.scalar_type() == c10::ScalarType::Float,
              "ring_round_enc: div must be float32");
  const bool int8 = enc.scalar_type() == c10::ScalarType::Char;
  if (int8) {
    TORCH_CHECK(scale.has_value() &&
                    scale->scalar_type() == c10::ScalarType::Float &&
                    scale->sizes() == rs.sizes(),
                "ring_round_enc: an int8 enc needs float32 scale (G, n, s)");
    TORCH_CHECK(!acc_bf16, "ring_round_enc: an int8 enc sums in float32");
  } else {
    TORCH_CHECK(enc.scalar_type() == st && !scale.has_value(),
                "ring_round_enc: enc must be int8 with scale, or stack's "
                "dtype without");
  }
  TORCH_CHECK(levels >= 0 && levels <= kMaxLevels,
              "ring_round_enc: levels = ", levels, ", want 0..", kMaxLevels);
  if (levels > 0) {
    TORCH_CHECK(int8, "ring_round_enc: levels > 0 needs an int8 enc");
    TORCH_CHECK(cluster >= 0 && cluster <= repro_torch::kRingQMaxCluster,
                "ring_round_enc: cluster = ", cluster, ", want 0..",
                repro_torch::kRingQMaxCluster);
  }
  if (levels > 0 && cluster > 0) {
    TORCH_CHECK(chunk >= 16 && chunk % 16 == 0 &&
                    chunk <= repro_torch::kRingQMaxChunk &&
                    cluster * chunk >= d,
                "ring_round_enc: chunk = ", chunk, " at cluster ", cluster,
                " must be a multiple of 16 in 16..",
                repro_torch::kRingQMaxChunk, " covering d = ", d);
    TORCH_CHECK(G * s <= kMaxGridX / cluster, "ring_round_enc: G * s * "
                "cluster = ", G, " * ", s, " * ", cluster, " blocks exceed ",
                kMaxGridX);
  }
  if (levels > 0 && cluster == 0) {
    TORCH_CHECK(part.scalar_type() == c10::ScalarType::Float &&
                    part.numel() == G * s * d,
                "ring_round_enc: part must be float32 (G, s, d)");
    TORCH_CHECK(amax.scalar_type() == c10::ScalarType::Int &&
                    amax.numel() == G * s * n,
                "ring_round_enc: amax must be int32 (G * s, n)");
  }
  // without the re-encode the (g, j) column stages 2 * n floats of masks
  // (3 * n with the int8 scales) beside the divisor in shared memory
  const int64_t most =
      levels > 0 ? kMaxWorkers
                 : (repro_torch::kRingSmemFloats - 1) / (int8 ? 3 : 2);
  TORCH_CHECK(n >= 1 && n <= most, "ring_round_enc: n = ", n,
              " ranks, want 1..", most);
  TORCH_CHECK(G >= 1 && s >= 1 && d >= 1,
              "ring_round_enc: need G, s, d >= 1");
  const int64_t tiles =
      (d + repro_torch::kRingTileCols - 1) / repro_torch::kRingTileCols;
  TORCH_CHECK(G * s <= kMaxGridX / tiles, "ring_round_enc: G * s * tiles = ",
              G, " * ", s, " * ", tiles, " blocks exceed ", kMaxGridX);
  const c10::cuda::CUDAGuard guard(stack.device());
  const cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  const float* sc =
      scale.has_value() ? static_cast<const float*>(scale->data_ptr())
                        : nullptr;
  if (levels > 0) {
    C10_CUDA_CHECK(repro_torch::ring_requant_launch(
        stack.data_ptr(), dtype_code(st), enc.data_ptr(), sc, rs.data_ptr(),
        dtype_code(rs.scalar_type()), ag.data_ptr(),
        dtype_code(ag.scalar_type()),
        static_cast<const float*>(div.data_ptr()), out.data_ptr(),
        static_cast<float*>(part.data_ptr()),
        static_cast<unsigned int*>(amax.data_ptr()),
        static_cast<int>(levels), renorm, G, n, s, d,
        static_cast<int>(cluster), chunk, stream));
  } else {
    repro_torch::ring_round_launch(
        stack.data_ptr(), dtype_code(st), enc.data_ptr(),
        dtype_code(enc.scalar_type()), sc, rs.data_ptr(),
        dtype_code(rs.scalar_type()), ag.data_ptr(),
        dtype_code(ag.scalar_type()),
        static_cast<const float*>(div.data_ptr()), out.data_ptr(),
        acc_bf16 ? repro_torch::DType::kBF16 : repro_torch::DType::kF32,
        renorm, G, n, s, d, stream);
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void check_cuda_contig(const char* op, const at::Tensor& ref,
                       std::initializer_list<const at::Tensor*> ts) {
  for (const at::Tensor* t : ts) {
    TORCH_CHECK(t->is_cuda() && t->device() == ref.device(), op,
                ": tensors must be on one CUDA device");
    TORCH_CHECK(t->is_contiguous(), op, ": tensors must be contiguous");
  }
}

void ring_rank_hop(const at::Tensor& src,
                   const std::optional<at::Tensor>& src_scale,
                   const at::Tensor& rs, const std::optional<at::Tensor>& recv,
                   const std::optional<at::Tensor>& recv_scale,
                   const at::Tensor& div, at::Tensor& out,
                   const std::optional<at::Tensor>& out_scale,
                   const std::optional<at::Tensor>& part_max, int64_t chunk,
                   bool acc_bf16, int64_t levels, bool last, int64_t blocks,
                   int64_t cols) {
  check_cuda_contig("ring_rank_hop", src, {&src, &rs, &div, &out});
  TORCH_CHECK(src.dim() == 2 && rs.dim() == 1 && div.dim() == 1 &&
                  out.dim() == 2,
              "ring_rank_hop: want src (S, W), rs and div (S), out (k, W)");
  const int64_t S = src.size(0), W = src.size(1), k = out.size(0);
  TORCH_CHECK(k >= 1 && k <= kMaxGridY && W >= 1 && S % k == 0 &&
                  out.size(1) == W && rs.size(0) == S && div.size(0) == S,
              "ring_rank_hop: shape mismatch (k = ", k, ", want 1..",
              kMaxGridY, ")");
  TORCH_CHECK(chunk >= 0 && chunk < S / k, "ring_rank_hop: chunk = ", chunk,
              ", want 0..", S / k - 1);
  TORCH_CHECK(div.scalar_type() == c10::ScalarType::Float,
              "ring_rank_hop: div must be float32");
  const c10::ScalarType st = src.scalar_type();
  const bool int8 = st == c10::ScalarType::Char;
  TORCH_CHECK(int8 || st == c10::ScalarType::Float ||
                  st == c10::ScalarType::BFloat16,
              "ring_rank_hop: src must be float32, bfloat16 or int8");
  const float* ssc = nullptr;
  if (int8) {
    TORCH_CHECK(src_scale.has_value(), "ring_rank_hop: int8 src needs scale");
    check_cuda_contig("ring_rank_hop", src, {&*src_scale});
    TORCH_CHECK(src_scale->scalar_type() == c10::ScalarType::Float &&
                    src_scale->dim() == 1 && src_scale->size(0) == S,
                "ring_rank_hop: src_scale must be float32 (S)");
    TORCH_CHECK(!acc_bf16, "ring_rank_hop: an int8 src sums in float32");
    ssc = static_cast<const float*>(src_scale->data_ptr());
  }
  TORCH_CHECK(levels >= 0 && levels <= kMaxLevels, "ring_rank_hop: levels = ",
              levels, ", want 0..", kMaxLevels);
  TORCH_CHECK(levels == 0 || int8,
              "ring_rank_hop: levels > 0 re-encodes an int8 wire");
  TORCH_CHECK(levels > 0 || !int8,
              "ring_rank_hop: an int8 src needs levels > 0");
  const c10::ScalarType acc =
      acc_bf16 ? c10::ScalarType::BFloat16 : c10::ScalarType::Float;
  const void* rv = nullptr;
  const float* rsc = nullptr;
  repro_torch::DType rdt = dtype_code(acc);
  if (recv.has_value()) {
    check_cuda_contig("ring_rank_hop", src, {&*recv});
    TORCH_CHECK(recv->sizes() == out.sizes(),
                "ring_rank_hop: recv must be (k, W)");
    if (levels > 0) {
      TORCH_CHECK(recv->scalar_type() == c10::ScalarType::Char &&
                      recv_scale.has_value(),
                  "ring_rank_hop: the int8 wire receives int8 with scales");
      check_cuda_contig("ring_rank_hop", src, {&*recv_scale});
      TORCH_CHECK(recv_scale->scalar_type() == c10::ScalarType::Float &&
                      recv_scale->dim() == 1 && recv_scale->size(0) == k,
                  "ring_rank_hop: recv_scale must be float32 (k)");
      rsc = static_cast<const float*>(recv_scale->data_ptr());
      rdt = repro_torch::DType::kI8;
    } else {
      TORCH_CHECK(recv->scalar_type() == acc,
                  "ring_rank_hop: recv must be of the accumulation dtype");
    }
    rv = recv->data_ptr();
  }
  float* osc = nullptr;
  float* pmax = nullptr;
  if (last) {
    TORCH_CHECK(out.scalar_type() == c10::ScalarType::Float ||
                    out.scalar_type() == c10::ScalarType::BFloat16,
                "ring_rank_hop: the last hop writes float32 or bfloat16");
  } else if (levels > 0) {
    TORCH_CHECK(out.scalar_type() == c10::ScalarType::Char &&
                    out_scale.has_value(),
                "ring_rank_hop: a re-encoding hop writes int8 with scales");
    check_cuda_contig("ring_rank_hop", src, {&*out_scale});
    TORCH_CHECK(out_scale->scalar_type() == c10::ScalarType::Float &&
                    out_scale->dim() == 1 && out_scale->size(0) == k,
                "ring_rank_hop: out_scale must be float32 (k)");
    osc = static_cast<float*>(out_scale->data_ptr());
    TORCH_CHECK(blocks >= 1 && blocks <= kMaxGridX && cols >= 16 &&
                    cols % 16 == 0 && (blocks - 1) * cols < W &&
                    W <= blocks * cols,
                "ring_rank_hop: the row split (", blocks, " blocks of ", cols,
                " columns) must cover W = ", W, " with multiples of 16 and "
                "no empty block");
    if (blocks > 1) {
      TORCH_CHECK(part_max.has_value(),
                  "ring_rank_hop: a split row needs part_max");
      check_cuda_contig("ring_rank_hop", src, {&*part_max});
      TORCH_CHECK(part_max->scalar_type() == c10::ScalarType::Float &&
                      part_max->numel() == k * blocks,
                  "ring_rank_hop: part_max must be float32 (k, blocks)");
      pmax = static_cast<float*>(part_max->data_ptr());
    }
  } else {
    TORCH_CHECK(out.scalar_type() == acc,
                "ring_rank_hop: a middle hop writes the accumulation dtype");
  }
  const c10::cuda::CUDAGuard guard(src.device());
  C10_CUDA_CHECK(repro_torch::ring_rank_hop_launch(
      src.data_ptr(), dtype_code(st), ssc, rs.data_ptr(),
      dtype_code(rs.scalar_type()), rv, rdt, rsc,
      static_cast<const float*>(div.data_ptr()), out.data_ptr(),
      dtype_code(out.scalar_type()), osc, pmax, dtype_code(acc),
      static_cast<int>(levels), last, chunk, k, W, blocks, cols,
      c10::cuda::getCurrentCUDAStream().stream()));
}

void ring_rank_land(const at::Tensor& cur, const at::Tensor& ag,
                    const at::Tensor& blocks, at::Tensor& out, int64_t chunk,
                    bool renorm) {
  check_cuda_contig("ring_rank_land", cur, {&cur, &ag, &blocks, &out});
  TORCH_CHECK(cur.dim() == 2 && ag.dim() == 1 && blocks.dim() == 2 &&
                  out.sizes() == blocks.sizes(),
              "ring_rank_land: want cur (k, W), ag (S), blocks and out "
              "(S, W)");
  const int64_t S = out.size(0), W = out.size(1), k = cur.size(0);
  TORCH_CHECK(k >= 1 && k <= kMaxGridY && W >= 1 && S % k == 0 &&
                  cur.size(1) == W && ag.size(0) == S,
              "ring_rank_land: shape mismatch");
  TORCH_CHECK(chunk >= 0 && chunk < S / k, "ring_rank_land: chunk = ", chunk,
              ", want 0..", S / k - 1);
  const c10::ScalarType st = cur.scalar_type();
  TORCH_CHECK(st == c10::ScalarType::Float || st == c10::ScalarType::BFloat16,
              "ring_rank_land: cur must be float32 or bfloat16");
  TORCH_CHECK(blocks.scalar_type() == st && out.scalar_type() == st,
              "ring_rank_land: cur, blocks and out share a dtype");
  const c10::cuda::CUDAGuard guard(cur.device());
  repro_torch::ring_rank_land_launch(
      cur.data_ptr(), dtype_code(st), ag.data_ptr(),
      dtype_code(ag.scalar_type()), blocks.data_ptr(), out.data_ptr(), renorm,
      chunk, k, W, c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("masked_avg_grid(Tensor blocks, Tensor mask, Tensor(a!) out, "
        "int tile) -> ()",
        &masked_avg_grid);
  m.def("tp_combine(Tensor partials, Tensor rs, Tensor ag, Tensor(a!) out, "
        "int site, int receiver, int blk, bool wire_bf16) -> ()",
        &tp_combine);
  m.def("rwkv6_fwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
        "Tensor(a!) out, Tensor(b!) state, Tensor(c!) scratch, "
        "Tensor(d!) ready) -> ()",
        &rwkv6_fwd);
  m.def("rglru_fwd(Tensor x, Tensor a, Tensor(a!) out, Tensor(b!) h_last) "
        "-> ()",
        &rglru_fwd);
  m.def("ring_round(Tensor stack, Tensor rs, Tensor ag, Tensor div, "
        "Tensor(a!) out, bool renorm, bool acc_bf16) -> ()",
        &ring_round);
  m.def("ring_round_enc(Tensor stack, Tensor enc, Tensor? scale, "
        "Tensor rs, Tensor ag, Tensor div, Tensor(a!) out, Tensor(b!) part, "
        "Tensor(c!) amax, bool renorm, bool acc_bf16, int levels, "
        "int cluster, int chunk) -> ()",
        &ring_round_enc);
  m.def("ring_rank_hop(Tensor src, Tensor? src_scale, Tensor rs, "
        "Tensor? recv, Tensor? recv_scale, Tensor div, Tensor(a!) out, "
        "Tensor(b!)? out_scale, Tensor(c!)? part_max, int chunk, "
        "bool acc_bf16, int levels, bool last, int blocks, int cols) -> ()",
        &ring_rank_hop);
  m.def("ring_rank_land(Tensor cur, Tensor ag, Tensor blocks, "
        "Tensor(a!) out, int chunk, bool renorm) -> ()",
        &ring_rank_land);
}
