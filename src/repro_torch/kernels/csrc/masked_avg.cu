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

// ---------------------------------------------------------------------------
// The tensor-parallel combine of one drop-masked decode site, in one launch.
//
// Replaces, on the serving path, the same Pallas kernel
// (src/repro/kernels/masked_avg.py::masked_avg_grid_pallas) together with
// the tensor work around it at one site of serve/tp.py::TPContext._exchange:
// the n * partials product, the plan's (d, B) gather and f32 cast, the wire
// cast, the copies into the (s, n, blk) block layout, the masked average,
// the all-gather's select against the receiver's own block and the scatter
// back to (B, 1, d). For partials p (n, B, 1, d) (read through its strides),
// the site's rows of the (n_sites, n, s) bool mask stacks rs and ag (read
// through their strides), receiver r and the plan's block width blk,
// element (b, c) of the (B, 1, d) f32 output is, with f = c * B + b the flat
// index of the plan's (d, B) leaf and j = f / blk its server block:
//   y_i = f32(round_P(n * p_i[b, c]))
//   out = f32(round_W(sum_i rs[i, j] * round_W(y_i) / max(sum_i rs[i, j], 1)))
//         where ag[r, j], else y_r,
// summed in f32 in worker order 0..n-1 and divided with IEEE division, the
// adds and the division of masked_avg_grid_kernel above, so the two routes
// agree bit for bit.
//
// What bounds it: at gemma3-1b's serving shape (n 4, B 8, d 1152, f32
// partials) it reads 147,456 bytes and writes 36,864, about 55 ns at the
// card's memory rate, so one launch costs more than its bytes. The unfused
// route spent 8-9 launches and ~105 host-side aten ops per site.
//
// What the design does about it:
//   - one launch per site and nothing else: no copy into a block layout, no
//     mask stack or cast, no select kernel afterwards; the output is the
//     only allocation (the wrapper's torch::empty);
//   - a thread owns one column of one request b (grid.y = b, so its
//     coordinates need no division), neighbouring threads on neighbouring
//     columns; it issues the loads of the first eight workers' partials
//     and mask bytes and of the receiver's ag byte before it uses any,
//     reading the masks straight from the step's stacks (the site's rows
//     are a few hundred bytes, cached after the first warp). No shared
//     memory and no barrier: the launch is set by each thread's short
//     dependent chain (loads, masks, n adds, a division), and one column a
//     thread puts the most warps on it. At the serving shape, staging the
//     masks in shared memory behind a barrier and 16-byte loads of 2 or 4
//     columns a thread both measured slower than this (PERF.md section 6);
//   - 256-thread blocks: 40 at the serving shape.
// No tensor cores and no TMA: there is no product here.

namespace {

constexpr int kTpThreads = 256;
// workers whose partials and mask bytes a thread loads before it uses any
constexpr int kTpPrefetch = 8;

// one site's combine: the partials and their element strides (worker,
// request, column), the site's rs rows and the receiver's ag row with their
// element strides (worker, block), the plan
struct TpSite {
  const void* partials;
  int64_t sn, sb, sc;
  const bool* rs;
  int64_t rs_sn, rs_ss;
  const bool* ag;
  int64_t ag_ss;
  float* out;
  int n, B, d, blk, receiver;
};

// worker i's contribution to a thread's column, in worker order
template <typename P, typename W>
__device__ __forceinline__ void tp_add(P x, bool m, int i, int receiver,
                                       float nf, float& acc, float& count,
                                       float& own) {
  // n * p in the partials' dtype, then the plan's f32 and the wire's
  const float y = to_float(from_float<P>(nf * to_float(x)));
  const float mf = m ? 1.0f : 0.0f;
  acc += mf * to_float(from_float<W>(y));
  count += mf;
  if (i == receiver) own = y;
}

// P partials, W wire
template <typename P, typename W>
__global__ void __launch_bounds__(kTpThreads)
    tp_combine_kernel(const TpSite a) {
  const int b = static_cast<int>(blockIdx.y);
  const int c = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= a.d) return;
  const int j = static_cast<int>(static_cast<unsigned>(c * a.B + b) /
                                 static_cast<unsigned>(a.blk));
  const P* src = static_cast<const P*>(a.partials) + b * a.sb + c * a.sc;
  const bool* rs = a.rs + j * a.rs_ss;
  // every load of the first workers, and the ag byte, before any is used
  P pre[kTpPrefetch];
  bool m[kTpPrefetch];
#pragma unroll
  for (int i = 0; i < kTpPrefetch; ++i) {
    if (i < a.n) {
      pre[i] = src[i * a.sn];
      m[i] = rs[i * a.rs_sn];
    }
  }
  const bool keep = a.ag[j * a.ag_ss];
  const float nf = static_cast<float>(a.n);
  float acc = 0.0f, count = 0.0f, own = 0.0f;
#pragma unroll
  for (int i = 0; i < kTpPrefetch; ++i) {
    if (i < a.n) {
      tp_add<P, W>(pre[i], m[i], i, a.receiver, nf, acc, count, own);
    }
  }
  for (int i = kTpPrefetch; i < a.n; ++i) {
    tp_add<P, W>(src[i * a.sn], rs[i * a.rs_sn], i, a.receiver, nf, acc,
                 count, own);
  }
  a.out[static_cast<int64_t>(b) * a.d + c] =
      keep ? to_float(from_float<W>(acc / fmaxf(count, 1.0f))) : own;
}

template <typename P, typename W>
void tp_launch_typed(const TpSite& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.d + kTpThreads - 1) / kTpThreads),
                  static_cast<unsigned>(a.B));
  tp_combine_kernel<P, W><<<grid, kTpThreads, 0, stream>>>(a);
}

template <typename P>
void tp_launch_wire(const TpSite& a, DType wire_dtype, cudaStream_t stream) {
  if (wire_dtype == DType::kBF16) {
    tp_launch_typed<P, __nv_bfloat16>(a, stream);
  } else {
    tp_launch_typed<P, float>(a, stream);
  }
}

}  // namespace

void tp_combine_launch(const void* partials, DType partials_dtype, int64_t sn,
                       int64_t sb, int64_t sc, const bool* rs_site,
                       int64_t rs_sn, int64_t rs_ss, const bool* ag_row,
                       int64_t ag_ss, DType wire_dtype, float* out, int64_t n,
                       int64_t B, int64_t d, int64_t blk, int64_t receiver,
                       cudaStream_t stream) {
  const TpSite a{partials,
                 sn,
                 sb,
                 sc,
                 rs_site,
                 rs_sn,
                 rs_ss,
                 ag_row,
                 ag_ss,
                 out,
                 static_cast<int>(n),
                 static_cast<int>(B),
                 static_cast<int>(d),
                 static_cast<int>(blk),
                 static_cast<int>(receiver)};
  if (partials_dtype == DType::kBF16) {
    tp_launch_wire<__nv_bfloat16>(a, wire_dtype, stream);
  } else {  // the binding admits only f32 and bf16 partials
    tp_launch_wire<float>(a, wire_dtype, stream);
  }
}

}  // namespace repro_torch
